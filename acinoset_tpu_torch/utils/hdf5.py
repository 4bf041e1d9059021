"""The subset of HDF5 that DeepLabCut's keypoint files use, read and
written in numpy and ``struct`` (``zlib`` for deflate), with no h5py.

What it reads (anything else raises, naming the file and the structure):

- superblock versions 0 and 1 (the sizes of offsets and lengths come from
  the superblock), behind a user block of 0, 512, 1024, ... bytes;
- version-1 object headers, following continuation messages;
- symbol-table groups: the v1 B-tree's group nodes, ``SNOD`` nodes and
  the local heap. Children come in name order, h5py's key order;
- dataspaces (versions 1 and 2);
- little-endian fixed-point and float datatypes, fixed-length strings,
  variable-length strings (through the global heap), compound (versions
  1-3, array members included), array and opaque;
- layout message version 3: compact, contiguous, and chunked through a v1
  B-tree of chunk keys, with the deflate (1) and shuffle (2) filters;
- attribute messages, versions 1-3.

This covers what h5py writes by default (``libver='earliest'``) and the
pandas/PyTables "fixed" and "table" layouts of a DLC ``.h5`` file.

What it writes (``write_file``): superblock 0, v1 object headers, a
symbol-table root group holding groups of contiguous datasets (int64,
float64, fixed-length strings, or variable-length UTF-8 strings as h5py
writes them) with fixed-length string attributes. That is the layout of
``pipeline.data.save_dlc_points_h5``.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class HDF5FormatError(ValueError):
    """A structure outside the supported subset (or a damaged file)."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------


class _File:
    """The whole file in memory, with the superblock's sizes."""

    def __init__(self, fpath: str):
        self.fpath = str(fpath)
        with open(fpath, "rb") as f:
            self.buf = f.read()
        base = 0
        while True:
            if base + 8 > len(self.buf):
                self.fail("no HDF5 signature")
            if self.buf[base:base + 8] == SIGNATURE:
                break
            base = 512 if base == 0 else 2 * base
        sb_version = self.buf[base + 8]
        if sb_version not in (0, 1):
            self.fail(f"superblock version {sb_version} (only 0 and 1 are supported)")
        self.size_o = self.buf[base + 13]
        self.size_l = self.buf[base + 14]
        if self.size_o not in (2, 4, 8) or self.size_l not in (2, 4, 8):
            self.fail(f"sizes of offsets {self.size_o} and lengths {self.size_l}")
        p = base + 24 + (4 if sb_version == 1 else 0)
        self.base, p = self.offset(p)
        _free, p = self.offset(p)
        _eof, p = self.offset(p)
        p += self.size_o  # the I/O information block's address, unused
        self.root = self._entry(p)[1]

    def fail(self, what: str):
        raise HDF5FormatError(f"{self.fpath}: unsupported HDF5 structure: {what}")

    def uint(self, p: int, n: int) -> int:
        if p + n > len(self.buf):
            self.fail(f"read past the end of the file at {p}")
        return int.from_bytes(self.buf[p:p + n], "little")

    def offset(self, p: int) -> Tuple[int, int]:
        v = self.uint(p, self.size_o)
        return (UNDEF if v == (1 << (8 * self.size_o)) - 1 else v), p + self.size_o

    def length(self, p: int) -> Tuple[int, int]:
        return self.uint(p, self.size_l), p + self.size_l

    def addr(self, a: int) -> int:
        return self.base + a

    def _entry(self, p: int) -> Tuple[int, int, int]:
        """A symbol-table entry -> (link name offset, object header
        address, next position). The cache type and scratch pad are not
        needed: the object header is always read."""
        name, p = self.offset(p)
        header, p = self.offset(p)
        return name, header, p + 8 + 16

    def check_sig(self, p: int, sig: bytes, what: str):
        if self.buf[p:p + 4] != sig:
            self.fail(f"{what} at {p} without its {sig!r} signature")

    # ---- object headers ----

    def messages(self, addr: int) -> List[Tuple[int, int, int, int]]:
        """(type, flags, data start, data size) of a v1 object header,
        across its continuation blocks."""
        p = self.addr(addr)
        if self.buf[p:p + 4] == b"OHDR":
            self.fail("a version-2 object header")
        version = self.buf[p]
        if version != 1:
            self.fail(f"object header version {version}")
        n_msgs = self.uint(p + 2, 2)
        size = self.uint(p + 8, 4)
        blocks = [(p + 16, size)]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 8 <= end and len(out) < n_msgs:
                mtype, msize, mflags = self.uint(q, 2), self.uint(q + 2, 2), self.buf[q + 4]
                data = q + 8
                if mtype == 0x10:  # continuation
                    off, r = self.offset(data)
                    ln, _ = self.length(r)
                    blocks.append((self.addr(off), ln))
                out.append((mtype, mflags, data, msize))
                q = data + msize
        return out

    def node(self, addr: int):
        """A group or dataset at an object header address."""
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        if 0x11 in types:
            return Group(self, msgs)
        if 0x0002 in types or 0x0006 in types:
            self.fail("a group with link messages (new-style, fractal-heap group)")
        if 0x0008 in types:
            return Dataset(self, msgs)
        self.fail(f"an object header at {addr} that is neither group nor dataset")

    # ---- datatypes / dataspaces ----

    def datatype(self, p: int) -> np.dtype:
        """The numpy dtype of a datatype message at ``p``. Variable-length
        strings map to ``object`` (their heap IDs are decoded by
        ``decode_vlen``)."""
        return self._datatype(p)[0]

    def _datatype(self, p: int) -> Tuple[np.dtype, int]:
        head = self.buf[p]
        cls, version = head & 0x0F, head >> 4
        bits = self.uint(p + 1, 3)
        size = self.uint(p + 4, 4)
        q = p + 8
        if cls in (0, 1):  # fixed-point, float
            if bits & 1:
                self.fail("a big-endian datatype")
            if cls == 0:
                if size not in (1, 2, 4, 8):
                    self.fail(f"a {size}-byte integer")
                kind = "i" if bits & 0x08 else "u"
                return np.dtype(f"<{kind}{size}"), q + 4
            if bits & 0x40:
                self.fail("a VAX-order float")
            if size not in (2, 4, 8):
                self.fail(f"a {size}-byte float")
            return np.dtype(f"<f{size}"), q + 12
        if cls == 3:  # fixed-length string
            return np.dtype(f"S{size}"), q
        if cls == 5:  # opaque: an ASCII tag padded to 8 bytes
            tag_len = bits & 0xFF
            return np.dtype(f"V{size}"), q + tag_len
        if cls == 6:  # compound
            n_members = bits & 0xFFFF
            names, formats, offsets = [], [], []
            for _ in range(n_members):
                end = self.buf.index(b"\x00", q)
                name = self.buf[q:end].decode()
                if version < 3:
                    q = q + _pad8(end - q + 1)
                    off = self.uint(q, 4)
                    q += 4
                else:
                    q = end + 1
                    nb = 1 if size < 1 << 8 else 2 if size < 1 << 16 else 3 if size < 1 << 24 else 4
                    off = self.uint(q, nb)
                    q += nb
                if version == 1:
                    ndims = self.buf[q]
                    dims = [self.uint(q + 12 + 4 * i, 4) for i in range(ndims)]
                    q += 28
                    mt, q = self._datatype(q)
                    if ndims:
                        mt = np.dtype((mt, tuple(dims)))
                else:
                    mt, q = self._datatype(q)
                if mt == np.dtype(object):
                    self.fail("a variable-length member of a compound")
                names.append(name)
                formats.append(mt)
                offsets.append(off)
            dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                           "itemsize": size})
            return dt, q
        if cls == 9:  # variable-length
            if bits & 0x0F != 1:
                self.fail("a variable-length sequence (only strings are supported)")
            _base, q = self._datatype(q)
            return np.dtype(object), q
        if cls == 10:  # array
            ndims = self.buf[q]
            if version < 3:
                dims = [self.uint(q + 4 + 4 * i, 4) for i in range(ndims)]
                q = q + 4 + 8 * ndims
            else:
                dims = [self.uint(q + 1 + 4 * i, 4) for i in range(ndims)]
                q = q + 1 + 4 * ndims
            base, q = self._datatype(q)
            if base == np.dtype(object):
                self.fail("an array of variable-length elements")
            return np.dtype((base, tuple(dims))), q
        names = {2: "time", 4: "bitfield", 7: "reference", 8: "enumeration"}
        self.fail(f"the {names.get(cls, f'class-{cls}')} datatype")

    def dataspace(self, p: int) -> Tuple[int, ...]:
        version, ndims, flags = self.buf[p], self.buf[p + 1], self.buf[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:
                return (0,)  # null dataspace: no elements
            q = p + 4
        else:
            self.fail(f"dataspace version {version}")
        return tuple(self.uint(q + self.size_l * i, self.size_l) for i in range(ndims))

    def decode_vlen(self, raw: bytes, n: int) -> np.ndarray:
        """n variable-length strings (4-byte length + global heap ID each)
        -> an object array of bytes, as h5py returns them."""
        out = np.empty(n, dtype=object)
        step = 4 + self.size_o + 4
        for i in range(n):
            e = raw[i * step:(i + 1) * step]
            length = int.from_bytes(e[:4], "little")
            coll = int.from_bytes(e[4:4 + self.size_o], "little")
            idx = int.from_bytes(e[4 + self.size_o:], "little")
            out[i] = b"" if length == 0 else self.heap_object(coll, idx)[:length]
        return out

    def heap_object(self, coll: int, idx: int) -> bytes:
        p = self.addr(coll)
        self.check_sig(p, b"GCOL", "global heap collection")
        size, _ = self.length(p + 8)
        q, end = p + 8 + self.size_l, p + size
        while q + 8 + self.size_l <= end:
            oid = self.uint(q, 2)
            osize, r = self.length(q + 8)
            if oid == idx:
                return self.buf[r:r + osize]
            if oid == 0:
                break
            q = r + _pad8(osize)
        self.fail(f"global heap object {idx} missing from the collection at {coll}")


class Group:
    """A symbol-table group: ``keys()`` in name order, ``group[name]``
    (a Group or a Dataset), ``attrs`` (name -> numpy value)."""

    def __init__(self, f: _File, msgs):
        self._f = f
        self.attrs = _attributes(f, msgs)
        data = next(m[2] for m in msgs if m[0] == 0x11)
        btree, q = f.offset(data)
        heap, _ = f.offset(q)
        self._children = _group_children(f, btree, heap)

    def keys(self) -> List[str]:
        return list(self._children)

    def __contains__(self, name) -> bool:
        return name in self._children

    def __getitem__(self, name: str):
        node: object = self
        for part in name.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node._children:
                raise KeyError(f"{self._f.fpath}: no object {name!r}")
            node = node._f.node(node._children[part])
        return node


class Dataset:
    """``shape``, ``dtype`` and ``attrs`` of a dataset; ``read()`` loads
    it whole."""

    def __init__(self, f: _File, msgs):
        self._f = f
        self.attrs = _attributes(f, msgs)
        by_type = {}
        for mtype, mflags, data, size in msgs:
            if mflags & 0x02 and mtype in (0x01, 0x03):
                f.fail("a shared (committed) datatype or dataspace")
            by_type.setdefault(mtype, (data, size))
        if 0x01 not in by_type or 0x03 not in by_type:
            f.fail("a dataset without its dataspace or datatype")
        self.shape = f.dataspace(by_type[0x01][0])
        self.dtype = f.datatype(by_type[0x03][0])
        self._layout = by_type[0x08][0]
        self._filters = _filters(f, by_type[0x0B][0]) if 0x0B in by_type else []

    def read(self) -> np.ndarray:
        f = self._f
        n = int(np.prod(self.shape, dtype=np.int64))
        vlen = self.dtype == np.dtype(object)
        itemsize = 4 + f.size_o + 4 if vlen else self.dtype.itemsize
        raw = self._raw(n * itemsize, itemsize)
        if vlen:
            return f.decode_vlen(raw, n).reshape(self.shape)
        return np.frombuffer(raw, dtype=self.dtype, count=n).reshape(self.shape).copy()

    def _raw(self, nbytes: int, itemsize: int) -> bytes:
        f, p = self._f, self._layout
        version, cls = f.buf[p], f.buf[p + 1]
        if version != 3:
            f.fail(f"data layout message version {version}"
                   + (" (a v2 B-tree or other new chunk index)" if version == 4 else ""))
        if cls == 0:  # compact
            size = f.uint(p + 2, 2)
            return f.buf[p + 4:p + 4 + size][:nbytes]
        if cls == 1:  # contiguous
            a, q = f.offset(p + 2)
            if a == UNDEF:  # never written: the fill value, zero
                return bytes(nbytes)
            return f.buf[f.addr(a):f.addr(a) + nbytes]
        if cls == 2:
            return self._chunked(p, nbytes, itemsize)
        f.fail(f"layout class {cls}")

    def _chunked(self, p: int, nbytes: int, itemsize: int) -> bytes:
        f = self._f
        ndims = f.buf[p + 2]  # rank + 1 (the element size)
        btree, q = f.offset(p + 3)
        chunk = [f.uint(q + 4 * i, 4) for i in range(ndims)]
        rank = ndims - 1
        shape = self.shape
        if rank != len(shape):
            f.fail("chunk rank differs from the dataspace's")
        out = np.zeros(tuple(shape) + (itemsize,), dtype=np.uint8)
        cshape = tuple(chunk[:rank])
        chunk_bytes = int(np.prod(cshape, dtype=np.int64)) * itemsize
        if btree != UNDEF:
            for offs, size, mask, addr in _chunk_keys(f, btree, ndims):
                raw = f.buf[f.addr(addr):f.addr(addr) + size]
                raw = _unfilter(f, raw, self._filters, mask, itemsize)
                if len(raw) != chunk_bytes:
                    f.fail(f"a chunk of {len(raw)} bytes where {chunk_bytes} were due")
                block = np.frombuffer(raw, dtype=np.uint8).reshape(cshape + (itemsize,))
                sel = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, cshape, shape))
                out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out.tobytes()[:nbytes]


def _attributes(f: _File, msgs) -> Dict[str, object]:
    """Attribute messages (versions 1-3) -> {name: value}: a scalar comes
    back as a numpy scalar (bytes for a string), an array as an array."""
    out = {}
    for mtype, _flags, p, _size in msgs:
        if mtype != 0x0C:
            continue
        version = f.buf[p]
        name_size, dt_size, ds_size = f.uint(p + 2, 2), f.uint(p + 4, 2), f.uint(p + 6, 2)
        if version == 1:
            q = p + 8
            name = f.buf[q:q + name_size].rstrip(b"\x00").decode()
            q += _pad8(name_size)
            dt_p = q
            q += _pad8(dt_size)
            ds_p = q
            q += _pad8(ds_size)
        elif version in (2, 3):
            if f.buf[p + 1] & 0x03:
                f.fail("a shared datatype or dataspace in an attribute")
            q = p + 8 + (1 if version == 3 else 0)
            name = f.buf[q:q + name_size].rstrip(b"\x00").decode()
            q += name_size
            dt_p, ds_p = q, q + dt_size
            q = ds_p + ds_size
        else:
            f.fail(f"attribute message version {version}")
        dtype = f.datatype(dt_p)
        shape = f.dataspace(ds_p)
        n = int(np.prod(shape, dtype=np.int64))
        if dtype == np.dtype(object):
            val = f.decode_vlen(f.buf[q:q + n * (8 + f.size_o)], n).reshape(shape)
        else:
            val = np.frombuffer(f.buf[q:q + n * dtype.itemsize], dtype=dtype, count=n)
            val = val.reshape(shape).copy()
        out[name] = val[()] if shape == () else val
    return out


def _group_children(f: _File, btree: int, heap: int) -> Dict[str, int]:
    """Name -> object header address of a symbol-table group's children,
    walking its v1 B-tree of group nodes, in name order."""
    hp = f.addr(heap)
    f.check_sig(hp, b"HEAP", "local heap")
    data_addr, _ = f.offset(hp + 8 + 2 * f.size_l)
    heap_data = f.addr(data_addr)

    def name_at(off: int) -> str:
        end = f.buf.index(b"\x00", heap_data + off)
        return f.buf[heap_data + off:end].decode()

    children: Dict[str, int] = {}

    def walk(addr: int):
        p = f.addr(addr)
        f.check_sig(p, b"TREE", "B-tree node")
        if f.buf[p + 4] != 0:
            f.fail("a B-tree of node type other than group in a group")
        level, used = f.buf[p + 5], f.uint(p + 6, 2)
        q = p + 8 + 2 * f.size_o
        for _ in range(used):
            q += f.size_l  # key
            child, q = f.offset(q)
            if level > 0:
                walk(child)
            else:
                snod(child)

    def snod(addr: int):
        p = f.addr(addr)
        f.check_sig(p, b"SNOD", "symbol table node")
        count = f.uint(p + 6, 2)
        q = p + 8
        for _ in range(count):
            name_off, header, q = f._entry(q)
            children[name_at(name_off)] = header

    walk(btree)
    return dict(sorted(children.items(), key=lambda kv: kv[0].encode()))


def _filters(f: _File, p: int) -> List[Tuple[int, List[int]]]:
    """The filter pipeline message -> [(filter id, client values)], in
    the order they were applied on write."""
    version, n = f.buf[p], f.buf[p + 1]
    q = p + (8 if version == 1 else 2)
    out = []
    for _ in range(n):
        fid = f.uint(q, 2)
        if version == 1 or fid >= 256:
            name_len = f.uint(q + 2, 2)
            q += 2
        else:
            name_len = 0
        nvals = f.uint(q + 4, 2)
        q += 6
        q += _pad8(name_len) if version == 1 else name_len
        vals = [f.uint(q + 4 * i, 4) for i in range(nvals)]
        q += 4 * nvals
        if version == 1 and nvals % 2:
            q += 4
        if fid not in (1, 2):
            names = {32000: "LZF", 32001: "blosc", 3: "fletcher32", 4: "szip", 5: "nbit",
                     6: "scale-offset"}
            f.fail(f"filter id {fid} ({names.get(fid, 'unknown')}); only deflate (1) and "
                   "shuffle (2) are supported")
        out.append((fid, vals))
    return out


def _unfilter(f: _File, raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, vals = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        else:  # shuffle: byte k of every element stored together
            size = vals[0] if vals else itemsize
            n = len(raw) // size
            head = np.frombuffer(raw[:n * size], dtype=np.uint8).reshape(size, n)
            raw = head.T.tobytes() + raw[n * size:]
    return raw


def _chunk_keys(f: _File, addr: int, ndims: int):
    """(offsets, stored size, filter mask, address) of every chunk in a
    v1 B-tree of raw-data chunks."""
    p = f.addr(addr)
    f.check_sig(p, b"TREE", "chunk B-tree node")
    if f.buf[p + 4] != 1:
        f.fail("a chunk index B-tree of node type other than raw data")
    level, used = f.buf[p + 5], f.uint(p + 6, 2)
    q = p + 8 + 2 * f.size_o
    key_size = 8 + 8 * ndims
    for _ in range(used):
        size, mask = f.uint(q, 4), f.uint(q + 4, 4)
        offs = [f.uint(q + 8 + 8 * i, 8) for i in range(ndims - 1)]
        child, q2 = f.offset(q + key_size)
        if level > 0:
            yield from _chunk_keys(f, child, ndims)
        else:
            yield offs, size, mask, child
        q = q2


def open_file(fpath) -> Group:
    """The root group of an HDF5 file in the supported subset."""
    f = _File(fpath)
    return f.node(f.root)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------

#: datatype messages: little-endian float64 and signed int64; a
#: variable-length UTF-8 string over an unsigned byte, as h5py's
#: ``string_dtype('utf-8')``
_F64_TYPE = struct.pack("<B3BI", 0x11, 0x20, 63, 0, 8) + struct.pack("<HHBBBBI", 0, 64, 52, 11,
                                                                          0, 52, 1023)
_I64_TYPE = struct.pack("<B3BIHH", 0x10, 0x08, 0, 0, 8, 0, 64)
_VLEN_UTF8_TYPE = (struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16)
                   + struct.pack("<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8))


def _string_type(size: int) -> bytes:
    """Fixed-length ASCII string, null-padded (numpy's ``S`` as h5py
    writes it)."""
    return struct.pack("<B3BI", 0x13, 0x01, 0, 0, size)


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    out = struct.pack("<BBB5x", 1, len(shape), 0)
    return out + b"".join(struct.pack("<Q", s) for s in shape)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + bytes(_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _attribute(name: str, value: bytes) -> bytes:
    """A version-1 attribute holding one fixed-length string."""
    nm = name.encode() + b"\x00"
    dt = _string_type(len(value))
    ds = _dataspace(())
    body = struct.pack("<BxHHH", 1, len(nm), len(dt), len(ds))
    for part in (nm, dt, ds):
        body += part + bytes(_pad8(len(part)) - len(part))
    return _message(0x0C, body + value)


class _Writer:
    def __init__(self):
        self.chunks: List[bytes] = []
        self.size = 0

    def alloc(self, data: bytes) -> int:
        addr = self.size
        data = data + bytes(_pad8(len(data)) - len(data))
        self.chunks.append(data)
        self.size += len(data)
        return addr

    def image(self) -> bytearray:
        return bytearray(b"".join(self.chunks))


def _dataset_payload(arr: np.ndarray, w: _Writer) -> Tuple[bytes, bytes]:
    """(datatype message body, raw bytes) of an array to write."""
    if arr.dtype == np.dtype(object):  # variable-length UTF-8 strings
        encoded = [str(s).encode("utf-8") for s in arr.reshape(-1)]
        objs = b""
        for i, e in enumerate(encoded, start=1):
            objs += struct.pack("<HH4xQ", i, 0, len(e)) + e + bytes(_pad8(len(e)) - len(e))
        total = max(4096, 16 + len(objs) + 16)
        free = total - 16 - len(objs)
        coll = (b"GCOL" + struct.pack("<B3xQ", 1, total) + objs
                + struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16))
        addr = w.alloc(coll)
        raw = b"".join(struct.pack("<IQI", len(e), addr, i)
                       for i, e in enumerate(encoded, start=1))
        return _VLEN_UTF8_TYPE, raw
    if arr.dtype.kind == "S":
        return _string_type(arr.dtype.itemsize), arr.tobytes()
    if arr.dtype == np.float64:
        return _F64_TYPE, arr.astype("<f8").tobytes()
    if arr.dtype == np.int64:
        return _I64_TYPE, arr.astype("<i8").tobytes()
    raise TypeError(f"cannot write a dataset of dtype {arr.dtype}")


def _symbol_table(w: _Writer, children: Dict[str, Tuple[int, Optional[Tuple[int, int]]]],
                  leaf_k: int) -> Tuple[int, int]:
    """A local heap, one SNOD and a one-entry B-tree for a group's
    children (name -> (object header address, (btree, heap) of a child
    group or None)). Returns (B-tree address, heap address)."""
    names = sorted(children, key=lambda s: s.encode())
    heap_data = bytes(8)  # offset 0: the empty name
    offs = {}
    for n in names:
        offs[n] = len(heap_data)
        enc = n.encode() + b"\x00"
        heap_data += enc + bytes(_pad8(len(enc)) - len(enc))
    heap_hdr_size = 8 + 2 * 8 + 8
    heap_addr = w.size
    # free list: 1 is "no free block" (H5HL_FREE_NULL)
    w.alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_addr + heap_hdr_size)
            + heap_data)
    entries = b""
    for n in names:
        header, stab = children[n]
        if stab is None:
            entries += struct.pack("<QQII16x", offs[n], header, 0, 0)
        else:
            entries += struct.pack("<QQII", offs[n], header, 1, 0) + struct.pack("<QQ", *stab)
    entries += bytes(40 * 2 * leaf_k - len(entries))
    snod = w.alloc(b"SNOD" + struct.pack("<BxH", 1, len(names)) + entries)
    internal_k = 16
    keys = struct.pack("<QQQ", 0, snod, offs[names[-1]] if names else 0)
    node = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF) + keys
            + bytes((2 * internal_k) * 16 - 16))
    return w.alloc(node), heap_addr


def write_file(fpath: str, groups: Dict[str, Tuple[Dict[str, bytes], Dict[str, np.ndarray]]]):
    """Write ``{group name: ({attribute name: bytes}, {dataset name:
    array})}`` as an HDF5 file of one level of groups under the root:
    superblock 0, v1 object headers, symbol-table groups, contiguous
    datasets. Arrays may be int64/float64 (written little-endian),
    numpy ``S`` (fixed-length strings) or ``object`` arrays of ``str``
    (variable-length UTF-8 strings, as h5py's ``string_dtype('utf-8')``).
    Attributes are scalar fixed-length strings."""
    n_max = max([len(d) for _a, d in groups.values()] + [len(groups), 1])
    leaf_k = max(4, (n_max + 1) // 2)
    w = _Writer()
    w.alloc(bytes(96))  # the superblock, filled in at the end
    group_entries = {}
    for gname, (attrs, datasets) in groups.items():
        children = {}
        for dname, arr in datasets.items():
            arr = np.asarray(arr)
            dt, raw = _dataset_payload(arr, w)
            data_addr = w.alloc(raw)
            header = _object_header([
                _message(0x01, _dataspace(arr.shape)),
                _message(0x03, dt, flags=0x01),
                _message(0x05, struct.pack("<BBBBI", 2, 2, 0, 1, 0), flags=0x01),
                _message(0x08, struct.pack("<BBQQ", 3, 1, data_addr, len(raw))),
            ])
            children[dname] = (w.alloc(header), None)
        stab = _symbol_table(w, children, leaf_k)
        msgs = [_message(0x11, struct.pack("<QQ", *stab))]
        msgs += [_attribute(k, v) for k, v in attrs.items()]
        group_entries[gname] = (w.alloc(_object_header(msgs)), stab)
    root_stab = _symbol_table(w, group_entries, leaf_k)
    root = w.alloc(_object_header([_message(0x11, struct.pack("<QQ", *root_stab))]))
    buf = w.image()
    sb = (SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
          + struct.pack("<HHI", leaf_k, 16, 0)
          + struct.pack("<QQQQ", 0, UNDEF, len(buf), UNDEF)
          + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", *root_stab))
    buf[:len(sb)] = sb
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    with open(fpath, "wb") as f:
        f.write(buf)
    return fpath
