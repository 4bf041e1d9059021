"""MP4/MOV files: a video's metadata from its boxes, without decoding a
frame (what ``cv2.VideoCapture`` reports as CAP_PROP_FRAME_WIDTH/HEIGHT,
FPS and FRAME_COUNT); the video track's samples (``read_video_track``);
and a writer of one ``mp4v`` video track (``Mp4Writer``).

It walks ``moov/trak`` to the track whose ``hdlr`` is ``vide`` (GoPro
files also carry audio and GPMF metadata tracks) and reads:

- the width and height from the visual sample entry in ``stsd`` (the
  coded size), else from ``tkhd`` (16.16 fixed point);
- the frame count from ``stsz``'s sample count;
- the frame rate as ``mdhd``'s timescale times the sample count over the
  total duration of ``stts`` (timescale / delta for a constant rate).

64-bit box sizes (``size == 1``), boxes running to the end of the file
(``size == 0``) and ``co64`` chunk offsets are handled. A file with no
video track raises, naming the file.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Iterator, List, Tuple

import numpy as np

#: boxes whose payload is a sequence of child boxes on the path to the
#: video track's tables
_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


class MP4FormatError(ValueError):
    """A file whose boxes do not hold what is needed."""


def _boxes(buf: bytes, start: int, end: int, fpath: str) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, payload end) of the boxes in buf[start:end]."""
    p = start
    while p + 8 <= end:
        size, btype = struct.unpack(">I4s", buf[p:p + 8])
        head = 8
        if size == 1:
            if p + 16 > end:
                raise MP4FormatError(f"{fpath}: truncated 64-bit box size at {p}")
            size = struct.unpack(">Q", buf[p + 8:p + 16])[0]
            head = 16
        elif size == 0:
            size = end - p
        if size < head or p + size > end:
            raise MP4FormatError(f"{fpath}: box {btype!r} at {p} of size {size} overruns "
                                 f"its parent (ends at {end})")
        yield btype, p + head, p + size
        p += size


def _tree(buf: bytes, start: int, end: int, fpath: str) -> Dict[bytes, list]:
    """Boxes by type, containers expanded: {type: [(start, end, children)]}."""
    out: Dict[bytes, list] = {}
    for btype, s, e in _boxes(buf, start, end, fpath):
        kids = _tree(buf, s, e, fpath) if btype in _CONTAINERS else None
        out.setdefault(btype, []).append((s, e, kids))
    return out


def _one(tree: Dict[bytes, list], path: str, fpath: str):
    node = tree
    box = None
    for name in path.split("/"):
        hits = node.get(name.encode()) if node is not None else None
        if not hits:
            raise MP4FormatError(f"{fpath}: no {path} box in the video track")
        box = hits[0]
        node = box[2]
    return box


def _full_box(buf: bytes, s: int) -> Tuple[int, int]:
    """(version, payload start after version and flags) of a full box."""
    return buf[s], s + 4


def video_info(fpath: str) -> Tuple[Tuple[int, int], float, int]:
    """((width, height), fps, frame count) of the first video track."""
    with open(fpath, "rb") as f:
        buf = f.read()
    return _track_info(buf, _video_trak(buf, fpath), fpath)


def _video_trak(buf: bytes, fpath: str):
    """The box tree of the first ``trak`` whose handler is ``vide``."""
    top = _tree(buf, 0, len(buf), fpath)
    if b"moov" not in top:
        raise MP4FormatError(f"{fpath}: no moov box (not an MP4/MOV file?)")
    for _s, _e, trak in top[b"moov"][0][2].get(b"trak", []):
        hs, _he, _ = _one(trak, "mdia/hdlr", fpath)
        if buf[hs + 8:hs + 12] == b"vide":
            return trak
    raise MP4FormatError(f"{fpath}: no video track")


def _track_info(buf: bytes, trak, fpath: str):
    # timescale
    s, _e, _ = _one(trak, "mdia/mdhd", fpath)
    version, q = _full_box(buf, s)
    q += 16 if version == 1 else 8  # creation and modification times
    timescale = struct.unpack(">I", buf[q:q + 4])[0]

    # frame count
    s, _e, _ = _one(trak, "mdia/minf/stbl/stsz", fpath)
    _v, q = _full_box(buf, s)
    _sample_size, n_frames = struct.unpack(">II", buf[q:q + 8])

    # frame rate: samples over the summed deltas of stts
    s, _e, _ = _one(trak, "mdia/minf/stbl/stts", fpath)
    _v, q = _full_box(buf, s)
    (n_entries,) = struct.unpack(">I", buf[q:q + 4])
    count = duration = first_delta = 0
    for i in range(n_entries):
        c, d = struct.unpack(">II", buf[q + 4 + 8 * i:q + 12 + 8 * i])
        count += c
        duration += c * d
        first_delta = first_delta or d
    if not count and timescale and first_delta:  # no sample yet: the rate of the first entry
        count, duration = 1, first_delta
    if not (timescale and duration):
        raise MP4FormatError(f"{fpath}: video track without timing (timescale {timescale}, "
                             f"duration {duration})")
    fps = count * timescale / duration

    # size: the visual sample entry, else the track header
    s, e, _ = _one(trak, "mdia/minf/stbl/stsd", fpath)
    _v, q = _full_box(buf, s)
    entries = list(_boxes(buf, q + 4, e, fpath))
    if entries:
        es = entries[0][1]
        # SampleEntry: 6 reserved + data_reference_index; VisualSampleEntry:
        # pre_defined, reserved, 3 x pre_defined, then width and height
        width, height = struct.unpack(">HH", buf[es + 24:es + 28])
    else:
        width = height = 0
    if not (width and height):
        s, _e, _ = _one(trak, "tkhd", fpath)
        version, q = _full_box(buf, s)
        q += 32 if version == 1 else 20  # times, track ID, reserved, duration
        q += 52  # reserved, layer, alternate group, volume, reserved, matrix
        w, h = struct.unpack(">II", buf[q:q + 8])
        width, height = w >> 16, h >> 16
    return (int(width), int(height)), float(fps), int(n_frames)


# ---- the video track's samples ----


@dataclass
class VideoTrack:
    """The first video track of a file. ``codec`` is its sample entry's
    type (``mp4v``, ``avc1``, ``hvc1``, ...); ``config`` the decoder
    configuration of an ``mp4v`` entry (its ``esds`` DecoderSpecificInfo,
    which holds the VOS/VO/VOL headers), empty where there is none;
    ``offsets`` and ``sizes`` each sample's bytes in the file (offset -1
    for a sample that no chunk holds); ``sync`` each sample's sync flag."""

    fpath: str
    codec: str
    config: bytes
    size: Tuple[int, int]
    fps: float
    offsets: np.ndarray
    sizes: np.ndarray
    sync: np.ndarray

    @property
    def n_frames(self) -> int:
        return len(self.sizes)


def _descriptor(buf: bytes, p: int, end: int, fpath: str):
    """(tag, payload start, payload end) of the MPEG-4 descriptor at p
    (ISO/IEC 14496-1 8.3.3: a length of 7-bit groups)."""
    tag = buf[p]
    n, q = 0, p + 1
    for _ in range(4):
        if q >= end:
            break
        b = buf[q]
        q += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    if q + n > end:
        raise MP4FormatError(f"{fpath}: esds descriptor {tag} at {p} overruns its box")
    return tag, q, q + n


def _esds_config(buf: bytes, s: int, e: int, fpath: str) -> bytes:
    """The DecoderSpecificInfo bytes of an esds box's payload."""
    _v, q = _full_box(buf, s)
    tag, q, end = _descriptor(buf, q, e, fpath)
    if tag != 3:
        raise MP4FormatError(f"{fpath}: esds without an ES_Descriptor")
    flags = buf[q + 2]
    q += 3
    if flags & 0x80:  # streamDependenceFlag
        q += 2
    if flags & 0x40:  # URL_Flag
        q += 1 + buf[q]
    if flags & 0x20:  # OCRstreamFlag
        q += 2
    while q < end:
        tag, ps, pe = _descriptor(buf, q, end, fpath)
        if tag == 4:  # DecoderConfigDescriptor: 13 bytes, then its descriptors
            r = ps + 13
            while r < pe:
                tag5, s5, e5 = _descriptor(buf, r, pe, fpath)
                if tag5 == 5:
                    return bytes(buf[s5:e5])
                r = e5
        q = pe
    return b""


def _u32s(buf: bytes, q: int, n: int, fmt: str = ">u4") -> np.ndarray:
    return np.frombuffer(buf, dtype=fmt, count=n, offset=q).astype(np.int64)


def read_video_track(fpath: str) -> VideoTrack:
    """The first video track's sample entry, decoder configuration and
    sample table (stsz, stsc, stco/co64, stss; no stss means that every
    sample is a sync sample)."""
    with open(fpath, "rb") as f:
        buf = f.read()
    trak = _video_trak(buf, fpath)
    (width, height), fps, _n = _track_info(buf, trak, fpath)

    def table(name):
        hits = _one(trak, "mdia/minf/stbl", fpath)[2].get(name.encode())
        return hits[0] if hits else None

    s, e, _ = table("stsd")
    _v, q = _full_box(buf, s)
    entries = list(_boxes(buf, q + 4, e, fpath))
    if not entries:
        raise MP4FormatError(f"{fpath}: the video track has no sample entry")
    kind, es, ee = entries[0]
    codec = kind.decode("latin-1")
    config = b""
    if kind == b"mp4v":
        for ctype, cs, ce in _boxes(buf, es + 78, ee, fpath):  # after the VisualSampleEntry
            if ctype == b"esds":
                config = _esds_config(buf, cs, ce, fpath)

    s, _e, _ = table("stsz")
    _v, q = _full_box(buf, s)
    sample_size, count = struct.unpack(">II", buf[q:q + 8])
    sizes = (np.full(count, sample_size, np.int64) if sample_size
             else _u32s(buf, q + 8, count))

    chunk_box = table("stco") or table("co64")
    if chunk_box is None:
        raise MP4FormatError(f"{fpath}: no stco or co64 box in the video track")
    s, _e, _ = chunk_box
    _v, q = _full_box(buf, s)
    (n_chunks,) = struct.unpack(">I", buf[q:q + 4])
    chunks = _u32s(buf, q + 4, n_chunks, ">u8" if table("stco") is None else ">u4")

    stsc = table("stsc")  # none in a file whose samples no chunk holds
    n_runs = 0
    if stsc is not None:
        _v, q = _full_box(buf, stsc[0])
        (n_runs,) = struct.unpack(">I", buf[q:q + 4])
    runs = _u32s(buf, q + 4, 3 * n_runs).reshape(n_runs, 3)
    offsets = np.full(count, -1, np.int64)
    i = 0
    for r in range(n_runs):
        first = int(runs[r, 0]) - 1
        stop = int(runs[r + 1, 0]) - 1 if r + 1 < n_runs else n_chunks
        per = int(runs[r, 1])
        for c in range(first, min(stop, n_chunks)):
            take = min(per, count - i)
            if take <= 0:
                break
            within = np.concatenate([[0], np.cumsum(sizes[i:i + take - 1])])
            offsets[i:i + take] = chunks[c] + within
            i += take
    if np.any((offsets >= 0) & (offsets + sizes > len(buf))):
        raise MP4FormatError(f"{fpath}: a sample runs past the end of the file")

    stss = table("stss")
    if stss is None:
        sync = np.ones(count, bool)
    else:
        s, _e, _ = stss
        _v, q = _full_box(buf, s)
        (k,) = struct.unpack(">I", buf[q:q + 4])
        sync = np.zeros(count, bool)
        idx = _u32s(buf, q + 4, k) - 1
        sync[idx[(idx >= 0) & (idx < count)]] = True
    return VideoTrack(fpath, codec, config, (width, height), fps, offsets, sizes, sync)


# ---- writing one mp4v track ----


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _fbox(kind: bytes, payload: bytes, flags: int = 0) -> bytes:
    return _box(kind, struct.pack(">I", flags) + payload)


def _descr(tag: int, payload: bytes) -> bytes:
    n = len(payload)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F]) + payload


#: identity transformation matrix of mvhd and tkhd (16.16 and 2.30 fixed point)
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def frame_rate(fps: float) -> Tuple[int, int]:
    """fps as (numerator, denominator), the denominator at most 1001:
    119.88 -> (2997, 25), 120000/1001 -> (120000, 1001), 90.0 -> (90, 1)."""
    r = Fraction(float(fps)).limit_denominator(1001)
    if r <= 0:
        raise ValueError(f"frame rate {fps} is not positive")
    return r.numerator, r.denominator


class Mp4Writer:
    """An MP4 file of one ``mp4v`` video track, written as samples come:
    ``ftyp``, then ``mdat`` (64-bit size, patched at ``close``), then a
    ``moov`` with ``mvhd`` and a ``trak`` (``tkhd``, ``mdia``: ``mdhd``,
    ``hdlr vide``, ``minf``: ``vmhd``, ``dinf``, ``stbl``: ``stsd mp4v``
    with ``esds``, ``stts``, ``stss``, ``stsc``, ``stsz``, ``stco`` or
    ``co64``). The frame rate is stored as a rational (``frame_rate``):
    the media timescale is its numerator, each sample lasts its
    denominator. ``config`` is the VOS/VO/VOL headers."""

    def __init__(self, fpath: str, size: Tuple[int, int], fps: float, config: bytes):
        self.fpath = fpath
        self.size = (int(size[0]), int(size[1]))
        self.timescale, self.delta = frame_rate(fps)
        self.config = bytes(config)
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.sync: List[int] = []
        self._f = open(fpath, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 16))

    def add_sample(self, data: bytes, sync: bool):
        self.offsets.append(self._f.tell())
        self.sizes.append(len(data))
        if sync:
            self.sync.append(len(self.sizes))
        self._f.write(data)

    def close(self):
        if self._f is None:
            return
        end = self._f.tell()
        self._f.seek(self._mdat + 8)
        self._f.write(struct.pack(">Q", end - self._mdat))
        self._f.seek(end)
        self._f.write(self._moov())
        self._f.close()
        self._f = None

    def _moov(self) -> bytes:
        n = len(self.sizes)
        w, h = self.size
        media_t = n * self.delta
        movie_t = media_t * 1000 // self.timescale
        mvhd = struct.pack(">IIII", 0, 0, 1000, movie_t) + struct.pack(">IH10x", 0x10000, 0x100) \
            + _MATRIX + bytes(24) + struct.pack(">I", 2)
        tkhd = struct.pack(">IIII", 0, 0, 1, 0) + struct.pack(">I8x", movie_t) \
            + struct.pack(">HHHH", 0, 0, 0, 0) + _MATRIX + struct.pack(">II", w << 16, h << 16)
        mdhd = struct.pack(">IIIIHH", 0, 0, self.timescale, media_t, 0x55C4, 0)  # 'und'
        hdlr = struct.pack(">I4s12x", 0, b"vide") + b"VideoHandler\x00"
        dinf = _box(b"dinf", _fbox(b"dref", struct.pack(">I", 1) + _fbox(b"url ", b"", flags=1)))
        esds = _fbox(b"esds", _descr(3, struct.pack(">HB", 1, 0) + _descr(
            4, struct.pack(">BB", 0x20, 0x11) + struct.pack(">I", max(self.sizes, default=0))[1:]
            + struct.pack(">II", 0, 0) + _descr(5, self.config)) + _descr(6, b"\x02")))
        entry = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", w, h)
                 + struct.pack(">IIIH", 0x480000, 0x480000, 0, 1) + bytes(32)
                 + struct.pack(">Hh", 0x18, -1))
        large = bool(self.offsets) and max(self.offsets) > 0xFFFFFFFF
        offsets = np.asarray(self.offsets, ">u8" if large else ">u4").tobytes()
        stbl = _box(b"stbl", b"".join([
            _fbox(b"stsd", struct.pack(">I", 1) + _box(b"mp4v", entry + esds)),
            _fbox(b"stts", struct.pack(">III", 1, n, self.delta)),  # the rate, even with no sample
            _fbox(b"stss", struct.pack(">I", len(self.sync))
                  + np.asarray(self.sync, ">u4").tobytes()),
            _fbox(b"stsc", struct.pack(">IIII", 1, 1, 1, 1) if n else struct.pack(">I", 0)),
            _fbox(b"stsz", struct.pack(">II", 0, n) + np.asarray(self.sizes, ">u4").tobytes()),
            _fbox(b"co64" if large else b"stco", struct.pack(">I", n) + offsets),
        ]))
        minf = _box(b"minf", _fbox(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1) + dinf
                    + stbl)
        mdia = _box(b"mdia", _fbox(b"mdhd", mdhd) + _fbox(b"hdlr", hdlr) + minf)
        trak = _box(b"trak", _fbox(b"tkhd", tkhd, flags=3) + mdia)
        return _box(b"moov", _fbox(b"mvhd", mvhd) + trak)

    def abort(self):
        """Close without a ``moov`` and remove the file."""
        if self._f is not None:
            self._f.close()
            self._f = None
            os.remove(self.fpath)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()
