"""MP4/MOV files: a video's metadata from its boxes, without decoding a
frame (what ``cv2.VideoCapture`` reports as CAP_PROP_FRAME_WIDTH/HEIGHT,
FPS and FRAME_COUNT); the video track's samples (``read_video_track``);
each sample's presentation time and the presentation order that
``cv2.VideoCapture`` counts frames in (``ctts`` and ``elst``); the
decoder configuration of ``mp4v`` (``esds``), ``avc1``/``avc3``
(``avcC``) and ``hvc1``/``hev1`` (``hvcC``) entries; and a writer of one
video track (``Mp4Writer``).

It walks ``moov/trak`` to the track whose ``hdlr`` is ``vide`` (GoPro
files also carry audio and GPMF metadata tracks) and reads:

- the width and height from the visual sample entry in ``stsd`` (the
  coded size), else from ``tkhd`` (16.16 fixed point);
- the frame count from ``stsz``'s sample count;
- the frame rate as ``mdhd``'s timescale times the sample count over the
  total duration of ``stts`` (timescale / delta for a constant rate).

64-bit box sizes (``size == 1``), boxes running to the end of the file
(``size == 0``) and ``co64`` chunk offsets are handled. A file with no
video track raises, naming the file. Only the ``moov`` box is read: the
top-level boxes are walked with seeks, so a GoPro chapter's ``mdat`` (up
to 4 GB) is never read to learn its metadata.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple

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


def _read_moov(fpath: str) -> Tuple[bytes, int]:
    """(the moov box, the file's size): the top-level boxes are walked
    with seeks, and only moov is read."""
    with open(fpath, "rb") as f:
        end = os.fstat(f.fileno()).st_size
        p = 0
        while p + 8 <= end:
            f.seek(p)
            head = f.read(16)
            size, btype = struct.unpack(">I4s", head[:8])
            hl = 8
            if size == 1:
                if len(head) < 16:
                    raise MP4FormatError(f"{fpath}: truncated 64-bit box size at {p}")
                size, hl = struct.unpack(">Q", head[8:16])[0], 16
            elif size == 0:
                size = end - p
            if size < hl or p + size > end:
                raise MP4FormatError(f"{fpath}: box {btype!r} at {p} of size {size} overruns "
                                     f"its parent (ends at {end})")
            if btype == b"moov":
                f.seek(p)
                return f.read(size), end
            p += size
    raise MP4FormatError(f"{fpath}: no moov box (not an MP4/MOV file?)")


def video_info(fpath: str) -> Tuple[Tuple[int, int], float, int]:
    """((width, height), fps, frame count) of the first video track: the
    frame count is cv2's CAP_PROP_FRAME_COUNT, the track's sample count."""
    buf, _size = _read_moov(fpath)
    return _track_info(buf, _video_trak(buf, fpath), fpath)


def _video_trak(buf: bytes, fpath: str):
    """The box tree of the first ``trak`` whose handler is ``vide`` (buf
    is the moov box)."""
    top = _tree(buf, 0, len(buf), fpath)
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
    type (``mp4v``, ``avc1``, ``hvc1``, ...); ``config`` its decoder
    configuration (an ``mp4v`` entry's ``esds`` DecoderSpecificInfo, which
    holds the VOS/VO/VOL headers; an ``avcC`` or ``hvcC`` payload), empty
    where there is none, and for H.264 and HEVC ``param_sets`` the
    parameter set NAL units it holds and ``length_size`` the bytes of each
    NAL unit's length in a sample; ``offsets`` and ``sizes`` each sample's
    bytes in the file (offset -1 for a sample that no chunk holds), in
    decode order; ``sync`` each sample's sync flag; ``pts`` each sample's
    composition time in media ticks (decode time plus its
    ``ctts`` offset); ``order`` the samples in presentation order, as
    cv2 counts frames: frame k is sample ``order[k]``, the k-th by
    composition time among those the edit list (``elst``) shows."""

    fpath: str
    codec: str
    config: bytes
    size: Tuple[int, int]
    fps: float
    offsets: np.ndarray
    sizes: np.ndarray
    sync: np.ndarray
    pts: np.ndarray = None
    order: np.ndarray = None
    length_size: int = 4
    param_sets: Tuple[bytes, ...] = ()

    def __post_init__(self):
        if self.pts is None:
            self.pts = np.arange(len(self.sizes), dtype=np.int64)
        if self.order is None:
            self.order = np.arange(len(self.sizes), dtype=np.int64)

    @property
    def n_samples(self) -> int:
        return len(self.sizes)

    @property
    def n_frames(self) -> int:
        """Frames in presentation order (the samples the edit list shows)."""
        return len(self.order)


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


def _avcc(buf: bytes, fpath: str) -> Tuple[int, Tuple[bytes, ...]]:
    """(NAL length size, SPS and PPS units) of an avcC payload."""
    try:
        length_size = (buf[4] & 3) + 1
        sets, p = [], 5
        for mask in (31, 255):  # the SPS count's 5 bits, then the PPS count's 8
            n, p = buf[p] & mask, p + 1
            for _ in range(n):
                (size,) = struct.unpack(">H", buf[p:p + 2])
                sets.append(bytes(buf[p + 2:p + 2 + size]))
                p += 2 + size
    except (IndexError, struct.error):
        raise MP4FormatError(f"{fpath}: a truncated avcC box") from None
    return length_size, tuple(sets)


def _hvcc(buf: bytes, fpath: str) -> Tuple[int, Tuple[bytes, ...]]:
    """(NAL length size, VPS, SPS and PPS units) of an hvcC payload."""
    try:
        length_size = (buf[21] & 3) + 1
        sets, p = [], 23
        for _ in range(buf[22]):
            (n,) = struct.unpack(">H", buf[p + 1:p + 3])
            p += 3
            for _ in range(n):
                size = struct.unpack(">H", buf[p:p + 2])[0]
                sets.append(bytes(buf[p + 2:p + 2 + size]))
                p += 2 + size
    except (IndexError, struct.error):
        raise MP4FormatError(f"{fpath}: a truncated hvcC box") from None
    return length_size, tuple(sets)


def _run_lengths(buf: bytes, q: int, fmt: str) -> np.ndarray:
    """The expanded second column of a table of (count, value) runs."""
    (n,) = struct.unpack(">I", buf[q:q + 4])
    runs = np.frombuffer(buf, dtype=fmt, count=2 * n, offset=q + 4).astype(np.int64)
    return np.repeat(runs[1::2], runs[0::2])


def presentation_order(pts: np.ndarray, edits, media_scale: int, movie_scale: int) -> np.ndarray:
    """Sample indices by composition time, as ffmpeg's MP4 reader (and so
    cv2) shows frames: each edit (segment duration in movie ticks, media
    time in media ticks) shows the samples whose time lies in its window,
    from its media time on for its duration (0 or less: to the end);
    empty edits (media time -1) show none. No edit list shows every
    sample."""
    by_time = np.argsort(pts, kind="stable")
    shown = [e for e in edits if e[1] >= 0]
    if not shown:
        return by_time
    out = []
    for duration, media_time in shown:
        t = pts[by_time]
        keep = t >= media_time
        if duration > 0 and movie_scale:
            keep &= t < media_time + duration * media_scale / movie_scale
        out.append(by_time[keep])
    return np.concatenate(out)


def read_video_track(fpath: str) -> VideoTrack:
    """The first video track's sample entry, decoder configuration,
    sample table (stsz, stsc, stco/co64, stss; no stss means that every
    sample is a sync sample) and timing (stts, ctts, and the track's
    elst with mvhd's timescale)."""
    buf, file_size = _read_moov(fpath)
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
    config, length_size, param_sets = b"", 4, ()
    for ctype, cs, ce in _boxes(buf, es + 78, ee, fpath):  # after the VisualSampleEntry
        if ctype == b"esds" and kind == b"mp4v":
            config = _esds_config(buf, cs, ce, fpath)
        elif ctype == b"avcC" and kind in (b"avc1", b"avc3"):
            config = bytes(buf[cs:ce])
            length_size, param_sets = _avcc(config, fpath)
        elif ctype == b"hvcC" and kind in (b"hvc1", b"hev1"):
            config = bytes(buf[cs:ce])
            length_size, param_sets = _hvcc(config, fpath)

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
    if np.any((offsets >= 0) & (offsets + sizes > file_size)):
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

    # timing: decode times from stts, composition offsets from ctts
    s, _e, _ = table("stts")
    _v, q = _full_box(buf, s)
    deltas = _run_lengths(buf, q, ">u4")[:count]
    deltas = np.concatenate([deltas, np.full(count - len(deltas), deltas[-1] if len(deltas)
                                             else 1, np.int64)])
    pts = (np.cumsum(deltas) - deltas).astype(np.int64)
    ctts = table("ctts")
    if ctts is not None:
        version, q = _full_box(buf, ctts[0])
        off = _run_lengths(buf, q, ">i4" if version else ">u4")[:count]
        pts[:len(off)] += off
    s, _e, _ = _one(trak, "mdia/mdhd", fpath)
    version, q = _full_box(buf, s)
    timescale = struct.unpack(">I", buf[q + (16 if version else 8):q + (20 if version else 12)])[0]
    edits = []
    elst = trak.get(b"edts", [(0, 0, {})])[0][2].get(b"elst")
    if elst:
        version, q = _full_box(buf, elst[0][0])
        (n,) = struct.unpack(">I", buf[q:q + 4])
        fmt = ">Qq4x" if version else ">Ii4x"
        step = struct.calcsize(fmt)
        edits = [struct.unpack(fmt, buf[q + 4 + step * j:q + 4 + step * (j + 1)])
                 for j in range(n)]
    movie_scale = 0  # no mvhd: an edit's duration is not applied
    mvhd = _tree(buf, 0, len(buf), fpath)[b"moov"][0][2].get(b"mvhd")
    if mvhd:
        version, q = _full_box(buf, mvhd[0][0])
        movie_scale = struct.unpack(">I", buf[q + (16 if version else 8):
                                              q + (20 if version else 12)])[0]
    order = presentation_order(pts, edits, timescale, movie_scale)
    return VideoTrack(fpath, codec, config, (width, height), fps, offsets, sizes, sync, pts,
                      order, length_size, param_sets)


# ---- writing one video track ----


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
    """An MP4 file of one video track, written as samples come: ``ftyp``,
    then ``mdat`` (64-bit size, patched at ``close``), then a ``moov``
    with ``mvhd`` and a ``trak`` (``tkhd``, ``edts`` with ``elst`` when
    ``edit`` is given, ``mdia``: ``mdhd``, ``hdlr vide``, ``minf``:
    ``vmhd``, ``dinf``, ``stbl``: ``stsd``, ``stts``, ``ctts`` when a
    sample has a composition offset, ``stss``, ``stsc``, ``stsz``,
    ``stco`` or ``co64``). The frame rate is stored as a rational
    (``frame_rate``): the media timescale is its numerator, each sample
    lasts its denominator. ``codec`` is the sample entry: ``mp4v``, whose
    ``config`` is the VOS/VOL headers (in ``esds``), or ``avc1``/``avc3``
    and ``hvc1``/``hev1``, whose ``config`` is the ``avcC``/``hvcC``
    payload. ``edit`` (media start, duration), in frames, is the one edit
    of the ``elst``; ``add_sample``'s ``offset`` is the sample's
    composition offset in frames (version-1 ``ctts`` if one is negative)."""

    def __init__(self, fpath: str, size: Tuple[int, int], fps: float, config: bytes,
                 codec: str = "mp4v", edit: Optional[Tuple[int, int]] = None):
        if codec not in ("mp4v", "avc1", "avc3", "hvc1", "hev1"):
            raise ValueError(f"{fpath}: the writer writes mp4v, avc1/avc3 or hvc1/hev1, not {codec}")
        self.fpath = fpath
        self.size = (int(size[0]), int(size[1]))
        self.timescale, self.delta = frame_rate(fps)
        self.config = bytes(config)
        self.codec = codec
        self.edit = edit
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.sync: List[int] = []
        self.cts: List[int] = []
        self._f = open(fpath, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 16))

    def add_sample(self, data: bytes, sync: bool, offset: int = 0):
        self.offsets.append(self._f.tell())
        self.sizes.append(len(data))
        self.cts.append(int(offset) * self.delta)
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

    def _entry(self) -> bytes:
        w, h = self.size
        entry = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", w, h)
                 + struct.pack(">IIIH", 0x480000, 0x480000, 0, 1) + bytes(32)
                 + struct.pack(">Hh", 0x18, -1))
        if self.codec == "mp4v":
            esds = _fbox(b"esds", _descr(3, struct.pack(">HB", 1, 0) + _descr(
                4, struct.pack(">BB", 0x20, 0x11) + struct.pack(">I", max(self.sizes, default=0))[1:]
                + struct.pack(">II", 0, 0) + _descr(5, self.config)) + _descr(6, b"\x02")))
            return _box(b"mp4v", entry + esds)
        conf = b"avcC" if self.codec.startswith("avc") else b"hvcC"
        return _box(self.codec.encode(), entry + _box(conf, self.config))

    def _ctts(self) -> bytes:
        if not any(self.cts):
            return b""
        runs: List[List[int]] = []
        for c in self.cts:
            if runs and runs[-1][1] == c:
                runs[-1][0] += 1
            else:
                runs.append([1, c])
        signed = min(self.cts) < 0
        body = np.asarray(runs, ">i4" if signed else ">u4").tobytes()
        return _box(b"ctts", struct.pack(">I", 1 << 24 if signed else 0)
                    + struct.pack(">I", len(runs)) + body)

    def _moov(self) -> bytes:
        n = len(self.sizes)
        w, h = self.size
        media_t = n * self.delta
        shown = self.edit[1] * self.delta if self.edit else media_t
        movie_t = shown * 1000 // self.timescale
        mvhd = struct.pack(">IIII", 0, 0, 1000, movie_t) + struct.pack(">IH10x", 0x10000, 0x100) \
            + _MATRIX + bytes(24) + struct.pack(">I", 2)
        tkhd = struct.pack(">IIII", 0, 0, 1, 0) + struct.pack(">I8x", movie_t) \
            + struct.pack(">HHHH", 0, 0, 0, 0) + _MATRIX + struct.pack(">II", w << 16, h << 16)
        mdhd = struct.pack(">IIIIHH", 0, 0, self.timescale, media_t, 0x55C4, 0)  # 'und'
        hdlr = struct.pack(">I4s12x", 0, b"vide") + b"VideoHandler\x00"
        dinf = _box(b"dinf", _fbox(b"dref", struct.pack(">I", 1) + _fbox(b"url ", b"", flags=1)))
        large = bool(self.offsets) and max(self.offsets) > 0xFFFFFFFF
        offsets = np.asarray(self.offsets, ">u8" if large else ">u4").tobytes()
        stbl = _box(b"stbl", b"".join([
            _fbox(b"stsd", struct.pack(">I", 1) + self._entry()),
            _fbox(b"stts", struct.pack(">III", 1, n, self.delta)),  # the rate, even with no sample
            self._ctts(),
            _fbox(b"stss", struct.pack(">I", len(self.sync))
                  + np.asarray(self.sync, ">u4").tobytes()),
            _fbox(b"stsc", struct.pack(">IIII", 1, 1, 1, 1) if n else struct.pack(">I", 0)),
            _fbox(b"stsz", struct.pack(">II", 0, n) + np.asarray(self.sizes, ">u4").tobytes()),
            _fbox(b"co64" if large else b"stco", struct.pack(">I", n) + offsets),
        ]))
        minf = _box(b"minf", _fbox(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1) + dinf
                    + stbl)
        mdia = _box(b"mdia", _fbox(b"mdhd", mdhd) + _fbox(b"hdlr", hdlr) + minf)
        edts = b""
        if self.edit:
            edts = _box(b"edts", _fbox(b"elst", struct.pack(">IIiHH", 1, movie_t,
                                                            self.edit[0] * self.delta, 1, 0)))
        trak = _box(b"trak", _fbox(b"tkhd", tkhd, flags=3) + edts + mdia)
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
