"""Video metadata from an MP4/MOV file's boxes, without decoding a frame
(what ``cv2.VideoCapture`` reports as CAP_PROP_FRAME_WIDTH/HEIGHT, FPS
and FRAME_COUNT).

It walks ``moov/trak`` to the track whose ``hdlr`` is ``vide`` (GoPro
files also carry audio and GPMF metadata tracks) and reads:

- the width and height from the visual sample entry in ``stsd`` (the
  coded size), else from ``tkhd`` (16.16 fixed point);
- the frame count from ``stsz``'s sample count;
- the frame rate as ``mdhd``'s timescale times the sample count over the
  total duration of ``stts`` (timescale / delta for a constant rate).

64-bit box sizes (``size == 1``), boxes running to the end of the file
(``size == 0``) and ``co64`` chunk offsets (never needed: no sample is
read) are handled. A file with no video track raises, naming the file.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

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
    top = _tree(buf, 0, len(buf), fpath)
    if b"moov" not in top:
        raise MP4FormatError(f"{fpath}: no moov box (not an MP4/MOV file?)")
    for _s, _e, trak in top[b"moov"][0][2].get(b"trak", []):
        hs, _he, _ = _one(trak, "mdia/hdlr", fpath)
        if buf[hs + 8:hs + 12] == b"vide":
            return _track_info(buf, trak, fpath)
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
    count = duration = 0
    for i in range(n_entries):
        c, d = struct.unpack(">II", buf[q + 4 + 8 * i:q + 12 + 8 * i])
        count += c
        duration += c * d
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
