"""The port's video metadata (acinoset_tpu_torch.utils.mp4, and
pipeline.app.get_vid_info on it) against cv2's, through the JAX
package's get_vid_info, on mp4v files that cv2 writes here; and the
box layouts cv2 does not write (64-bit sizes, co64, a GoPro-like file
whose first tracks are audio and metadata), built byte by byte."""
import json
import struct

import cv2
import numpy as np
import pytest

from acinoset_tpu.pipeline import app as japp
from acinoset_tpu_torch.pipeline import app as tapp
from acinoset_tpu_torch.utils import mp4

#: (width, height), fps, frames
VIDEOS = [((64, 48), 90.0, 12), ((80, 32), 119.88, 7)]


def _write_video(path, size, fps, n):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert vw.isOpened()
    for i in range(n):
        vw.write(np.full((size[1], size[0], 3), 10 * i, np.uint8))
    vw.release()


@pytest.mark.parametrize("size,fps,n", VIDEOS)
def test_get_vid_info_matches_jax_on_cv2_files(tmp_path, size, fps, n):
    for c in (1, 2):
        _write_video(tmp_path / f"cam{c}.mp4", size, fps, n)
    got, want = tapp.get_vid_info(str(tmp_path)), japp.get_vid_info(str(tmp_path))
    assert got[0] == tuple(want[0]) == size
    assert got[2] == want[2] == n
    assert abs(got[1] - want[1]) <= 1e-9 * want[1]
    assert abs(got[1] - fps) <= 1e-9 * fps
    assert got[3] == want[3] == sorted(str(tmp_path / f"cam{c}.mp4") for c in (1, 2))


def test_get_vid_info_sidecar_and_missing(tmp_path):
    info = {"resolution": [2704, 1520], "fps": 90.0, "tot_frames": 200}
    with open(tmp_path / "video_info.json", "w") as f:
        json.dump(info, f)
    got, want = tapp.get_vid_info(str(tmp_path)), japp.get_vid_info(str(tmp_path))
    assert got == want == ((2704, 1520), 90.0, 200, [])
    empty = tmp_path / "empty"
    empty.mkdir()
    for module in (tapp, japp):
        with pytest.raises(FileNotFoundError, match="No cam\\[1-9\\].mp4 or video_info.json"):
            module.get_vid_info(str(empty))


def _box(kind, payload, large=False):
    if large:
        return struct.pack(">I4sQ", 1, kind, 16 + len(payload)) + payload
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full(kind, payload, version=0, large=False):
    return _box(kind, struct.pack(">B3x", version) + payload, large)


def _track(handler, timescale, deltas, n_samples, size=(0, 0), entry=b"mp4v", version=0):
    """One trak: tkhd, mdia/mdhd, hdlr, minf/stbl with stsd, stts, stsz,
    co64; sizes from the sample entry and (as 16.16) the track header."""
    if version:
        tkhd = struct.pack(">QQI4xQ", 0, 0, 1, 0)
        mdhd = struct.pack(">QQIQ", 0, 0, timescale, 0) + bytes(4)
    else:
        tkhd = struct.pack(">III4xI", 0, 0, 1, 0)
        mdhd = struct.pack(">IIII", 0, 0, timescale, 0) + bytes(4)
    tkhd += bytes(52) + struct.pack(">II", size[0] << 16, size[1] << 16)
    sample = bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", *size) + bytes(50)
    stsd = _full(b"stsd", struct.pack(">I", 1) + _box(entry, sample))
    stts = _full(b"stts", struct.pack(">I", len(deltas)) + b"".join(
        struct.pack(">II", c, d) for c, d in deltas))
    stsz = _full(b"stsz", struct.pack(">II", 0, n_samples) + bytes(4 * n_samples))
    co64 = _full(b"co64", struct.pack(">IQ", 1, 1 << 33))
    stbl = _box(b"stbl", stsd + stts + stsz + co64)
    minf = _box(b"minf", stbl)
    hdlr = _full(b"hdlr", struct.pack(">I4s12x", 0, handler) + b"\x00")
    mdia = _box(b"mdia", _full(b"mdhd", mdhd, version) + hdlr + minf, large=True)
    return _box(b"trak", _full(b"tkhd", tkhd, version) + mdia)


def test_gopro_like_layout(tmp_path):
    """Audio and GPMF metadata tracks before the video track, a 64-bit
    mdia and mdat, version-1 headers, co64, and a two-entry stts
    (4 frames at 1001 and 116 at 1000 ticks of 120,000 a second)."""
    moov = _box(b"moov", _full(b"mvhd", bytes(96))
                + _track(b"soun", 48000, [(100, 1024)], 100)
                + _track(b"meta", 1000, [(10, 1000)], 10, entry=b"gpmd")
                + _track(b"vide", 120000, [(4, 1001), (116, 1000)], 120, (2704, 1520),
                         entry=b"avc1", version=1))
    data = _box(b"ftyp", b"mp41" + bytes(4)) + moov + _box(b"mdat", bytes(64), large=True)
    fp = tmp_path / "GOPR0001.mp4"
    fp.write_bytes(data)
    res, fps, n = mp4.video_info(str(fp))
    assert res == (2704, 1520) and n == 120
    assert fps == 120 * 120000 / (4 * 1001 + 116 * 1000)


def test_size_from_the_track_header_when_the_sample_entry_has_none(tmp_path):
    moov = _box(b"moov", _track(b"vide", 90, [(3, 1)], 3, (0, 0)))
    fp = tmp_path / "a.mp4"
    fp.write_bytes(moov)
    assert mp4.video_info(str(fp)) == ((0, 0), 90.0, 3)
    # the track header's 16.16 size answers when the sample entry's is zero
    trak = _track(b"vide", 90, [(3, 1)], 3, (0, 0))
    i = trak.index(b"tkhd") + 4 + 4 + 20 + 52
    trak = trak[:i] + struct.pack(">II", 1920 << 16, 1080 << 16) + trak[i + 8:]
    fp.write_bytes(_box(b"moov", trak))
    assert mp4.video_info(str(fp)) == ((1920, 1080), 90.0, 3)


@pytest.mark.parametrize("data,match", [
    (_box(b"moov", _track(b"soun", 48000, [(10, 1024)], 10)), "no video track"),
    (_box(b"ftyp", b"isom"), "no moov box"),
    (struct.pack(">I4s", 4096, b"moov") + bytes(8), "overruns"),
])
def test_files_without_a_video_track_raise_naming_the_file(tmp_path, data, match):
    fp = tmp_path / "bad.mp4"
    fp.write_bytes(data)
    with pytest.raises(mp4.MP4FormatError, match=match) as err:
        mp4.video_info(str(fp))
    assert str(fp) in str(err.value)


def test_only_the_moov_box_is_read(tmp_path, monkeypatch):
    """A GoPro-like file whose 64 MiB mdat comes before its moov (and a
    second, 32-bit mdat after it): video_info and read_video_track walk
    the top-level boxes with seeks and read the moov and the box headers
    only, whatever the mdat holds."""
    moov = _box(b"moov", _full(b"mvhd", bytes(96))
                + _track(b"vide", 120000, [(4, 1001), (116, 1000)], 120, (2704, 1520),
                         entry=b"avc1", version=1))
    fp = tmp_path / "GX010001.MP4"
    big = 64 << 20
    with open(fp, "wb") as f:
        f.write(_box(b"ftyp", b"mp41" + bytes(4)))
        f.write(struct.pack(">I4sQ", 1, b"mdat", 16 + big))
        f.seek(big, 1)
        f.write(moov + _box(b"mdat", bytes(4096)))
    size = fp.stat().st_size
    reads = []
    real_open = open

    class Counting:
        def __init__(self, f):
            self.f = f

        def read(self, n=-1):
            data = self.f.read(n)
            reads.append(len(data))
            return data

        def __getattr__(self, name):
            return getattr(self.f, name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

    monkeypatch.setattr(mp4, "open", lambda *a, **k: Counting(real_open(*a, **k)),
                        raising=False)
    assert mp4.video_info(str(fp)) == ((2704, 1520), 120 * 120000 / (4 * 1001 + 116 * 1000), 120)
    assert sum(reads) <= len(moov) + 4 * 16 < size // 1000
    reads.clear()
    track = mp4.read_video_track(str(fp))
    assert (track.codec, track.n_samples, track.size) == ("avc1", 120, (2704, 1520))
    assert sum(reads) <= len(moov) + 4 * 16
