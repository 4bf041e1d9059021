"""The port's reading of 10-bit HEVC (Main 10: utils/csrc/hevc.cpp at
BitDepth 10, utils/nvdec.py's 10-bit conversion) against cv2 (ffmpeg and
its swscale) and the JAX package, on the CPU:

- the plain 10-bit 4:2:0 -> BGR conversion (nvdec.yuv420p10_to_bgr_plain)
  equals cv2's on hand-written C420p10 .y4m frames bit for bit: random
  planes at 2704 x 1520, 1920 x 1080 (both ranges), a width not a
  multiple of 8 with an odd chroma height, the shortest frames swscale
  filters so (10 and 12 rows), impulses, ramps and flat planes;
- streams of utils.h26x.RandomHEVC(bit_depth=10) decode to cv2's frames
  bit for bit (I, P and B pictures with TMVP, explicit weights, SAO's
  offsets to 31, deblocking override, PCM of 10 and fewer bits,
  transquant bypass, scaling lists, negative QPs with chroma QP offsets,
  a cropped size, BT.601, BT.709 and BT.2020 in both ranges, and every
  chroma siting the VUI names);
- the port's get_frames and extract_frame_range equal the JAX package's
  on a 10-bit file;
- chip_smoke.py's Main 10 streams have the MP4 and frame SHA-256 it holds
  the card's decode to, as cv2 reads them;
- what stays refused is named: a frame of fewer than 10 rows, and NVDEC.

Every stream and frame is written in the test from a seed.
"""
import hashlib
import tempfile

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import h26x, hevc, mpeg4, nvdec

torch.set_num_threads(2)

#: y4m frames have no chroma siting: swscale centres their chroma
Y4M_SITING = (128, 128)


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def write_y4m(path, frames, full=False):
    """frames of (Y, Cb, Cr) planes of 10-bit samples, as C420p10 (16-bit
    little-endian)."""
    H, W = frames[0][0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420p10"
                f"{' XCOLORRANGE=FULL' if full else ''}\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(np.ascontiguousarray(p, "<u2").tobytes())


def surface(y, u, v):
    """The planes as the decoder's 16-bit NV12 surface."""
    H, W = y.shape
    uv = np.zeros((u.shape[0], W), np.int16)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return torch.from_numpy(np.concatenate([y.astype(np.int16), uv]))


def random_planes(rng, W, H):
    ch = (H + 1) // 2
    return (rng.integers(0, 1024, (H, W)), rng.integers(0, 1024, (ch, W // 2)),
            rng.integers(0, 1024, (ch, W // 2)))


def patterns(W, H):
    """Chroma impulses (one row, one column), ramps and flat planes."""
    ch = H // 2
    out = []
    for j in range(3):
        u = np.full((ch, W // 2), 512)
        v = u.copy()
        u[3 * j + 1] = 1023
        v[:, 5 * j] = 0
        out.append((np.full((H, W), 400 + 100 * j), u, v))
    ramp = np.arange(ch)[:, None] * 37 + np.arange(W // 2)[None, :] * 11
    out.append((np.arange(W * H).reshape(H, W) % 1024, ramp % 1024, 1023 - ramp % 1024))
    for val in (0, 64, 102, 940, 1023):
        out.append((np.full((H, W), val), np.full((ch, W // 2), val),
                    np.full((ch, W // 2), 1023 - val)))
    return out


Y4M_CASES = {
    "random 2704x1520": (2704, 1520, False, 1),
    "random 1920x1080 full range": (1920, 1080, True, 1),
    "random 1922x1078 (odd chroma height)": (1922, 1078, False, 1),
    "random 66x10 (the shortest)": (66, 10, False, 2),
    "random 130x12 full range": (130, 12, True, 2),
    "impulses, ramps, flat 98x32": (98, 32, False, 0),
}


@pytest.mark.parametrize("case", sorted(Y4M_CASES))
def test_plain_conversion_equals_cv2_on_y4m(tmp_path, case):
    W, H, full, n = Y4M_CASES[case]
    rng = np.random.default_rng(W + H)
    frames = [random_planes(rng, W, H) for _ in range(n)] or patterns(W, H)
    path = str(tmp_path / "a.y4m")
    write_y4m(path, frames, full)
    want = cv2_frames(path)
    assert len(want) == len(frames)
    coefs = nvdec.colour_coefs10(2, full)  # y4m signals no matrix: BT.601
    for k, (planes, a) in enumerate(zip(frames, want)):
        got = nvdec.yuv420p10_to_bgr(surface(*planes), H, (W, H), coefs, siting=Y4M_SITING)
        np.testing.assert_array_equal(got.numpy(), a, err_msg=f"{case}, frame {k}")


#: (size, frames, the writer's options) of each 10-bit case
CASES = {
    "i_only": ((96, 80), 3, dict(intra_only=True, ctb=16)),
    "p_b_tmvp": ((96, 80), 7, dict(b_frames=3)),
    "explicit_weights": ((96, 80), 5, dict(weighted=True, b_frames=1)),
    "sao_deblocking_override": ((176, 144), 4, dict(deblock="override", slices=3, sao=True)),
    "pcm_bypass": ((96, 80), 4, dict(bypass=True, pcm=True, pcm_loop_filter=False, sao=True)),
    "scaling_transform_skip": ((96, 80), 4, dict(scaling="sps", ctb=64, transform_skip=True)),
    "cu_qp_delta_negative_qp": ((96, 80), 5, dict(cu_qp_delta=True, qp_depth=2, qp=(-12, 20),
                                                  chroma_qp_offsets=(-4, 5),
                                                  slice_chroma_offsets=True)),
    "cropped_168x132_wpp": ((168, 132), 3, dict(ctb=64, wpp=True, cabac_init=True,
                                                vui_extra=True)),
    "bt601_limited": ((64, 48), 2, dict(matrix=h26x.BT601, full_range=False, chroma_loc=1)),
    "bt601_full": ((64, 48), 2, dict(matrix=h26x.BT601, full_range=True, chroma_loc=2)),
    "bt709_limited": ((64, 48), 2, dict(matrix=h26x.BT709, full_range=False, chroma_loc=3)),
    "bt709_full": ((64, 48), 2, dict(matrix=h26x.BT709, full_range=True, chroma_loc=4)),
    "bt2020_limited": ((64, 48), 2, dict(matrix=h26x.BT2020, full_range=False, chroma_loc=5)),
    "bt2020_full": ((64, 48), 2, dict(matrix=h26x.BT2020, full_range=True, chroma_loc=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_random_syntax_decodes_as_cv2_bit_for_bit(tmp_path, case):
    size, n, opts = CASES[case]
    stream = h26x.RandomHEVC(size, n, seed=sum(map(ord, case)), bit_depth=10, **opts)
    assert stream.profile == 2
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, codec="hev1" if n % 2 else "hvc1")
    want = cv2_frames(path)
    with tvideo.open_video(path, device="cpu") as r:
        assert isinstance(r, hevc.Reader) and r.info["bit_depth"] == 10
        got = [r.read(k) for k in range(r.n_frames)]
    assert len(want) == len(got) == len(stream.shown)
    for k, (a, b) in enumerate(zip(want, got)):
        assert b.shape == a.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    assert len({f.tobytes() for f in got}) == len(got)  # no two frames alike: an order error shows


def test_the_writer_writes_main10():
    """bit_depth=10 writes a Main 10 SPS of 10 bits for both components
    (the decoder reads it so), other pictures than the 8-bit stream of the
    same seed."""
    stream = h26x.RandomHEVC((96, 80), 2, seed=3, bit_depth=10, pcm=True, intra_only=True)
    dec = hevc.Decoder()
    try:
        for s in stream.param_sets:
            dec.decode(s, 0, None)
        info = dec.info()
    finally:
        dec.close()
    assert info["bit_depth"] == 10
    eight = h26x.RandomHEVC((96, 80), 2, seed=3, pcm=True, intra_only=True)
    assert eight.profile == 1 and stream.profile == 2 and eight.pictures != stream.pictures


def test_get_frames_and_extract_frame_range_equal_the_jax_package(tmp_path):
    """The JAX package reads through cv2; the port through its software
    decoder and the 10-bit conversion: the same frames and PNGs."""
    stream = h26x.RandomHEVC((96, 80), 10, seed=7, gop=5, b_frames=2, sao=True, open_gop=True,
                             bit_depth=10, matrix=h26x.BT2020, full_range=False)
    assert stream.shown == list(range(stream.n))
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 119.88)
    seeks = [7, 2, 9, 0, 4, 4, 10]
    theirs = jvideo.get_frames(path, seeks)
    ours = tvideo.get_frames(path, seeks, out_dir=str(tmp_path / "f"), device="cpu")
    assert [i for i, _f in ours] == [i for i, _f in theirs] == seeks[:-1]
    for (_i, a), (_j, b) in zip(theirs, ours):
        np.testing.assert_array_equal(b, a)
    got = tvideo.extract_frame_range(path, 3, 8, str(tmp_path / "g"), device="cpu")
    want = jvideo.get_frames(path, range(3, 8))
    assert [i for i, _f in got] == list(range(3, 8))
    for (_i, a), (_j, b) in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert sorted(p.name for p in (tmp_path / "g").iterdir()) == sorted(f"{i}.png" for i in range(3, 8))


def test_chip_smoke_main10_streams_have_the_digests_cv2_gives():
    """chip_smoke.phase_hevc holds the card's decode of its Main 10
    streams to HEVC_DIGESTS: the streams written here are those bytes, and
    cv2 reads them to those frames."""
    labels = []
    for label, stream in chip_smoke.hevc_streams(bit_depth=10):
        labels.append(label)
        assert stream.profile == 2
        with tempfile.TemporaryDirectory() as root:
            path = h26x.write_mp4(f"{root}/a.mp4", stream, chip_smoke.NVDEC_FPS)
            with open(path, "rb") as f:
                file_sha = hashlib.sha256(f.read()).hexdigest()
            frames = cv2_frames(path)
        want_file, want_frames = chip_smoke.HEVC_DIGESTS[label]
        assert file_sha == want_file, label
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == list(want_frames), label
    assert labels == ["main10 tiles 2704x1520", "main10 wpp 1920x1080"]


def test_what_stays_refused_is_named(tmp_path):
    """A 10-bit frame of 8 rows (swscale converts it with other code) and
    decoder='nvdec' on the CPU raise UnsupportedVideo naming them; nothing
    falls back."""
    short = h26x.write_mp4(str(tmp_path / "short.mp4"), h26x.RandomHEVC(
        (64, 8), 1, seed=1, intra_only=True, bit_depth=10), 30.0)
    with pytest.raises(mpeg4.UnsupportedVideo, match="fewer than 10 rows"):
        tvideo.open_video(short, device="cpu")
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), h26x.RandomHEVC(
        (64, 48), 1, seed=1, intra_only=True, bit_depth=10), 30.0)
    with pytest.raises(mpeg4.UnsupportedVideo, match="NVDEC"):
        tvideo.open_video(path, device="cpu", decoder="nvdec")
    with pytest.raises(ValueError, match="int16"):
        nvdec.yuv420p10_to_bgr(torch.zeros((24, 64), dtype=torch.uint8), 16, (64, 16),
                               nvdec.colour_coefs10(1, False))


def test_the_writer_keeps_clear_of_ffmpegs_chroma_qp_clip():
    """ffmpeg's deblocking clips the chroma's QP at 57 where the standard
    does not (csrc/hevc.cpp's notes): the writer refuses QPs and chroma QP
    offsets that sum above it, at either depth."""
    for depth in (8, 10):
        with pytest.raises(ValueError, match="above 57"):
            h26x.RandomHEVC((64, 48), 1, bit_depth=depth, qp=(30, 50), chroma_qp_offsets=(0, 8))
