"""GoPro-shaped H.264 on the CPU (acinoset_tpu_torch.utils.h26x's
writer, utils.mp4's avcC/ctts/elst reading, utils.nvdec's plain colour
conversion and its refusals) against cv2 (ffmpeg) and the JAX package:

- cv2 decodes the writer's streams (I_PCM IDRs, P_Skip and B_Skip
  frames around moving I_PCM patches, frame cropping, the four VUI
  (matrix, range) pairs and none) to the writer's reconstruction in cv2's
  colours, bit for bit, in presentation order;
- the container's presentation order (ctts versions 0 and 1, edit lists
  that show a window of the frames) and frame count are cv2's;
- the JAX package's get_frames and get_vid_info on those files equal
  the reconstruction and the port's get_vid_info;
- the plain NV12 -> BGR conversion equals cv2 over every (U, V) pair and
  every Y in all four cases;
- device='cpu' with decoder='nvdec' raises UnsupportedVideo naming NVDEC,
  before any output.

The card's half is tests/test_torch_nvdec_cuda.py. Every stream is made
in the test from a seed.
"""
import os

import cv2
import numpy as np
import pytest
import torch

from acinoset_tpu.pipeline import app as japp
from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.pipeline import app as tapp
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import h26x, mp4, mpeg4, nvdec
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

FAMILY = {h26x.BT709: "BT.709", h26x.BT601: "BT.601", 5: "BT.601", None: "BT.601"}


def expected(stream, k):
    """Frame k as cv2 shows it: the reconstruction through the plain
    conversion with the stream's colour constants."""
    coefs = mpeg4.BGR_COEFS[(FAMILY[stream.matrix],
                             stream.full_range if stream.matrix is not None else False)]
    surface = torch.from_numpy(stream.nv12(k))
    return nvdec.nv12_to_bgr(surface, stream.coded[1], stream.size, coefs).numpy()


def cv2_read(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out, cap
        out.append(f)


@pytest.mark.parametrize("size,matrix,full,entry", [
    ((176, 144), h26x.BT709, True, "avc1"),
    ((176, 136), h26x.BT601, False, "avc3"),  # 136 of 144 coded lines
    ((320, 184), h26x.BT709, False, "avc1"),
    ((320, 184), h26x.BT601, True, "avc3"),
    ((192, 112), None, False, "avc1"),  # no colour description: BT.601 limited
])
def test_cv2_decodes_the_writer_stream_bit_for_bit(tmp_path, size, matrix, full, entry):
    """Two GOPs (I B B P B B P B B P P P, then I P): every frame equal to
    the reconstruction, in presentation order, at the display size."""
    stream = h26x.H264Stream(size, 14, gop=12, seed=size[0] + size[1], matrix=matrix,
                             full_range=full)
    assert "".join(stream.types) == "IBBPBBPBBPPPIP"
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 90.0, codec=entry)
    frames, cap = cv2_read(path)
    assert len(frames) == stream.n == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == size
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(f, expected(stream, k), err_msg=f"frame {k}")
    # no two frames alike: an order error shows
    assert len({f.tobytes() for f in frames}) == stream.n


@pytest.mark.parametrize("kw", [dict(), dict(signed_ctts=True), dict(edit=(1 + 3, 9)),
                                dict(edit=(1, 20))])
def test_container_order_and_count_are_cv2s(tmp_path, kw):
    """ctts version 0 with the muxers' one-frame edit, version 1 without
    an edit, an edit that shows frames 3..11, one longer than the stream:
    the track's presentation order is cv2's sequence, cv2's seeks land on
    its frames, and video_info's count and rate are cv2's (the sample
    count, whatever the edit shows)."""
    stream = h26x.H264Stream((176, 144), 14, gop=12, seed=3)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, **kw)
    track = mp4.read_video_track(path)
    shown = [stream.decode[i] for i in track.order]
    frames, cap = cv2_read(path)
    assert len(frames) == track.n_frames == len(shown)
    for f, k in zip(frames, shown):
        np.testing.assert_array_equal(f, expected(stream, k))
    res, fps, n = mp4.video_info(path)
    assert (res, fps, n) == ((int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                              int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))),
                             cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    assert list(track.param_sets) == stream.param_sets and track.length_size == 4
    for idx in (5, 1, len(shown) - 1, 0):
        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, f = cap.read()
        assert ok
        np.testing.assert_array_equal(f, expected(stream, shown[idx]))


def test_jax_get_frames_and_get_vid_info_on_h264(tmp_path):
    """A run directory whose cam1.mp4 is the writer's H.264: the JAX
    package's get_frames (cv2 seeks, an index past the end skipped)
    gives the reconstruction, and its get_vid_info the port's."""
    run = tmp_path / "run"
    run.mkdir()
    stream = h26x.H264Stream((176, 136), 26, gop=12, seed=9, matrix=h26x.BT709, full_range=True)
    path = h26x.write_mp4(str(run / "cam1.mp4"), stream, 119.88)
    seeks = [20, 3, 13, 0, 25, 11, 26]
    got = jvideo.get_frames(path, seeks)
    assert [i for i, _f in got] == seeks[:-1]
    for i, f in got:
        np.testing.assert_array_equal(f, expected(stream, i))
    theirs = japp.get_vid_info(str(run))
    ours = tapp.get_vid_info(str(run))
    assert ours[0] == theirs[0] == (176, 136) and ours[2] == theirs[2] == 26
    assert ours[1] == pytest.approx(theirs[1], rel=1e-12) and ours[3] == theirs[3]


@pytest.mark.parametrize("family,full", [("BT.601", False), ("BT.709", False),
                                         ("BT.601", True), ("BT.709", True),
                                         ("BT.2020", False), ("BT.2020", True)])
def test_plain_conversion_equals_cv2_over_every_uv_pair(tmp_path, family, full):
    """One 512 x 512 I_PCM frame whose chroma holds every (U, V) pair and
    whose luma every Y beside each: cv2's BGR equals the plain
    conversion's on all 786,432 values."""
    matrix = {"BT.601": h26x.BT601, "BT.709": h26x.BT709, "BT.2020": h26x.BT2020}[family]

    class Exhaustive(h26x.H264Stream):
        def planes(self, k):
            u, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
            y = (3 * np.arange(512)[:, None] + np.arange(512)[None, :]) % 256
            return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)

    stream = Exhaustive((512, 512), 1, matrix=matrix, full_range=full)
    path = h26x.write_mp4(str(tmp_path / "uv.mp4"), stream, 30.0)
    frames, _cap = cv2_read(path)
    surface = torch.from_numpy(stream.nv12(0))
    ours = nvdec.nv12_to_bgr(surface, 512, (512, 512), mpeg4.BGR_COEFS[(family, full)]).numpy()
    assert ours.size == 786_432
    np.testing.assert_array_equal(frames[0], ours)


def test_plain_conversion_reads_a_pitched_surface_at_its_origin():
    """The rectangle (W, H) at (left, top) of a surface whose rows are
    wider than the frame, chroma from row surface_height: the same as the
    planes cut out and converted."""
    rng = np.random.default_rng(0)
    rows, pitch, sh = 3 * 72 // 2, 128, 72
    surf = torch.from_numpy(rng.integers(0, 256, (rows, pitch), dtype=np.uint8))
    coefs = mpeg4.BGR_COEFS[("BT.709", True)]
    got = nvdec.nv12_to_bgr(surf, sh, (64, 40), coefs, origin=(8, 6))
    y = surf[6:46, 8:72]
    uv = surf[sh + 3:sh + 23, 8:72]
    want = mpeg4.yuv420_to_bgr(y, uv[:, 0::2], uv[:, 1::2], (64, 40), coefs)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not fit"):
        nvdec.nv12_to_bgr(surf, sh, (128, 40), coefs, origin=(8, 6))


def test_cpu_device_raises_naming_nvdec(tmp_path):
    """Asked for NVDEC, every reading function refuses an H.264 file on
    the CPU before it writes anything (nothing falls back to the software
    decoder)."""
    stream = h26x.H264Stream((64, 48), 4, seed=1)
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 30.0)
    tdata.save_dlc_points_h5(str(tmp_path / "labels_cam1.h5"), np.zeros((4, 20, 2)),
                             np.ones((4, 20)), tsyn.cheetah.get_markers())
    reason = ("H.264: NVDEC decodes it on the card only, not on cpu (decoder='software' reads "
              "it on the host)")
    for call in (lambda: nvdec.Reader(path, device="cpu"),
                 lambda: tvideo.open_video(path, device="cpu", decoder="nvdec"),
                 lambda: tvideo.get_frames(path, [0], out_dir=str(tmp_path / "f"), device="cpu",
                                           decoder="nvdec"),
                 lambda: tvideo.extract_frame_range(path, 0, 2, str(tmp_path / "g"),
                                                    device="cpu", decoder="nvdec"),
                 lambda: tvideo.create_labeled_videos([path], str(tmp_path), device="cpu",
                                                      decoder="nvdec")):
        with pytest.raises(mpeg4.UnsupportedVideo) as err:
            call()
        assert err.value.reason == reason and "NVDEC" in str(err.value)
    assert sorted(os.listdir(tmp_path)) == ["cam1.mp4", "labels_cam1.h5"]


@pytest.mark.parametrize("given,withheld", [(None, False), ("compute,utility", True),
                                            ("compute,video,utility", False), ("all", False),
                                            ("compute, video", False)])
def test_refusal_gives_the_drivers_error_and_the_capability_only_where_withheld(
        monkeypatch, given, withheld):
    """nvdec.refusal carries cuvidGetDecoderCaps' own error; the missing
    capability is named only where NVIDIA_DRIVER_CAPABILITIES withholds
    'video' (which is where the decode gates may skip)."""
    if given is None:
        monkeypatch.delenv("NVIDIA_DRIVER_CAPABILITIES", raising=False)
    else:
        monkeypatch.setenv("NVIDIA_DRIVER_CAPABILITIES", given)
    error = "cuvidGetDecoderCaps failed: CUDA_ERROR_INVALID_VALUE (1)"
    monkeypatch.setattr(nvdec, "caps", lambda device, codec: (None, error))
    why = nvdec.refusal("cuda:0", "avc1", (2704, 1520))
    assert why.startswith("H.264: NVDEC cannot be used on cuda:0 (" + error)
    assert (nvdec.withheld() is not None) == withheld
    assert ("capability 'video'" in why) == withheld


def test_formats_the_nvdec_path_refuses_are_named():
    base = dict(chroma_format=1, luma_minus8=0, chroma_minus8=0, progressive=1, matrix=1)
    assert nvdec.format_reason(base) is None
    assert nvdec.format_reason({**base, "matrix": 2}) is None  # unspecified: BT.601
    assert nvdec.format_reason({**base, "matrix": 9}) is None  # BT.2020
    cases = {("chroma_format", 2): "4:2:2", ("chroma_format", 3): "4:4:4",
             ("luma_minus8", 2): "10-bit video (P016)", ("progressive", 0): "interlaced",
             ("matrix", 10): "BT.2020 (constant luminance)"}
    for (key, value), name in cases.items():
        why = nvdec.format_reason({**base, key: value})
        assert why is not None and name in why
    assert nvdec.colour_coefs(6, True) == mpeg4.BGR_COEFS[("BT.601", True)]
    assert nvdec.colour_coefs(9, True) == mpeg4.BGR_COEFS[("BT.2020", True)]
    with pytest.raises(KeyError):
        nvdec.colour_coefs(10, False)


def test_escape_and_nal_units_round_trip():
    """Emulation prevention against a byte-by-byte reference on runs of
    zeros and small bytes, and a length-prefixed sample split back into
    its NAL units and put in start-code form."""
    rng = np.random.default_rng(4)

    def reference(b):
        out, zeros = bytearray(), 0
        for x in b:
            if zeros == 2 and x <= 3:
                out.append(3)
                zeros = 0
            out.append(x)
            zeros = zeros + 1 if x == 0 else 0
        return bytes(out)

    for trial in range(200):
        n = int(rng.integers(1, 64))
        b = rng.choice([0, 0, 0, 1, 2, 3, 4, 255], size=n).astype(np.uint8)
        b[-1] = 0x80  # as every payload the writers escape ends
        assert h26x.escape(b) == reference(b.tobytes()), (trial, b.tolist())
    nals = [b"\x67abc", b"\x68\x00\x01", b"\x65" + bytes(300)]
    sample = b"".join(len(n).to_bytes(4, "big") + n for n in nals)
    assert h26x.nal_units(sample) == nals
    assert h26x.annexb(nals) == b"".join(b"\x00\x00\x00\x01" + n for n in nals)
    with pytest.raises(ValueError, match="overruns"):
        h26x.nal_units(sample[:-1])
