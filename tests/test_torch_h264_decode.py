"""The port's software H.264 decoder (acinoset_tpu_torch.utils.h264,
utils/csrc/h264.cpp) against cv2 (ffmpeg) and the JAX package, on the
CPU:

- streams of utils.h26x's random-syntax writer, which drives the
  decoder's own syntax code with every element picked from a seed, decode
  to cv2's frames bit for bit in uint8 (CAVLC and CABAC; I, P and B; both
  direct modes; default, explicit and implicit weights; the 8x8 transform
  with scaling lists; several slices with each deblocking mode and
  offsets; MMCO with long-term references; frame_num gaps; frame_num and
  POC lsb wrapping; POC types 0, 1 and 2; cropping; the VUI's timing and
  HRD; BT.601 and BT.709 in both ranges);
- the port's get_frames and extract_frame_range equal the JAX package's
  on the same file, and seeks equal the sequential decode;
- H264Stream decodes to its known reconstruction;
- each feature the decoder does not take raises UnsupportedVideo naming
  it, and open_video picks the decoder by its fixed table;
- chip_smoke.py's full-width streams and their frames have the SHA-256
  it holds the card's decode to, as cv2 reads them.

Every stream is written in the test from a seed.
"""
import hashlib

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import h26x, h264, hevc, mp4, mpeg4, nvdec

torch.set_num_threads(2)

#: (size, frames, the writer's options) of each case
CASES = {
    "cavlc_i_only": ((96, 80), 4, dict(intra_only=True)),
    "cabac_i_only": ((96, 80), 4, dict(intra_only=True, cabac=True)),
    "cavlc_p_refs": ((112, 64), 6, dict(b_frames=0, refs=4)),
    "cabac_p_refs": ((112, 64), 6, dict(b_frames=0, refs=4, cabac=True)),
    "cavlc_b_spatial": ((96, 80), 7, dict(b_frames=2, direct="spatial")),
    "cabac_b_spatial": ((96, 80), 7, dict(b_frames=2, direct="spatial", cabac=True)),
    "cavlc_b_temporal": ((96, 80), 7, dict(b_frames=2, direct="temporal", direct_8x8=False)),
    "cabac_b_temporal": ((96, 80), 7, dict(b_frames=2, direct="temporal", cabac=True, refs=4)),
    "cavlc_explicit_weights": ((96, 80), 7, dict(weighted="explicit", direct="both")),
    "cabac_explicit_weights": ((96, 80), 7, dict(weighted="explicit", cabac=True)),
    "cavlc_implicit_weights": ((96, 80), 7, dict(weighted="implicit", b_refs=True)),
    "cabac_implicit_weights": ((96, 80), 7, dict(weighted="implicit", cabac=True)),
    "cavlc_8x8_scaling": ((96, 80), 5, dict(transform8x8=True, scaling=True)),
    "cabac_8x8_scaling": ((96, 80), 5, dict(transform8x8=True, scaling=True, cabac=True)),
    "cavlc_slices_deblocking": ((176, 144), 4, dict(slices=5, deblock=(0, 1, 2),
                                                    deblock_offsets=True)),
    "cabac_slices_deblocking": ((176, 144), 4, dict(slices=5, deblock=(0, 1, 2),
                                                    deblock_offsets=True, cabac=True)),
    "cavlc_mmco_long_term": ((64, 48), 10, dict(mmco=True, long_term=True, refs=4, b_frames=1,
                                                mmco5=True)),
    "cabac_mmco_long_term": ((64, 48), 10, dict(mmco=True, long_term=True, refs=3, cabac=True,
                                                b_refs=True)),
    "poc_type_1": ((96, 80), 7, dict(poc_type=1, cabac=True)),
    "poc_type_2": ((96, 80), 7, dict(poc_type=2, b_frames=1)),
    "cropped_136_of_144": ((176, 136), 5, dict(cabac=True, transform8x8=True)),
    "bt601_limited": ((64, 48), 3, dict(matrix=h26x.BT601, full_range=False)),
    "bt601_full": ((64, 48), 3, dict(matrix=h26x.BT601, full_range=True)),
    "bt709_limited": ((64, 48), 3, dict(matrix=h26x.BT709, full_range=False)),
    "bt709_full": ((64, 48), 3, dict(matrix=h26x.BT709, full_range=True, cabac=True)),
    "cavlc_frame_num_gaps": ((64, 48), 16, dict(gaps=True, b_frames=0, refs=4, gop=16)),
    "cabac_frame_num_gaps_mmco": ((64, 48), 16, dict(gaps=True, b_frames=0, refs=5, gop=16,
                                                     mmco=True, long_term=True, cabac=True)),
    "frame_num_and_poc_lsb_wrap": ((64, 48), 40, dict(gop=40, log2_max_frame_num=4,
                                                      log2_max_poc_lsb=5, b_frames=2)),
    "vui_timing_hrd": ((64, 48), 4, dict(vui_extra=True)),
    "constrained_intra_chroma_offsets": ((96, 80), 5, dict(constrained_intra=True,
                                                           intra_percent=40,
                                                           chroma_qp_offsets=(-3, 5),
                                                           transform8x8=True)),
}


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def port_frames(path, **kw):
    with h264.Reader(path, device="cpu", **kw) as r:
        return [r.read(k) for k in range(r.n_frames)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_random_syntax_decodes_as_cv2_bit_for_bit(tmp_path, case):
    size, n, opts = CASES[case]
    stream = h26x.RandomH264(size, n, seed=sum(map(ord, case)), **opts)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0)
    want = cv2_frames(path)
    got = port_frames(path)
    assert len(want) == len(got) == n
    for k, (a, b) in enumerate(zip(want, got)):
        assert b.shape == a.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    assert len({f.tobytes() for f in got}) == n  # no two frames alike: an order error shows


def test_get_frames_and_extract_frame_range_equal_the_jax_package(tmp_path):
    """The JAX package reads through cv2; the port through its software
    decoder: the same frames, the same indices skipped, the same PNGs."""
    stream = h26x.RandomH264((96, 80), 14, seed=5, cabac=True, gop=6)
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 119.88)
    seeks = [9, 2, 13, 0, 5, 5, 11, 14]
    theirs = jvideo.get_frames(path, seeks)
    ours = tvideo.get_frames(path, seeks, out_dir=str(tmp_path / "f"), device="cpu")
    assert [i for i, _f in ours] == [i for i, _f in theirs] == seeks[:-1]
    for (_i, a), (_j, b) in zip(theirs, ours):
        np.testing.assert_array_equal(b, a)
    got = tvideo.extract_frame_range(path, 3, 9, str(tmp_path / "g"), device="cpu")
    want = jvideo.get_frames(path, range(3, 9))
    assert [i for i, _f in got] == list(range(3, 9))
    for (_i, a), (_j, b) in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert sorted(p.name for p in (tmp_path / "g").iterdir()) == sorted(f"{i}.png" for i in range(3, 9))


def test_seeks_equal_the_sequential_decode(tmp_path):
    """Any index restarts at the last IDR at or before it; reading on is
    sequential; an index past the end reads as None."""
    stream = h26x.RandomH264((64, 48), 20, seed=6, gop=7, b_frames=2, b_refs=True)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, codec="avc3")
    seq = port_frames(path)
    with h264.Reader(path, device="cpu") as r:
        for k in (12, 3, 19, 4, 5, 13, 0, 6, 6, 18):
            np.testing.assert_array_equal(r.read(k), seq[k], err_msg=f"frame {k}")
        assert r.read(20) is None and r.read(-1) is None


def test_h264stream_decodes_to_its_reconstruction(tmp_path):
    """The writer of known reconstruction (I_PCM, P_Skip and B_Skip with
    spatial direct, cropping, the VUI's colours)."""
    stream = h26x.H264Stream((176, 136), 14, gop=12, seed=2, matrix=h26x.BT601, full_range=False)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 90.0)
    coefs = nvdec.colour_coefs(stream.matrix, stream.full_range)
    got = port_frames(path)
    assert len(got) == stream.n
    for k, f in enumerate(got):
        want = nvdec.nv12_to_bgr_plain(stream.surface(k, "cpu"), stream.coded[1], stream.size,
                                       coefs).numpy()
        np.testing.assert_array_equal(f, want, err_msg=f"frame {k}")


def _sps(profile=100, chroma=1, depth=8, bypass=0, frame_mbs_only=1):
    """A 32 x 32 SPS with the fields that the decoder checks."""
    b = h26x.Bits().u(profile, 8).u(0, 8).u(40, 8).ue(0)
    if profile in (100, 110, 122, 244):
        b.ue(chroma)
        if chroma == 3:
            b.u(0, 1)
        b.ue(depth - 8).ue(depth - 8).u(bypass, 1).u(0, 1)
    b.ue(0).ue(0).ue(4).ue(1).u(0, 1).ue(1).ue(1).u(frame_mbs_only, 1)
    if not frame_mbs_only:
        b.u(0, 1)
    b.u(1, 1).u(0, 1).u(0, 1)
    return bytes([0x67]) + h26x.escape(np.frombuffer(b.trailing(), np.uint8))


def _refusal(nals):
    dec = h264.Decoder("x.mp4")
    try:
        with pytest.raises(mpeg4.UnsupportedVideo) as err:
            for nal in nals:
                dec.decode(nal, 0, None)
        return err.value.reason
    finally:
        dec.close()


def _aso_sample():
    """A picture of two slices, the second one first."""
    stream = h26x.RandomH264((64, 48), 1, seed=3, intra_only=True, slices=2)
    while len(stream.pictures[0]) < 2:  # a picture that happens to have one slice
        stream = h26x.RandomH264((64, 48), 1, seed=stream.seed + 1, intra_only=True, slices=2)
    nals = stream.pictures[0][::-1]
    return stream.param_sets, b"".join(len(n).to_bytes(4, "big") + n for n in nals)


@pytest.mark.parametrize("feature,nals,name", [
    ("interlace", [_sps(frame_mbs_only=0)], "interlaced"),
    ("4:0:0", [_sps(chroma=0)], "4:0:0"),
    ("4:2:2", [_sps(profile=122, chroma=2)], "4:2:2"),
    ("4:4:4", [_sps(profile=244, chroma=3)], "4:4:4"),
    ("10-bit", [_sps(profile=110, depth=10)], "more than 8 bits"),
    ("lossless", [_sps(profile=244, bypass=1)], "lossless"),
    ("FMO", [_sps(), b"\x68" + h26x.Bits().ue(0).ue(0).u(0, 1).u(0, 1).ue(1).trailing()],
     "slice groups (FMO"),
    ("SP", [_sps(), b"\x01" + h26x.Bits().ue(0).ue(3).trailing()], "SP and SI"),
    ("data partitioning", [b"\x02\x80"], "data partitioning"),
    ("MVC", [b"\x14\x80"], "SVC/MVC"),
])
def test_refused_features_are_named(feature, nals, name):
    reason = _refusal(nals)
    assert reason.startswith("H.264: ") and name in reason, (feature, reason)


def test_refusals_raise_from_the_reader(tmp_path):
    """An unsupported SPS in avcC refuses at open, an arbitrary slice
    order at the read that meets it; neither falls back."""
    stream = h26x.RandomH264((64, 48), 1, seed=1, intra_only=True)
    bad = str(tmp_path / "interlaced.mp4")
    with mp4.Mp4Writer(bad, (64, 48), 30.0, h26x._avcc(_sps(frame_mbs_only=0), stream.pps),
                       codec="avc1") as w:
        w.add_sample(b"".join(len(n).to_bytes(4, "big") + n for n in stream.pictures[0]), True)
    for call in (lambda: h264.Reader(bad, device="cpu"),
                 lambda: tvideo.open_video(bad, device="cpu"),
                 lambda: tvideo.get_frames(bad, [0], device="cpu")):
        with pytest.raises(mpeg4.UnsupportedVideo, match="interlaced"):
            call()
    sets, sample = _aso_sample()
    aso = str(tmp_path / "aso.mp4")
    with mp4.Mp4Writer(aso, (64, 48), 30.0, h26x._avcc(*sets), codec="avc1") as w:
        w.add_sample(sample, True)
    with h264.Reader(aso, device="cpu") as r:
        with pytest.raises(mpeg4.UnsupportedVideo, match="arbitrary slice order"):
            r.read(0)


def test_open_video_picks_the_decoder_by_a_fixed_table(tmp_path):
    """avc1/avc3 -> the software H.264 decoder; hvc1/hev1 -> the software
    HEVC decoder; mp4v -> the port's MPEG-4 codec; decoder= asks for one
    (NVDEC, which the CPU refuses), and nothing falls back."""
    avc = h26x.write_mp4(str(tmp_path / "a.mp4"), h26x.RandomH264((64, 48), 2, seed=1), 30.0)
    hevc_path = h26x.write_mp4(str(tmp_path / "h.mp4"), h26x.HevcStream((64, 48), 2, seed=1), 30.0)
    with tvideo.open_video(avc, device="cpu") as r:
        assert isinstance(r, h264.Reader)
    with tvideo.open_video(avc, device="cpu", decoder="software") as r:
        assert isinstance(r, h264.Reader)
    with pytest.raises(mpeg4.UnsupportedVideo, match="NVDEC"):
        tvideo.open_video(avc, device="cpu", decoder="nvdec")
    with tvideo.open_video(hevc_path, device="cpu") as r:
        assert isinstance(r, hevc.Reader)
    with tvideo.open_video(hevc_path, device="cpu", decoder="software") as r:
        assert isinstance(r, hevc.Reader)
    with pytest.raises(mpeg4.UnsupportedVideo, match="NVDEC"):
        tvideo.open_video(hevc_path, device="cpu", decoder="nvdec")
    with pytest.raises(ValueError, match="decoder must be"):
        tvideo.open_video(avc, device="cpu", decoder="cv2")
    assert tvideo.DECODERS == {"avc1": "software", "avc3": "software", "hvc1": "software",
                               "hev1": "software"}


def test_chip_smoke_streams_have_the_digests_cv2_gives():
    """chip_smoke.phase_h264 holds the card's decode of its full-width
    streams to H264_DIGESTS: the streams written here are those bytes, and
    cv2 reads them to those frames."""
    import tempfile

    for label, stream in chip_smoke.h264_streams():
        with tempfile.TemporaryDirectory() as root:
            path = h26x.write_mp4(f"{root}/a.mp4", stream, chip_smoke.NVDEC_FPS)
            with open(path, "rb") as f:
                file_sha = hashlib.sha256(f.read()).hexdigest()
            frames = cv2_frames(path)
        want_file, want_frames = chip_smoke.H264_DIGESTS[label]
        assert file_sha == want_file, label
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == list(want_frames), label


def test_writer_is_deterministic():
    """The same seed and options give the same bytes (the digests above
    depend on it); another seed gives others."""
    a = h26x.RandomH264((64, 48), 4, seed=9, cabac=True)
    b = h26x.RandomH264((64, 48), 4, seed=9, cabac=True)
    c = h26x.RandomH264((64, 48), 4, seed=10, cabac=True)
    assert a.pictures == b.pictures and a.param_sets == b.param_sets
    assert a.pictures != c.pictures
