"""The port's software HEVC decoder (acinoset_tpu_torch.utils.hevc,
utils/csrc/hevc.cpp) against cv2 (ffmpeg) and the JAX package, on the
CPU:

- streams of utils.h26x's random-syntax writer, which drives the
  decoder's own syntax code with every element picked from a seed, decode
  to cv2's frames bit for bit in uint8 (CTBs of 16, 32 and 64; I, P and B
  pictures with TMVP on and off; AMP; transform skip and sign hiding;
  scaling lists; SAO; each deblocking mode; cu_qp_delta with chroma QP
  offsets; transquant bypass and PCM; constrained intra prediction;
  slices with dependent slice segments; uniform and explicit tiles;
  wavefronts; explicit weights; long-term pictures with list
  modification; CRA and BLA pictures with RASL and RADL pictures; SEI
  units; POC lsb wrap; pic_output_flag; IRAP pictures whose
  NoOutputOfPriorPicsFlag drops the pictures still waiting, an end of
  sequence before a CRA; a cropped size; BT.601, BT.709 and BT.2020 in
  both ranges);
- the port's get_frames and extract_frame_range equal the JAX package's
  on the same file, and seeks equal the sequential decode (a RASL frame
  too); where a decode drops pictures, frames are numbered as cv2 reads
  them in order;
- HevcStream decodes to its known reconstruction;
- each feature the decoder does not take raises UnsupportedVideo naming
  it, and pictures of a layer above 0 are dropped;
- chip_smoke.py's full-width streams and their frames have the SHA-256
  it holds the card's decode to, as cv2 reads them;
- the writer is deterministic, and bit-flipped streams give frames or an
  error, never a crash.

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
from acinoset_tpu_torch.utils import h26x, hevc, mp4, mpeg4, nvdec

torch.set_num_threads(2)

#: (size, frames, the writer's options) of each case
CASES = {
    "i_only_ctb16": ((96, 80), 3, dict(intra_only=True, ctb=16)),
    "i_only_ctb32": ((96, 80), 3, dict(intra_only=True, ctb=32, depths=(2, 2))),
    "i_only_ctb64": ((128, 96), 2, dict(intra_only=True, ctb=64, depths=(3, 3))),
    "p_tmvp": ((96, 80), 5, dict(b_frames=0, refs=3)),
    "b_tmvp": ((96, 80), 7, dict(b_frames=3)),
    "b_no_tmvp": ((96, 80), 7, dict(b_frames=3, tmvp=False)),
    "amp": ((96, 80), 5, dict(amp=True, ctb=32)),
    "transform_skip_sign_hiding": ((96, 80), 4, dict(transform_skip=True, sign_hiding=True)),
    "scaling_default_and_sps": ((96, 80), 4, dict(scaling="sps", ctb=64)),
    "scaling_pps": ((96, 80), 4, dict(scaling="pps")),
    "sao": ((96, 80), 5, dict(sao=True, b_frames=1)),
    "deblocking_off": ((96, 80), 4, dict(deblock="off")),
    "deblocking_override": ((176, 144), 4, dict(deblock="override", slices=3, sao=True)),
    "deblocking_offsets": ((96, 80), 4, dict(deblock_offsets=True)),
    "cu_qp_delta_chroma_offsets": ((96, 80), 5, dict(cu_qp_delta=True, qp_depth=2, qp=(10, 45),
                                                     chroma_qp_offsets=(-4, 5),
                                                     slice_chroma_offsets=True)),
    "bypass_pcm": ((96, 80), 4, dict(bypass=True, pcm=True, sao=True)),
    "pcm_loop_filter_off": ((96, 80), 4, dict(pcm=True, pcm_loop_filter=False, sao=True)),
    "constrained_intra": ((96, 80), 5, dict(constrained_intra=True, intra_percent=40)),
    "slices_dependent": ((176, 144), 3, dict(slices=4, dependent_slices=True, ctb=16, sao=True)),
    "tiles_uniform": ((176, 144), 3, dict(tiles=(3, 2), ctb=16, slices=3)),
    "tiles_explicit": ((176, 144), 3, dict(tiles=(2, 3), uniform_tiles=False, ctb=16, sao=True,
                                           lf_across=(False, True))),
    "wpp": ((176, 144), 3, dict(wpp=True, ctb=16, slices=3, dependent_slices=True)),
    "explicit_weights": ((96, 80), 5, dict(weighted=True, b_frames=1)),
    "long_term_list_modification": ((64, 48), 10, dict(long_term=True, lt_sps=True, list_mod=True,
                                                       gop=10, b_frames=1)),
    "cra_rasl_radl": ((64, 48), 14, dict(open_gop=True, cra_start=True, gop=6, b_frames=2)),
    "bla_sei": ((64, 48), 14, dict(open_gop=True, bla=True, gop=6, b_frames=3, sei=True)),
    "no_output_of_prior_pics": ((64, 48), 16, dict(gop=5, b_frames=3)),
    "end_of_sequence_cra": ((64, 48), 20, dict(open_gop=True, eos=True, gop=5, b_frames=2,
                                               sei=True)),
    "poc_lsb_wrap_hidden": ((64, 48), 24, dict(gop=24, log2_max_poc_lsb=4, b_frames=3,
                                               hidden=True)),
    "merge_level_min_cb16": ((96, 80), 5, dict(max_merge=0, parallel_merge=4, min_cb=16)),
    "cropped_168x132": ((168, 132), 3, dict(ctb=64, cabac_init=True, extra_bits=2,
                                            header_ext=True, vui_extra=True)),
    "bt601_limited": ((64, 48), 2, dict(matrix=h26x.BT601, full_range=False)),
    "bt601_full": ((64, 48), 2, dict(matrix=h26x.BT601, full_range=True)),
    "bt709_limited": ((64, 48), 2, dict(matrix=h26x.BT709, full_range=False)),
    "bt709_full": ((64, 48), 2, dict(matrix=h26x.BT709, full_range=True)),
    "bt2020_limited": ((64, 48), 2, dict(matrix=h26x.BT2020, full_range=False)),
    "bt2020_full": ((64, 48), 2, dict(matrix=h26x.BT2020, full_range=True)),
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
    with hevc.Reader(path, device="cpu", **kw) as r:
        return [r.read(k) for k in range(r.n_frames)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_random_syntax_decodes_as_cv2_bit_for_bit(tmp_path, case):
    size, n, opts = CASES[case]
    stream = h26x.RandomHEVC(size, n, seed=sum(map(ord, case)), **opts)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, codec="hev1" if n % 2 else "hvc1")
    want = cv2_frames(path)
    got = port_frames(path)
    assert len(want) == len(got) == len(stream.shown)
    for k, (a, b) in enumerate(zip(want, got)):
        assert b.shape == a.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(b, a, err_msg=f"frame {k}")
    assert len({f.tobytes() for f in got}) == len(got)  # no two frames alike: an order error shows


@pytest.mark.parametrize("case", ["no_output_of_prior_pics", "end_of_sequence_cra"])
def test_the_dropping_cases_drop_pictures(case):
    """The two cases above drop pictures a decoder has decoded: an IRAP's
    NoOutputOfPriorPicsFlag (no_output_of_prior_pics_flag, or 1 for a CRA
    after an end of sequence) empties the DPB of pictures still waiting
    for output, and a CRA after an end of sequence drops its RASL
    pictures."""
    size, n, opts = CASES[case]
    stream = h26x.RandomHEVC(size, n, seed=sum(map(ord, case)), **opts)
    rasl = {k for k in range(n) if stream.kinds[k] == h26x.RASL_N}
    dropped = set(range(n)) - set(stream.shown)
    assert dropped - rasl
    if opts.get("eos"):
        assert any(nal[0] >> 1 == 36 for nals in stream.pictures for nal in nals)
        assert dropped & rasl


def test_get_frames_and_extract_frame_range_equal_the_jax_package(tmp_path):
    """The JAX package reads through cv2; the port through its software
    decoder: the same frames, the same indices skipped, the same PNGs. The
    stream shows every picture it holds (open GOPs: a CRA inside a stream
    drops no picture); where a decode drops some, see the next test."""
    stream = h26x.RandomHEVC((96, 80), 14, seed=5, gop=6, b_frames=2, sao=True, open_gop=True)
    assert stream.shown == list(range(stream.n))
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


def test_dropped_pictures_number_frames_as_cv2_reads_them(tmp_path):
    """Where a decode drops pictures (here an IDR's
    no_output_of_prior_pics_flag), frame k is the k-th picture cv2 reads
    in order, as create_labeled_videos and the dlc stage count them,
    through get_frames and extract_frame_range too. (The JAX package's
    get_frames seeks with CAP_PROP_POS_FRAMES, which cv2 counts by
    timestamp, so there its indices name other pictures.)"""
    stream = h26x.RandomHEVC((64, 48), 16, seed=3, gop=5, b_frames=3)
    assert len(stream.shown) < stream.n
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 30.0)
    want = cv2_frames(path)
    assert len(want) == len(stream.shown)
    seeks = [len(want) - 1, 2, 0, 5, 5, len(want)]
    got = tvideo.get_frames(path, seeks, device="cpu")
    assert [i for i, _f in got] == seeks[:-1]
    for i, f in got:
        np.testing.assert_array_equal(f, want[i], err_msg=f"frame {i}")
    got = tvideo.extract_frame_range(path, 1, len(want), str(tmp_path / "g"), device="cpu")
    assert [i for i, _f in got] == list(range(1, len(want)))
    for i, f in got:
        np.testing.assert_array_equal(f, want[i], err_msg=f"frame {i}")


def test_seeks_equal_the_sequential_decode(tmp_path):
    """Any index restarts at the IRAP picture a sequential decode passes
    through to show it: for a RASL frame of a CRA inside the stream, the
    IRAP before that CRA. Reading on is sequential; an index past the end
    reads as None."""
    stream = h26x.RandomHEVC((64, 48), 20, seed=6, gop=7, b_frames=3, open_gop=True)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, codec="hev1")
    seq = port_frames(path)
    np.testing.assert_array_equal(np.stack(seq), np.stack(cv2_frames(path)))
    rasl = [k for k in range(stream.n) if stream.kinds[k] == h26x.RASL_N]
    assert rasl
    with hevc.Reader(path, device="cpu") as r:
        for k in [rasl[-1], 12, 3, 19, rasl[0], 4, 5, 13, 0, 6, 6, 18]:
            np.testing.assert_array_equal(r.read(k), seq[k], err_msg=f"frame {k}")
        assert r.read(20) is None and r.read(-1) is None


def test_hevcstream_decodes_to_its_reconstruction(tmp_path):
    """The writer of known reconstruction (PCM and skipped CUs, cropping,
    the VUI's colours) through open_video's default."""
    stream = h26x.HevcStream((176, 136), 14, gop=12, seed=2, matrix=h26x.BT601, full_range=False)
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 90.0)
    coefs = nvdec.colour_coefs(stream.matrix, stream.full_range)
    with tvideo.open_video(path, device="cpu") as r:
        assert isinstance(r, hevc.Reader)
        got = [r.read(k) for k in range(r.n_frames)]
    assert len(got) == stream.n
    for k, f in enumerate(got):
        want = nvdec.nv12_to_bgr_plain(stream.surface(k, "cpu"), stream.coded[1], stream.size,
                                       coefs).numpy()
        np.testing.assert_array_equal(f, want, err_msg=f"frame {k}")


def _nal(kind, rbsp: bytes) -> bytes:
    return bytes([kind << 1, 1]) + h26x.escape(np.frombuffer(rbsp, np.uint8))


def _sps(chroma=1, depth=8, field_seq=False, frame_field=False, ext=None, depth_c=None):
    """A 64 x 64 SPS (CTB 32, min CB 16) with the fields the decoder checks
    (depth_c: the chroma's bit depth, the luma's by default); ext (flag
    index, range-extension flag index) sets one extension flag."""
    b = h26x.Bits().u(0, 4).u(0, 3).u(1, 1)
    h26x.HevcStream._ptl(b).ue(0).ue(chroma)
    if chroma == 3:
        b.u(0, 1)
    b.ue(64).ue(64).u(0, 1).ue(depth - 8).ue((depth if depth_c is None else depth_c) - 8).ue(4)
    b.u(1, 1).ue(1).ue(0).ue(0)  # sub-layer ordering
    b.ue(1).ue(1).ue(0).ue(2).ue(0).ue(0)  # CB 16..32, TB 4..16, depths 0
    b.u(0, 1).u(0, 1).u(0, 1).u(0, 1)  # scaling lists, AMP, SAO, PCM
    b.ue(0)  # short-term sets
    b.u(0, 1).u(0, 1).u(0, 1)  # long-term, TMVP, strong smoothing
    vui = field_seq or frame_field
    b.u(int(vui), 1)
    if vui:
        b.u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1)  # aspect, overscan, signal, chroma loc, neutral
        b.u(int(field_seq), 1).u(int(frame_field), 1)
        b.u(0, 1).u(0, 1).u(0, 1)  # display window, timing, bitstream restriction
    if ext is None:
        b.u(0, 1)
    else:
        b.u(1, 1)
        for i in range(4):
            b.u(int(i == ext[0]), 1)
        b.u(0, 4)
        if ext[0] == 0:
            for i in range(9):
                b.u(int(i == ext[1]), 1)
    return _nal(33, b.trailing())


def _refusal(nals):
    dec = hevc.Decoder("x.mp4")
    try:
        with pytest.raises(mpeg4.UnsupportedVideo) as err:
            for nal in nals:
                dec.decode(nal, 0, None)
        return err.value.reason
    finally:
        dec.close()


@pytest.mark.parametrize("feature,nals,name", [
    ("12-bit", [_sps(depth=12)], "luma bit depth 12"),
    ("chroma depth unlike luma's", [_sps(depth=10, depth_c=8)], "chroma bit depth 8 unlike the luma's 10"),
    ("4:0:0", [_sps(chroma=0)], "4:0:0"),
    ("4:2:2", [_sps(chroma=2)], "4:2:2"),
    ("4:4:4", [_sps(chroma=3)], "4:4:4"),
    ("range extension", [_sps(ext=(0, 2))], "implicit_rdpcm_enabled_flag"),
    ("multilayer", [_sps(ext=(1, 0))], "multilayer extension"),
    ("3D", [_sps(ext=(2, 0))], "3D extension"),
    ("SCC", [_sps(ext=(3, 0))], "screen content coding extension"),
    ("field_seq_flag", [_sps(field_seq=True)], "field_seq_flag"),
    ("pic_timing fields", [_sps(frame_field=True), _nal(39, bytes([1, 1, 0x10, 0x80]))],
     "pic_struct 1: the pictures are fields"),
])
def test_refused_features_are_named(feature, nals, name):
    reason = _refusal(nals)
    assert reason.startswith("HEVC: ") and name in reason, (feature, reason)


def test_refusals_raise_from_the_reader(tmp_path):
    """A 12-bit SPS in hvcC and a colour matrix the port does not convert
    (10, BT.2020 constant luminance) refuse at open, through every reading
    function; nothing falls back. (10-bit streams and BT.2020 read: the
    bt2020 cases above, tests/test_torch_hevc10.py.)"""
    stream = h26x.RandomHEVC((64, 48), 1, seed=1, intra_only=True)
    bad = str(tmp_path / "main12.mp4")
    with mp4.Mp4Writer(bad, (64, 48), 30.0, h26x._hvcc(stream.vps, _sps(depth=12), stream.pps),
                       codec="hvc1") as w:
        w.add_sample(b"".join(len(n).to_bytes(4, "big") + n for n in stream.pictures[0]), True)
    bt2020c = h26x.write_mp4(str(tmp_path / "bt2020c.mp4"), h26x.RandomHEVC(
        (64, 48), 1, seed=1, intra_only=True, matrix=10), 30.0)
    for path, match in ((bad, "luma bit depth 12"),
                        (bt2020c, "colour matrix 10 BT.2020 \\(constant luminance\\)")):
        for call in (lambda: hevc.Reader(path, device="cpu"),
                     lambda: tvideo.open_video(path, device="cpu"),
                     lambda: tvideo.get_frames(path, [0], device="cpu")):
            with pytest.raises(mpeg4.UnsupportedVideo, match=match):
                call()


def test_layers_above_zero_are_dropped(tmp_path):
    """NAL units of nuh_layer_id 1 (another view's slices) change nothing:
    the port decodes the base layer, as cv2 does."""
    stream = h26x.RandomHEVC((64, 48), 4, seed=8, b_frames=1)
    plain = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0)
    layered = [[n for nal in nals for n in (nal, bytes([nal[0], nal[1] | 8]) + nal[2:])]
               for nals in stream.pictures]
    stream.pictures = layered
    path = h26x.write_mp4(str(tmp_path / "b.mp4"), stream, 30.0)
    want = port_frames(plain)
    got = port_frames(path)
    assert len(got) == len(want) == stream.n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_streams_have_the_digests_cv2_gives():
    """chip_smoke.phase_hevc holds the card's decode of its full-width
    8-bit streams to HEVC_DIGESTS: the streams written here are those
    bytes, and cv2 reads them to those frames (its Main 10 streams:
    tests/test_torch_hevc10.py)."""
    import tempfile

    for label, stream in chip_smoke.hevc_streams(bit_depth=8):
        with tempfile.TemporaryDirectory() as root:
            path = h26x.write_mp4(f"{root}/a.mp4", stream, chip_smoke.NVDEC_FPS)
            with open(path, "rb") as f:
                file_sha = hashlib.sha256(f.read()).hexdigest()
            frames = cv2_frames(path)
        want_file, want_frames = chip_smoke.HEVC_DIGESTS[label]
        assert file_sha == want_file, label
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == list(want_frames), label


def test_writer_is_deterministic():
    """The same seed and options give the same bytes (the digests above
    depend on it); another seed gives others."""
    a = h26x.RandomHEVC((64, 48), 4, seed=9, sao=True, tiles=(2, 1), ctb=16)
    b = h26x.RandomHEVC((64, 48), 4, seed=9, sao=True, tiles=(2, 1), ctb=16)
    c = h26x.RandomHEVC((64, 48), 4, seed=10, sao=True, tiles=(2, 1), ctb=16)
    assert a.pictures == b.pictures and a.param_sets == b.param_sets
    assert a.pictures != c.pictures


@pytest.mark.parametrize("seed", range(3))
def test_bit_flipped_streams_never_crash(seed):
    """Streams with bits flipped at random decode to pictures or raise
    ValueError or UnsupportedVideo; the process survives (the decoder was
    also fuzzed under ASAN and UBSAN before it was committed)."""
    rng = np.random.default_rng(seed)
    stream = h26x.RandomHEVC((96, 64), 5, seed=seed, b_frames=1, sao=True, slices=2,
                             dependent_slices=True, pcm=True, amp=True, cu_qp_delta=True)
    out = np.zeros(96 * 64 * 3 // 2, np.uint8)
    outcomes = set()
    for trial in range(12):
        dec, scan = hevc.Decoder("fuzz"), hevc.Decoder("fuzz")
        try:
            for s in stream.param_sets:
                dec.decode(s, 0, None)
                scan.decode(s, 0, None)
            for k, nals in enumerate(stream.pictures):
                data = bytearray(b"".join(len(n).to_bytes(4, "big") + n for n in nals))
                for _ in range(int(rng.integers(1, 4))):
                    bit = int(rng.integers(48, 8 * len(data)))
                    data[bit // 8] ^= 1 << (bit % 8)
                try:
                    outcomes.add(dec.decode(bytes(data), 4, out))
                except (ValueError, mpeg4.UnsupportedVideo):
                    outcomes.add("error")
                try:  # the reader's scan, on its first bytes
                    scan.scan(bytes(data[:int(rng.integers(8, len(data) + 1))]), 4, k)
                    scan.scan_end(k == len(stream.pictures) - 1)
                except (ValueError, mpeg4.UnsupportedVideo):
                    outcomes.add("scan error")
        finally:
            dec.close()
            scan.close()
    assert outcomes
