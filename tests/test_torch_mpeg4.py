"""The port's mp4v codec (acinoset_tpu_torch.utils.mpeg4, its C++
bitstream half and utils.mp4's sample tables and writer) on the CPU,
against the JAX package's cv2 writer and cv2's decoder (ffmpeg):

(a) the integer IDCT against IEEE Std 1180-1990;
(b) the port decodes the JAX package's cv2-written files as cv2 does;
(c) cv2 reads the port's files: frame count, size, frame rate and a
    PSNR no lower than the JAX package's file's less 1 dB; the port's
    decode equals the encoder's own reconstruction;
    the VLC tables, each through a stream built to use it, decoded by
    the port (the levels, modes and vectors given) and by cv2 (the same
    frames);
(g) every codec and tool the port does not decode raises, naming it.
(h), the card against the CPU, is tests/test_torch_mpeg4_cuda.py.

Every video is written in the test, from numpy data made from a seed.
"""
import os

import cv2
import numpy as np
import pytest
import torch

from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import mp4, mpeg4, png
from acinoset_tpu_torch.utils import synthetic as tsyn
from acinoset_tpu_torch.utils.mpeg4 import (MB_INTER, MB_INTER_Q, MB_INTRA, MB_INTRA_Q,
                                            MB_SKIP)

torch.set_num_threads(2)

#: (width, height), fps: a multiple of 16, and a size that is not
SIZES = [((176, 144), 30.0), ((72, 40), 119.88)]
N_FRAMES = 36


def footage(size, n, seed=0):
    """BGR frames: a static third (not-coded macroblocks), a smooth
    texture moving half a pixel a frame across, a quarter down (half-pel
    vectors), and every third frame a 16 x 16 square of fresh noise
    (intra macroblocks in P-VOPs)."""
    W, H = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    static = np.stack([128 + 40 * np.sin(xx / 9.0), 128 + 30 * np.cos(yy / 7.0), 120 + 0 * xx],
                      -1)
    out = []
    for i in range(n):
        X, Y = xx - 0.5 * i, yy - 0.5 * (i // 2)
        moving = np.stack([128 + 60 * np.sin(X / 7.0) * np.cos(Y / 5.0),
                           128 + 50 * np.sin((X + Y) / 9.0),
                           128 + 70 * np.cos(X / 11.0 - Y / 6.0)], -1)
        f = np.where((xx < W // 3)[..., None], static, moving)
        if i % 3 == 2:
            y0, x0 = rng.integers(0, H - 16), rng.integers(W // 3, W - 16)
            f[y0:y0 + 16, x0:x0 + 16] = rng.uniform(0, 255, (16, 16, 3))
        out.append(f.clip(0, 255).astype(np.uint8))
    return out


def write_pngs(d, frames):
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f"f{i}.png") for i in range(len(frames))]
    for p, f in zip(paths, frames):
        png.write_png(p, f[..., ::-1])
    return paths


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


# ---- (a) the IDCT ----


def _dct_matrix():
    u, x = np.mgrid[0:8, 0:8]
    c = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    c[0] /= np.sqrt(2)
    return c


@pytest.mark.parametrize("lo,hi", [(-256, 255), (-5, 5), (-300, 300)])
def test_idct_meets_ieee_1180(lo, hi):
    """10,000 random blocks a range and sign: the inputs the standard
    makes (pixels uniform in [lo, hi], their float DCT rounded and
    clipped to [-2048, 2047]) through the integer IDCT and a float64
    IDCT, both rounded and clipped to [-256, 255]."""
    c = _dct_matrix()
    rng = np.random.default_rng(hi)
    pix = rng.integers(lo, hi + 1, (10_000, 8, 8)).astype(np.float64)
    for sign in (1, -1):
        coef = np.clip(np.floor(c @ (sign * pix) @ c.T + 0.5), -2048, 2047)
        ref = np.clip(np.floor(c.T @ coef @ c + 0.5), -256, 255)
        got = mpeg4.idct(torch.from_numpy(coef).to(torch.int32)).clamp(-256, 255).numpy()
        e = got - ref
        assert np.abs(e).max() <= 1
        assert (e ** 2).mean(0).max() <= 0.06
        assert (e ** 2).mean() <= 0.02
        assert np.abs(e.mean(0)).max() <= 0.015
        assert abs(e.mean()) <= 0.0015
    zero = mpeg4.idct(torch.zeros((1, 8, 8), dtype=torch.int32))
    assert not zero.any()


def test_dct_and_quantisers_round_trip_a_block():
    """The forward DCT (8 x the orthonormal DCT) against float64, and an
    intra block through quantisation, dequantisation and the IDCT."""
    c = _dct_matrix()
    rng = np.random.default_rng(3)
    pix = rng.integers(0, 256, (500, 8, 8))
    got = mpeg4.fdct8(torch.from_numpy(pix).to(torch.int32)).numpy()
    assert np.abs(got / 8.0 - c @ pix @ c.T).max() < 0.2
    luma = torch.ones(500, dtype=torch.bool)
    lv = mpeg4.quantise_intra(torch.from_numpy(got.reshape(500, 64)).to(torch.int32), 2, luma)
    back = mpeg4.idct(mpeg4.dequantise(lv, torch.full((500,), 2), luma, luma).view(-1, 8, 8))
    assert np.abs(back.numpy() - pix).mean() < 2.0


# ---- (b) and (c): both directions against cv2 ----


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """For each size: the source frames, their PNGs, the JAX package's
    images_to_video file (cv2) and the port's."""
    out = {}
    for size, fps in SIZES:
        d = tmp_path_factory.mktemp(f"v{size[0]}")
        frames = footage(size, N_FRAMES, seed=size[0])
        paths = write_pngs(str(d / "png"), frames)
        jax = jvideo.images_to_video(paths, str(d / "jax.mp4"), fps=fps)
        port = tvideo.images_to_video(paths, str(d / "port.mp4"), fps=fps, device="cpu")
        out[size] = dict(fps=fps, frames=frames, jax=jax, port=port, dir=str(d))
    return out


@pytest.mark.parametrize("size", [s for s, _ in SIZES])
def test_port_decodes_cv2_files_bit_for_bit(videos, size):
    """Every frame of the JAX package's file, decoded by the port, equals
    cv2's decode bit for bit: the same IDCT, half-pel prediction and
    swscale's yuv420p -> bgr24 arithmetic. The stream holds not-coded
    and intra macroblocks in P-VOPs and half-pel vectors."""
    v = videos[size]
    want = cv2_frames(v["jax"])
    assert len(want) == N_FRAMES
    kinds = dict(skipped=0, intra=0, half_pel=0)
    with mpeg4.Reader(v["jax"], device="cpu") as r:
        assert (r.n_frames, r.size) == (N_FRAMES, size)
        assert abs(r.fps - v["fps"]) <= 1e-9 * v["fps"]
        assert np.flatnonzero(r.track.sync).tolist() == [0, 12, 24]
        for i in range(N_FRAMES):
            np.testing.assert_array_equal(r.read(i), want[i])
            mb = r._dec.last.mb
            if r._dec.last.hdr[0] == 1:
                kinds["skipped"] += int((mb[:, 0] == 0).sum())
                kinds["intra"] += int((mb[:, 0] == 2).sum())
                kinds["half_pel"] += int(((mb[:, 1:] & 1) != 0).any(1).sum())
    assert all(kinds.values()), kinds


@pytest.mark.parametrize("size", [s for s, _ in SIZES])
def test_cv2_reads_the_ports_files(videos, size):
    """The port's images_to_video file, read by cv2: the frame count,
    size and fps asked for; a PSNR against the sources no lower than the
    JAX package's file's less 1 dB; and the port's own decode equals its
    encoder's reconstruction and cv2's decode bit for bit."""
    v = videos[size]
    cap = cv2.VideoCapture(v["port"])
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == N_FRAMES
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == size
    assert abs(cap.get(cv2.CAP_PROP_FPS) - v["fps"]) <= 1e-6 * v["fps"]
    assert mp4.video_info(v["port"]) == (size, v["fps"], N_FRAMES)
    got, jax = cv2_frames(v["port"]), cv2_frames(v["jax"])
    assert len(got) == N_FRAMES
    p_port = np.mean([psnr(a, b) for a, b in zip(got, v["frames"])])
    p_jax = np.mean([psnr(a, b) for a, b in zip(jax, v["frames"])])
    assert p_port >= p_jax - 1.0, (p_port, p_jax)

    again = os.path.join(v["dir"], "again.mp4")
    recon = []
    with mpeg4.Writer(again, size, v["fps"], device="cpu") as w:
        for f in v["frames"]:
            w.write(f)
            recon.append(mpeg4.yuv420_to_bgr(*w.planes, size).numpy())
    assert open(again, "rb").read() == open(v["port"], "rb").read()
    with mpeg4.Reader(again, device="cpu") as r:
        for i in range(N_FRAMES):
            f = r.read(i)
            np.testing.assert_array_equal(f, recon[i])
            np.testing.assert_array_equal(f, got[i])


def test_frame_rates_read_back_as_rationals(tmp_path):
    """90 fps stays 90/1; 119.88 is 2997/25; 120000/1001 keeps its
    denominator; cv2 and utils.mp4 read each back."""
    assert mp4.frame_rate(90.0) == (90, 1)
    assert mp4.frame_rate(119.88) == (2997, 25)
    assert mp4.frame_rate(120000 / 1001) == (120000, 1001)
    frame = np.full((16, 32, 3), 77, np.uint8)
    for fps in (90.0, 119.88, 120000 / 1001, 15.0):
        path = str(tmp_path / f"{fps}.mp4")
        with mpeg4.Writer(path, (32, 16), fps, device="cpu") as w:
            for _ in range(3):
                w.write(frame)
        assert abs(cv2.VideoCapture(path).get(cv2.CAP_PROP_FPS) - fps) <= 1e-6 * fps
        assert mp4.video_info(path)[1] == pytest.approx(fps, rel=1e-12)


def test_empty_video_has_no_frame(tmp_path):
    """A writer closed before any frame leaves a file that reads as zero
    frames at its size and rate, as cv2 reads it."""
    path = str(tmp_path / "empty.mp4")
    mpeg4.Writer(path, (48, 32), 90.0, device="cpu").close()
    with mpeg4.Reader(path, device="cpu") as r:
        assert (r.n_frames, r.size, r.fps) == (0, (48, 32), 90.0)
        assert r.read(0) is None
    assert not cv2.VideoCapture(path).read()[0]


def test_sensor_noise_is_drawn_anew_every_frame(tmp_path):
    """scene_frames' temporal noise: the same seed gives the same frames,
    frame to frame the background differs by about sqrt(2) sigma, and the
    port still decodes what it encodes as its reconstruction."""
    size, sigma = (64, 48), 3.0
    a = [f.to(torch.int32) for f in tsyn.scene_frames(size, 14, seed=2, sensor_noise=sigma)]
    b = list(tsyn.scene_frames(size, 2, seed=2, sensor_noise=sigma))
    assert torch.equal(a[1], b[1].to(torch.int32))
    corner = (a[1] - a[0])[:8, :8].double()  # the patch starts a quarter in
    assert 0.8 * sigma * 2 ** 0.5 < float(corner.std()) < 1.2 * sigma * 2 ** 0.5
    path = str(tmp_path / "noisy.mp4")
    recon = []
    with mpeg4.Writer(path, size, 90.0, device="cpu") as w:
        for f in a:
            w.write(f.to(torch.uint8))
            recon.append(mpeg4.yuv420_to_bgr(*w.planes, size))
    with mpeg4.Reader(path, device="cpu") as r:
        for n, want in enumerate(recon):
            assert torch.equal(r.read_tensor(n), want)


def test_a_write_that_fails_leaves_no_file(tmp_path):
    """An exception inside the writer's ``with`` (here a frame of the
    wrong size after a good one) removes the unfinished file."""
    path = str(tmp_path / "failed.mp4")
    frames = list(tsyn.scene_frames((48, 32), 2, seed=1))
    with pytest.raises(ValueError, match="a frame must be uint8"):
        with mpeg4.Writer(path, (48, 32), 90.0, device="cpu") as w:
            w.write(frames[0])
            w.write(frames[1][:16])
    assert not os.path.exists(path)


def test_seeking_from_sync_samples(videos):
    """Frames read in any order equal the sequential decode; an index
    past the end reads as None."""
    v = videos[(72, 40)]
    with mpeg4.Reader(v["port"], device="cpu") as r:
        seq = [r.read(i) for i in range(N_FRAMES)]
    with mpeg4.Reader(v["port"], device="cpu") as r:
        for i in (30, 5, 5, 13, 12, 35, 0, 23, 24, 11):
            np.testing.assert_array_equal(r.read(i), seq[i])
        assert r.read(N_FRAMES) is None and r.read(-1) is None


# ---- the VLC tables, through streams built to use each ----


def _scaler(q, luma):
    if q <= 4:
        return 8
    if luma:
        return 2 * q if q <= 8 else q + 8 if q <= 24 else 2 * q - 16
    return (q + 13) // 2 if q <= 24 else q - 6


def _events_block(rng, start, sweep):
    """A block's levels (raster) from random (run, level) events placed in
    zigzag order; sweep takes runs and levels over the tables' range and
    beyond (every entry, and the three escapes)."""
    zz = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
                   41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
                   23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62,
                   63])
    blk = np.zeros(64, np.int16)
    i = start
    for _ in range(rng.integers(1, 6)):
        run = int(rng.integers(0, 45 if sweep else 6))
        level = int(rng.integers(1, 60 if sweep else 4))
        i += run
        if i > 63:
            break
        blk[zz[i]] = level * rng.choice([-1, 1])
        i += 1
    return blk


def crafted_stream(path, rng, n_frames=6, size=(176, 144), modes_p=(MB_SKIP, MB_INTER),
                   ac_pred=False, dquant=False, vectors=False, sweep=False, cbpy_all=False):
    """An mp4v file whose VOPs are built through mpeg4.encode_vop from
    random macroblock modes, vectors and levels: intra DC levels about
    mid-grey and small AC levels (runs and levels past the tables at
    QP 1-2 where ``sweep``), so that no sample reaches 0, where ffmpeg's
    x86 no-rounding half-pel average is approximate. Returns what each
    frame's decode must give back: (mbs, [(block index, levels)])."""
    W, H = size
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    qp_hi = 2 if sweep else 12
    config = mpeg4.write_config(size, 30)
    vol = mpeg4.parse_config(config)
    want = []
    with mp4.Mp4Writer(path, size, 30.0, config) as out:
        for n in range(n_frames):
            vop_type = 0 if n % 6 == 0 else 1
            qp = q = int(rng.integers(1, qp_hi + 1))
            fcode = int(rng.integers(1, 4))
            mbs = np.zeros((mbw * mbh, 5), np.int16)
            levels, blocks = [], []
            for m in range(mbw * mbh):
                mode = MB_INTRA if vop_type == 0 else int(rng.choice(modes_p))
                steps = [d for d in (-2, -1, 1, 2) if 1 <= q + d <= qp_hi]
                if dquant and steps and rng.random() < 0.5 and mode in (MB_INTER, MB_INTRA):
                    mode += 1  # MB_INTER_Q, MB_INTRA_Q
                    dq = int(rng.choice(steps))
                    q += dq
                else:
                    mode = {MB_INTER_Q: MB_INTER, MB_INTRA_Q: MB_INTRA}.get(mode, mode)
                    dq = 0
                lim = 32 << (fcode - 1)
                mv = (rng.integers(-lim, lim, 2) if vectors and mode in (MB_INTER, MB_INTER_Q)
                      else (0, 0))
                mbs[m] = (mode, dq, int(ac_pred and rng.integers(0, 2)), mv[0], mv[1])
                if mode == MB_SKIP:
                    continue
                intra = mode >= MB_INTRA
                pattern = m % 16 if cbpy_all else int(rng.integers(0, 16))
                lv = np.zeros((6, 64), np.int16)
                for b in range(6):
                    if (b >= 4 or (pattern >> (3 - b)) & 1) and rng.random() < 0.8:
                        lv[b] = _events_block(rng, 1 if intra else 0, sweep)
                    if intra:
                        lv[b, 0] = rng.integers(100, 160) * 8 // _scaler(q, b < 4)
                levels.append(lv)
                blocks += [(6 * m + b, lv[b]) for b in range(6) if intra or lv[b].any()]
            levels = np.concatenate(levels) if levels else np.zeros((0, 64), np.int16)
            data = mpeg4.encode_vop(vol, vop_type, qp, mbs, levels, rounding=n % 2,
                                    fcode=fcode, time_inc=n)
            out.add_sample(data, vop_type == 0)
            want.append((mbs, blocks))
    return want


TABLE_STREAMS = {
    # B-6: every intra MCBPC (intra and intra+q, cbpc 0-3)
    "mcbpc_intra": dict(modes_p=(MB_INTRA,), dquant=True),
    # B-7: every P-VOP MCBPC but inter4v (not coded, inter, inter+q,
    # intra, intra+q; cbpc 0-3) with vectors and AC prediction
    "mcbpc_inter": dict(modes_p=(MB_SKIP, MB_INTER, MB_INTER_Q, MB_INTRA, MB_INTRA_Q),
                        dquant=True, vectors=True, ac_pred=True),
    # B-8: each of the 16 luma patterns in intra and inter macroblocks
    "cbpy": dict(modes_p=(MB_INTER, MB_INTRA), cbpy_all=True),
    # B-12: vectors over f_code 1-3's whole range
    "mvd": dict(modes_p=(MB_INTER,), vectors=True),
    # B-13/B-14: intra DC differentials of every size a valid stream has
    "dc_size": dict(modes_p=(MB_SKIP, MB_INTRA), n_frames=12, ac_pred=True),
    # B-16: intra TCOEF, runs and levels past the table (escapes 1-3),
    # with the alternate scans of AC prediction
    "tcoef_intra": dict(modes_p=(MB_INTRA,), sweep=True, ac_pred=True),
    # B-17: inter TCOEF, the same sweep
    "tcoef_inter": dict(modes_p=(MB_INTER, MB_SKIP), sweep=True),
}


@pytest.mark.parametrize("table", sorted(TABLE_STREAMS))
def test_vlc_table_decodes_what_it_encodes_as_cv2_does(tmp_path, table):
    path = str(tmp_path / "crafted.mp4")
    rng = np.random.default_rng(sorted(TABLE_STREAMS).index(table))
    want = crafted_stream(path, rng, **TABLE_STREAMS[table])
    theirs = cv2_frames(path)
    assert len(theirs) == len(want)
    with mpeg4.Reader(path, device="cpu") as r:
        for i, (mbs, blocks) in enumerate(want):
            np.testing.assert_array_equal(r.read(i), theirs[i])
            last = r._dec.last
            kinds = np.select([mbs[:, 0] == MB_SKIP, mbs[:, 0] >= MB_INTRA], [0, 2], 1)
            np.testing.assert_array_equal(last.mb[:, 0], kinds)
            inter = (kinds == 1)
            np.testing.assert_array_equal(last.mb[inter, 1:], mbs[inter, 3:])
            np.testing.assert_array_equal(last.idx, [b for b, _ in blocks])
            np.testing.assert_array_equal(last.levels, np.array([lv for _, lv in blocks]))


def test_n_vop_repeats_the_previous_frame(tmp_path):
    """I, P, N (vop_coded 0), P, P, N, P: as in cv2, an N-VOP gives no
    frame, both read in order and at the index get_frames seeks to
    (cv2's CAP_PROP_POS_FRAMES): the port's five frames are cv2's five,
    and an index past them reads as None."""
    config = mpeg4.write_config((32, 32), 30)
    vol = mpeg4.parse_config(config)
    intra = np.full((4, 5), (MB_INTRA, 0, 0, 0, 0), np.int16)
    lv = np.zeros((24, 64), np.int16)
    lv[:, 0], lv[::3, 5] = 100, 3
    inter = np.full((4, 5), (MB_INTER, 0, 0, 0, 0), np.int16)
    res = np.zeros((24, 64), np.int16)
    res[::2, 0] = 4
    coded = [True, True, False, True, True, False, True]
    vops = [mpeg4.encode_vop(vol, 0, 3, intra, lv)]
    vops += [mpeg4.encode_vop(vol, 1, 3, inter, res if c else res[:0], coded=c, time_inc=t)
             for t, c in enumerate(coded[1:], 1)]
    path = str(tmp_path / "nvop.mp4")
    with mp4.Mp4Writer(path, (32, 32), 30.0, config) as w:
        for i, v in enumerate(vops):
            w.add_sample(v, i == 0)
    theirs = cv2_frames(path)
    assert len(theirs) == sum(coded) == 5
    with mpeg4.Reader(path, device="cpu") as r:
        assert r.n_frames == 5
        got = [r.read(i) for i in range(5)]
        assert r.read(5) is None
    for g, t in zip(got, theirs):
        np.testing.assert_array_equal(g, t)
    assert len({g.tobytes() for g in got}) == 5
    seeks = [3, 1, 4, 0, 2, 5]
    cap = cv2.VideoCapture(path)
    for (i, f) in tvideo.get_frames(path, seeks, device="cpu"):
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, want = cap.read()
        assert ok
        np.testing.assert_array_equal(f, want)
    assert [i for i, _f in tvideo.get_frames(path, seeks, device="cpu")] == \
        [i for i, _f in jvideo.get_frames(path, seeks)] == seeks[:-1]


# ---- (g) what the port does not decode ----


class Bits:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(int(v) >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def start(self, code):
        while len(self.bits) % 8:
            self.bits.append(1)
        return self.put(0x000001, 24).put(code, 8)

    def bytes(self):
        b = self.bits + [0] + [1] * ((-len(self.bits) - 1) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2) for i in range(0, len(b), 8))


def vol_bits(shape=0, verid=1, interlaced=0, obmc_disable=1, sprite=0, not_8_bit=0, quant_type=0,
             quarter=0, complexity_disable=1, resync_disable=1, partitioned=0):
    """A VOL header (16 x 16, 30 fps) with one field set to what the port
    refuses."""
    b = Bits().start(0x00).start(0x20)
    b.put(0, 1).put(1, 8).put(1, 1).put(verid, 4).put(1, 3).put(1, 4).put(0, 1)
    b.put(shape, 2).put(1, 1).put(30, 16).put(1, 1).put(0, 1).put(1, 1)
    if shape == 0:
        b.put(16, 13).put(1, 1).put(16, 13).put(1, 1)
    b.put(interlaced, 1).put(obmc_disable, 1).put(sprite, 1 if verid == 1 else 2)
    b.put(not_8_bit, 1).put(quant_type, 1)
    if verid != 1:
        b.put(quarter, 1)
    b.put(complexity_disable, 1).put(resync_disable, 1).put(partitioned, 1)
    if verid != 1:
        b.put(0, 1).put(0, 1)
    b.put(0, 1)
    return b.bytes()


VOL_FAULTS = {
    "interlaced": dict(interlaced=1),
    "shape": dict(shape=1),
    "OBMC": dict(obmc_disable=0),
    "sprites/GMC": dict(sprite=1),
    "not-8-bit": dict(not_8_bit=1),
    "MPEG quantisation matrices": dict(quant_type=1),
    "quarter-pel": dict(verid=2, quarter=1),
    "complexity estimation": dict(complexity_disable=0),
    "resync markers": dict(resync_disable=0),
    "data partitioning and RVLC": dict(partitioned=1),
}


@pytest.mark.parametrize("feature", sorted(VOL_FAULTS))
def test_unsupported_vol_raises_naming_the_feature(tmp_path, feature):
    path = str(tmp_path / "vol.mp4")
    with mp4.Mp4Writer(path, (16, 16), 30.0, vol_bits(**VOL_FAULTS[feature])) as w:
        w.add_sample(b"\x00\x00\x01\xb6" + bytes(8), True)
    with pytest.raises(mpeg4.UnsupportedVideo, match=feature) as err:
        mpeg4.Reader(path, device="cpu")
    assert path in str(err.value) and feature in err.value.reason
    assert vol_bits() and mpeg4.parse_config(vol_bits())[0] == 1


def _vop(vop_type, after):
    """A VOP header of the 16 x 16 VOL (5 time-increment bits), then bits."""
    b = Bits().start(0xB6).put(vop_type, 2).put(0, 1).put(1, 1).put(0, 5).put(1, 1).put(1, 1)
    for v, n in after:
        b.put(v, n)
    return b.bytes()


@pytest.mark.parametrize("feature,vop", [
    ("B-VOPs", _vop(2, [])),
    ("sprite", _vop(3, [])),
    # a P-VOP (rounding, intra_dc_vlc_thr 0, QP 4, f_code 1) whose one
    # macroblock is coded (0) as inter4v, cbpc 0 (MCBPC '010')
    ("4MV", _vop(1, [(0, 1), (0, 3), (4, 5), (1, 3), (0, 1), (0b010, 3), (0, 16)])),
    ("intra_dc_vlc_thr", _vop(0, [(3, 3), (4, 5), (0, 16)])),
])
def test_unsupported_vop_raises_naming_the_feature(tmp_path, feature, vop):
    path = str(tmp_path / "vop.mp4")
    config = vol_bits()
    vol = mpeg4.parse_config(config)
    first = mpeg4.encode_vop(vol, 0, 4, np.full((1, 5), (MB_INTRA, 0, 0, 0, 0), np.int16),
                             np.full((6, 64), 0, np.int16) + np.eye(1, 64, dtype=np.int16) * 100)
    with mp4.Mp4Writer(path, (16, 16), 30.0, config) as w:
        w.add_sample(first, True)
        w.add_sample(vop, False)
    with mpeg4.Reader(path, device="cpu") as r:
        assert r.read(0) is not None
        with pytest.raises(mpeg4.UnsupportedVideo, match=feature):
            r.read(1)


@pytest.mark.parametrize("in_band", [False, True])
def test_a_vol_that_changes_the_frame_size_raises(tmp_path, in_band):
    """A later sample whose own VOL declares a larger frame than the one
    the reader sized its buffers for (from the esds, or from the first
    sample's in-band VOL) is refused before its VOP is decoded."""
    path = str(tmp_path / "resize.mp4")
    config = mpeg4.write_config((16, 16), 30)
    vol = mpeg4.parse_config(config)
    first = mpeg4.encode_vop(vol, 0, 4, np.full((1, 5), (MB_INTRA, 0, 0, 0, 0), np.int16),
                             np.full((6, 64), 0, np.int16) + np.eye(1, 64, dtype=np.int16) * 100)
    larger = mpeg4.write_config((2048, 1024), 30) + _vop(0, [(0, 3), (4, 5), (0, 16)])
    with mp4.Mp4Writer(path, (16, 16), 30.0, b"" if in_band else config) as w:
        w.add_sample(config + first if in_band else first, True)
        w.add_sample(larger, True)
    with mpeg4.Reader(path, device="cpu") as r:
        assert r.size == (16, 16) and r.read(0) is not None
        with pytest.raises(mpeg4.UnsupportedVideo,
                           match="changes the frame size .16 x 16, then 2048 x 1024."):
            r.read(1)


@pytest.mark.parametrize("entry,name", [(b"avc1", "H.264"), (b"hvc1", "HEVC"),
                                        (b"av01", "AV1")])
def test_other_codecs_raise_naming_the_codec(tmp_path, entry, name):
    """A GoPro-like sample entry (write_box_mp4's boxes with another
    type): every reading function refuses it before it writes; H.264 and
    HEVC where NVDEC is asked for (the software decoders read them by
    default), because NVDEC decodes on the card only, and so not on the
    CPU; AV1 because the port does not decode it."""
    path = str(tmp_path / "cam1.mp4")
    tsyn.write_box_mp4(path, (64, 48), 119.88, 4)
    data = open(path, "rb").read()
    open(path, "wb").write(data.replace(b"mp4v", entry))
    markers = tsyn.cheetah.get_markers()
    tdata.save_dlc_points_h5(str(tmp_path / "labels_cam1.h5"), np.zeros((4, 20, 2)),
                             np.ones((4, 20)), markers)
    reason = (f"{name}: NVDEC decodes it on the card only, not on cpu (decoder='software' "
              "reads it on the host)" if entry in (b"avc1", b"hvc1")
              else f"{name}: the port decodes mp4v, H.264 and HEVC only")
    kw = dict(decoder="nvdec") if entry in (b"avc1", b"hvc1") else {}
    for call in (lambda: tvideo.open_video(path, device="cpu", **kw),
                 lambda: tvideo.create_labeled_videos([path], str(tmp_path), device="cpu", **kw),
                 lambda: tvideo.get_frames(path, [0], out_dir=str(tmp_path / "frames"),
                                           device="cpu", **kw)):
        with pytest.raises(mpeg4.UnsupportedVideo) as err:
            call()
        assert err.value.reason == reason and path in str(err.value)
    assert sorted(os.listdir(tmp_path)) == ["cam1.mp4", "labels_cam1.h5"]
