"""The port's checkerboard detector (acinoset_tpu_torch.calib.corners) and
its native engine binding (calib.native) against the JAX package's, on
frames rendered from a seed (tests/image_calib_cases.py), on the CPU.

Tolerances: the dense ops in float64 (JAX runs x64 here) at 1e-9 of
scale; find_corner_candidates identical, ties included; the float32
detector's corners within 1e-3 px; the two native bindings' grids
identical (both libraries built from native/corners.cpp with
native/Makefile's flags)."""
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_calib_cases as cases
from acinoset_tpu.calib import corners as jcorners
from acinoset_tpu.calib import native as jnative
from acinoset_tpu_torch.calib import corners as tcorners
from acinoset_tpu_torch.calib import native as tnative
from acinoset_tpu_torch.utils import _gxx
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1  # every board of the case found, within 0.5 px of the truth


@pytest.fixture(scope="module")
def frames():
    """Three rendered RGB frames and their true corners."""
    fr, truth = cases.render(3, seed=SEED)
    return fr[0], truth[0]


def _scale_close(got, want, rel=1e-9):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def test_saddle_response_matches_jax(frames):
    gray = cases.grey64(frames[0][:2])
    want = np.stack([np.asarray(jcorners.saddle_response(jnp.asarray(g))) for g in gray])
    got = tcorners.saddle_response(torch.as_tensor(gray)).numpy()
    _scale_close(got, want)


def _tie_image():
    """Two copies of one textured X-corner patch on a flat field, on one
    row, far enough apart that each copy's peaks tie exactly with the
    other's: the lower flat index (the left copy) must come first."""
    rng = np.random.default_rng(3)
    img = np.full((64, 96), 0.5)
    yy, xx = np.mgrid[-8:8, -8:8] + 0.3
    patch = 0.5 + 0.3 * np.sign(xx * yy) + 0.05 * rng.normal(size=xx.shape)
    img[20:36, 20:36] = patch
    img[20:36, 60:76] = patch
    return img


def test_find_corner_candidates_matches_jax_with_ties(frames):
    grays = [cases.grey64(f) for f in frames[0]] + [_tie_image()]
    for g in grays:
        jxy, jsc = (np.asarray(a) for a in jcorners.find_corner_candidates(jnp.asarray(g)))
        txy, tsc = (a.numpy() for a in tcorners.find_corner_candidates(torch.as_tensor(g)))
        np.testing.assert_array_equal(txy, jxy)
        _scale_close(tsc, jsc)
    # the constructed ties: scores in equal pairs, the left copy first
    peaks = tsc > 0
    assert peaks.sum() >= 4 and peaks.sum() % 2 == 0
    assert (tsc[peaks][0::2] == tsc[peaks][1::2]).all()
    assert (txy[peaks][0::2, 0] + 40 == txy[peaks][1::2, 0]).all()
    # a batch gives each frame's own candidates
    bxy, _ = tcorners.find_corner_candidates(torch.as_tensor(np.stack(grays[:2])))
    for i in range(2):
        np.testing.assert_array_equal(
            bxy[i].numpy(), tcorners.find_corner_candidates(torch.as_tensor(grays[i]))[0].numpy())


def test_refine_subpixel_matches_jax(frames):
    """From the true corners moved by up to 1.5 px, a batch of frames at
    once against the JAX package's per-frame vmap."""
    frames_, truth = frames
    rng = np.random.default_rng(0)
    gray = np.stack([cases.grey64(f) for f in frames_])
    start = truth + rng.uniform(-1.5, 1.5, truth.shape)
    want = np.stack([np.asarray(jcorners.refine_subpixel(jnp.asarray(g), jnp.asarray(s)))
                     for g, s in zip(gray, start)])
    got = tcorners.refine_subpixel(torch.as_tensor(gray), torch.as_tensor(start)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gray_keeps_the_jax_package_rules():
    """BGR weights on RGB arrays and /255 only where the maximum exceeds
    2, in float64, then float32: equal to the JAX package's host step."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (2, 30, 40, 3), dtype=np.uint8)
    low = rng.uniform(0, 1, (30, 40))  # max <= 2: no rescale
    got = tcorners._gray(list(rgb), "cpu").numpy()
    want = np.asarray(jnp.asarray(cases.grey64(rgb), jnp.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcorners._gray([low], "cpu")[0].numpy(), low.astype(np.float32))


def test_find_corners_matches_jax(frames):
    """The float32 detector on RGB uint8 frames, batched, against the JAX
    package's find_corners a frame: within 1e-3 px, and within 0.5 px of
    the truth."""
    frames_, truth = frames
    grids, found = tcorners.find_corners_batch(list(frames_), cases.BOARD, device="cpu")
    assert found.all()
    for f, g, t in zip(frames_, grids, truth):
        want, ok = jcorners.find_corners(f, cases.BOARD)
        assert ok and g.shape == want.shape == cases.BOARD + (2,)
        np.testing.assert_allclose(g, want, atol=1e-3)
        assert np.abs(np.sort(g.reshape(-1, 2), 0) - np.sort(t, 0)).max() < 0.5
    one, ok = tcorners.find_corners(frames_[0], cases.BOARD, device="cpu")
    assert ok
    np.testing.assert_array_equal(one, grids[0])
    blank = np.full_like(frames_[0], 128)
    assert tcorners.find_corners(blank, cases.BOARD, device="cpu") == (None, False)


def _write_frames(tmp_path, frames_):
    paths = []
    for i, f in enumerate(frames_):
        paths.append(str(tmp_path / f"{i}.png"))
        tsyn.write_png(paths[-1], f)
    return paths


def test_find_corners_images_matches_jax(tmp_path, frames):
    """PNG files through find_corners_images, a frame without a board
    among them; the engine choices the port refuses."""
    frames_, _ = frames
    paths = _write_frames(tmp_path, list(frames_) + [np.full_like(frames_[0], 128)])
    pts, names, res = tcorners.find_corners_images(paths, cases.BOARD, verbose=False,
                                                   device="cpu")
    jpts, jnames, jres = jcorners.find_corners_images(paths, cases.BOARD, verbose=False,
                                                      engine="jax")
    assert names == jnames == ["0.png", "1.png", "2.png"] and res == jres == cases.RES
    np.testing.assert_allclose(pts, jpts, atol=1e-3)
    with pytest.raises(ValueError, match="does not pick an engine"):
        tcorners.find_corners_images(paths, cases.BOARD, engine="auto", device="cpu")
    jpg = str(tmp_path / "frame.jpg")
    with pytest.raises(ValueError, match="frame.jpg: JPEG frames cannot be read"):
        tcorners.find_corners_images(paths + [jpg], cases.BOARD, device="cpu")
    small = str(tmp_path / "small.png")
    tsyn.write_png(small, frames_[0][:100])
    with pytest.raises(ValueError, match="Inconsistent image resolutions"):
        tcorners.find_corners_images(paths + [small], cases.BOARD, device="cpu")


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library, built by native/Makefile into a
    private directory (the repository's native/ stays as it is)."""
    out = tmp_path_factory.mktemp("native")
    subprocess.run(["make", "-s", "-C", str(out), "-f", os.path.join(REPO, "native", "Makefile"),
                    f"VPATH={os.path.join(REPO, 'native')}"], check=True, timeout=300)
    return str(out / "libacinoset_native.so")


def test_native_binding_matches_jax_binding(monkeypatch, tmp_path, frames, jax_native_lib):
    frames_, _ = frames
    monkeypatch.setenv("ACINOSET_NATIVE_LIB", jax_native_lib)
    monkeypatch.setattr(jnative, "_SEARCHED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    assert jnative.available()
    imgs = list(frames_) + [np.full_like(frames_[0], 128)]
    g_t, ok_t = tnative.find_corners_batch(imgs, cases.BOARD)
    g_j, ok_j = jnative.find_corners_batch(imgs, cases.BOARD)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(g_t, g_j)
    assert ok_t.tolist() == [True, True, True, False]
    one, ok = tnative.find_corners(imgs[1], cases.BOARD)
    assert ok
    np.testing.assert_array_equal(one, jnative.find_corners(imgs[1], cases.BOARD)[0])
    # through find_corners_images; and against the device detector by
    # tests/test_native.py's rule
    paths = _write_frames(tmp_path, imgs)
    pts, names, _ = tcorners.find_corners_images(paths, cases.BOARD, verbose=False,
                                                 engine="native")
    jpts, jnames, _ = jcorners.find_corners_images(paths, cases.BOARD, verbose=False,
                                                   engine="native")
    assert names == jnames
    np.testing.assert_array_equal(pts, jpts)
    dev, _ = tcorners.find_corners_batch(imgs[:3], cases.BOARD, device="cpu")
    assert np.median(np.linalg.norm(pts - dev, axis=-1)) < 0.3


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ refuses raises, naming it; nothing is looked for
    elsewhere."""
    broken = tmp_path / "corners.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "libacinoset_native.so")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on corners.cpp"):
        tnative.find_corners(np.zeros((32, 32)), cases.BOARD)
    monkeypatch.setattr(_gxx.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ is not on PATH"):
        tnative.find_corners(np.zeros((32, 32)), cases.BOARD)
