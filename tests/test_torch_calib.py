"""The port's calibration slice, part 1 (acinoset_tpu_torch.calib.pnp,
the fisheye calibrations of calib.intrinsics and calib.extrinsics)
against the JAX package's, in float64 on the CPU, with the same seeded
numpy inputs on both sides (tests/sba_calib_cases.py); and every numpy
entry point of the SBA and calibration slice refusing to fall back to
the CPU.

Tolerances: the closed forms of pnp at 1e-10; calibrate_fisheye_camera's
K and D at 1e-8 (relative) with `used` equal; the pair's R and t at 1e-8.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sba_calib_cases as cases
from acinoset_tpu.calib import extrinsics as jext
from acinoset_tpu.calib import intrinsics as jint
from acinoset_tpu.calib import pnp as jpnp
from acinoset_tpu_torch.calib import extrinsics as text
from acinoset_tpu_torch.calib import intrinsics as tint
from acinoset_tpu_torch.calib import pnp as tpnp
from acinoset_tpu_torch.pipeline import sba as tsba
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-10)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


# ---- pnp ----

def test_pnp_matches_jax():
    """homography_dlt (batched over frames), zhang_intrinsics with the
    principal point fixed and free, pose_from_homography and
    board_pose_fisheye, at 1e-10; H is normalised by H[2, 2], so the
    eigenvector's free sign cancels."""
    obj, img, res = cases.fisheye_intrinsics_case()
    obj2 = obj[:, :2].astype(np.float64)
    Hj = np.asarray(jax.vmap(lambda p: jpnp.homography_dlt(jnp.asarray(obj2), p))(img))
    Ht = tpnp.homography_dlt(T(obj2), T(img)).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-10, atol=1e-10 * np.abs(Hj).max())
    pp = (res[0] / 2.0, res[1] / 2.0)
    Kj = np.asarray(jpnp.zhang_intrinsics(jnp.asarray(Hj), fix_principal_point=pp))
    np.testing.assert_allclose(tpnp.zhang_intrinsics(T(Hj), fix_principal_point=pp).numpy(), Kj,
                               **TOL)
    np.testing.assert_allclose(tpnp.zhang_intrinsics(T(Hj)).numpy(),
                               np.asarray(jpnp.zhang_intrinsics(jnp.asarray(Hj))), rtol=1e-10,
                               atol=1e-10 * np.abs(Kj).max())
    Rj, tj = jax.vmap(lambda H: jpnp.pose_from_homography(H, jnp.asarray(Kj)))(jnp.asarray(Hj))
    Rt, tt = tpnp.pose_from_homography(T(Hj), T(Kj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL)
    K, D = tsyn.FISHEYE_K, tsyn.FISHEYE_D
    Rj, tj = jax.vmap(lambda p: jpnp.board_pose_fisheye(jnp.asarray(obj2), p, K, D))(img)
    Rt, tt = tpnp.board_pose_fisheye(T(obj2), T(img), T(K), T(D))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL)


# ---- intrinsics ----

@pytest.fixture(scope="module")
def jax_fisheye():
    """The JAX package's calibrate_fisheye_camera (F = 12, view 5
    corrupted) and fisheye pair calibration (F = 8, 40 iterations) on the
    golden file's inputs."""
    obj, img, res = cases.fisheye_intrinsics_case()
    obj_p, p1, p2, K, D = cases.fisheye_pair_case()
    return (quiet(jint.calibrate_fisheye_camera, obj, img, res),
            jext.calibrate_pair_extrinsics_fisheye(obj_p, p1, p2, K, D, K, D, res, num_iters=40))


def test_calibrate_fisheye_camera_matches_jax(jax_fisheye):
    obj, img, res = cases.fisheye_intrinsics_case()
    want = jax_fisheye[0]
    got = quiet(tint.calibrate_fisheye_camera, obj, img, res, device="cpu")
    np.testing.assert_array_equal(got.used, want.used)
    assert not got.used[5] and got.used.sum() == 11  # the drop round ran
    np.testing.assert_allclose(got.k, np.asarray(want.k), rtol=1e-8)
    wd = np.asarray(want.d)
    np.testing.assert_allclose(got.d, wd, rtol=1e-8, atol=1e-8 * np.abs(wd).max())
    for key in ("rms", "frame_rms"):
        np.testing.assert_allclose(getattr(got, key), np.asarray(getattr(want, key)), rtol=1e-8)
    np.testing.assert_allclose(got.rvecs, np.asarray(want.rvecs), atol=1e-8)
    np.testing.assert_allclose(got.tvecs, np.asarray(want.tvecs), atol=1e-8)


def test_calibrate_pair_extrinsics_fisheye_matches_jax(jax_fisheye):
    obj, p1, p2, K, D = cases.fisheye_pair_case()
    rms, R, t = text.calibrate_pair_extrinsics_fisheye(obj, p1, p2, K, D, K, D, tsyn.FISHEYE_RES,
                                                       num_iters=40, device="cpu")
    want = jax_fisheye[1]
    np.testing.assert_allclose(R, np.asarray(want[1]), atol=1e-8)
    np.testing.assert_allclose(t, np.asarray(want[2]), atol=1e-8)
    np.testing.assert_allclose(rms, np.asarray(want[0]), rtol=1e-8)
    np.testing.assert_allclose(R, tsyn._rot(tsyn.PAIR_RVEC), atol=2e-3)  # tests/test_calib.py's


def test_jax_package_still_reproduces_golden_calibration(jax_fisheye):
    """The golden file's calibration keys: its inputs are the cases' (the
    same seeds), and the JAX package's outputs on them (the fixture's)
    agree with the committed ones at the port's tolerances."""
    import test_torch_lm_sba as lm_sba

    golden = dict(np.load(chip_smoke.GOLDEN_SBA))
    obj, img, res = cases.fisheye_intrinsics_case()
    obj_p, p1, p2, K, D = cases.fisheye_pair_case()
    for key, a in dict(fi_obj=obj, fi_img=img, fi_res=np.asarray(res), fp_obj=obj_p, fp_p1=p1,
                       fp_p2=p2, fp_K=K, fp_D=D).items():
        np.testing.assert_array_equal(golden[key], a, err_msg=key)
    worst = chip_smoke.golden_sba_compare(lm_sba.jax_golden_calib(*jax_fisheye), golden)
    assert len(worst) == 9


# ---- no silent CPU fallback ----

def _sba_args():
    px, valid, cams, _ = cases.sba_scene()
    return px[:, :2], valid[:, :2], *cams


def _board():
    obj, p1, p2, K, D = cases.fisheye_pair_case(F=4)
    return obj, p1, p2, K, D


def _chain():
    obj, img, names, _rev, ks, ds, R, Tt = cases.chain_case(n_cams=2, n_views=4, reversed_views=0)
    return img, names, ks, ds, list(R), list(Tt)


ENTRY_POINTS = {
    "sba_run": lambda: tsba.sba_run(*_sba_args()),
    "calibrate_fisheye_camera": lambda: tint.calibrate_fisheye_camera(
        *cases.fisheye_intrinsics_case()),
    "calibrate_camera": lambda: tint.calibrate_camera(*tsyn.pinhole_views(), tsyn.PINHOLE_RES),
    "calibrate_pair_extrinsics_fisheye": lambda: text.calibrate_pair_extrinsics_fisheye(
        *_board()[:3], *_board()[3:], *_board()[3:], tsyn.FISHEYE_RES),
    "calibrate_pair_extrinsics": lambda: text.calibrate_pair_extrinsics(
        *tsyn.pinhole_pair_views(), *[tsyn.PINHOLE_K, tsyn.PINHOLE_PAIR_D] * 2, tsyn.PINHOLE_RES),
    "_align_pair_orderings": lambda: text._align_pair_orderings(*_board(), *_board()[3:]),
    "calibrate_pairwise_extrinsics": lambda: text.calibrate_pairwise_extrinsics(
        text.calibrate_pair_extrinsics_fisheye, *_chain()[:4], tsyn.FISHEYE_RES, (9, 6), 0.04),
    "prepare_calib_board_data": lambda: text.prepare_calib_board_data(
        *_chain()[:2], (9, 6), *_chain()[2:]),
    "bundle_adjust_board_points_and_extrinsics": lambda: (
        text.bundle_adjust_board_points_and_extrinsics(*_chain()[:2], (9, 6), *_chain()[2:])),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_and_cuda_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
