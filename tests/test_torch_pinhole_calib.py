"""The port's pinhole calibrations (acinoset_tpu_torch.calib.intrinsics.
calibrate_camera and calib.extrinsics.calibrate_pair_extrinsics) against
the JAX package's, in float64 on the CPU, at tests/test_pinhole_calib.py's
shapes, with the same seeded numpy inputs on both sides
(acinoset_tpu_torch.utils.synthetic's pinhole views).

Tolerances: the pair's R and t at 1e-8. calibrate_camera's K at 1e-8,
but its 8-coefficient rational D is held by the final cost instead: its
numerator and denominator coefficients trade off almost freely on a
board this size (the JAX package's own D keeps moving between 40 and 60
iterations at an unchanged cost), so rounding alone moves D by far more
than 1e-8 while the RMS agrees.
"""
import numpy as np
import torch

from acinoset_tpu.calib import extrinsics as jext
from acinoset_tpu.calib import intrinsics as jint
from acinoset_tpu_torch.calib import extrinsics as text
from acinoset_tpu_torch.calib import intrinsics as tint
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)


def test_calibrate_camera_matches_jax():
    """Pinhole: K at 1e-8, the RMS at 1e-8 (relative) in place of D (see
    the module docstring), rvecs and tvecs at 1e-6."""
    obj, views = tsyn.pinhole_views()
    res = tsyn.PINHOLE_RES
    want = [np.asarray(a) for a in jint.calibrate_camera(obj, views, res)]
    got = tint.calibrate_camera(obj, views, res, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-8)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    assert got[1].shape == (8,) and float(got[4]) < 0.5
    np.testing.assert_allclose(got[0][0, 0], tsyn.PINHOLE_K[0, 0], rtol=0.02)


def test_calibrate_pair_extrinsics_pinhole_matches_jax():
    obj, p1, p2 = tsyn.pinhole_pair_views()
    K, D, R_rel, t_rel = (tsyn.PINHOLE_K, tsyn.PINHOLE_PAIR_D, tsyn._rot(tsyn.PINHOLE_PAIR_RVEC),
                          tsyn.PINHOLE_PAIR_T)
    want = [np.asarray(a) for a in jext.calibrate_pair_extrinsics(obj, p1, p2, K, D, K, D,
                                                                   tsyn.PINHOLE_RES, num_iters=40)]
    rms, R, t = text.calibrate_pair_extrinsics(obj, p1, p2, K, D, K, D, tsyn.PINHOLE_RES,
                                               num_iters=40, device="cpu")
    np.testing.assert_allclose(R, want[1], atol=1e-8)
    np.testing.assert_allclose(t, want[2], atol=1e-8)
    np.testing.assert_allclose(rms, want[0], rtol=1e-8)
    np.testing.assert_allclose(R, R_rel, atol=3e-3)  # tests/test_pinhole_calib.py's bound
