"""The port's calibration slice, part 2 (acinoset_tpu_torch.calib.
extrinsics: the corner-ordering consensus, pairwise chaining, the board
data and the board bundle adjustment) against the
JAX package's, in float64 on the CPU, with the same seeded numpy inputs
on both sides (tests/sba_calib_cases.py): a 3-camera chained fisheye rig,
10 views a pair, 2 of the second camera's corner sets reversed in each.

Tolerances: the ordering search's keep mask
and fixed corners exactly equal; the chain's R and t at 1e-8; the board
data's obs and mask exactly equal and pts3d0 at 1e-9; the board bundle
adjustment's points, R and t at 1e-7.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import sba_calib_cases as cases
from acinoset_tpu.calib import extrinsics as jext
from acinoset_tpu.ops import camera as jcam
from acinoset_tpu_torch.calib import extrinsics as text
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
RES = tsyn.FISHEYE_RES


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _pair(i=0):
    """The chain case's pair (i, i+1): cam i's and cam i+1's views of it."""
    obj, img, names, rev, ks, ds, _R, _T = cases.chain_case()
    n = len(names[0])
    return obj, img[i][-n:], img[i + 1][:n], ks[i], ds[i], ks[i + 1], ds[i + 1]


def test_align_pair_orderings_matches_jax_and_finds_the_reversed_sets():
    obj, p1, p2, k1, d1, k2, d2 = _pair()
    want_p2, want_keep = jext._align_pair_orderings(obj, p1, p2, k1, d1, k2, d2)
    got_p2, got_keep = text._align_pair_orderings(obj, p1, p2, k1, d1, k2, d2, device="cpu")
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_array_equal(got_p2, want_p2)
    fixed = p2.copy()
    fixed[:2] = fixed[:2, ::-1]  # the chain case reverses the first 2 views of each pair
    np.testing.assert_array_equal(got_p2[got_keep], fixed[got_keep])
    assert got_keep[:2].any()  # a reversed set found (a set may also be dropped as inconsistent)


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's calibrate_pairwise_extrinsics on the 3-camera
    chain case, and its prepare_calib_board_data on the result (its
    per-frame triangulations compiled once with jax.jit: the same
    arithmetic, without retracing each call)."""
    obj, img, names, _rev, ks, ds, _R, _T = cases.chain_case()
    r_arr, t_arr = quiet(jext.calibrate_pairwise_extrinsics, jext.calibrate_pair_extrinsics_fisheye,
                         img, names, ks, ds, RES, (9, 6), 0.04)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("triangulate_points_fisheye", "project_points_fisheye"):
            mp.setattr(jext.cam_ops, name, jax.jit(getattr(jcam, name)))
        board = quiet(jext.prepare_calib_board_data, img, names, (9, 6), ks, ds, r_arr, t_arr)
    return [np.asarray(r) for r in r_arr], [np.asarray(t) for t in t_arr], board


def test_calibrate_pairwise_extrinsics_matches_jax(jax_chain):
    obj, img, names, _rev, ks, ds, R_true, T_true = cases.chain_case()
    r_arr, t_arr = quiet(text.calibrate_pairwise_extrinsics, text.calibrate_pair_extrinsics_fisheye,
                         img, names, ks, ds, RES, (9, 6), 0.04, device="cpu")
    np.testing.assert_allclose(np.array(r_arr), np.array(jax_chain[0]), atol=1e-8)
    np.testing.assert_allclose(np.array(t_arr), np.array(jax_chain[1]), atol=1e-8)
    np.testing.assert_array_equal(r_arr[0], text.WORLD_R1)
    np.testing.assert_allclose(np.array(r_arr), R_true, atol=5e-3)
    np.testing.assert_allclose(np.array(t_arr), T_true, atol=2e-2)


def test_prepare_calib_board_data_matches_jax(jax_chain):
    obj, img, names, rev, ks, ds, _R, _T = cases.chain_case()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        obs, mask, pts0 = text.prepare_calib_board_data(img, names, (9, 6), ks, ds, *jax_chain[:2],
                                                        device="cpu")
    want_obs, want_mask, want_pts0 = jax_chain[2]
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(obs, want_obs)
    np.testing.assert_allclose(pts0, want_pts0, rtol=1e-9, atol=1e-9)
    assert f"fixed {len(rev)} reversed corner set(s)" in out.getvalue()


def test_bundle_adjust_board_points_and_extrinsics_matches_jax(jax_chain):
    """Points, R and t at 1e-7 after the default 80 iterations; the JAX
    side's board data is the fixture's (prepare_calib_board_data is
    checked above)."""
    obj, img, names, _rev, ks, ds, _R, _T = cases.chain_case()
    r0, t0, board = jax_chain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jext, "prepare_calib_board_data", lambda *a, **k: board)
        want = jext.bundle_adjust_board_points_and_extrinsics(img, names, (9, 6), ks, ds, r0, t0)
    got = quiet(text.bundle_adjust_board_points_and_extrinsics, img, names, (9, 6), ks, ds, r0,
                t0, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-7)
    for key in ("before", "after"):
        np.testing.assert_allclose(got[3][key], np.asarray(want[3][key]), atol=1e-7)
