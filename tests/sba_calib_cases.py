"""Seeded numpy inputs shared by the port's SBA and calibration tests
(tests/test_torch_lm_sba.py, tests/test_torch_calib.py,
tests/test_torch_extrinsics.py) and by the golden file
tests/golden/sba_calib_synthetic.npz that the first of them writes.
Each builder makes its data anew from its seed; the port's synthetic
module draws the same numbers as the JAX package's."""
import numpy as np

from acinoset_tpu_torch.calib.extrinsics import WORLD_R1
from acinoset_tpu_torch.utils import synthetic as tsyn


def sba_scene():
    """tests/test_sba.py's scene: 4 ring cameras, N = 20 frames (400
    points, each seen by all 4 cameras: an even count), 1 px noise, 3%
    outliers. Returns (pixels (C, N, L, 2), valid (C, N, L), (k, d, r, t),
    pts3d (N, L, 3))."""
    cams = tsyn.ring_cameras(n_cams=4)
    px, lik, pts3d = tsyn.render_measurements(tsyn.cheetah_gallop(N=20, fps=90.0), cams,
                                              noise_px=1.0, outlier_frac=0.03,
                                              bad_lik_frac=0.0, seed=4)
    return px, lik > 0.5, cams[:4], pts3d


def sba_scene_masked():
    """6 ring cameras, N = 10, 5% outliers, 10% low likelihood, and half
    the observations masked at random, so that some points are seen by
    fewer than 2 cameras; masked pixels are NaN where the likelihood is
    low (sba_run zeroes NaNs)."""
    cams = tsyn.ring_cameras(n_cams=6)
    px, lik, pts3d = tsyn.render_measurements(tsyn.cheetah_gallop(N=10, fps=90.0), cams,
                                              noise_px=1.0, outlier_frac=0.05,
                                              bad_lik_frac=0.1, seed=11)
    rng = np.random.default_rng(12)
    valid = (lik > 0.5) & (rng.random(lik.shape) > 0.5)
    px[lik < 0.5] = np.nan
    return px, valid, cams[:4], pts3d


def extrinsics_case():
    """tests/test_sba.py::test_sba_points_extrinsics_recovers_cameras'
    input: clean 0.5 px corners of 8 frames in 4 cameras (P = 160), the
    extrinsics of cameras 1-3 perturbed by 0.01 rad and 3 cm, the points
    by 5 cm. Returns (obs (P, C, 2), mask, k, d, r_pert, t_pert, x0)."""
    cams = tsyn.ring_cameras(n_cams=4)
    pixels, _lik, pts3d = tsyn.render_measurements(tsyn.cheetah_gallop(N=20, fps=90.0), cams,
                                                   noise_px=0.5, outlier_frac=0.0,
                                                   bad_lik_frac=0.0, seed=4)
    k_arr, d_arr, r_arr, t_arr, _res = cams
    C = len(k_arr)
    rng = np.random.default_rng(7)
    r_pert, t_pert = [r_arr[0]], [t_arr[0]]
    for c in range(1, C):
        r_pert.append(tsyn._rot(rng.normal(scale=0.01, size=3)) @ r_arr[c])
        t_pert.append(t_arr[c] + rng.normal(scale=0.03, size=(3, 1)))
    obs = pixels[:, :8].reshape(C, -1, 2).transpose(1, 0, 2)
    gt = pts3d[:8].reshape(-1, 3)
    x0 = gt + rng.normal(scale=0.05, size=gt.shape)
    return (obs, np.ones(obs.shape[:2], dtype=bool), k_arr, d_arr, np.stack(r_pert),
            np.stack(t_pert), x0)


def fisheye_intrinsics_case():
    """12 board views of tests/test_calib.py's fisheye by that test's
    rule, 0.2 px noise, seed 3, view 5 corrupted with 5 px noise so that
    the drop round runs. Returns (obj (M, 3), img (12, M, 2),
    resolution)."""
    rng = np.random.default_rng(3)
    obj, views = tsyn.board_views(
        rng, 12, [(tsyn.FISHEYE_K, tsyn.FISHEYE_D, np.eye(3), np.zeros(3))], **tsyn.FISHEYE_POSES)
    img = views[0]
    img[5] += rng.normal(scale=5.0, size=img[5].shape)
    return obj, img, tsyn.FISHEYE_RES


def fisheye_pair_case(F=8, seed=5):
    """tests/test_calib.py::test_stereo_pair_synthetic's pair: F shared
    views, 0.2 px noise. Returns (obj, p1, p2, K, D)."""
    rng = np.random.default_rng(seed)
    K, D = tsyn.FISHEYE_K, tsyn.FISHEYE_D
    obj, v = tsyn.board_views(rng, F, [(K, D, np.eye(3), np.zeros(3)),
                                       (K, D, tsyn._rot(tsyn.PAIR_RVEC), tsyn.PAIR_T)],
                              **tsyn.FISHEYE_POSES)
    return obj, v[0], v[1], K, D


def chain_case(n_cams=3, n_views=10, reversed_views=2, seed=9):
    """A chained fisheye rig of n_cams cameras, n_views board views a
    pair, the second camera's corners reversed in the first
    reversed_views views of each pair. Returns (obj, img_pts_arr,
    fnames_arr, reversed names, K list, D list, R_true, T_true)."""
    obj, img, names, rev = tsyn.chained_pair_views(np.random.default_rng(seed), n_cams, n_views,
                                                   reversed_views=reversed_views)
    R, T = tsyn.chained_rig(n_cams, WORLD_R1)
    return (obj, img, names, rev, [tsyn.FISHEYE_K] * n_cams, [tsyn.FISHEYE_D] * n_cams, R, T)
