"""Rendered calibration frames for the port's image tests
(tests/test_torch_corners.py, tests/test_torch_calib_app.py): a small
fisheye camera at 640 x 480 (tests/test_calib.py's D) and a 3-camera
chained rig that sees every board, rendered on the CPU by
acinoset_tpu_torch.utils.synthetic (2x supersampled, 2 grey levels of
noise), seeded; and the helpers the calibration app's tests share."""
import contextlib
import io

import numpy as np
import torch

from acinoset_tpu_torch.ops import camera as tcam
from acinoset_tpu_torch.utils import synthetic as tsyn

K = np.array([[300.0, 0, 320.0], [0, 300.0, 240.0], [0, 0, 1.0]])
D = tsyn.FISHEYE_D
RES = (640, 480)
BOARD = (9, 6)
SQUARE = 0.04
#: board poses in the first camera's frame: near (0.55-0.8 m), so that a
#: square spans ~15-20 px
POSES = dict(rot_scale=0.25, t_range=((-0.15, 0.1), (-0.15, 0.0), (0.55, 0.8)))
#: each camera of the rig relative to the one before: X_next = R X + t
RIG_RVEC = np.array([0.02, 0.25, 0.01])
RIG_T = np.array([-0.2, 0.0, 0.02])


def rig(n_cams):
    """Each camera's pose (R, t) relative to the first."""
    r = tsyn._rot(RIG_RVEC)
    cams = [(np.eye(3), np.zeros(3))]
    for _ in range(n_cams - 1):
        R, t = cams[-1]
        cams.append((r @ R, r @ t + RIG_T))
    return cams


def render(n_views, n_cams=1, seed=0, poses=None):
    """RGB uint8 frames (n_cams, n_views, H, W, 3) of the board at
    n_views poses (POSES' rule, or ``poses``), each seen by every camera
    of rig(n_cams), and the true corners (n_cams, n_views, 54, 2)."""
    rng = np.random.default_rng(seed)
    poses = poses or tsyn.board_poses(rng, n_views, **POSES)
    rays = tsyn.fisheye_rays(K, D, RES, "cpu")
    gen = torch.Generator().manual_seed(seed)
    obj = torch.as_tensor(tsyn.create_board_object_pts(BOARD, SQUARE), dtype=torch.float64)
    frames, truth = [], []
    for Rc, tc in rig(n_cams):
        frames.append([tsyn.render_board_frame(rays, Rc @ Rb, Rc @ tb + tc, gen).numpy()
                       for Rb, tb in poses])
        truth.append([tcam.project_points_fisheye(obj, K, D, Rc @ Rb, Rc @ tb + tc).numpy()
                      for Rb, tb in poses])
    return np.array(frames), np.array(truth)


def grey64(frames):
    """The JAX package's host grayscale (BGR weights on RGB, /255) of
    frames (..., H, W, 3), in float64."""
    return (frames @ np.array([0.114, 0.587, 0.299])) / 255.0


# ---- the calibration app's scene (tests/test_torch_calib_app.py,
# tests/test_torch_calib_cli.py) ----

N_CAMS, N_VIEWS, RIG_SEED = 3, 6, 1  # seed 1: every board found, within 0.5 px


def write_rig(root):
    """Render rig(N_CAMS)'s frames of N_VIEWS boards (RIG_SEED) as PNGs,
    <root>/extrinsic_calib/frames/<cam>/<view>.png, cameras from 1.
    Returns the true corners (N_CAMS, N_VIEWS, 54, 2)."""
    frames, truth = render(N_VIEWS, N_CAMS, RIG_SEED)
    for c in range(N_CAMS):
        d = root / "extrinsic_calib" / "frames" / str(c + 1)
        d.mkdir(parents=True)
        for v in range(N_VIEWS):
            tsyn.write_png(str(d / f"{v}.png"), frames[c, v])
    return truth


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def same_camera(got, want, rtol=1e-8):
    """(k, d, resolution) of two camera files: K and D at rtol."""
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=rtol * np.abs(want[1]).max())
    assert got[2] == want[2]


def same_scene(got, want, atol):
    """(k, d, r, t, resolution) of two scene files: K and D at 1e-8, R
    and t at atol."""
    same_camera(got[:2] + got[4:], want[:2] + want[4:])
    np.testing.assert_allclose(got[2], want[2], atol=atol)
    np.testing.assert_allclose(got[3], want[3], atol=atol)
