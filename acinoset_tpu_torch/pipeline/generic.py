"""Generic-skeleton FTE, the counterpart of acinoset_tpu.pipeline.generic
(the reference's src/build.py path for humans and new animals), with
``build_and_solve``, its file level.

The reference builder's weights (flat model weight 0.002, measurement
std 3 px, build.py:142,190), its L1 measurement loss (:299, realised as
Huber IRLS), its blanket +-pi/2 joint limits (:263-266) and its
forehead-track linear-regression init (:151-165), on the same banded
Gauss-Newton solver as the cheetah.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..models.skeleton import (
    SkeletonModel, build_skeleton_model, fk_and_jac_any, generic_pose_limits,
)
from ..solvers import trajopt
from ..utils.device import resolve_device
from . import data as data_io
from .ekf import RigFunction, make_h_fn_aux_generic, make_hj_parts_aux_generic, nose_track_linreg
from .tri import triangulate_run


def make_h_fn_generic(model: SkeletonModel, k_arr, d_arr, r_arr, t_arr, dtype=torch.float64,
                      device=None):
    """poses (..., n_pose) -> predicted pixels (..., C, R, 2) through the
    skeleton's FK and the fisheye rig, with the rig on ``device`` (CUDA
    unless given), as a ``pipeline.ekf.RigFunction``."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)
    return RigFunction(make_h_fn_aux_generic(model.fk), aux)


def make_hj_parts_fn_generic(model: SkeletonModel, k_arr, d_arr, r_arr, t_arr,
                             dtype=torch.float64, device=None):
    """Unassembled chain-rule measurement Jacobian of the skeleton for
    ``solvers.trajopt.fte_solve``: poses (..., n_pose) -> (h (..., C*R*2),
    Jp (..., C, R, 2, 3), Jfk (..., R, 3, n_pose)). The FK Jacobian is
    analytic for compat="tpu" skeletons and ``torch.func.jacfwd`` over the
    FK alone otherwise (``fk_and_jac_any``); the projection Jacobian is
    the closed form. The rig lives on ``device`` (CUDA unless given); a
    ``pipeline.ekf.RigFunction``."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)
    return RigFunction(make_hj_parts_aux_generic(fk_and_jac_any(model)), aux)


def generic_config(
    model: SkeletonModel,
    fps: float,
    num_iters: int = 60,
    model_err_weight: float = 0.002,
    meas_std_px: float = 3.0,
    huber_delta: float = 3.0,
) -> trajopt.FteConfig:
    """The reference builder's config for a skeleton. ``huber_delta``: the
    reference loss is pure L1 (build.py:299); the IRLS realisation is
    Huber with this transition point on the 1/R-scaled residual."""
    lo, hi = generic_pose_limits(model)
    # model_err_weight = 1/Q -> Q = 1/w (build.py:186-190)
    q = np.full(model.n_pose, 1.0 / model_err_weight)
    return trajopt.FteConfig(
        Ts=1.0 / fps,
        q_var=tuple(float(v) for v in q),
        lo=tuple(float(v) for v in lo),
        hi=tuple(float(v) for v in hi),
        meas_std_px=meas_std_px,
        redesc=(huber_delta, 10.0, 20.0),
        meas_loss="l1",
        num_iters=num_iters,
    )


def fte_generic_run(
    skel_dict: Dict,
    pixels: np.ndarray,  # (C, N, L, 2) in skeleton marker order
    likelihood: np.ndarray,  # (C, N, L)
    k_arr, d_arr, r_arr, t_arr,
    fps: float,
    dlc_thresh: float = 0.4,
    init_marker: str = "forehead",
    num_iters: int = 60,
    exclude_markers=("neck",),
    dtype=torch.float64,
    compat: str = "tpu",
    huber_delta: float = 3.0,
    device=None,
) -> Dict:
    """Solve one generic-skeleton trajectory on ``device`` (CUDA unless
    given; raises without CUDA when none is given). ``exclude_markers``
    get zero measurement weight (build.py skips the synthetic 'neck'
    marker, :121-129); names the model lacks are skipped. Returns
    positions, states, markers and the solver status as numpy values."""
    device = resolve_device(device)
    model = build_skeleton_model(skel_dict, compat=compat)
    C, N, L, _ = pixels.shape
    if L != model.n_markers:
        raise ValueError(f"pixels hold {L} markers, the skeleton {model.n_markers}")
    cfg = generic_config(model, fps, num_iters=num_iters, huber_delta=huber_delta)

    # init: the straight line of the triangulated init_marker track
    valid = np.nan_to_num(likelihood, nan=-1.0) > dlc_thresh
    tri_pos = triangulate_run(np.nan_to_num(pixels), valid, k_arr, d_arr, r_arr, t_arr, device)
    frames = np.arange(N)
    xs, xi, ys, yi, zs, zi = nose_track_linreg(tri_pos, frames, model.markers.index(init_marker))
    X0 = np.zeros((N, model.n_pose))
    f = frames.astype(np.float64)
    X0[:, 0] = f * xs + xi
    X0[:, 1] = f * ys + yi
    X0[:, 2] = f * zs + zi

    lik = np.nan_to_num(likelihood.transpose(1, 0, 2), nan=-1.0)
    w = (lik > dlc_thresh).astype(np.float64) / cfg.meas_std_px
    for m in exclude_markers or ():
        if m in model.markers:
            w[:, :, model.markers.index(m)] = 0.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    hj_parts = make_hj_parts_fn_generic(model, k_arr, d_arr, r_arr, t_arr, dtype, device)
    X, info = trajopt.fte_solve(hj_parts, t(X0)[None], t(pixels.transpose(1, 0, 2, 3))[None],
                                t(w)[None], cfg, device=device)
    X = X[0]
    dx, ddx = trajopt.derivatives_from_trajectory(X, cfg.Ts)

    def host(a):
        return a.detach().cpu().numpy()

    return dict(
        positions=host(model.fk(X)),
        x=host(X),
        dx=host(dx),
        ddx=host(ddx),
        markers=model.markers,
        cost=float(info["cost"][0]),
        cost0=float(info["cost0"][0]),
        converged=bool(info["converged"][0]),
        grad_norm=float(info["grad_norm"][0]),
    )


def build_and_solve(
    skeleton_fpath: str,
    project_dir: str,
    start_frame: int = 60,
    n_frames: int = 100,
    fps: float = 120.0,
    dlc_thresh: float = 0.4,
    out_fpath: Optional[str] = None,
    num_iters: int = 60,
    device=None,
) -> Dict:
    """The file-driven twin of src/build.py's __main__ (:483-497), on
    ``device`` (CUDA unless given): the skeleton pickle, the scene
    ``<project_dir>/data/4_cam_scene_static_sba.json`` and the DLC files
    ``<project_dir>/data/*.h5`` in; frames [start_frame, start_frame +
    n_frames) (0-based) solved; ``traj_results.pickle`` out (default
    ``<project_dir>/data/results/``)."""
    device = resolve_device(device)
    skel = data_io.load_skeleton(skeleton_fpath)
    model = build_skeleton_model(skel)
    scene_path = os.path.join(project_dir, "data", "4_cam_scene_static_sba.json")
    k_arr, d_arr, r_arr, t_arr, _res = data_io.load_scene(scene_path)
    fpaths = sorted(glob(os.path.join(project_dir, "data", "*.h5")))
    p2d = data_io.load_dlc_points(fpaths, markers=model.markers)
    win = p2d.window(start_frame, start_frame + n_frames)
    result = fte_generic_run(
        skel, win.pixels, win.likelihood, k_arr, d_arr.reshape(-1, 4), r_arr, t_arr,
        fps=fps, dlc_thresh=dlc_thresh, num_iters=num_iters, device=device,
    )
    out_fpath = out_fpath or os.path.join(project_dir, "data", "results", "traj_results.pickle")
    data_io.save_pickle(
        out_fpath,
        dict(
            positions=result["positions"], x=result["x"], dx=result["dx"],
            ddx=result["ddx"],
            # beyond the reference's schema (build.py:344-378): lets
            # `cli eval` align ground-truth windows and markers by name
            markers=result["markers"], start_frame=start_frame,
            scene_fpath=scene_path,
            converged=result["converged"], grad_norm=result["grad_norm"],
        ),
    )
    return result
