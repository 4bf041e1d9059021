"""FTE pipeline for the cheetah model, the counterpart of
acinoset_tpu.pipeline.fte: default config, the linear-regression initial
trajectory, one run's solve (``fte_run``), and ``fte``, the file level (a
run directory's DLC ``.h5`` files in; ``fte.pickle``, the per-camera
reprojections and the state plot ``fte.svg`` out)."""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from ..models import cheetah
from ..ops import camera as cam_ops
from ..solvers import trajopt
from ..utils.device import resolve_device
from . import app
from . import data as data_io
from .ekf import make_hj_parts_fn, nose_track_linreg
from .plots import plot_cheetah_states
from .tri import triangulate_run


def default_config(fps: float, num_iters: int = 60) -> trajopt.FteConfig:
    lo, hi = cheetah.pose_limits_25()
    return trajopt.FteConfig(
        Ts=1.0 / fps,
        q_var=tuple(cheetah.Q_VAR[cheetah.ACTIVE_IDX_ORDERED]),
        lo=tuple(lo),
        hi=tuple(hi),
        meas_std_px=cheetah.MEAS_STD_PX,
        redesc=(cheetah.REDESC_A, cheetah.REDESC_B, cheetah.REDESC_C),
        num_iters=num_iters,
        linear_solver="pcg",
    )


def _x0_from_tri(tri_pos: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """Nose-track linear regression -> straight-line x/y/z + initial yaw."""
    nose = cheetah.get_markers().index("nose")
    xs, xi, ys, yi, zs, zi = nose_track_linreg(tri_pos, frames, nose)
    X0 = np.zeros((len(frames), cheetah.N_ACTIVE))
    pp = cheetah.get_pose_params()
    f = frames.astype(np.float64)
    X0[:, pp["x_0"]] = f * xs + xi
    X0[:, pp["y_0"]] = f * ys + yi
    X0[:, pp["z_0"]] = f * zs + zi
    X0[:, pp["psi_0"]] = np.arctan2(ys, xs)
    return X0


def initial_trajectory(pixels, likelihood, k_arr, d_arr, r_arr, t_arr, frames, dlc_thresh,
                       device=None) -> np.ndarray:
    """Linear-regression init of one run (pixels (C, N, L, 2), likelihood
    (C, N, L)): the triangulated nose track gives a straight line in
    x/y/z and the initial yaw. Triangulates on ``device``."""
    tri_pos = triangulate_run(
        np.nan_to_num(pixels), np.nan_to_num(likelihood, nan=-1.0) > dlc_thresh,
        k_arr, d_arr, r_arr, t_arr, device=resolve_device(device),
    )
    return _x0_from_tri(tri_pos, frames)


def initial_trajectory_batch(pixels_b, likelihood_b, aux, frames, dlc_thresh,
                             device=None) -> list:
    """Batched initial_trajectory: one triangulation of all B runs on
    ``device``, then the numpy regression per run.

    pixels_b (B, C, N, L, 2); likelihood_b (B, C, N, L); aux (K, D, R, T)
    stacks, each (B, C, ...); frames (N,). Returns B (N, 25) float64 arrays."""
    device = resolve_device(device)
    px = torch.as_tensor(np.nan_to_num(np.asarray(pixels_b)), dtype=torch.float64,
                         device=device)
    ok = torch.as_tensor(np.nan_to_num(np.asarray(likelihood_b), nan=-1.0) > dlc_thresh,
                         device=device)
    cams = [torch.as_tensor(np.array(a, dtype=np.float64), device=device) for a in aux]
    tri = cam_ops.triangulate_pairwise_mean(px, ok, *cams)[0].cpu().numpy()
    return [_x0_from_tri(t, frames) for t in tri]


def fte_run(
    pixels: np.ndarray,  # (C, N, L, 2)
    likelihood: np.ndarray,  # (C, N, L)
    k_arr, d_arr, r_arr, t_arr,
    fps: float,
    dlc_thresh: float,
    frames: Optional[np.ndarray] = None,
    num_iters: int = 60,
    dtype=torch.float64,
    device=None,
    uncertainty: bool = False,
) -> Dict:
    """Solve one trajectory with the default config; returns positions,
    states and the solver status as numpy values. ``uncertainty`` adds
    the Laplace posterior (``fte_solve(compute_cov=True)``):
    ``marker_std`` (N, L, 3), per-marker 1-sigma error bars in metres,
    and ``pose_cov`` (N, P, P)."""
    device = resolve_device(device)
    C, N, L, _ = pixels.shape
    frames = frames if frames is not None else np.arange(N)
    cfg = default_config(fps, num_iters=num_iters)
    X0 = initial_trajectory(pixels, likelihood, k_arr, d_arr, r_arr, t_arr, frames,
                            dlc_thresh, device=device)
    hj_parts = make_hj_parts_fn(k_arr, d_arr, r_arr, t_arr, dtype, device)
    meas = torch.as_tensor(pixels.transpose(1, 0, 2, 3), dtype=dtype, device=device)
    lik = np.nan_to_num(likelihood.transpose(1, 0, 2), nan=-1.0)
    w_meas = torch.as_tensor((lik > dlc_thresh) / cfg.meas_std_px, dtype=dtype, device=device)
    X, info = trajopt.fte_solve(
        hj_parts, torch.as_tensor(X0, dtype=dtype, device=device)[None], meas[None],
        w_meas[None], cfg, compute_cov=uncertainty, device=device,
    )
    X = X[0]
    dx, ddx = trajopt.derivatives_from_trajectory(X, cfg.Ts)

    def host(t):
        return t.detach().cpu().numpy()

    converged = bool(info["converged"][0])
    print(f"FTE solve: cost {float(info['cost0'][0]):.1f} -> {float(info['cost'][0]):.1f} "
          f"(grad_norm {float(info['grad_norm'][0]):.3g}; "
          f"{'converged' if converged else 'NOT converged — raise num_iters'})")
    out = dict(
        positions=host(cheetah.fk25(X)),
        x=host(X),
        dx=host(dx),
        ddx=host(ddx),
        cost=float(info["cost"][0]),
        cost0=float(info["cost0"][0]),
        cost_history=host(info["cost_history"][0]),
        converged=converged,
        grad_norm=float(info["grad_norm"][0]),
    )
    if uncertainty:
        out["marker_std"] = host(info["marker_std"][0])
        out["pose_cov"] = host(info["pose_cov"][0])
        print(f"posterior marker std: median "
              f"{1e3 * float(np.median(out['marker_std'])):.1f} mm")
    return out


def fte(
    data_dir: str,
    start_frame: int,
    end_frame: int,
    dlc_thresh: float,
    out_dir: Optional[str] = None,
    save: bool = True,
    num_iters: int = 60,
    uncertainty: bool = False,
    device=None,
) -> Dict:
    """The CLI's ``fte`` stage on a run directory, on ``device`` (CUDA
    unless given), in float64. ``start_frame`` is 1-based; ``end_frame``
    -1 is the video's last frame. Writes ``<out_dir or data_dir/fte>/
    fte.pickle`` (the states in the reference's column order,
    ``cheetah.to_fte_order``; ``marker_std`` with ``uncertainty``),
    ``cheetah_reprojected_cam{c}.h5`` for every camera, and ``fte.svg``,
    the solved states against the frame index."""
    device = resolve_device(device)
    out_dir = out_dir or os.path.join(data_dir, "fte")
    dlc_dir = os.path.join(data_dir, "dlc")
    assert os.path.exists(dlc_dir), f"missing {dlc_dir}"

    k_arr, d_arr, r_arr, t_arr, cam_res, n_cams, scene_fpath = data_io.find_scene_file(
        data_dir, verbose=False
    )
    _res, fps, tot_frames, _ = app.get_vid_info(data_dir)
    if end_frame == -1:
        end_frame = tot_frames
    start0 = start_frame - 1

    fpaths = sorted(glob(os.path.join(dlc_dir, "*.h5")))
    markers = cheetah.get_markers()
    p2d = data_io.load_dlc_points(fpaths, markers=markers)
    win = p2d.window(start0, end_frame)

    result = fte_run(
        win.pixels, win.likelihood, k_arr, d_arr, r_arr, t_arr, fps, dlc_thresh,
        frames=win.frames, num_iters=num_iters, uncertainty=uncertainty, device=device,
    )
    if save:
        os.makedirs(out_dir, exist_ok=True)
        order = cheetah.FTE_SAVE_ORDER  # the reference's column order
        states = dict(
            x=result["x"][..., order], dx=result["dx"][..., order],
            ddx=result["ddx"][..., order],
            start_frame=start0,
            cost_history=result["cost_history"], scene_fpath=scene_fpath,
            dlc_thresh=dlc_thresh,
            cost=result["cost"], cost0=result["cost0"],
            converged=result["converged"], grad_norm=result["grad_norm"],
        )
        if uncertainty:
            states["marker_std"] = result["marker_std"]
        app.save_optimised_cheetah(
            result["positions"], os.path.join(out_dir, "fte.pickle"), extra_data=states
        )
        app.save_3d_cheetah_as_2d(
            result["positions"], out_dir, scene_fpath, markers,
            cam_ops.project_points_fisheye, start0, device=device,
        )
        plot_cheetah_states(result["x"], out_fpath=os.path.join(out_dir, "fte.svg"))
    return result
