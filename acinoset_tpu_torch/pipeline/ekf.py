"""The EKF pipeline's array level on torch tensors, the counterpart of
acinoset_tpu.pipeline.ekf: the measurement functions shared with the
FTE, the per-marker error bars from a smoothed covariance, and
``run_cheetah_ekf``, the EKF + RTS smoother over one run with the
reference's initial covariance (AcinoSet src/all_optimizations.py:
713-731).

Every measurement function maps poses (..., 25) with any leading batch
dimensions through FK and the fisheye rig. ``ekf`` is the file level: a
run directory's DLC ``.h5`` files in, ``ekf.pickle`` and the state plot
``ekf.pdf`` (x and smoothed_x) out.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..models import cheetah
from ..ops import camera as cam_ops
from ..solvers import ekf as ekf_solver
from ..utils.device import resolve_device
from . import app
from . import data as data_io
from .plots import plot_cheetah_states
from .tri import triangulate_run


def nose_track_linreg(positions: np.ndarray, frames: np.ndarray, marker_idx: int):
    """Linear regression of a marker's triangulated track over frame
    index: (x_slope, x_int, y_slope, y_int, z_slope, z_int), NaN frames
    ignored (reference: scipy.stats.linregress)."""
    track = positions[:, marker_idx]  # (N, 3)
    ok = np.isfinite(track).all(axis=1)
    f = frames[ok].astype(np.float64)
    out = []
    for d in range(3):
        y = track[ok, d]
        if len(f) < 2:
            out.extend([0.0, float(np.nanmean(y)) if len(y) else 0.0])
            continue
        slope, intercept = np.polyfit(f, y, 1)
        out.extend([float(slope), float(intercept)])
    return tuple(out)


class RigFunction:
    """A measurement function with its camera rig bound: calling it on
    poses calls ``fn(pose, rig)``, ``rig = (K, D, R, T)`` with the
    cameras on axis -3 of K and R and axis -2 of D and T.
    ``on(device, cams)`` gives the same function over a copy of the rig
    on ``device``, cut to the cameras ``cams`` (a slice or indices): how
    ``parallel.mesh`` gives each shard its device and its own cameras."""

    def __init__(self, fn, rig):
        self.fn, self.rig = fn, tuple(rig)

    def __call__(self, pose):
        return self.fn(pose, self.rig)

    @property
    def n_cams(self) -> int:
        return self.rig[0].shape[-3]

    @property
    def device(self) -> torch.device:
        return self.rig[0].device

    def on(self, device, cams=slice(None)):
        K, D, R, T = (a.to(device) for a in self.rig)
        return RigFunction(self.fn, (K[..., cams, :, :], D[..., cams, :], R[..., cams, :, :],
                                     T[..., cams, :]))


def make_h_fn(k_arr, d_arr, r_arr, t_arr, dtype=torch.float64, device=None):
    """pose25 (..., 25) -> predicted pixels (..., C, L, 2) through FK and
    the fisheye projection, with the rig on ``device`` (CUDA unless
    given), as a ``RigFunction``."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)
    return RigFunction(h_aux, aux)


class _HAux:
    """``h(pose, aux)`` of ``make_h_fn_aux_generic``; it pickles when its
    FK does (a module's function, e.g. ``cheetah.fk25``)."""

    def __init__(self, fk):
        self.fk = fk

    def __call__(self, pose, aux):
        K, D, R, T = aux
        D = D.reshape(*K.shape[:-2], -1)[..., :4]
        pts = self.fk(pose)[..., None, :, :]  # (..., 1, L, 3)
        return cam_ops.project_points_fisheye(
            pts, K[..., None, :, :], D[..., None, :], R[..., None, :, :], T[..., None, :])


class _HJPartsAux:
    """``hj(pose, aux)`` of ``make_hj_parts_aux_generic``; it pickles when
    its FK with Jacobian does."""

    def __init__(self, fk_and_jac):
        self.fk_and_jac = fk_and_jac

    def __call__(self, pose, aux):
        K, D, R, T = aux
        D = D.reshape(*K.shape[:-2], -1)[..., :4]
        pts, Jfk = self.fk_and_jac(pose)
        h, Jp = cam_ops.project_rig_and_jac(pts, K, D, R, T)
        return h.reshape(*h.shape[:-3], -1), Jp, Jfk


def make_h_fn_aux_generic(fk):
    """Measurement function of any FK with the rig as an argument:
    ``h(pose (..., P), aux) -> pixels (..., C, L, 2)``, ``aux = (K, D, R,
    T)`` with leading dimensions that broadcast against the poses' (for
    per-run rigs)."""
    return _HAux(fk)


def make_hj_parts_aux_generic(fk_and_jac):
    """Measurement pieces of any FK with its Jacobian, the rig as an
    argument (see ``make_h_fn_aux_generic``): ``hj(pose (..., P), aux)
    -> (h (..., C*L*2), Jp (..., C, L, 2, 3), Jfk (..., L, 3, P))``."""
    return _HJPartsAux(fk_and_jac)


#: the cheetah's measurement pieces with the rig as an argument:
#: poses (..., 25) -> (h, Jp, Jfk (..., L, 3, 25))
hj_parts_aux = make_hj_parts_aux_generic(cheetah.fk25_and_jac)
#: the cheetah's pixels with the rig as an argument: poses (..., 25) ->
#: (..., C, L, 2)
h_aux = make_h_fn_aux_generic(cheetah.fk25)


def hj_aux(pose25, aux):
    """The cheetah's fused (h (..., C*L*2), J (..., C*L*2, 25)) with the
    rig as an argument."""
    return assemble_hj(*hj_parts_aux(pose25, aux))


def make_hj_parts_fn(k_arr, d_arr, r_arr, t_arr, dtype=torch.float64, device=None):
    """Chain-rule measurement Jacobian, unassembled, for
    ``solvers.trajopt.fte_solve``: poses (..., 25) -> (h (..., C*L*2),
    Jp (..., C, L, 2, 3), Jfk (..., L, 3, 25)). The full J = Jp @ Jfk is
    never formed: the solver assembles H = Jfk^T A Jfk from (3, 3)
    per-marker cores. The rig lives on ``device`` (CUDA unless given); a
    ``RigFunction``."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)
    return RigFunction(hj_parts_aux, aux)


def make_hj_fn(k_arr, d_arr, r_arr, t_arr, dtype=torch.float64, device=None):
    """Fused (pixels, Jacobian) by the chain rule, J = J_proj @ J_fk, for
    ``solvers.ekf.run_ekf``: poses (..., 25) -> (h (..., C*L*2),
    J (..., C*L*2, 25)), with the rig on ``device`` (CUDA unless given);
    a ``RigFunction``."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)
    return RigFunction(hj_aux, aux)


def assemble_hj(h, Jp, Jfk):
    """(h, Jp (..., C, L, 2, 3), Jfk (..., L, 3, 25)) -> (h, J (..., C*L*2, 25))."""
    J = torch.einsum("...clij,...ljk->...clik", Jp, Jfk)
    return h, J.reshape(*h.shape, -1)


def make_marker_std_fn(fk_and_jac, n_pose):
    """Per-frame per-marker 1-sigma error bars from a smoothed covariance:
    ``one(x (..., n_pose), Pf (..., S, S)) -> (..., L, 3)`` std in meters,
    sqrt(diag(J_fk Sigma_pose J_fk^T)) at the smoothed pose."""

    def one(x, Pf):
        _pts, J = fk_and_jac(x)  # (..., L, 3, n_pose)
        S = Pf[..., None, :n_pose, :n_pose]
        mc = J @ S @ J.mT
        return torch.sqrt(torch.clamp(torch.diagonal(mc, dim1=-2, dim2=-1), min=0.0))

    return one


def marker_std_from_smoothed(smoothed_x, smoothed_P, device=None) -> np.ndarray:
    """Per-marker 1-sigma position error bars (N, L, 3) in meters from the
    RTS-smoothed covariance (see make_marker_std_fn), in float64 on
    ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    one = make_marker_std_fn(cheetah.fk25_and_jac, cheetah.N_ACTIVE)
    x = torch.tensor(np.asarray(smoothed_x), dtype=torch.float64, device=device)
    P = torch.tensor(np.asarray(smoothed_P), dtype=torch.float64, device=device)
    return one(x, P).cpu().numpy()


def ekf_P0(n_pose: int) -> np.ndarray:
    """The reference's initial state covariance (:713-731)."""
    p_ang = np.ones(n_pose - 3)
    p_ang_acc = p_ang * 9.0
    p_ang_acc[10:] = 25.0
    return np.diag(np.concatenate([
        np.ones(3) * 9.0, p_ang * (np.pi / 4) ** 2,
        np.ones(3) * 25.0, p_ang * 9.0,
        np.ones(3) * 9.0, p_ang_acc,
    ]))


def run_cheetah_ekf(
    pixels: np.ndarray,  # (N, C, L, 2)
    likelihood: np.ndarray,  # (N, C, L)
    k_arr, d_arr, r_arr, t_arr,
    fps: float,
    cam_res,
    dlc_thresh: float,
    x0_pose: Optional[np.ndarray] = None,
    dtype=torch.float64,
    device=None,
) -> Dict:
    """EKF + RTS over one run on ``device`` (CUDA unless given). Returns
    the states dict of ``solvers.ekf.run_ekf`` as host numpy arrays
    ((N, 25) states, (N, 25, 25) pose covariances, outliers a scalar)."""
    device = resolve_device(device)
    n_pose = cheetah.N_ACTIVE
    cfg = ekf_solver.EkfConfig(
        dt=1.0 / fps,
        dlc_thresh=dlc_thresh,
        meas_std_px=cheetah.MEAS_STD_PX,
        max_pixel_err=float(cam_res[0]),
    )
    x0 = np.zeros(3 * n_pose)
    if x0_pose is not None:
        x0[: len(x0_pose)] = np.asarray(x0_pose).reshape(-1)[: 3 * n_pose]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    out = ekf_solver.run_ekf(
        make_hj_fn(k_arr, d_arr, r_arr, t_arr, dtype, device),
        t(pixels)[None], t(np.nan_to_num(likelihood, nan=-1.0))[None], t(x0)[None],
        t(ekf_P0(n_pose)), cheetah.EKF_QB, cfg,
    )
    return {k: v[0].cpu().numpy() for k, v in out.items()}


def ekf(
    data_dir: str,
    start_frame: int,
    end_frame: int,
    dlc_thresh: float,
    out_dir: Optional[str] = None,
    save: bool = True,
    device=None,
) -> Dict:
    """The CLI's ``ekf`` stage on a run directory, on ``device`` (CUDA
    unless given), in float64. ``start_frame`` is 1-based; ``end_frame``
    -1 is the video's last frame. The initial state comes from the line
    fit of the triangulated nose track (position, heading and velocity,
    the reference's :699-711). Writes ``<out_dir or data_dir/ekf>/
    ekf.pickle`` with the filtered and smoothed states and per-marker
    error bars, and ``ekf.pdf``, x and smoothed_x against the frame
    index."""
    device = resolve_device(device)
    out_dir = out_dir or os.path.join(data_dir, "ekf")
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
    assert len(fpaths) == n_cams, f"{len(fpaths)} dlc files != {n_cams} cams"
    markers = cheetah.get_markers()
    p2d = data_io.load_dlc_points(fpaths, markers=markers)
    win = p2d.window(start0, end_frame)

    tri_pos = triangulate_run(
        np.nan_to_num(win.pixels), win.valid(dlc_thresh), k_arr, d_arr, r_arr, t_arr, device
    )
    xi = cheetah.get_pose_params()
    x0_pose = np.zeros(cheetah.N_ACTIVE * 3)
    nose = markers.index("nose")
    xs, xi_, ys, yi_, _zs, _zi = nose_track_linreg(tri_pos, win.frames, nose)
    sT = 1.0 / fps
    x0_pose[xi["x_0"]] = start0 * xs + xi_
    x0_pose[xi["y_0"]] = start0 * ys + yi_
    x0_pose[xi["psi_0"]] = np.arctan2(ys, xs)
    v = cheetah.N_ACTIVE
    x0_pose[v + xi["x_0"]] = xs / sT
    x0_pose[v + xi["y_0"]] = ys / sT

    states = run_cheetah_ekf(
        win.pixels.transpose(1, 0, 2, 3),
        win.likelihood.transpose(1, 0, 2),
        k_arr, d_arr, r_arr, t_arr,
        fps, cam_res, dlc_thresh,
        x0_pose=x0_pose, device=device,
    )
    positions = cheetah.fk25(torch.as_tensor(states["smoothed_x"], device=device)).cpu().numpy()
    keep = dict(
        x=states["x"], dx=states["dx"], ddx=states["ddx"],
        smoothed_x=states["smoothed_x"], smoothed_dx=states["smoothed_dx"],
        smoothed_ddx=states["smoothed_ddx"],
        marker_std=marker_std_from_smoothed(states["smoothed_x"], states["smoothed_P"],
                                            device=device),
    )
    print("EKF complete!")
    print("Outliers ignored:", int(states["outliers"]))
    if save:
        os.makedirs(out_dir, exist_ok=True)
        app.save_ekf(keep, out_dir, scene_fpath, start0, dlc_thresh, positions=positions)
        plot_cheetah_states(keep["x"], keep["smoothed_x"], os.path.join(out_dir, "ekf.pdf"))
    return dict(positions=positions, states=keep, outliers=int(states["outliers"]))
