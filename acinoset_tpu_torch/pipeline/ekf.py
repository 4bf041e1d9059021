"""Measurement functions of the EKF/FTE pipeline on torch tensors, the
counterpart of the array functions of acinoset_tpu.pipeline.ekf
(the EKF itself is not ported yet).

Every measurement function maps poses (..., 25) with any leading batch
dimensions through FK and the fisheye rig.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..models import cheetah
from ..ops import camera as cam_ops
from ..utils.device import resolve_device


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


def make_h_fn(k_arr, d_arr, r_arr, t_arr, dtype=torch.float64, device=None):
    """pose25 (..., 25) -> predicted pixels (..., C, L, 2) through FK and
    the fisheye projection, with the rig on ``device`` (CUDA unless given)."""
    k, d, r, t = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)

    def h(pose25):
        pts = cheetah.fk25(pose25)[..., None, :, :]  # (..., 1, L, 3)
        return cam_ops.project_points_fisheye(
            pts, k[:, None], d[:, None], r[:, None], t[:, None]
        )

    return h


def hj_parts_aux(pose25, aux):
    """Measurement pieces with the rig as an argument: ``aux = (K, D, R, T)``
    with leading dimensions that broadcast against the poses' (for
    per-run rigs). Returns (h (..., C*L*2), Jp (..., C, L, 2, 3),
    Jfk (..., L, 3, 25))."""
    K, D, R, T = aux
    D = D.reshape(*K.shape[:-2], -1)[..., :4]
    pts, Jfk = cheetah.fk25_and_jac(pose25)
    h, Jp = cam_ops.project_rig_and_jac(pts, K, D, R, T)
    return h.reshape(*h.shape[:-3], -1), Jp, Jfk


def make_hj_parts_fn(k_arr, d_arr, r_arr, t_arr, dtype=torch.float64, device=None):
    """Chain-rule measurement Jacobian, unassembled, for
    ``solvers.trajopt.fte_solve``: poses (..., 25) -> (h (..., C*L*2),
    Jp (..., C, L, 2, 3), Jfk (..., L, 3, 25)). The full J = Jp @ Jfk is
    never formed: the solver assembles H = Jfk^T A Jfk from (3, 3)
    per-marker cores. The rig lives on ``device`` (CUDA unless given)."""
    aux = convert.rig_to_torch(k_arr, d_arr, r_arr, t_arr, resolve_device(device), dtype)

    def hj_parts(pose25):
        return hj_parts_aux(pose25, aux)

    return hj_parts
