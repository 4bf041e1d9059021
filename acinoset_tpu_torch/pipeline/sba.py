"""SBA, sparse bundle adjustment over the marker points of a run, the
counterpart of acinoset_tpu.pipeline.sba (the reference's ``sba()`` entry
point, AcinoSet src/all_optimizations.py:868-895).

Every (frame, marker) seen by >= 2 cameras becomes a 3D point,
initialised from the camera pair whose triangulation reprojects best,
then refined against all observing cameras under a Cauchy loss
(f_scale 50) with the cameras fixed: one batched LM over the points
(solvers.lm.sba_points).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import rig_to_torch
from ..models import cheetah
from ..ops import camera as cam_ops
from ..solvers import lm
from ..utils.device import resolve_device
from . import app
from . import data as data_io


def _nanmedian(x, dim=-1):
    """``jnp.nanmedian``: the median of the non-NaN values along ``dim``,
    the mean of the two middle ones for an even count (torch.nanmedian
    takes the lower one), NaN where there is none. The same arithmetic as
    JAX's linear-interpolation quantile."""
    s = torch.sort(x, dim=dim).values  # NaN last
    n = (~torch.isnan(x)).sum(dim, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w

    def at(i):
        i = torch.clamp(torch.minimum(i, n - 1.0), min=0.0).long()
        return torch.gather(s, dim, i)

    return (at(low) * low_w + at(high) * high_w).squeeze(dim)


def _pair_candidates(pixels, valid, k_arr, d_arr, r_arr, t_arr):
    """Every camera pair's DLT triangulation of every point and its score,
    the median reprojection error over the observing cameras (1e12 where
    the pair does not both see the point). pixels (C, N, L, 2), valid
    (C, N, L) and the rig as tensors. Returns (tris (n_pairs, N*L, 3),
    scores (n_pairs, N*L), seen (N*L,)), pairs (i, j), i < j, in
    lexicographic order."""
    C, N, L, _ = pixels.shape
    ab = cam_ops.undistort_points_fisheye(pixels.reshape(C, -1, 2), k_arr[:, None], d_arr[:, None])
    abT = ab.reshape(C, N * L, 2).transpose(0, 1)  # (Npts, C, 2)
    pixT = pixels.reshape(C, N * L, 2).transpose(0, 1)
    vT = valid.reshape(C, N * L).transpose(0, 1)  # (Npts, C)
    P_mats = cam_ops._projection(r_arr, t_arr)  # (C, 3, 4)

    pairs = torch.triu_indices(C, C, offset=1, device=pixels.device)  # (2, n_pairs)
    i, j = pairs[0], pairs[1]
    tris = cam_ops._dlt_one(abT[:, i].transpose(0, 1), abT[:, j].transpose(0, 1),
                            P_mats[i, None], P_mats[j, None])  # (n_pairs, Npts, 3)
    proj = cam_ops.project_points_fisheye(
        tris[:, None], k_arr[None, :, None], d_arr[None, :, None], r_arr[None, :, None],
        t_arr[None, :, None])  # (n_pairs, C, Npts, 2)
    diff = proj.transpose(1, 2) - pixT
    err = torch.sqrt((diff * diff).sum(-1))  # (n_pairs, Npts, C)
    err = torch.where(vT, err, float("nan"))
    ok = (vT[:, i] & vT[:, j]).transpose(0, 1)
    scores = torch.where(ok, _nanmedian(err, -1), 1e12)
    return tris, scores, vT.sum(1) >= 2


def _robust_triangulation_init(pixels, valid, k_arr, d_arr, r_arr, t_arr):
    """Initialise each (frame, marker): triangulate every camera pair and
    keep, per point, the candidate whose median reprojection error over
    all observing cameras is smallest (a RANSAC-lite replacement for the
    reference's first-two-cameras init, which one outlier derails).
    pixels (C, N, L, 2), valid (C, N, L) and the rig as tensors. Returns
    ((N, L, 3) init, zero where < 2 views, seen (N, L))."""
    C, N, L, _ = pixels.shape
    tris, scores, seen = _pair_candidates(pixels, valid, k_arr, d_arr, r_arr, t_arr)
    best = torch.argmin(scores, dim=0)  # (Npts,)
    pts = torch.take_along_dim(tris, best[None, :, None], dim=0)[0]
    pts = torch.where(seen[:, None], pts, 0.0)
    return pts.reshape(N, L, 3), seen.reshape(N, L)


def sba_run(
    pixels: np.ndarray,  # (C, N, L, 2)
    valid: np.ndarray,  # (C, N, L) bool
    k_arr, d_arr, r_arr, t_arr,
    f_scale: float = 50.0,
    num_iters: int = 30,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """The functional core of the SBA stage, in the dtype of ``pixels``
    on ``device`` (``cuda`` unless given). Returns (positions (N, L, 3),
    NaN where unseen, dict(before, after) of the reprojection residuals),
    as numpy."""
    device = resolve_device(device)
    C, N, L, _ = pixels.shape
    px = torch.as_tensor(np.nan_to_num(pixels), device=device)
    ok = torch.as_tensor(np.asarray(valid), device=device)
    rig = rig_to_torch(k_arr, d_arr, r_arr, t_arr, device, dtype=px.dtype)
    x0, seen = _robust_triangulation_init(px, ok, *rig)

    obs = px.permute(1, 2, 0, 3).reshape(-1, C, 2)  # (N*L, C, 2)
    mask = ok.permute(1, 2, 0).reshape(-1, C) & seen.reshape(-1)[:, None]
    pts, residuals = lm.sba_points(obs, mask, *rig, x0.reshape(-1, 3),
                                   f_scale=f_scale, num_iters=num_iters)
    positions = pts.reshape(N, L, 3).cpu().numpy().copy()
    positions[~seen.cpu().numpy()] = np.nan
    return positions, {k: v.cpu().numpy() for k, v in residuals.items()}


def sba_points_fisheye(scene_fpath: str, p2d: data_io.Points2D, dlc_thresh: float = 0.5,
                       device=None):
    """``sba_run`` on a scene file's rig and a Points2D's detections above
    ``dlc_thresh`` (the reference's lib.app.sba_points_fisheye), on
    ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    k_arr, d_arr, r_arr, t_arr, _cam_res = data_io.load_scene(scene_fpath)
    return sba_run(p2d.pixels, p2d.valid(dlc_thresh), k_arr, d_arr.reshape(-1, 4), r_arr, t_arr,
                   device=device)


def sba(
    data_dir: str,
    start_frame: int,
    end_frame: int,
    dlc_thresh: float,
    out_dir: Optional[str] = None,
    save: bool = True,
    device=None,
) -> Dict:
    """The CLI's ``sba`` stage on a run directory, on ``device`` (CUDA
    unless given), in float64. ``start_frame`` is 1-based; ``end_frame``
    -1 is the last frame. Writes ``<out_dir or data_dir/sba>/sba.pickle``."""
    device = resolve_device(device)
    out_dir = out_dir or os.path.join(data_dir, "sba")
    dlc_dir = os.path.join(data_dir, "dlc")
    assert os.path.exists(dlc_dir), f"missing {dlc_dir}"

    k_arr, d_arr, r_arr, t_arr, cam_res, n_cams, scene_fpath = data_io.find_scene_file(
        data_dir, verbose=False
    )
    fpaths = sorted(glob(os.path.join(dlc_dir, "*.h5")))
    p2d = data_io.load_dlc_points(fpaths, markers=cheetah.get_markers())
    start0 = start_frame - 1
    if end_frame == -1:
        end_frame = p2d.pixels.shape[1]
    win = p2d.window(start0, end_frame)

    positions, residuals = sba_run(
        win.pixels, win.valid(dlc_thresh), k_arr, d_arr, r_arr, t_arr, device=device
    )
    if save:
        os.makedirs(out_dir, exist_ok=True)
        app.save_sba(positions, out_dir, scene_fpath, start0, dlc_thresh)
    return dict(positions=positions, residuals=residuals, start_frame=start0)
