"""Reconstruction quality metrics, the counterpart of
acinoset_tpu.eval.metrics (the reference's src/testing.py:88-214):
per-marker reprojection RMSE (px), its standard deviation, PCK at a
fraction of the bounding-box diagonal, and NRMSE, between reprojected 3D
reconstructions and 2D labels. The projection runs on ``device`` (CUDA
unless given); the statistics are numpy. ``save_error_histogram`` draws
the errors' histogram through ``utils.figure``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..utils.device import resolve_device
from ..utils.figure import subplots


def reproject_positions(positions, k, d, r, t, device=None):
    """(N, L, 3) world positions -> (N, L, 2) pixels in one camera, in
    float64 on ``device``; NaN positions give NaN pixels."""
    device = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float64)
    N, L, _ = positions.shape
    flat = positions.reshape(-1, 3)
    ok = np.isfinite(flat).all(axis=1)
    out = np.full((N * L, 2), np.nan)
    if ok.any():
        cam = [torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
               for a in (k, np.asarray(d).reshape(-1)[:4], r, t)]
        out[ok] = cam_ops.project_points_fisheye(
            torch.as_tensor(flat[ok], device=device), *cam).cpu().numpy()
    return out.reshape(N, L, 2)


def bbox_diag(gt_2d: np.ndarray) -> np.ndarray:
    """Per-frame bounding-box diagonal of the labelled keypoints (N,)."""
    mins = np.nanmin(gt_2d, axis=1)  # (N, 2)
    maxs = np.nanmax(gt_2d, axis=1)
    return np.linalg.norm(maxs - mins, axis=1)


def keypoint_metrics(
    pred_2d: np.ndarray,  # (N, L, 2)
    gt_2d: np.ndarray,  # (N, L, 2), NaN where unlabelled
    pck_thresh: float = 0.1,
) -> Dict[str, float]:
    """RMSE / std / PCK at pck_thresh * bbox diagonal / NRMSE (the
    formulas of src/testing.py:188-214)."""
    err = np.linalg.norm(np.asarray(pred_2d) - np.asarray(gt_2d), axis=-1)  # (N, L)
    valid = np.isfinite(err)
    e = err[valid]
    rmse = float(np.sqrt(np.mean(e**2))) if e.size else float("nan")
    std = float(np.std(e)) if e.size else float("nan")
    diag = bbox_diag(gt_2d)  # (N,)
    thresh = pck_thresh * diag[:, None]
    pck = float(np.mean((err <= thresh)[valid])) if e.size else float("nan")
    nrmse = float(rmse / np.nanmean(diag)) if e.size else float("nan")
    return dict(rmse_px=rmse, std_px=std, pck=pck, nrmse=nrmse, n_points=int(e.size))


def _cam_indices(cam_indices, n):
    return list(cam_indices) if cam_indices is not None else list(range(n))


def evaluate_reconstruction(
    positions: np.ndarray,  # (N, L, 3)
    gt_2d_per_cam: Sequence[np.ndarray],  # per camera (N, L, 2)
    k_arr, d_arr, r_arr, t_arr,
    cam_indices: Optional[Sequence[int]] = None,
    pck_thresh: float = 0.1,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """A 3D reconstruction against 2D labels in the chosen cameras,
    projected on ``device`` (CUDA unless given). Returns {"cam{i}":
    metrics, ..., "overall": metrics}."""
    device = resolve_device(device)
    out = {}
    all_pred, all_gt = [], []
    for ci, gt in zip(_cam_indices(cam_indices, len(gt_2d_per_cam)), gt_2d_per_cam):
        pred = reproject_positions(positions, k_arr[ci], d_arr[ci], r_arr[ci], t_arr[ci], device)
        out[f"cam{ci + 1}"] = keypoint_metrics(pred, gt, pck_thresh)
        all_pred.append(pred)
        all_gt.append(gt)
    out["overall"] = keypoint_metrics(
        np.concatenate(all_pred, axis=0), np.concatenate(all_gt, axis=0), pck_thresh
    )
    return out


def positions_rmse_3d(pred: np.ndarray, gt: np.ndarray) -> float:
    """3D marker RMSE between two (N, L, 3) reconstructions (NaN-aware)."""
    d = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)
    return float(np.sqrt(np.nanmean(d**2)))


def reprojection_errors(
    positions: np.ndarray,
    gt_2d_per_cam: Sequence[np.ndarray],
    k_arr, d_arr, r_arr, t_arr,
    cam_indices: Optional[Sequence[int]] = None,
    device=None,
) -> np.ndarray:
    """The flat per-point reprojection errors (px) over all evaluated
    cameras, the distribution the reference histograms
    (src/testing.py:199-221)."""
    device = resolve_device(device)
    errs = []
    for ci, gt in zip(_cam_indices(cam_indices, len(gt_2d_per_cam)), gt_2d_per_cam):
        pred = reproject_positions(positions, k_arr[ci], d_arr[ci], r_arr[ci], t_arr[ci], device)
        e = np.linalg.norm(pred - np.asarray(gt), axis=-1).ravel()
        errs.append(e[np.isfinite(e)])
    return np.concatenate(errs) if errs else np.zeros(0)


def save_error_histogram(
    errors: np.ndarray,
    out_fpath: str,
    bins: int = 20,
    title: str = "Reprojection error",
) -> str:
    """The reference-style reprojection-error histogram
    (src/testing.py:199-205): the bars of ``np.histogram(errors, bins)``,
    which is what matplotlib's ``hist`` draws, on 'Reprojection Error
    (px)' / 'Frequency' axes, 6 x 4 inches at 120 dpi, written by the
    extension (a PNG holds the title, the labels and the bars' edges and
    counts in its tEXt chunks). Returns out_fpath."""
    fig, axes = subplots(figsize=(6, 4), dpi=120)
    ax = axes[0][0]
    ax.hist(np.asarray(errors), bins=bins)
    ax.set_title(title)
    ax.set_xlabel("Reprojection Error (px)")
    ax.set_ylabel("Frequency")
    fig.save(out_fpath)
    return out_fpath
