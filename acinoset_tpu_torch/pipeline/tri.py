"""TRI, pairwise DLT triangulation, the counterpart of
acinoset_tpu.pipeline.tri (the reference's ``tri()`` entry point,
AcinoSet src/all_optimizations.py:906-939): filter detections by
likelihood, triangulate every adjacent camera pair, average the pair
estimates per (frame, marker). ``get_pairwise_3d_points_from_df`` is
the column-table twin of the JAX package's DataFrame function
(``pipeline.data``'s tables).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from ..models import cheetah
from ..ops import camera as cam_ops
from ..utils.device import resolve_device
from . import app
from . import data as data_io


def triangulate_run(pixels, valid, k_arr, d_arr, r_arr, t_arr, device,
                    dtype=torch.float64) -> np.ndarray:
    """(N, L, 3) numpy positions for one run's numpy pixels (C, N, L, 2)
    and valid mask (C, N, L), computed on ``device``; NaN where unseen."""
    px = torch.as_tensor(np.asarray(pixels), dtype=dtype, device=device)
    ok = torch.as_tensor(np.asarray(valid), device=device)
    cams = [torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            for a in (k_arr, d_arr, r_arr, t_arr)]
    return cam_ops.triangulate_pairwise_mean(px, ok, *cams)[0].cpu().numpy()


def triangulate_runs_batch(
    pixels_b: np.ndarray,  # (B, C, N, L, 2)
    valid_b: np.ndarray,  # (B, C, N, L) bool
    aux,  # (K, D, R, T) stacks, each (B, C, ...)
    device=None,
) -> np.ndarray:
    """(B, N, L, 3) pair-averaged positions of a padded run group, in one
    batched call on ``device`` (CUDA unless given) and one download."""
    device = resolve_device(device)
    K, D, R, T = (np.asarray(a) for a in aux)
    B, C = K.shape[:2]
    return triangulate_run(pixels_b, valid_b, K, D.reshape(B, C, -1)[..., :4], R,
                           T.reshape(B, C, 3), device)


def get_pairwise_3d_points_from_df(
    points_2d_df, k_arr, d_arr, r_arr, t_arr, triangulate_func=None, device=None
):
    """A tidy table of detections [frame, camera, marker, x, y] (a
    mapping of columns; a DataFrame is one) -> the pair-averaged 3D
    points [frame, marker, x, y, z] of every (frame, marker) seen, as a
    dict of numpy arrays (src/calib/calib.py:394-423). Every detection
    counts; the triangulation runs on ``device`` (CUDA unless given).
    ``triangulate_func`` is accepted and unused, as in the JAX package."""
    device = resolve_device(device)
    markers = sorted(set(np.asarray(points_2d_df["marker"]).tolist()))
    table = {k: points_2d_df[k] for k in ("frame", "camera", "marker", "x", "y")}
    table["likelihood"] = np.ones(len(np.asarray(table["x"])))
    p2d = data_io.points2d_from_df(table, markers)
    pts3d = triangulate_run(np.nan_to_num(p2d.pixels), np.isfinite(p2d.pixels).all(axis=-1),
                            k_arr, d_arr, r_arr, t_arr, device)
    N, L, _ = pts3d.shape
    flat = pts3d.reshape(-1, 3)
    ok = np.isfinite(flat).all(axis=1)
    return {"frame": np.repeat(np.arange(N), L)[ok],
            "marker": np.tile(np.array(markers, dtype=object), N)[ok],
            "x": flat[ok, 0], "y": flat[ok, 1], "z": flat[ok, 2]}


def tri(
    data_dir: str,
    start_frame: int,
    end_frame: int,
    dlc_thresh: float,
    out_dir: Optional[str] = None,
    save: bool = True,
    markers=None,
    device=None,
) -> Dict:
    """The CLI's ``tri`` stage on a run directory (``dlc/*.h5`` and a scene
    file at or above it), on ``device`` (CUDA unless given). ``start_frame``
    is 1-based, as in the reference; ``end_frame`` -1 is the last frame.
    Writes ``<out_dir or data_dir/tri>/tri.pickle``."""
    device = resolve_device(device)
    out_dir = out_dir or os.path.join(data_dir, "tri")
    dlc_dir = os.path.join(data_dir, "dlc")
    assert os.path.exists(dlc_dir), f"missing {dlc_dir}"

    k_arr, d_arr, r_arr, t_arr, cam_res, n_cams, scene_fpath = data_io.find_scene_file(
        data_dir, verbose=False
    )
    fpaths = sorted(glob(os.path.join(dlc_dir, "*.h5")))
    assert n_cams == len(fpaths), f"{len(fpaths)} dlc files != {n_cams} cams"

    markers = markers or cheetah.get_markers()
    p2d = data_io.load_dlc_points(fpaths, markers=markers)
    start0 = start_frame - 1
    if end_frame == -1:
        end_frame = p2d.pixels.shape[1]
    win = p2d.window(start0, end_frame)

    positions = triangulate_run(
        np.nan_to_num(win.pixels), win.valid(dlc_thresh), k_arr, d_arr, r_arr, t_arr, device
    )
    result = dict(positions=positions, start_frame=start0, markers=markers)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        app.save_tri(positions, out_dir, scene_fpath, start0, dlc_thresh)
    return result
