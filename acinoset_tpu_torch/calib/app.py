"""Calibration from files, the counterpart of acinoset_tpu.calib.app (the
reference's src/calib/app.py:30-223): corner detection, intrinsic and
extrinsic calibration and the scene bundle adjustment, connected by the
reference's JSON files (points_*.json -> camera_*.json ->
{n}_cam_scene.json -> {n}_cam_scene_sba.json).

Every flow takes ``device`` (``cuda`` unless given) and passes it to
the detector and the solvers. Frames are PNG files: a .jpg raises.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..pipeline import data as data_io
from ..solvers import lm
from ..utils.device import resolve_device
from . import corners as corners_mod
from . import extrinsics as ext_mod
from . import intrinsics as int_mod


def board_order(grid: np.ndarray) -> np.ndarray:
    """A detector grid (board_shape[0], board_shape[1], 2) as its corners
    are saved: (board_shape[1], board_shape[0], 2), the board's first axis
    fastest (the order of pipeline.data.create_board_object_pts and of
    cv2's corners in the reference's files, which every calibration
    reads), labelled as a board seen from its front. The detector's
    canonical order (first corner nearest the image origin) can mirror
    the board, as if seen from behind, which no pose of the board's face
    explains in a second camera; such a grid is turned to the front's
    labelling whose first corner is nearer the image origin."""
    u = (grid[1:] - grid[:-1]).mean(axis=(0, 1))  # image direction of the first axis
    v = (grid[:, 1:] - grid[:, :-1]).mean(axis=(0, 1))
    if u[0] * v[1] - u[1] * v[0] < 0:
        a, b = grid[::-1], grid[:, ::-1]
        grid = a if np.hypot(*a[0, 0]) <= np.hypot(*b[0, 0]) else b
    return np.ascontiguousarray(grid.transpose(1, 0, 2))


def extract_corners_from_images(
    img_dir: str,
    out_fpath: str,
    board_shape: Tuple[int, int],
    board_square_len: float,
    remove_unused_images: bool = False,
    engine: str = "torch",
    device=None,
):
    """Detect checkerboards in every image of a directory and save the
    points JSON (src/calib/app.py:30-41). ``engine``: see
    calib.corners.find_corners_images.

    Each frame's corners are saved by board_order; the JAX package saves
    the detector's grid as is, whose flattened corners do not follow the
    object points. Returns the points as saved."""
    print(f"Finding calibration board corners for images in {img_dir}")
    paths = sorted(glob(os.path.join(img_dir, "*.png")) + glob(os.path.join(img_dir, "*.jpg")))
    grids, fnames, cam_res = corners_mod.find_corners_images(paths, board_shape, engine=engine,
                                                             device=device)
    points = np.array([board_order(g) for g in grids])
    saved_fnames = [os.path.basename(f) for f in fnames]
    data_io.save_points(out_fpath, points, saved_fnames, board_shape, board_square_len, cam_res)
    if remove_unused_images:
        used = set(saved_fnames)
        for p in paths:
            if os.path.basename(p) not in used:
                os.remove(p)
    return points, saved_fnames, cam_res


def calibrate_fisheye_intrinsics(points_fpath: str, out_fpath: str, device=None):
    """points JSON -> camera JSON (src/calib/app.py:75-81)."""
    points, fnames, board_shape, board_edge_len, cam_res = data_io.load_points(points_fpath)
    obj_pts = data_io.create_board_object_pts(board_shape, board_edge_len)
    cal = int_mod.calibrate_fisheye_camera(obj_pts, points, cam_res, device=device)
    print(f"RMS Error is {float(cal.rms):.3f} pixels")
    data_io.save_camera(out_fpath, cam_res, cal.k, np.asarray(cal.d).reshape(4, 1))
    return cal.k, cal.d, cam_res, cal


def calibrate_intrinsics(points_fpath: str, out_fpath: str, device=None):
    """Standard-camera twin (src/calib/app.py:66-72)."""
    points, fnames, board_shape, board_edge_len, cam_res = data_io.load_points(points_fpath)
    obj_pts = data_io.create_board_object_pts(board_shape, board_edge_len)
    k, d, rvecs, tvecs, rms = int_mod.calibrate_camera(obj_pts, points, cam_res, device=device)
    print(f"RMS Error is {float(rms):.3f} pixels")
    data_io.save_camera(out_fpath, cam_res, k, np.asarray(d).reshape(-1, 1))
    return k, d, cam_res


def _load_multicam_points(points_fpaths: Sequence[str]):
    img_pts_arr, fnames_arr = [], []
    board_shape = board_edge_len = cam_res = None
    for fp in points_fpaths:
        points, fnames, board_shape, board_edge_len, cam_res = data_io.load_points(fp)
        img_pts_arr.append(points)
        fnames_arr.append(fnames)
    return img_pts_arr, fnames_arr, board_shape, board_edge_len, cam_res


def calibrate_fisheye_extrinsics_pairwise(
    camera_fpaths: Sequence[str],
    points_fpaths: Sequence[str],
    out_fpath: str,
    dummy_scene_fpath: Optional[str] = None,
    device=None,
):
    """Per-camera intrinsics + per-camera points -> chained scene JSON
    (src/calib/app.py:84-124). A points path of None/'' marks a camera
    with no usable footage this session; its slot is filled from
    ``dummy_scene_fpath`` so that downstream n-camera indexing stays
    intact."""
    k_arr, d_arr = [], []
    for fp in camera_fpaths:
        k, d, _res = data_io.load_camera(fp)
        k_arr.append(k)
        d_arr.append(d.reshape(-1)[:4])

    present = [i for i, fp in enumerate(points_fpaths) if fp]
    img_pts_arr, fnames_arr, board_shape, board_edge_len, cam_res = _load_multicam_points(
        [points_fpaths[i] for i in present]
    )
    r_sub, t_sub = ext_mod.calibrate_pairwise_extrinsics(
        ext_mod.calibrate_pair_extrinsics_fisheye,
        img_pts_arr, fnames_arr,
        [k_arr[i] for i in present], [d_arr[i] for i in present],
        cam_res, board_shape, board_edge_len, device=device,
    )
    if len(present) == len(points_fpaths):
        r_arr, t_arr = r_sub, t_sub
    else:
        if not dummy_scene_fpath:
            raise ValueError("cameras without points need dummy_scene_fpath")
        dk, dd, dr, dt, _dres = data_io.load_scene(dummy_scene_fpath)
        r_arr = [dr[min(i, len(dr) - 1)] for i in range(len(points_fpaths))]
        t_arr = [dt[min(i, len(dt) - 1)] for i in range(len(points_fpaths))]
        for j, i in enumerate(present):
            r_arr[i], t_arr[i] = r_sub[j], t_sub[j]
    data_io.save_scene(out_fpath, k_arr, [d.reshape(4, 1) for d in d_arr], r_arr, t_arr, cam_res)
    return k_arr, d_arr, r_arr, t_arr


def sba_board_points_fisheye(
    scene_fpath: str,
    points_fpaths: Sequence[str],
    out_fpath: Optional[str] = None,
    num_iters: int = 80,
    device=None,
):
    """Scene-level board bundle adjustment -> *_sba.json
    (src/calib/app.py:201-223). Returns (points, residuals dict)."""
    k_arr, d_arr, r_arr, t_arr, cam_res = data_io.load_scene(scene_fpath)
    d_arr = d_arr.reshape(len(k_arr), -1)[:, :4]
    img_pts_arr, fnames_arr, board_shape, _edge, _res = _load_multicam_points(points_fpaths)
    pts3d, r_out, t_out, residuals = ext_mod.bundle_adjust_board_points_and_extrinsics(
        img_pts_arr, fnames_arr, board_shape, k_arr, d_arr, r_arr, t_arr,
        num_iters=num_iters, device=device,
    )
    out_fpath = out_fpath or scene_fpath.replace(".json", "_sba.json")
    data_io.save_scene(
        out_fpath, k_arr, d_arr.reshape(-1, 4, 1), r_out, t_out, cam_res
    )
    before = float(np.sqrt(np.mean(residuals["before"] ** 2)))
    after = float(np.sqrt(np.mean(residuals["after"] ** 2)))
    print(f"Board SBA: RMS {before:.3f} -> {after:.3f} px; saved {out_fpath}")
    return pts3d, residuals


def adjust_extrinsics_manual_points(
    scene_fpath: str,
    manual_points_fpath: str,
    out_fpath: Optional[str] = None,
    num_iters: int = 80,
    device=None,
):
    """Refine extrinsics against manually-clicked scene points
    (manual_points.json, shape (n_points, n_cams, 2) with NaN where not
    clicked; the schema of src/argus_converter.py:35-83): points seen by
    at least two cameras, each started by triangulating its first two
    cameras, then the points + extrinsics SBA (Cauchy, f_scale 1).
    Returns numpy (points (P, 3), residuals dict)."""
    device = resolve_device(device)
    k_arr, d_arr, r_arr, t_arr, cam_res = data_io.load_scene(scene_fpath)
    d4 = d_arr.reshape(len(k_arr), -1)[:, :4]
    with open(manual_points_fpath) as f:
        manual = json.load(f)
    pts = np.array(manual["points"], dtype=np.float64)  # (P, C, 2)
    mask = np.isfinite(pts).all(axis=2)
    seen = mask.sum(axis=1) >= 2
    pts = np.nan_to_num(pts[seen])
    mask = mask[seen]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    init = []
    for i in range(len(pts)):
        a, b = np.where(mask[i])[0][:2]
        init.append(cam_ops.triangulate_points_fisheye(
            t(pts[i, a]), t(pts[i, b]),
            k_arr[a], d4[a], r_arr[a], t_arr[a],
            k_arr[b], d4[b], r_arr[b], t_arr[b],
        )[0])
    pts3d, r_out, t_out, residuals = lm.sba_points_extrinsics(
        t(pts), torch.as_tensor(mask, device=device), k_arr, d4, r_arr, t_arr,
        torch.stack(init), f_scale=1.0, num_iters=num_iters,
    )
    out_fpath = out_fpath or scene_fpath.replace(".json", "_sba.json")
    data_io.save_scene(out_fpath, k_arr, d_arr, r_out.cpu().numpy(), t_out.cpu().numpy(),
                       cam_res)
    return pts3d.cpu().numpy(), {k: v.cpu().numpy() for k, v in residuals.items()}
