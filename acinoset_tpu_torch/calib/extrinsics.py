"""Stereo-pair extrinsic calibration, pairwise chaining and board bundle
adjustment on torch tensors, the counterpart of
acinoset_tpu.calib.extrinsics (cv2.fisheye.stereoCalibrate and the
reference's chaining, src/calib/calib.py:110-194, and its board bundle
adjustment, :362-390). The world frame is pinned as the reference pins
it: camera 1 at R = [[1, 0, 0], [0, 0, -1], [0, 1, 0]], T = 0; each next
camera is composed as R2 = r @ R1, T2 = r @ T1 + t.

The entry points take numpy arrays, run in float64 on ``device``
(``cuda`` unless given) and return numpy arrays. The searches over
corner orderings and the per-frame board bookkeeping stay host loops,
as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from ..ops import camera as cam_ops
from ..ops.rotations import rodrigues, rodrigues_inv
from ..pipeline import data as data_io
from ..solvers import lm
from ..utils.device import resolve_device
from ..utils.precision import f32_matmuls
from . import pnp


# --------------------------------------------------------------------------
# Stereo pair (fixed intrinsics)
# --------------------------------------------------------------------------


def _t(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)


def _pair_tensors(obj_pts, img_pts_1, img_pts_2, device):
    obj = _t(obj_pts, device)[:, :2]
    p1 = _t(np.asarray(img_pts_1, np.float64).reshape(len(img_pts_1), -1, 2), device)
    p2 = _t(np.asarray(img_pts_2, np.float64).reshape(len(img_pts_2), -1, 2), device)
    return obj, p1, p2


def _relative_init(R1s, t1s, R2s, t2s):
    """The per-frame relative poses cam1 -> cam2 (X_c2 = R X_c1 + t) and
    their chordal mean: the mean matrix projected onto SO(3) by SVD."""
    R_rel_i = torch.einsum("fij,fkj->fik", R2s, R1s)  # R2 @ R1^T
    t_rel_i = t2s - torch.einsum("fij,fj->fi", R_rel_i, t1s)
    U, _, Vt = torch.linalg.svd(R_rel_i.mean(0))
    R0 = U @ Vt
    return R0 * torch.sign(torch.linalg.det(R0)), t_rel_i.mean(0)


def _pair_lm(project_fn, obj, p1, p2, cam1, cam2, R1s, t1s, R0, t0, num_iters):
    """LM over the relative pose and cam1's board pose in every frame,
    minimising the reprojection error in both cameras. Returns (rms,
    R (3, 3), t (3, 1)) as numpy."""
    F = p1.shape[0]
    obj3 = torch.cat([obj, torch.zeros_like(obj[:, :1])], dim=1)

    def residual(theta):
        rel = theta[:6]
        Rr = rodrigues(rel[:3])

        def per_frame(pose, q1, q2):
            Rb, tb = rodrigues(pose[:3]), pose[3:]
            pr1 = project_fn(obj3, *cam1, Rb, tb)
            pr2 = project_fn(obj3, *cam2, Rr @ Rb, Rr @ tb + rel[3:])
            return torch.cat([(pr1 - q1).reshape(-1), (pr2 - q2).reshape(-1)])

        return vmap(per_frame)(theta[6:].reshape(F, 6), p1, p2).reshape(-1)

    theta0 = torch.cat([rodrigues_inv(R0), t0,
                        torch.cat([rodrigues_inv(R1s), t1s], dim=1).reshape(-1)])
    out = lm.lm_dense(residual, theta0, num_iters=num_iters)
    rel = out.x[:6]
    rms = torch.sqrt(2.0 * out.cost / residual(out.x).shape[0])
    return rms.cpu().numpy(), rodrigues(rel[:3]).cpu().numpy(), rel[3:].reshape(3, 1).cpu().numpy()


@f32_matmuls()
def calibrate_pair_extrinsics_fisheye(
    obj_pts, img_pts_1, img_pts_2, k1, d1, k2, d2, camera_resolution,
    num_iters: int = 60, device=None,
):
    """Relative pose (R, t) of cam2 with respect to cam1 from shared board
    views (cv2.fisheye.stereoCalibrate with CALIB_FIX_INTRINSIC): each
    frame's fisheye board pose in both cameras, their relative poses'
    chordal mean, then joint LM over the relative pose and the board
    poses. Returns numpy (rms, R (3, 3), t (3, 1))."""
    device = resolve_device(device)
    obj, p1, p2 = _pair_tensors(obj_pts, img_pts_1, img_pts_2, device)
    k1, k2 = _t(k1, device), _t(k2, device)
    d1, d2 = _t(d1, device).reshape(-1)[:4], _t(d2, device).reshape(-1)[:4]
    R1s, t1s = pnp.board_pose_fisheye(obj, p1, k1, d1)
    R2s, t2s = pnp.board_pose_fisheye(obj, p2, k2, d2)
    R0, t0 = _relative_init(R1s, t1s, R2s, t2s)
    return _pair_lm(cam_ops.project_points_fisheye, obj, p1, p2, (k1, d1), (k2, d2),
                    R1s, t1s, R0, t0, num_iters)


def calibrate_pair_extrinsics(
    obj_pts, img_pts_1, img_pts_2, k1, d1, k2, d2, camera_resolution,
    num_iters: int = 60, device=None,
):
    """The pinhole twin (src/calib/calib.py:41-49): rational-model
    undistortion, homography poses, then the same LM through the pinhole
    projection. Returns numpy (rms, R (3, 3), t (3, 1))."""
    device = resolve_device(device)
    obj, p1, p2 = _pair_tensors(obj_pts, img_pts_1, img_pts_2, device)
    k1, k2 = _t(k1, device), _t(k2, device)
    d1, d2 = _t(d1, device).reshape(-1), _t(d2, device).reshape(-1)
    eye = torch.eye(3, dtype=p1.dtype, device=device)

    def poses(p, k, d):
        u = cam_ops.undistort_points_pinhole(p, k, d)
        return pnp.pose_from_homography(pnp.homography_dlt(obj, u), eye)

    R1s, t1s = poses(p1, k1, d1)
    R2s, t2s = poses(p2, k2, d2)
    R0, t0 = _relative_init(R1s, t1s, R2s, t2s)
    return _pair_lm(cam_ops.project_points_pinhole, obj, p1, p2, (k1, d1), (k2, d2),
                    R1s, t1s, R0, t0, num_iters)


# --------------------------------------------------------------------------
# Pairwise chaining (src/calib/calib.py:141-194)
# --------------------------------------------------------------------------

WORLD_R1 = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=np.float64)


def _rot_geodesic_deg(Ra, Rb):
    tr = np.trace(Ra @ Rb.T)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _align_pair_orderings(
    obj_pts, p1, p2, k1, d1, k2, d2, tol_deg: float = 10.0, tol_t: float = 0.3, device=None
):
    """Resolve the per-frame 180-degree corner-ordering ambiguity between
    two cameras' detections of the same board: every shared frame's
    relative pose cam1 -> cam2 under both orderings of cam2's corners (on
    the device), then per frame the ordering closest to the consensus
    pose, the consensus found by a host search over candidate frames.
    Returns numpy (p2 with its orderings fixed, keep mask)."""
    device = resolve_device(device)
    F = p1.shape[0]
    obj2 = _t(obj_pts, device)[:, :2]
    q1 = _t(p1.reshape(F, -1, 2), device)
    q2 = _t(p2.reshape(F, -1, 2), device)
    k1, k2 = _t(k1, device), _t(k2, device)
    d1, d2 = _t(d1, device).reshape(-1)[:4], _t(d2, device).reshape(-1)[:4]

    R1s, t1s = (a.cpu().numpy() for a in pnp.board_pose_fisheye(obj2, q1, k1, d1))

    def rel(q):
        R2s, t2s = (a.cpu().numpy() for a in pnp.board_pose_fisheye(obj2, q, k2, d2))
        Rr = np.einsum("fij,fkj->fik", R2s, R1s)
        return Rr, t2s - np.einsum("fij,fj->fi", Rr, t1s)

    Ra, ta = rel(q2)
    Rb, tb = rel(torch.flip(q2, dims=[1]))

    best_keep, best_choice, best_count = None, None, -1
    for f0 in range(F):
        for cand_R, cand_t in ((Ra[f0], ta[f0]), (Rb[f0], tb[f0])):
            choice = np.zeros(F, dtype=bool)  # False = as-is, True = reversed
            keep = np.zeros(F, dtype=bool)
            for f in range(F):
                da = _rot_geodesic_deg(Ra[f], cand_R) + 90.0 * (
                    np.linalg.norm(ta[f] - cand_t) > tol_t
                )
                db = _rot_geodesic_deg(Rb[f], cand_R) + 90.0 * (
                    np.linalg.norm(tb[f] - cand_t) > tol_t
                )
                if min(da, db) < tol_deg:
                    keep[f] = True
                    choice[f] = db < da
            if keep.sum() > best_count:
                best_keep, best_choice, best_count = keep, choice, keep.sum()
        if best_count >= max(3, F // 2):
            break

    p2_fixed = p2.copy()
    flat = p2_fixed.reshape(F, -1, 2)
    flat[best_choice] = flat[best_choice, ::-1]
    return flat.reshape(p2.shape), best_keep


def calibrate_pairwise_extrinsics(
    calib_func: Callable,
    img_pts_arr: Sequence[np.ndarray],
    fnames_arr: Sequence[List[str]],
    k_arr, d_arr,
    camera_resolution,
    board_shape,
    board_square_len,
    device=None,
):
    """Chain stereo pairs cam1 -> cam2 -> ... -> camN into world
    extrinsics (src/calib/calib.py:141-194): corresponding frames matched
    by file name, each pair's corner orderings aligned by relative-pose
    consensus (frames that fit none dropped), then
    ``calib_func(obj, p1, p2, k1, d1, k2, d2, camera_resolution,
    device=device)``. Returns (r_arr, t_arr) lists of numpy arrays."""
    device = resolve_device(device)
    n_cam = len(img_pts_arr)
    r_arr = [WORLD_R1.copy()]
    t_arr = [np.zeros((3, 1))]
    R1 = WORLD_R1.copy()
    T1 = np.zeros((3, 1))
    obj_pts = data_io.create_board_object_pts(board_shape, board_square_len)
    for i in range(n_cam - 1):
        fnames_1, fnames_2 = fnames_arr[i], fnames_arr[i + 1]
        img_pts_1, img_pts_2 = [], []
        for a, f in enumerate(fnames_1):
            if f in fnames_2:
                b = fnames_2.index(f)
                img_pts_1.append(img_pts_arr[i][a])
                img_pts_2.append(img_pts_arr[i + 1][b])
        if not img_pts_1:
            raise ValueError(f"No corresponding frames between cams {i} and {i + 1}")
        p1 = np.array(img_pts_1, dtype=np.float64)
        p2 = np.array(img_pts_2, dtype=np.float64)
        # The detector labels the board's first corner ambiguously (a
        # 180-degree rotation), per frame and per camera: align each
        # frame's ordering by relative-pose consensus
        p2, keep = _align_pair_orderings(
            obj_pts, p1, p2, k_arr[i], d_arr[i], k_arr[i + 1], d_arr[i + 1], device=device
        )
        if keep.sum() < len(keep):
            print(f"Pair {i}->{i + 1}: dropped {len(keep) - keep.sum()} inconsistent frame(s)")
        rms, r, t = calib_func(
            obj_pts, p1[keep], p2[keep],
            k_arr[i], d_arr[i], k_arr[i + 1], d_arr[i + 1],
            camera_resolution, device=device,
        )
        r = np.asarray(r)
        t = np.asarray(t).reshape(3, 1)
        print(f"Pair {i}->{i + 1}: RMS reprojection error {float(rms):.3f} px")
        R2 = r @ R1
        T2 = r @ T1 + t
        R1, T1 = R2, T2
        r_arr.append(R2)
        t_arr.append(T2)
    return r_arr, t_arr


# --------------------------------------------------------------------------
# Board bundle adjustment (src/calib/calib.py:210-264, 362-390)
# --------------------------------------------------------------------------


def prepare_calib_board_data(
    img_pts_arr: Sequence[np.ndarray],
    fnames_arr: Sequence[List[str]],
    board_shape: Tuple[int, int],
    k_arr, d_arr, r_arr, t_arr,
    align_tol_px: float = 30.0,
    device=None,
):
    """The dense (P, C) grid of board corners seen by >= 2 cameras, with
    3D inits from the first two kept cameras (src/calib/calib.py:210-263).

    Per-frame corner-ordering flips between cameras are resolved: each
    frame's first observing camera is its anchor; every other camera's
    corners are kept as they are or reversed, whichever triangulation
    with the anchor reprojects closer into it, and dropped if neither is
    within align_tol_px median error. A host loop over frames and
    cameras; the triangulations run on ``device``. Returns numpy (obs
    (P, C, 2), mask (P, C), pts3d0 (P, 3)).
    """
    device = resolve_device(device)
    n_cam = len(img_pts_arr)
    ppi = board_shape[0] * board_shape[1]
    all_names = sorted({f for fn in fnames_arr for f in fn})
    shared = [f for f in all_names if sum(f in fn for fn in fnames_arr) >= 2]

    cams = [(_t(k, device), _t(d, device).reshape(-1)[:4], _t(r, device),
             _t(t, device).reshape(3)) for k, d, r, t in zip(k_arr, d_arr, r_arr, t_arr)]

    def triangulate(pts_a, pts_b, a, b):
        return cam_ops.triangulate_points_fisheye(_t(pts_a, device), _t(pts_b, device),
                                                  *cams[a], *cams[b])

    P = len(shared) * ppi
    obs = np.zeros((P, n_cam, 2))
    mask = np.zeros((P, n_cam), dtype=bool)
    pts3d0 = np.zeros((P, 3))
    n_flipped = n_dropped = 0
    for s, fname in enumerate(shared):
        sl = slice(s * ppi, (s + 1) * ppi)
        seen_by = [c for c in range(n_cam) if fname in fnames_arr[c]]
        a = seen_by[0]
        corners_a = np.asarray(img_pts_arr[a][fnames_arr[a].index(fname)]).reshape(ppi, 2)
        obs[sl, a] = corners_a
        mask[sl, a] = True
        for c in seen_by[1:]:
            corners_c = np.asarray(img_pts_arr[c][fnames_arr[c].index(fname)]).reshape(ppi, 2)
            # score both orderings by triangulate(a, c) -> reproject into a
            best = None
            for cand in (corners_c, corners_c[::-1]):
                pr_a = cam_ops.project_points_fisheye(triangulate(corners_a, cand, a, c), *cams[a])
                err = np.median(np.linalg.norm(pr_a.cpu().numpy() - corners_a, axis=1))
                if best is None or err < best[0]:
                    best = (err, cand)
            err, cand = best
            if err > align_tol_px:
                n_dropped += 1
                continue
            if cand is not corners_c:
                n_flipped += 1
            obs[sl, c] = cand
            mask[sl, c] = True
        # 3D init from the first two kept cameras
        kept = [c for c in seen_by if mask[s * ppi, c]]
        if len(kept) < 2:
            mask[sl, :] = False
            continue
        a2, b2 = kept[0], kept[1]
        pts3d0[sl] = triangulate(obs[sl, a2], obs[sl, b2], a2, b2).cpu().numpy()
    if n_flipped or n_dropped:
        print(
            f"Board data prep: fixed {n_flipped} reversed corner set(s), "
            f"dropped {n_dropped} inconsistent one(s)"
        )
    return obs, mask, pts3d0


def bundle_adjust_board_points_and_extrinsics(
    img_pts_arr, fnames_arr, board_shape, k_arr, d_arr, r_arr, t_arr,
    num_iters: int = 80, device=None,
):
    """Joint board-point and extrinsics refinement
    (src/calib/calib.py:362-390): prepare_calib_board_data, then
    Schur-complement LM (solvers.lm.sba_points_extrinsics, Cauchy
    f_scale 1). Returns numpy (pts3d, r_arr (C, 3, 3), t_arr (C, 3, 1),
    dict(before, after) of the residuals)."""
    device = resolve_device(device)
    obs, mask, pts0 = prepare_calib_board_data(
        img_pts_arr, fnames_arr, board_shape, k_arr, d_arr, r_arr, t_arr, device=device
    )
    pts, r_out, t_out, residuals = lm.sba_points_extrinsics(
        _t(obs, device), torch.as_tensor(mask, device=device),
        np.asarray(k_arr), np.asarray(d_arr), np.asarray(r_arr), np.asarray(t_arr),
        _t(pts0, device), f_scale=1.0, num_iters=num_iters,
    )
    return (pts.cpu().numpy(), r_out.cpu().numpy(), t_out.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in residuals.items()})
