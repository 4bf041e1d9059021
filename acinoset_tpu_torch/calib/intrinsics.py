"""Fisheye (KB4) and pinhole intrinsic calibration on torch tensors, the
counterpart of acinoset_tpu.calib.intrinsics (cv2.fisheye.calibrate and
cv2.calibrateCamera as the reference uses them, including its dropping
of ill-conditioned frames, here a per-frame RMS screen).

Per camera: Zhang's closed-form K from the board homographies (principal
point at the image centre, no skew); board poses from the homographies;
then joint Gauss-Newton over [fx, fy, cx, cy, d0..d3] and every frame's
pose, the (6, 6) pose blocks eliminated by a Schur complement.

The entry points take numpy arrays, run in float64 on ``device``
(``cuda`` unless given) and return numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops import camera as cam_ops
from ..ops.rotations import rodrigues, rodrigues_inv
from ..solvers.lm import inv, lm_dense, solve
from ..utils.device import resolve_device
from ..utils.precision import f32_matmuls
from . import pnp


class FisheyeCalibration(NamedTuple):
    k: np.ndarray  # (3, 3)
    d: np.ndarray  # (4,)
    rvecs: np.ndarray  # (F, 3) board poses
    tvecs: np.ndarray  # (F, 3)
    rms: np.ndarray  # scalar reprojection RMS (px)
    frame_rms: np.ndarray  # (F,) per-frame RMS
    used: np.ndarray  # (F,) bool: frames kept after the conditioning screen


def _pack_cam(K, D):
    return torch.cat([torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), D.reshape(-1)[:4]])


def _unpack_k(c):
    """K (3, 3) from packed [fx, fy, cx, cy, ...], without skew."""
    z, o = torch.zeros_like(c[0]), torch.ones_like(c[0])
    return torch.stack([torch.stack([c[0], z, c[2]]), torch.stack([z, c[1], c[3]]),
                        torch.stack([z, z, o])])


def _unpack_cam(c):
    return _unpack_k(c), c[4:8]


@f32_matmuls()
def _joint_refine(obj_pts, img_pts, cam0, rvecs0, tvecs0, num_iters, project_fn,
                  fix_principal_point=False):
    """GN over the 8 camera parameters and the per-frame poses, the poses
    eliminated by a Schur complement. obj_pts (M, 3), img_pts (F, M, 2),
    cam0 (8,) packed. Returns (cam, poses (F, 6), rms, frame_rms (F,))."""
    F, M, _ = img_pts.shape
    dtype, device = img_pts.dtype, img_pts.device
    poses0 = torch.cat([rvecs0, tvecs0], dim=1)  # (F, 6)

    def frame_residual(cam, pose):  # (2M,)
        K, D = _unpack_cam(cam)
        return project_fn(obj_pts, K, D, rodrigues(pose[:3]), pose[3:]).reshape(-1)

    def residuals(cam, poses):  # (F, 2M)
        return vmap(frame_residual, in_dims=(None, 0))(cam, poses) - img_pts.reshape(F, -1)

    jacobians = vmap(jacfwd(frame_residual, argnums=(0, 1)), in_dims=(None, 0))
    cam_mask = torch.ones(8, dtype=dtype, device=device)
    if fix_principal_point:
        cam_mask[2:4] = 0.0
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def cost(cam, poses):
        r = residuals(cam, poses)
        return 0.5 * (r * r).sum()

    cam, poses = cam0, poses0
    c0 = cost(cam, poses)
    lam = torch.full_like(c0, 1e-3)
    for _ in range(num_iters):
        r = residuals(cam, poses)  # (F, 2M)
        Jc, Jp = jacobians(cam, poses)  # (F, 2M, 8), (F, 2M, 6)
        Jc = Jc * cam_mask

        Hcc = torch.einsum("fmi,fmj->ij", Jc, Jc)
        Hpp = torch.einsum("fmi,fmj->fij", Jp, Jp)
        B = torch.einsum("fmi,fmj->fij", Jc, Jp)  # (F, 8, 6)
        gc = torch.einsum("fmi,fm->i", Jc, r)
        gp = torch.einsum("fmi,fm->fi", Jp, r)

        Hcc_d = Hcc + lam * torch.diag(torch.clamp(torch.diagonal(Hcc), min=1e-10))
        dpp = torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-10)
        Hpp_inv = inv(Hpp + lam * dpp[:, :, None] * eye6)

        BHinv = torch.einsum("fij,fjk->fik", B, Hpp_inv)  # (F, 8, 6)
        S = Hcc_d - torch.einsum("fik,fjk->ij", BHinv, B)
        rhs = gc - torch.einsum("fik,fk->i", BHinv, gp)
        # fixed parameters: their rows and columns pinned to the identity
        S = S * cam_mask[:, None] * cam_mask[None, :] + torch.diag(1.0 - cam_mask)
        dcam = -solve(S, rhs * cam_mask)
        dposes = -torch.einsum("fij,fj->fi", Hpp_inv, gp + torch.einsum("fij,i->fj", B, dcam))

        cam_new, poses_new = cam + dcam, poses + dposes
        c_new = cost(cam_new, poses_new)
        ok = (c_new < c0) & torch.isfinite(c_new)
        cam = torch.where(ok, cam_new, cam)
        poses = torch.where(ok, poses_new, poses)
        c0 = torch.where(ok, c_new, c0)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-10, 1e8)

    r = residuals(cam, poses)
    frame_rms = torch.sqrt((r.reshape(F, M, 2) ** 2).mean(dim=(1, 2)))
    return cam, poses, torch.sqrt((r**2).mean()), frame_rms


def _board_tensors(obj_pts, img_pts, device):
    """obj (M, 2) and img (F, M, 2) float64 tensors on ``device``."""
    obj = torch.as_tensor(np.asarray(obj_pts, np.float64)[:, :2], device=device)
    img = torch.as_tensor(np.asarray(img_pts, np.float64).reshape(len(img_pts), -1, 2),
                          device=device)
    return obj, img


def _homography_init(obj, img, camera_resolution):
    """Zhang's K with the principal point at the image centre, and each
    frame's board pose (rvec, t) (F, 6) under it."""
    cx, cy = camera_resolution[0] / 2.0, camera_resolution[1] / 2.0
    Hs = pnp.homography_dlt(obj, img)
    K0 = pnp.zhang_intrinsics(Hs, fix_principal_point=(cx, cy))
    R, t = pnp.pose_from_homography(Hs, K0)
    return K0, torch.cat([rodrigues_inv(R), t], dim=-1)


def _with_z(obj):
    return torch.cat([obj, torch.zeros_like(obj[:, :1])], dim=1)


def calibrate_fisheye_camera(
    obj_pts: np.ndarray,  # (M, 3) board object points
    img_pts: np.ndarray,  # (F, ..., 2) detected corners per frame
    camera_resolution: Tuple[int, int],
    num_iters: int = 60,
    cond_rms_factor: float = 3.0,
    max_drop_rounds: int = 3,
    device=None,
) -> FisheyeCalibration:
    """Calibrate a KB4 fisheye camera from checkerboard corners, as the
    reference does: principal point initialised at the image centre,
    skew fixed at 0, and frames whose RMS exceeds cond_rms_factor times
    the median (at least 0.3 px) dropped and the calibration re-run, at
    most max_drop_rounds times (a host loop, one sync a round)."""
    device = resolve_device(device)
    obj, img = _board_tensors(obj_pts, img_pts, device)
    F = img.shape[0]
    if F < 4:
        raise ValueError("Need at least 4 valid frames to perform calibration.")
    used = np.ones(F, dtype=bool)

    for _ in range(max_drop_rounds):
        sel = torch.as_tensor(np.where(used)[0], device=device)
        res = _calibrate_once(obj, img[sel], camera_resolution, num_iters)
        frame_rms = res.frame_rms.cpu().numpy()
        med = np.median(frame_rms)
        bad = frame_rms > cond_rms_factor * max(med, 0.3)
        if not bad.any() or used.sum() - bad.sum() < 4:
            break
        idx = np.where(used)[0]
        used[idx[bad]] = False
        print(f"Dropping {bad.sum()} ill-conditioned frame(s); re-calibrating")

    full_r = np.zeros((F, 3))
    full_t = np.zeros((F, 3))
    sel = np.where(used)[0]
    full_r[sel] = res.rvecs.cpu().numpy()
    full_t[sel] = res.tvecs.cpu().numpy()
    return FisheyeCalibration(
        k=res.k.cpu().numpy(), d=res.d.cpu().numpy(), rvecs=full_r, tvecs=full_t,
        rms=res.rms.cpu().numpy(), frame_rms=frame_rms, used=used,
    )


def _calibrate_once(obj, img, camera_resolution, num_iters):
    """One calibration of all the frames img (F, M, 2); a
    FisheyeCalibration of tensors."""
    # Zhang's init on the raw pixels: the distortion is ignored, the
    # central corners dominate the fit enough for a usable focal length
    K0, poses = _homography_init(obj, img, camera_resolution)
    cam0 = _pack_cam(K0, torch.zeros(4, dtype=img.dtype, device=img.device))
    cam, poses, rms, frame_rms = _joint_refine(
        _with_z(obj), img, cam0, poses[:, :3], poses[:, 3:], num_iters,
        cam_ops.project_points_fisheye,
    )
    K, D = _unpack_cam(cam)
    return FisheyeCalibration(k=K, d=D, rvecs=poses[:, :3], tvecs=poses[:, 3:], rms=rms,
                              frame_rms=frame_rms, used=np.ones(img.shape[0], bool))


def calibrate_camera(
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    camera_resolution: Tuple[int, int],
    num_iters: int = 60,
    device=None,
):
    """Pinhole (8-coefficient rational model) calibration, the twin of
    cv2.calibrateCamera with CALIB_FIX_PRINCIPAL_POINT and
    CALIB_RATIONAL_MODEL: one dense LM over the 12 camera parameters and
    6 a frame, with the principal point held at the image centre.
    Returns numpy (k (3, 3), d (8,), rvecs (F, 3), tvecs (F, 3), rms)."""
    device = resolve_device(device)
    obj, img = _board_tensors(obj_pts, img_pts, device)
    F = img.shape[0]
    K0, poses = _homography_init(obj, img, camera_resolution)
    # packed: fx, fy, cx, cy, d0..d7
    cam0 = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
                      torch.zeros(8, dtype=img.dtype, device=device)])
    obj3 = _with_z(obj)

    def frame_residual(cam, pose):
        return cam_ops.project_points_pinhole(obj3, _unpack_k(cam), cam[4:12],
                                              rodrigues(pose[:3]), pose[3:]).reshape(-1)

    def residual_all(theta):
        proj = vmap(frame_residual, in_dims=(None, 0))(theta[:12], theta[12:].reshape(F, 6))
        return (proj - img.reshape(F, -1)).reshape(-1)

    theta0 = torch.cat([cam0, poses.reshape(-1)])
    # the principal point's update is masked out
    mask = torch.ones_like(theta0)
    mask[2:4] = 0.0

    def residual_masked(theta):
        return residual_all(theta0 + mask * (theta - theta0))

    out = lm_dense(residual_masked, theta0, num_iters=num_iters)
    theta = theta0 + mask * (out.x - theta0)
    poses = theta[12:].reshape(F, 6)
    rms = torch.sqrt((residual_all(theta) ** 2).mean())
    return tuple(a.cpu().numpy() for a in (_unpack_k(theta), theta[4:12], poses[:, :3],
                                           poses[:, 3:], rms))
