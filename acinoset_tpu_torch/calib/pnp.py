"""Planar homography estimation and pose recovery on torch tensors, the
counterpart of acinoset_tpu.calib.pnp: the building blocks of
checkerboard calibration (the internals of cv2.calibrateCamera and
cv2.fisheye.calibrate): a Hartley-normalised DLT homography, Zhang's
closed-form intrinsics, and a homography's board pose. Every function
batches over leading (frame) dimensions where the JAX package vmaps.
"""
from __future__ import annotations

import math

import torch

from ..ops.camera import undistort_points_fisheye


def _norm(v):
    """Euclidean norm over the last dimension, as jnp.linalg.norm."""
    return torch.sqrt((v * v).sum(-1))


def _hartley(p):
    """Points p (..., M, 2) -> homogeneous normalised points (..., M, 3)
    (centroid at 0, mean distance sqrt 2) and the map T (..., 3, 3)."""
    mean = p.mean(-2)  # (..., 2)
    scale = math.sqrt(2.0) / torch.clamp(_norm(p - mean[..., None, :]).mean(-1), min=1e-12)
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, z, -scale * mean[..., 0]], -1),
        torch.stack([z, scale, -scale * mean[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return (T @ ph.mT).mT, T


def homography_dlt(obj_xy, img_xy):
    """H (..., 3, 3) mapping board-plane points obj_xy (M, 2) or
    (..., M, 2) to image points img_xy (..., M, 2): Hartley-normalised
    DLT, solved by the eigenvector of A^T A with the smallest eigenvalue.
    The division by H[2, 2] cancels the eigenvector's free sign."""
    obj_xy = obj_xy.expand(img_xy.shape)
    src, Ts = _hartley(obj_xy)
    dst, Td = _hartley(img_xy)
    zeros = torch.zeros_like(src)
    # rows: [-x, -y, -1, 0, 0, 0, u*x, u*y, u] and [0, 0, 0, -x, -y, -1, v*x, v*y, v]
    r1 = torch.cat([-src, zeros, dst[..., 0:1] * src], dim=-1)
    r2 = torch.cat([zeros, -src, dst[..., 1:2] * src], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    h = torch.linalg.eigh(A.mT @ A)[1][..., :, 0]
    H = torch.linalg.solve_ex(Td, h.reshape(h.shape[:-1] + (3, 3)) @ Ts)[0]
    return H / H[..., 2:3, 2:3]


def zhang_intrinsics(Hs, fix_principal_point=None):
    """Zhang's closed-form K (3, 3) from >= 3 homographies Hs (F, 3, 3).
    With fix_principal_point=(cx, cy), solves the reduced 2-parameter
    least-squares system for (fx, fy) only (more stable for fisheye
    lenses, where the plain system can go indefinite)."""

    def v_ij(i, j):
        H = Hs
        return torch.stack([
            H[:, 0, i] * H[:, 0, j],
            H[:, 0, i] * H[:, 1, j] + H[:, 1, i] * H[:, 0, j],
            H[:, 1, i] * H[:, 1, j],
            H[:, 2, i] * H[:, 0, j] + H[:, 0, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 1, j] + H[:, 1, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 2, j],
        ], dim=-1)  # (F, 6)

    # two rows a frame, frame by frame
    V = torch.stack([v_ij(0, 1), v_ij(0, 0) - v_ij(1, 1)], dim=1).reshape(-1, 6)

    def const(rows):
        return torch.tensor(rows, dtype=Hs.dtype, device=Hs.device)

    if fix_principal_point is not None:
        cx, cy = fix_principal_point
        # omega ~ [[a, 0, -a cx], [0, c, -c cy], [-a cx, -c cy, a cx^2 + c cy^2 + 1]]
        # with a = 1/fx^2, c = 1/fy^2: b = a ba + c bc + b0
        ba = const([1.0, 0.0, 0.0, -cx, 0.0, cx * cx])
        bc = const([0.0, 0.0, 1.0, 0.0, -cy, cy * cy])
        b0 = const([0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
        A2 = torch.stack([V @ ba, V @ bc], dim=1)  # (rows, 2)
        a, c = torch.linalg.lstsq(A2, -(V @ b0)[:, None]).solution[:, 0]
        fx = 1.0 / torch.sqrt(torch.clamp(a, min=1e-12))
        fy = 1.0 / torch.sqrt(torch.clamp(c, min=1e-12))
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, z + cx]), torch.stack([z, fy, z + cy]),
                            torch.stack([z, z, o])])

    b11, b12, b22, b13, b23, b33 = torch.linalg.eigh(V.mT @ V)[1][:, 0]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = torch.sqrt(lam / b11)
    fy = torch.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, skew, cx]), torch.stack([z, fy, cy]),
                        torch.stack([z, z, o])])


def pose_from_homography(H, K):
    """Board pose (R (..., 3, 3), t (..., 3)) from homographies
    H (..., 3, 3) under intrinsics K: H ~ K [r1 r2 t], with [r1 r2 r3]
    projected onto the nearest rotation by SVD and the board in front of
    the camera (t_z > 0)."""
    A = torch.linalg.solve_ex(K, H)[0]
    A = A * torch.sign(A[..., 2, 2])[..., None, None]  # positive depth
    lam = 0.5 * (_norm(A[..., :, 0]) + _norm(A[..., :, 1]))[..., None]
    r1 = A[..., :, 0] / lam
    r2 = A[..., :, 1] / lam
    t = A[..., :, 2] / lam
    Q = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1)
    U, _, Vt = torch.linalg.svd(Q)
    R = U @ Vt  # the polar factor: unique, whatever the SVD's signs
    return R * torch.sign(torch.linalg.det(R))[..., None, None], t


def board_pose_fisheye(obj_xy, img_pts, K, D):
    """Initial board pose of fisheye views img_pts (..., M, 2): undistort
    the corners to the normalised plane, fit a homography against
    identity intrinsics and decompose it."""
    ab = undistort_points_fisheye(img_pts, K, D)
    H = homography_dlt(obj_xy, ab)
    return pose_from_homography(H, torch.eye(3, dtype=img_pts.dtype, device=img_pts.device))
