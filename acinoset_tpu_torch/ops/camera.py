"""Fisheye (Kannala-Brandt 4-coefficient) and pinhole (8-coefficient
rational) camera models on torch tensors, the counterpart of
acinoset_tpu.ops.camera: projection (the fisheye one with its analytic
point-Jacobian), undistortion of points and of images (remap grids and
a bilinear gather), and two-view DLT triangulation.

Camera parameters are K (..., 3, 3), D (..., 4), R (..., 3, 3) and
t (..., 3). With an unbatched K (3, 3), D and t may also come in the
JAX package's shapes ((4, 1), (3, 1)). A batched camera's leading
dimensions broadcast against those of the points, so one call covers a
rig or a batch of rigs where the JAX package vmaps.
"""
from __future__ import annotations

import math

import torch

from ..utils.device import resolve_device
from .rotations import mv3


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _camera(pts, K, D, R, t):
    K, D, R, t = (_like(a, pts) for a in (K, D, R, t))
    if K.dim() == 2:  # one camera: accept the JAX package's (4, 1)/(3, 1) shapes
        D = D.reshape(-1)[:4]
        t = t.reshape(3)
    else:
        D = D[..., :4]
    return K, D, R, t


def distort_theta(theta, D):
    """theta_d = theta (1 + d0 t^2 + d1 t^4 + d2 t^6 + d3 t^8)."""
    t2 = theta * theta
    poly = 1.0 + t2 * (D[..., 0] + t2 * (D[..., 1] + t2 * (D[..., 2] + t2 * D[..., 3])))
    return theta * poly


def project_points_fisheye(pts, K, D, R, t, eps: float = 1e-12):
    """World points (..., 3) -> pixels (..., 2) through the KB4 model
    (cv2.fisheye.projectPoints), with the same 1e-12 guard inside the
    radius sqrt as the JAX version."""
    K, D, R, t = _camera(pts, K, D, R, t)
    cam = mv3(R, pts) + t
    a = cam[..., 0] / cam[..., 2]
    b = cam[..., 1] / cam[..., 2]
    r = torch.sqrt(a * a + b * b + eps)
    scale = distort_theta(torch.atan(r), D) / r
    u = K[..., 0, 0] * (a * scale) + K[..., 0, 2]
    v = K[..., 1, 1] * (b * scale) + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def _pinhole(pts, K, D):
    """K and the first 8 coefficients (k1, k2, p1, p2, k3, k4, k5, k6) of
    an OpenCV rational model D, zero-padded; with an unbatched K (3, 3),
    D may come in any shape, as in the JAX version."""
    K, D = _like(K, pts), _like(D, pts)
    D = D.reshape(-1)[:8] if K.dim() == 2 else D[..., :8]
    pad = torch.zeros(D.shape[:-1] + (8 - D.shape[-1],), dtype=D.dtype, device=D.device)
    return K, torch.cat([D, pad], dim=-1)


def project_points_pinhole(pts, K, D, R, t):
    """World points (..., 3) -> pixels (..., 2) through a pinhole camera
    with OpenCV's rational distortion (cv2.projectPoints; the first 8
    coefficients of D, missing ones zero), as the JAX version."""
    K, d = _pinhole(pts, K, D)
    R, t = _like(R, pts), _like(t, pts)
    if K.dim() == 2:
        t = t.reshape(3)
    cam = mv3(R, pts) + t
    x = cam[..., 0] / cam[..., 2]
    y = cam[..., 1] / cam[..., 2]
    r2 = x * x + y * y
    num = 1.0 + r2 * (d[..., 0] + r2 * (d[..., 1] + r2 * d[..., 4]))
    den = 1.0 + r2 * (d[..., 5] + r2 * (d[..., 6] + r2 * d[..., 7]))
    radial = num / den
    x_d = x * radial + 2.0 * d[..., 2] * x * y + d[..., 3] * (r2 + 2.0 * x * x)
    y_d = y * radial + d[..., 2] * (r2 + 2.0 * y * y) + 2.0 * d[..., 3] * x * y
    u = K[..., 0, 0] * x_d + K[..., 0, 1] * y_d + K[..., 0, 2]
    v = K[..., 1, 1] * y_d + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def undistort_points_pinhole(pts, K, D, num_iters: int = 20):
    """Pixels (..., 2) -> normalized coordinates by a fixed number of
    fixed-point steps on the rational distortion model
    (cv2.undistortPoints without P)."""
    K, d = _pinhole(pts, K, D)
    x0 = (pts[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    y0 = (pts[..., 1] - K[..., 1, 2]) / K[..., 1, 1]
    x, y = x0, y0
    for _ in range(num_iters):
        r2 = x * x + y * y
        num = 1.0 + r2 * (d[..., 0] + r2 * (d[..., 1] + r2 * d[..., 4]))
        den = 1.0 + r2 * (d[..., 5] + r2 * (d[..., 6] + r2 * d[..., 7]))
        radial = num / den
        dx = 2.0 * d[..., 2] * x * y + d[..., 3] * (r2 + 2.0 * x * x)
        dy = d[..., 2] * (r2 + 2.0 * y * y) + 2.0 * d[..., 3] * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def project_points_fisheye_and_jac(pts, K, D, R, t, eps: float = 1e-12):
    """Fused KB4 projection and analytic point-Jacobian:
    ``(uv (..., 2), J (..., 2, 3))`` with J = d uv / d world-point, the
    closed form of the JAX version (equal to jacfwd of
    :func:`project_points_fisheye`)."""
    K, D, R, t = _camera(pts, K, D, R, t)
    cam = mv3(R, pts) + t
    z = cam[..., 2]
    a = cam[..., 0] / z
    b = cam[..., 1] / z
    r2 = a * a + b * b + eps  # r^2 including eps, as in the primal
    r = torch.sqrt(r2)
    theta = torch.atan(r)
    t2 = theta * theta
    d0, d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    poly = 1.0 + t2 * (d0 + t2 * (d1 + t2 * (d2 + t2 * d3)))
    dpoly = 1.0 + t2 * (3.0 * d0 + t2 * (5.0 * d1 + t2 * (7.0 * d2 + 9.0 * t2 * d3)))
    s = theta * poly / r
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    uv = torch.stack([fx * (a * s) + K[..., 0, 2], fy * (b * s) + K[..., 1, 2]], dim=-1)

    g = (dpoly / (1.0 + r2) - s) / r2
    zinv = 1.0 / z[..., None]
    Ma = (R[..., 0, :] - a[..., None] * R[..., 2, :]) * zinv  # da/dp
    Mb = (R[..., 1, :] - b[..., None] * R[..., 2, :]) * zinv  # db/dp
    Ju = fx[..., None] * ((s + a * a * g)[..., None] * Ma + (a * b * g)[..., None] * Mb)
    Jv = fy[..., None] * ((a * b * g)[..., None] * Ma + (s + b * b * g)[..., None] * Mb)
    return uv, torch.stack([Ju, Jv], dim=-2)


def project_rig_and_jac(pts, K, D, R, T):
    """Project points (..., L, 3) through a C-camera rig, K (..., C, 3, 3)
    etc.: ``(h (..., C, L, 2), Jp (..., C, L, 2, 3))``."""
    K = _like(K, pts)
    lead = K.shape[:-2]
    D = _like(D, pts).reshape(*lead, -1)[..., :4]
    T = _like(T, pts).reshape(*lead, 3)
    R = _like(R, pts)
    return project_points_fisheye_and_jac(
        pts[..., None, :, :], K[..., None, :, :], D[..., None, :], R[..., None, :, :],
        T[..., None, :],
    )


def undistort_theta(th_d, D, num_iters: int = 10):
    """Invert theta_d = distort_theta(theta) by a fixed number of Newton steps."""
    theta = th_d
    d0, d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    for _ in range(num_iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (d0 + t2 * (d1 + t2 * (d2 + t2 * d3)))
        dpoly = 1.0 + t2 * (3.0 * d0 + t2 * (5.0 * d1 + t2 * (7.0 * d2 + 9.0 * t2 * d3)))
        theta = theta - (theta * poly - th_d) / dpoly
    return theta


def undistort_points_fisheye(pts, K, D, P=None, num_iters: int = 10, eps: float = 1e-12):
    """Pixels (..., 2) -> normalized camera-plane coordinates (a, b)
    (cv2.fisheye.undistortPoints); with ``P`` re-applies a pinhole
    matrix to give undistorted pixels."""
    K = _like(K, pts)
    D = _like(D, pts)
    D = D.reshape(-1)[:4] if K.dim() == 2 else D[..., :4]
    x = (pts[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    y = (pts[..., 1] - K[..., 1, 2]) / K[..., 1, 1]
    th_d = torch.sqrt(x * x + y * y + eps)
    # cv2 clips theta_d to pi/2 before inverting
    th_d = torch.clamp(th_d, max=math.pi / 2)
    theta = undistort_theta(th_d, D, num_iters=num_iters)
    scale = torch.tan(theta) / th_d
    a = x * scale
    b = y * scale
    if P is not None:
        P = _like(P, pts)
        a = P[..., 0, 0] * a + P[..., 0, 2]
        b = P[..., 1, 1] * b + P[..., 1, 2]
    return torch.stack([a, b], dim=-1)


def _dlt_rows(ab1, ab2, P1, P2):
    """The two-view DLT system A (..., 4, 4) of normalized point pairs
    ab (..., 2) and projection matrices P (..., 3, 4)."""
    return torch.stack(
        [
            ab1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            ab1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            ab2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            ab2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )


def _dlt_one(ab1, ab2, P1, P2):
    """Two-view DLT of normalized point pairs ab (..., 2) with projection
    matrices P (..., 3, 4), broadcasting over leading dimensions: the
    inhomogeneous 3x3 normal equations solved by Cramer's rule, as in
    the JAX version."""
    A = _dlt_rows(ab1, ab2, P1, P2)  # (..., 4, 4)
    M = A[..., :3]
    rhs = -A[..., 3]
    G = M.mT @ M  # (..., 3, 3)
    h = (M.mT @ rhs[..., None])[..., 0]  # (..., 3)

    def g(i, j):
        return G[..., i, j]

    c00 = g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1)
    c01 = g(1, 2) * g(2, 0) - g(1, 0) * g(2, 2)
    c02 = g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0)
    det = g(0, 0) * c00 + g(0, 1) * c01 + g(0, 2) * c02
    adj = torch.stack(
        [
            torch.stack([c00, g(0, 2) * g(2, 1) - g(0, 1) * g(2, 2), g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1)], -1),
            torch.stack([c01, g(0, 0) * g(2, 2) - g(0, 2) * g(2, 0), g(0, 2) * g(1, 0) - g(0, 0) * g(1, 2)], -1),
            torch.stack([c02, g(0, 1) * g(2, 0) - g(0, 0) * g(2, 1), g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0)], -1),
        ],
        dim=-2,
    )
    den = torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    return (adj.mT @ h[..., None])[..., 0] / den[..., None]


def _dlt_one_eigh(ab1, ab2, P1, P2):
    """Homogeneous two-view DLT (the eigenvector of A^T A with the
    smallest eigenvalue; cv2.triangulatePoints). The division by X[3]
    cancels the eigenvector's free sign."""
    A = _dlt_rows(ab1, ab2, P1, P2)
    X = torch.linalg.eigh(A.mT @ A)[1][..., :, 0]
    return X[..., :3] / X[..., 3, None]


def _projection(r, t):
    """[R | t] (..., 3, 4)."""
    return torch.cat([r, t[..., None]], dim=-1)


def triangulate_points_fisheye(img_pts_1, img_pts_2, k1, d1, r1, t1, k2, d2, r2, t2):
    """Triangulate fisheye pixel correspondences (..., 2) in two views
    into world points (-1, 3): undistort both views, then DLT with
    P = [R | t]."""
    p1 = img_pts_1.reshape(-1, 2)
    p2 = img_pts_2.reshape(-1, 2)
    ab1 = undistort_points_fisheye(p1, k1, d1)
    ab2 = undistort_points_fisheye(p2, k2, d2)
    P1 = _projection(_like(r1, p1), _like(t1, p1).reshape(3))
    P2 = _projection(_like(r2, p1), _like(t2, p1).reshape(3))
    return _dlt_one(ab1, ab2, P1, P2)


def triangulate_points(img_pts_1, img_pts_2, k1, d1, r1, t1, k2, d2, r2, t2):
    """The pinhole twin of :func:`triangulate_points_fisheye`: rational-
    model undistortion of both views, then DLT with P = [R | t]."""
    p1 = img_pts_1.reshape(-1, 2)
    p2 = img_pts_2.reshape(-1, 2)
    ab1 = undistort_points_pinhole(p1, k1, d1)
    ab2 = undistort_points_pinhole(p2, k2, d2)
    P1 = _projection(_like(r1, p1), _like(t1, p1).reshape(3))
    P2 = _projection(_like(r2, p1), _like(t2, p1).reshape(3))
    return _dlt_one(ab1, ab2, P1, P2)


def triangulate_pairwise_mean(pts2d, valid, k_arr, d_arr, r_arr, t_arr):
    """Masked pairwise triangulation averaged over adjacent camera pairs
    (c, c+1), the counterpart of the JAX version.

    pts2d (..., C, N, L, 2), valid (..., C, N, L) bool, camera stacks
    with the same leading (..., C). Returns points3d (..., N, L, 3), NaN
    where no adjacent pair saw the marker, and seen (..., N, L)."""
    k_arr = _like(k_arr, pts2d)
    lead = k_arr.shape[:-2]
    d_arr = _like(d_arr, pts2d).reshape(*lead, -1)[..., :4]
    r_arr = _like(r_arr, pts2d)
    t_arr = _like(t_arr, pts2d).reshape(*lead, 3)
    C = k_arr.shape[-3]

    def cam(c):  # camera c broadcast over (N, L)
        k = k_arr[..., c, None, None, :, :]
        d = d_arr[..., c, None, None, :]
        P = _projection(r_arr[..., c, :, :], t_arr[..., c, :])[..., None, None, :, :]
        return k, d, P

    total = torch.zeros(pts2d.shape[:-4] + pts2d.shape[-3:-1] + (3,), dtype=pts2d.dtype,
                        device=pts2d.device)
    count = torch.zeros(total.shape[:-1], dtype=pts2d.dtype, device=pts2d.device)
    for c in range(C - 1):
        k1, d1, P1 = cam(c)
        k2, d2, P2 = cam(c + 1)
        ab1 = undistort_points_fisheye(pts2d[..., c, :, :, :], k1, d1)
        ab2 = undistort_points_fisheye(pts2d[..., c + 1, :, :, :], k2, d2)
        xyz = _dlt_one(ab1, ab2, P1, P2)
        ok = valid[..., c, :, :] & valid[..., c + 1, :, :]
        total = total + torch.where(ok[..., None], xyz, torch.zeros_like(xyz))
        count = count + ok.to(pts2d.dtype)
    seen = count > 0
    mean = total / torch.where(seen, count, torch.ones_like(count))[..., None]
    points3d = torch.where(seen[..., None], mean, torch.full_like(mean, float("nan")))
    return points3d, seen


# --------------------------------------------------------------------------
# Image undistortion (remap grids + bilinear gather)
# --------------------------------------------------------------------------


def _on_device(ref, device):
    """Where an image op runs: ``device`` if given, else the device of
    ``ref`` if it is a tensor, else ``cuda`` (resolve_device)."""
    if device is None and isinstance(ref, torch.Tensor):
        return ref.device
    return resolve_device(device)


def _pixel_grid(size, device):
    """(u, v) float32 pixel coordinates (H, W) of an image of size
    (width, height)."""
    W, H = size
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return u, v


# The maps take the camera's entries as 1-element slices, not 0-dim
# tensors: torch promotes a 0-dim float64 tensor with a float32 tensor to
# float32, JAX to float64; a 1-element tensor promotes as JAX does.


def undistort_rectify_map_fisheye(K, D, new_K, size, device=None):
    """The (map_x, map_y) source-pixel grids (H, W) that undistort a
    fisheye image, the twin of cv2.fisheye.initUndistortRectifyMap (the
    reference's src/calib/calib.py:101-106). size: (width, height) of the
    output image."""
    device = _on_device(K, device)
    K, D, new_K = (torch.as_tensor(a, device=device) for a in (K, D, new_K))
    u, v = _pixel_grid(size, device)
    # output pixel -> ideal normalized coords under new_K
    a = (u - new_K[0, 2:3]) / new_K[0, 0:1]
    b = (v - new_K[1, 2:3]) / new_K[1, 1:2]
    # distort: normalized -> fisheye source pixel
    r = torch.sqrt(a * a + b * b + 1e-12)
    scale = distort_theta(torch.atan(r), D.reshape(1, -1)[:, :4]) / r
    map_x = K[0, 0:1] * (a * scale) + K[0, 2:3]
    map_y = K[1, 1:2] * (b * scale) + K[1, 2:3]
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """Sample img (H, W[, C]) at float source coordinates (the maps'
    shape), zero outside; a uint8 image comes out in the maps' float
    dtype."""
    img = torch.as_tensor(img, device=map_x.device)
    H, W = img.shape[:2]
    x0 = torch.floor(map_x).to(torch.int32)
    y0 = torch.floor(map_y).to(torch.int32)
    fx = map_x - x0
    fy = map_y - y0
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    if img.dim() == 3:
        fx, fy, inside = fx[..., None], fy[..., None], inside[..., None]
    xc0, xc1 = x0.clamp(0, W - 1).long(), (x0 + 1).clamp(0, W - 1).long()
    yc0, yc1 = y0.clamp(0, H - 1).long(), (y0 + 1).clamp(0, H - 1).long()
    out = (
        img[yc0, xc0] * (1 - fx) * (1 - fy)
        + img[yc0, xc1] * fx * (1 - fy)
        + img[yc1, xc0] * (1 - fx) * fy
        + img[yc1, xc1] * fx * fy
    )
    return torch.where(inside, out, 0)


def undistort_image_fisheye(img, K, D, new_K=None, device=None):
    """Undistort one fisheye image (H, W[, C]); new_K defaults to K."""
    device = _on_device(img, device)
    K = torch.as_tensor(K, device=device)
    new_K = K if new_K is None else new_K
    H, W = img.shape[:2]
    map_x, map_y = undistort_rectify_map_fisheye(K, D, new_K, (W, H), device=device)
    return remap_bilinear(img, map_x, map_y)


def undistort_rectify_map_pinhole(K, D, new_K, size, device=None):
    """Source-pixel grids that undistort a standard (rational-model)
    camera image, the twin of cv2.initUndistortRectifyMap (the
    reference's src/calib/calib.py:33-38).

    D: up to 8 coefficients in OpenCV order (k1 k2 p1 p2 k3 k4 k5 k6),
    rounded to float32 as the JAX package rounds them; shorter vectors
    are zero-padded. size: (width, height).
    """
    device = _on_device(K, device)
    K, new_K = (torch.as_tensor(a, device=device) for a in (K, new_K))
    d_in = torch.as_tensor(D, device=device).reshape(-1)[:8].to(torch.float32)
    d = torch.zeros(8, dtype=torch.float32, device=device)
    d[: d_in.shape[0]] = d_in
    d0, d1, d2, d3, d4, d5, d6, d7 = d.reshape(8, 1)
    u, v = _pixel_grid(size, device)
    # output pixel -> ideal normalized coords under new_K
    a = (u - new_K[0, 2:3]) / new_K[0, 0:1]
    b = (v - new_K[1, 2:3]) / new_K[1, 1:2]
    # forward-distort: normalized -> source pixel
    r2 = a * a + b * b
    num = 1.0 + r2 * (d0 + r2 * (d1 + r2 * d4))
    den = 1.0 + r2 * (d5 + r2 * (d6 + r2 * d7))
    radial = num / den
    xd = a * radial + 2.0 * d2 * a * b + d3 * (r2 + 2.0 * a * a)
    yd = b * radial + d2 * (r2 + 2.0 * b * b) + 2.0 * d3 * a * b
    map_x = K[0, 0:1] * xd + K[0, 2:3]
    map_y = K[1, 1:2] * yd + K[1, 2:3]
    return map_x, map_y


def undistort_image_pinhole(img, K, D, new_K=None, device=None):
    """Undistort one standard-camera image (H, W[, C]), the twin of the
    reference's create_undistort_img_function (src/calib/calib.py:33-38:
    initUndistortRectifyMap + INTER_LINEAR remap with P = K)."""
    device = _on_device(img, device)
    K = torch.as_tensor(K, device=device)
    new_K = K if new_K is None else new_K
    H, W = img.shape[:2]
    map_x, map_y = undistort_rectify_map_pinhole(K, D, new_K, (W, H), device=device)
    return remap_bilinear(img, map_x, map_y)
