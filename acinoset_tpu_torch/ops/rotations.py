"""SO(3) primitives on torch tensors, the counterpart of
acinoset_tpu.ops.rotations.

``rot_x/y/z`` are *frame* rotations (direction-cosine matrices mapping
inertial-frame vectors into the rotated frame), the transpose of the
usual active rotation, as in the reference kinematic model. Every
function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch


def mm3(A, B):
    """(.., 3, 3) @ (.., 3, 3) as broadcast-multiply-reduce (the JAX
    package's form; kept so the two agree to the last bits in f64)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def mvT3(R, v):
    """``R^T @ v`` for (.., 3, 3) and (.., 3)."""
    return torch.sum(R * v[..., :, None], dim=-2)


def mv3(R, v):
    """``R @ v`` for (.., 3, 3) and (.., 3)."""
    return torch.sum(R * v[..., None, :], dim=-1)


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(a):
    """Frame rotation about x. a: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[o, z, z], [z, c, s], [z, -s, c]])


def rot_y(a):
    """Frame rotation about y. a: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[c, z, -s], [z, o, z], [s, z, c]])


def rot_z(a):
    """Frame rotation about z. a: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[c, s, z], [-s, c, z], [z, z, o]])


def rodrigues(rvec):
    """so(3) exponential map: rotation vector (..., 3) -> matrix (..., 3, 3),
    with the same Taylor guard near theta = 0 as the JAX version."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    one = torch.ones_like(theta)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    cosc = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.where(small, one, theta2)
    )
    kx, ky, kz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    z = torch.zeros_like(kx)
    K = _mat([[z, -kz, ky], [kz, z, -kx], [-ky, kx, z]])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + sinc * K + cosc * (K @ K)


def rodrigues_inv(R):
    """so(3) log map: rotation matrix (..., 3, 3) -> vector (..., 3)
    (cv2.Rodrigues, matrix to vector), with the JAX version's Taylor
    branch near theta = 0 and its diagonal formula near theta = pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    # antisymmetric part -> axis * sin(theta)
    w = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < 1e-6
    scale = torch.where(small, 1.0 + theta**2 / 6.0,
                        theta / torch.where(small, torch.ones_like(theta), torch.sin(theta)))
    generic = w * scale[..., None]
    # near pi: axis from the diagonal, signs from the off-diagonals
    c = cos_t[..., None]
    axis = torch.sqrt(torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1) - c) / (1.0 - c + 1e-12),
                                  min=0.0))
    signs = torch.stack(
        [torch.ones_like(theta), torch.sign(R[..., 0, 1] + R[..., 1, 0] + 1e-30),
         torch.sign(R[..., 0, 2] + R[..., 2, 0] + 1e-30)],
        dim=-1,
    )
    near_pi = (theta > torch.pi - 1e-3)[..., None]
    return torch.where(near_pi, axis * signs * theta[..., None], generic)
