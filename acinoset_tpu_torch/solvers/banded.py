"""Block-banded solves on torch tensors, the counterpart of the solve
core of acinoset_tpu.solvers.banded.

Band convention: ``bands[k]`` has shape (..., N, P, P) and holds block
(n, n-k) at index n (zero for n < k); the matrix is symmetric and only
the lower bands are stored. Bandwidth is 3 (the FTE's third-difference
stencil). Leading dimensions are a batch of independent systems, where
the JAX package vmaps; the time recurrences are Python loops over N,
where it scans.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _chol_inv_unrolled(A):
    """Cholesky factor L and its inverse of SPD matrices (..., P, P) by a
    column loop (left-looking factor, then forward substitution row by
    row), the arithmetic of the JAX version."""
    P = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(P):
        col = A[..., :, j]
        if j > 0:
            col = col - torch.einsum("...ik,...k->...i", L[..., :, :j], L[..., j, :j])
        d = torch.rsqrt(torch.clamp(col[..., j], min=1e-30))
        col = col * d[..., None]
        col[..., :j] = 0.0
        L[..., :, j] = col
    Linv = torch.zeros_like(A)
    for i in range(P):
        row = torch.zeros_like(A[..., 0, :])
        row[..., i] = 1.0
        if i > 0:
            row = row - torch.einsum("...k,...kj->...j", L[..., i, :i], Linv[..., :i, :])
        Linv[..., i, :] = row / L[..., i, i][..., None]
    return L, Linv


def _chol_inv_blocked3(A, p: int):
    """Cholesky factor and inverse of SPD matrices (..., 3p, 3p) over a
    3 x 3 grid of (p, p) blocks: three ``_chol_inv_unrolled`` diagonal
    factorizations and batched (p, p) products for the rest, the
    arithmetic of the JAX version (the RTS smoother's gains)."""
    T = lambda m: m.mT  # noqa: E731

    def blk(i, j):
        return A[..., i * p:(i + 1) * p, j * p:(j + 1) * p]

    L11, L11i = _chol_inv_unrolled(blk(0, 0))
    L21 = blk(1, 0) @ T(L11i)
    L31 = blk(2, 0) @ T(L11i)
    L22, L22i = _chol_inv_unrolled(blk(1, 1) - L21 @ T(L21))
    L32 = (blk(2, 1) - L31 @ T(L21)) @ T(L22i)
    L33, L33i = _chol_inv_unrolled(blk(2, 2) - L31 @ T(L31) - L32 @ T(L32))

    # block lower-triangular inverse
    Li21 = -L22i @ L21 @ L11i
    Li32 = -L33i @ L32 @ L22i
    Li31 = -L33i @ (L31 @ L11i + L32 @ Li21)

    z = torch.zeros_like(L11)
    L = torch.cat([torch.cat([L11, z, z], -1), torch.cat([L21, L22, z], -1),
                   torch.cat([L31, L32, L33], -1)], -2)
    Linv = torch.cat([torch.cat([L11i, z, z], -1), torch.cat([Li21, L22i, z], -1),
                      torch.cat([Li31, Li32, L33i], -1)], -2)
    return L, Linv


def block_banded_solve_unrolled(bands: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """Factor and solve the bandwidth-3 SPD system A x = b, bands
    [A0..A3] (..., N, P, P), b (..., N, P). The factor recurrence:

        L3 = A3 L0inv_{n-3}^T
        L2 = (A2 - L3 L1_{n-2}^T) L0inv_{n-2}^T
        L1 = (A1 - L3 L2_{n-1}^T - L2 L1_{n-1}^T) L0inv_{n-1}^T
        S  = A0 - L1 L1^T - L2 L2^T - L3 L3^T;  L0, L0inv = chol(S)

    then forward and backward block substitution. This is the plain
    version of the CUDA kernel in ``kernels.banded_cuda``."""
    A0, A1, A2, A3 = bands
    N, P = b.shape[-2:]
    eye = torch.eye(P, dtype=b.dtype, device=b.device).expand(A0.shape[:-3] + (P, P))
    zM = torch.zeros_like(eye)
    T = lambda m: m.mT  # noqa: E731

    # rows n-1, n-2, n-3 of the factor as (L0inv, L1, L2)
    r1 = r2 = r3 = (eye, zM, zM)
    Li, L1, L2, L3 = [], [], [], []
    for n in range(N):
        a0, a1, a2, a3 = A0[..., n, :, :], A1[..., n, :, :], A2[..., n, :, :], A3[..., n, :, :]
        (Li_1, L1_1, L2_1), (Li_2, L1_2, _), (Li_3, _, _) = r1, r2, r3
        l3 = a3 @ T(Li_3)
        l2 = (a2 - l3 @ T(L1_2)) @ T(Li_2)
        l1 = (a1 - l3 @ T(L2_1) - l2 @ T(L1_1)) @ T(Li_1)
        S = a0 - l1 @ T(l1) - l2 @ T(l2) - l3 @ T(l3)
        _L0, li = _chol_inv_unrolled(S)
        r1, r2, r3 = (li, l1, l2), r1, r2
        Li.append(li)
        L1.append(l1)
        L2.append(l2)
        L3.append(l3)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    zv = torch.zeros_like(b[..., 0, :])
    y = []
    for n in range(N):
        y1, y2, y3 = (y[n - k] if n >= k else zv for k in (1, 2, 3))
        y.append(mv(Li[n], b[..., n, :] - mv(L1[n], y1) - mv(L2[n], y2) - mv(L3[n], y3)))

    x = [None] * N
    for n in reversed(range(N)):
        rhs = y[n]
        for k, Lk in ((1, L1), (2, L2), (3, L3)):
            if n + k < N:
                rhs = rhs - mv(T(Lk[n + k]), x[n + k])
        x[n] = mv(T(Li[n]), rhs)
    return torch.stack(x, dim=-2)


def banded_matvec(bands: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = A x for the symmetric block-banded A; x (..., N, P)."""
    y = torch.einsum("...nij,...nj->...ni", bands[0], x)
    for k in range(1, min(len(bands), x.shape[-2])):  # no block (n, n-k) when k >= N
        Ak = bands[k][..., k:, :, :]
        lower = torch.einsum("...nij,...nj->...ni", Ak, x[..., :-k, :])  # block (n, n-k) x[n-k]
        upper = torch.einsum("...nji,...nj->...ni", Ak, x[..., k:, :])  # block (n, n+k) x[n+k]
        y = y + torch.nn.functional.pad(lower, (0, 0, k, 0))
        y = y + torch.nn.functional.pad(upper, (0, 0, 0, k))
    return y


def pcg_solve(matvec, minv, b: torch.Tensor, num_iters: int = 16,
              tol: float = 1e-6) -> torch.Tensor:
    """Preconditioned CG with a fixed iteration count on a batch of
    systems b (..., N, P): every scalar of the recurrence is per system,
    and a system freezes once its M-norm residual drops below tol^2 of
    its initial value."""

    def dot(u, v):
        return torch.sum(u * v, dim=(-2, -1), keepdim=True)

    x = torch.zeros_like(b)
    r = b
    z = minv(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    for _ in range(num_iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        active = (rz > tol * tol * rz0) & (denom > 0)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        alpha = torch.where(active, rz / safe, torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv(r)
        rz_new = dot(r, z)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x


def spectral_minv(U: torch.Tensor, eigs: torch.Tensor, wq: torch.Tensor, c: torch.Tensor):
    """Preconditioner for the unscaled FTE normal equations:
    M = U [2 eigs_k wq_p + c_p] U^T, with U diag(eigs) U^T the
    eigendecomposition of the (N, N) third-difference Gram, wq (P,) the
    model weights and c (..., P) the per-system mean frame-local diagonal.
    It inverts the model term exactly in the smoothness eigenbasis."""
    scale = 2.0 * eigs[:, None] * wq[None, :] + c[..., None, :]  # (..., N, P)

    def minv(r):
        return U @ ((U.T @ r) / scale)

    return minv
