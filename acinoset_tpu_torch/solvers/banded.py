"""Block-banded solves on torch tensors, the counterpart of
acinoset_tpu.solvers.banded: the unrolled Cholesky ('chol_unrolled', the
plain version of the CUDA kernel), CG and spectral PCG, the library
Cholesky ('chol'), the 3-frame grouping into block-tridiagonal form
('grouped', and the cyclic reduction of solvers/cyclic.py), and the
marginal covariance of the Laplace posterior.

Band convention: ``bands[k]`` has shape (..., N, P, P) and holds block
(n, n-k) at index n (zero for n < k); the matrix is symmetric and only
the lower bands are stored. Bandwidth is 3 (the FTE's third-difference
stencil). Leading dimensions are a batch of independent systems, where
the JAX package vmaps; the time recurrences are Python loops over N,
where it scans.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..utils.precision import f32_matmuls


def _T(x):
    return x.mT


def _mv(M, v):
    """Batched matrix-vector product M (..., m, n) v (..., n)."""
    return (M @ v[..., None])[..., 0]


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
    def blk(i, j):
        return A[..., i * p:(i + 1) * p, j * p:(j + 1) * p]

    L11, L11i = _chol_inv_unrolled(blk(0, 0))
    L21 = blk(1, 0) @ _T(L11i)
    L31 = blk(2, 0) @ _T(L11i)
    L22, L22i = _chol_inv_unrolled(blk(1, 1) - L21 @ _T(L21))
    L32 = (blk(2, 1) - L31 @ _T(L21)) @ _T(L22i)
    L33, L33i = _chol_inv_unrolled(blk(2, 2) - L31 @ _T(L31) - L32 @ _T(L32))

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

    # rows n-1, n-2, n-3 of the factor as (L0inv, L1, L2)
    r1 = r2 = r3 = (eye, zM, zM)
    Li, L1, L2, L3 = [], [], [], []
    for n in range(N):
        a0, a1, a2, a3 = A0[..., n, :, :], A1[..., n, :, :], A2[..., n, :, :], A3[..., n, :, :]
        (Li_1, L1_1, L2_1), (Li_2, L1_2, _), (Li_3, _, _) = r1, r2, r3
        l3 = a3 @ _T(Li_3)
        l2 = (a2 - l3 @ _T(L1_2)) @ _T(Li_2)
        l1 = (a1 - l3 @ _T(L2_1) - l2 @ _T(L1_1)) @ _T(Li_1)
        S = a0 - l1 @ _T(l1) - l2 @ _T(l2) - l3 @ _T(l3)
        _L0, li = _chol_inv_unrolled(S)
        r1, r2, r3 = (li, l1, l2), r1, r2
        Li.append(li)
        L1.append(l1)
        L2.append(l2)
        L3.append(l3)

    zv = torch.zeros_like(b[..., 0, :])
    y = []
    for n in range(N):
        y1, y2, y3 = (y[n - k] if n >= k else zv for k in (1, 2, 3))
        y.append(_mv(Li[n], b[..., n, :] - _mv(L1[n], y1) - _mv(L2[n], y2) - _mv(L3[n], y3)))

    x = [None] * N
    for n in reversed(range(N)):
        rhs = y[n]
        for k, Lk in ((1, L1), (2, L2), (3, L3)):
            if n + k < N:
                rhs = rhs - _mv(_T(Lk[n + k]), x[n + k])
        x[n] = _mv(_T(Li[n]), rhs)
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


def banded_cg_solve(bands: Sequence[torch.Tensor], b: torch.Tensor, num_iters: int = 50,
                    tol: float = 1e-8) -> torch.Tensor:
    """Conjugate gradients on the SPD block-banded system (Jacobi-scaled
    to unit diagonal by the FTE solver): ``pcg_solve`` with the identity
    preconditioner, the recurrence of the JAX version, every scalar per
    system."""
    return pcg_solve(lambda p: banded_matvec(bands, p), lambda r: r, b, num_iters=num_iters,
                     tol=tol)


def banded_pcg_solve(bands: Sequence[torch.Tensor], b: torch.Tensor, U: torch.Tensor,
                     eigs: torch.Tensor, wq: torch.Tensor, c: torch.Tensor, num_iters: int = 16,
                     tol: float = 1e-6) -> torch.Tensor:
    """Spectral PCG against explicit banded storage, the testing form of
    the structured operator ``fte_solve`` applies: bands are the unscaled
    [A0..A3] with the damping in A0; c (..., P) as in ``spectral_minv``."""
    return pcg_solve(lambda p: banded_matvec(bands, p), spectral_minv(U, eigs, wq, c), b,
                     num_iters=num_iters, tol=tol)


# ---- direct solves with library Cholesky and triangular solves ----

def _tri_solve_right(L, B):
    """X = B L^{-T} for lower-triangular L (solves X L^T = B)."""
    return torch.linalg.solve_triangular(L, B.mT, upper=False).mT


def _cholesky_or_nan(S):
    """Lower Cholesky factors of S (..., P, P). A matrix that is not
    positive definite gets NaN, as ``jnp.linalg.cholesky`` returns it, so
    the LM step of that system alone fails its finiteness test.
    ``cholesky_ex`` checks nothing on the host: a CUDA call does not
    synchronise."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)


@f32_matmuls()
def block_banded_cholesky(bands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Factor the SPD bandwidth-3 matrix, bands [A0..A3] (..., N, P, P):
    returns the factor's bands [L0..L3] in the same convention, L0 the
    lower Cholesky factors of the diagonal blocks' Schur complements."""
    A0 = bands[0]
    P = A0.shape[-1]
    eye = torch.eye(P, dtype=A0.dtype, device=A0.device).expand(A0.shape[:-3] + (P, P))
    zM = torch.zeros_like(eye)
    r1 = r2 = r3 = (eye, zM, zM)  # rows n-1, n-2, n-3 as (L0, L1, L2)
    out = ([], [], [], [])
    for n in range(A0.shape[-3]):
        a0, a1, a2, a3 = (A[..., n, :, :] for A in bands)
        (L0_1, L1_1, L2_1), (L0_2, L1_2, _), (L0_3, _, _) = r1, r2, r3
        L3 = _tri_solve_right(L0_3, a3)
        L2 = _tri_solve_right(L0_2, a2 - L3 @ _T(L1_2))
        L1 = _tri_solve_right(L0_1, a1 - L3 @ _T(L2_1) - L2 @ _T(L1_1))
        L0 = _cholesky_or_nan(a0 - L1 @ _T(L1) - L2 @ _T(L2) - L3 @ _T(L3))
        r1, r2, r3 = (L0, L1, L2), r1, r2
        for acc, v in zip(out, (L0, L1, L2, L3)):
            acc.append(v)
    return [torch.stack(acc, dim=-3) for acc in out]


@f32_matmuls()
def block_banded_solve(L_bands: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b, b (..., N, P), given A's factor bands from
    ``block_banded_cholesky``: forward then backward block substitution
    with triangular solves."""
    L0, L1, L2, L3 = L_bands
    N = b.shape[-2]
    zv = torch.zeros_like(b[..., 0, :])
    y = []
    for n in range(N):
        y1, y2, y3 = (y[n - k] if n >= k else zv for k in (1, 2, 3))
        rhs = (b[..., n, :] - _mv(L1[..., n, :, :], y1) - _mv(L2[..., n, :, :], y2)
               - _mv(L3[..., n, :, :], y3))
        y.append(torch.linalg.solve_triangular(L0[..., n, :, :], rhs[..., None], upper=False)[..., 0])
    x = [None] * N
    for n in reversed(range(N)):
        rhs = y[n]
        for k, Lk in ((1, L1), (2, L2), (3, L3)):
            if n + k < N:
                rhs = rhs - _mv(_T(Lk[..., n + k, :, :]), x[n + k])
        x[n] = torch.linalg.solve_triangular(_T(L0[..., n, :, :]), rhs[..., None], upper=True)[..., 0]
    return torch.stack(x, dim=-2)


# ---- the 3-frame grouping: block-tridiagonal super-blocks ----

def group_bands_tridiagonal(bands: Sequence[torch.Tensor], group: int = 3):
    """Regroup the bandwidth-3 bands [A0..A3] (..., N, P, P) into block-
    tridiagonal form with (3P, 3P) super-blocks of three frames. Pad
    frames (N % 3 != 0) get identity diagonal blocks and no coupling.

    Returns (diag (..., M, G, G), lower (..., M, G, G), M, pad), G = 3P:
    lower[m] couples group m to group m-1, and lower[0] = 0."""
    if len(bands) != 4 or group != 3:
        raise ValueError("grouping is implemented for bandwidth 3, group 3")
    A0, A1, A2, A3 = bands
    N, P = A0.shape[-3], A0.shape[-1]
    M = -(-N // 3)
    pad = 3 * M - N
    if pad:
        eye = torch.eye(P, dtype=A0.dtype, device=A0.device).expand(A0.shape[:-3] + (pad, P, P))
        A0 = torch.cat([A0, eye], dim=-3)
        A1, A2, A3 = (F.pad(A, (0, 0, 0, 0, 0, pad)) for A in (A1, A2, A3))

    def g(A, off):  # A[3m + off] for every group m
        return A[..., off::3, :, :]

    Z = torch.zeros_like(g(A0, 0))
    # diag[m] = [[A0[3m],   A1[3m+1]^T, A2[3m+2]^T],
    #            [A1[3m+1], A0[3m+1],   A1[3m+2]^T],
    #            [A2[3m+2], A1[3m+2],   A0[3m+2]]]
    diag = torch.cat([
        torch.cat([g(A0, 0), _T(g(A1, 1)), _T(g(A2, 2))], dim=-1),
        torch.cat([g(A1, 1), g(A0, 1), _T(g(A1, 2))], dim=-1),
        torch.cat([g(A2, 2), g(A1, 2), g(A0, 2)], dim=-1),
    ], dim=-2)
    # lower[m]: rows 3m..3m+2 against columns 3m-3..3m-1
    lower = torch.cat([
        torch.cat([g(A3, 0), g(A2, 0), g(A1, 0)], dim=-1),
        torch.cat([Z, g(A3, 1), g(A2, 1)], dim=-1),
        torch.cat([Z, Z, g(A3, 2)], dim=-1),
    ], dim=-2)
    lower = torch.cat([torch.zeros_like(lower[..., :1, :, :]), lower[..., 1:, :, :]], dim=-3)
    return diag, lower, M, pad


def _schur_factor_step(Li_prev, d, l):
    """One step of the block-tridiagonal Schur recurrence
    F_m = D_m - Loff Loff^T, Loff = B_m chol(F_{m-1})^{-T}, with the
    column-unrolled factorisation of the (G, G) F_m: returns
    (chol(F_m)^{-1}, Loff). The direct ``grouped`` solve's step."""
    Loff = l @ _T(Li_prev)
    _L, Li = _chol_inv_unrolled(d - Loff @ _T(Loff))
    return Li, Loff


@f32_matmuls()
def banded_solve_grouped(bands: Sequence[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """Factor and solve the bandwidth-3 system through the 3-frame
    grouping: M = ceil(N / 3) Schur steps on (3P, 3P) super-blocks, then
    a forward and a backward pass. bands [A0..A3] (..., N, P, P), g
    (..., N, P) -> x (..., N, P)."""
    N, P = g.shape[-2:]
    diag, lower, M, pad = group_bands_tridiagonal(bands)
    b = F.pad(g, (0, 0, 0, pad)).reshape(g.shape[:-2] + (M, 3 * P))
    Li_prev = torch.eye(3 * P, dtype=g.dtype, device=g.device).expand(diag.shape[:-3] + (3 * P,) * 2)
    Li, Loff = [], []
    for m in range(M):
        Li_prev, lo = _schur_factor_step(Li_prev, diag[..., m, :, :], lower[..., m, :, :])
        Li.append(Li_prev)
        Loff.append(lo)
    y, y_prev = [], torch.zeros_like(b[..., 0, :])
    for m in range(M):
        y_prev = _mv(Li[m], b[..., m, :] - _mv(Loff[m], y_prev))
        y.append(y_prev)
    x = [None] * M
    x[M - 1] = _mv(_T(Li[M - 1]), y[M - 1])
    for m in reversed(range(M - 1)):
        x[m] = _mv(_T(Li[m]), y[m] - _mv(_T(Loff[m + 1]), x[m + 1]))
    return torch.stack(x, dim=-2).reshape(g.shape[:-2] + (3 * M, P))[..., :N, :]


@f32_matmuls()
def block_banded_marginal_covariance(bands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Diagonal blocks of inv(A) for the SPD bandwidth-3 A, bands
    [A0..A3] (..., N, P, P): the per-frame marginal covariances when A is
    a precision matrix. Returns Z (..., N, P, P), Z[n] = block (n, n).

    The recursive Green's function scheme on the 3-frame grouping, with
    D_m, B_m the diagonal and sub-diagonal super-blocks:

        F_m = D_m - B_m F_{m-1}^-1 B_m^T                  (forward Schur)
        Z_{M-1} = F_{M-1}^-1
        Z_m = F_m^-1 + (F_m^-1 B_{m+1}^T) Z_{m+1} (B_{m+1} F_m^-1)

    Every F_m is an SPD Schur complement and the backward step only adds
    PSD terms, which keeps it stable on the FTE's ~1e8-conditioned
    Hessians. The forward step factors F_m by the blocked 3 x 3 form
    (``_chol_inv_blocked3``) and, after the loop, one Newton/Schulz step
    refines the batched F_m^-1; the carried factor keeps the blocked
    form's rounding."""
    N, P = bands[0].shape[-3], bands[0].shape[-1]
    diag, lower, M, _pad = group_bands_tridiagonal(bands)
    G = diag.shape[-1]
    eye = torch.eye(G, dtype=diag.dtype, device=diag.device)
    Li_prev = eye.expand(diag.shape[:-3] + (G, G))
    Li, Loff = [], []
    for m in range(M):
        d, l = diag[..., m, :, :], lower[..., m, :, :]
        lo = l @ _T(Li_prev)
        _L, Li_prev = _chol_inv_blocked3(d - lo @ _T(lo), P)
        Li.append(Li_prev)
        Loff.append(lo)
    Li, Loff = torch.stack(Li, dim=-3), torch.stack(Loff, dim=-3)
    Finv = _T(Li) @ Li
    Finv = Finv + Finv @ (eye - (diag - Loff @ _T(Loff)) @ Finv)
    Finv = 0.5 * (Finv + _T(Finv))

    Z = [None] * M
    Z[M - 1] = Finv[..., M - 1, :, :]
    for m in reversed(range(M - 1)):
        W = Finv[..., m, :, :] @ _T(lower[..., m + 1, :, :])  # F_m^-1 B_{m+1}^T
        Zm = Finv[..., m, :, :] + W @ Z[m + 1] @ _T(W)
        Z[m] = 0.5 * (Zm + _T(Zm))
    Z = torch.stack(Z, dim=-3)
    Zf = torch.stack([Z[..., j * P:(j + 1) * P, j * P:(j + 1) * P] for j in range(3)], dim=-3)
    return Zf.reshape(Z.shape[:-3] + (3 * M, P, P))[..., :N, :, :]
