"""Block cyclic reduction for the FTE's banded normal equations, the
counterpart of acinoset_tpu.solvers.cyclic.

The bandwidth-3 system is regrouped into block-tridiagonal form with
3-frame super-blocks (``banded.group_bands_tridiagonal``, G = 3P). Each
level eliminates the odd-indexed blocks: with
x_o = D_o^-1 (b_o - L_o x_{o-1} - L_{o+1}^T x_{o+1}) substituted into the
even equations, the evens form a block-tridiagonal system of half the
size,

    D'_e = D_j - L_j D_{j-1}^-1 L_j^T - L_{j+1}^T D_{j+1}^-1 L_{j+1}
    L'_e = -L_j D_{j-1}^-1 L_{j-1}
    b'_e = b_j - L_j D_{j-1}^-1 b_{j-1} - L_{j+1}^T D_{j+1}^-1 b_{j+1}

(j = 2e). The last block is solved, and the levels are walked back up
filling in the odd blocks: log2 M levels of batched (G, G) products in
place of M sequential steps. Leading dimensions of the bands are a batch
of independent systems.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.precision import f32_matmuls
from .banded import _T, _chol_inv_unrolled, _mv, group_bands_tridiagonal


def _dinv(D):
    """Inverses of SPD blocks (..., G, G) by the unrolled Cholesky inverse."""
    _L, Li = _chol_inv_unrolled(D)
    return _T(Li) @ Li


def _pad_rows(x, count, dim):
    """x with ``count`` zero rows appended along ``dim``."""
    if count == 0:
        return x
    shape = list(x.shape)
    shape[dim] = count
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _shift_in_zero(x, length, dim):
    """[0, x[0], x[1], ...] along ``dim``, cut to ``length`` rows."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x.new_zeros(shape), x], dim=dim).narrow(dim, 0, length)


@f32_matmuls()
def banded_solve_cr(bands: Sequence[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """Solve the SPD bandwidth-3 block-banded system by block cyclic
    reduction. bands [A0..A3] (..., N, P, P), g (..., N, P) -> x
    (..., N, P); the system of ``block_banded_solve_unrolled`` at
    sequential depth O(log N)."""
    N, P = g.shape[-2:]
    diag, lower, M, pad = group_bands_tridiagonal(bands)
    b = torch.nn.functional.pad(g, (0, 0, 0, pad)).reshape(g.shape[:-2] + (M, 3 * P))
    M3, V2 = -3, -2  # the block axis of matrices and of vectors

    levels = []  # per level: (D_odd^-1, L_odd, L_even, b_odd) for the way back up
    D, L = diag, lower
    while D.shape[M3] > 1:
        Ml = D.shape[M3]
        E, O = (Ml + 1) // 2, Ml // 2  # even blocks kept, odd blocks eliminated
        Dinv_o = _dinv(D[..., 1::2, :, :])
        L_even, L_odd, b_odd = L[..., 0::2, :, :], L[..., 1::2, :, :], b[..., 1::2, :]
        # odd-side neighbours of each even block, zero at the ends
        Dinv_prev = _shift_in_zero(Dinv_o, E, M3)  # D[2e-1]^-1
        L_prev_odd = _shift_in_zero(L_odd, E, M3)  # L[2e-1]
        b_prev = _shift_in_zero(b_odd, E, V2)  # b[2e-1]
        L_next = _pad_rows(L_odd, E - O, M3)  # L[2e+1]
        Dinv_next = _pad_rows(Dinv_o, E - O, M3)  # D[2e+1]^-1
        b_next = _pad_rows(b_odd, E - O, V2)  # b[2e+1]

        T1 = L_even @ Dinv_prev  # L[2e] D[2e-1]^-1 (zero at e = 0: L[0] = 0)
        T2 = _T(L_next) @ Dinv_next  # L[2e+1]^T D[2e+1]^-1 (zero past the tail)
        D_new = D[..., 0::2, :, :] - T1 @ _T(L_even) - T2 @ L_next
        L_new = -(T1 @ L_prev_odd)
        L_new = torch.cat([torch.zeros_like(L_new[..., :1, :, :]), L_new[..., 1:, :, :]], dim=M3)
        b_new = b[..., 0::2, :] - _mv(T1, b_prev) - _mv(T2, b_next)

        levels.append((Dinv_o, L_odd, L_even, b_odd))
        D, L, b = D_new, L_new, b_new

    x = _mv(_dinv(D), b)  # the single root block
    for Dinv_o, L_odd, L_even, b_odd in reversed(levels):
        O, E = Dinv_o.shape[M3], x.shape[V2]
        # x_odd[o] = D[2o+1]^-1 (b[2o+1] - L[2o+1] x[2o] - L[2o+2]^T x[2o+2])
        x_next = x[..., 1:O + 1, :]
        L_up = L_even[..., 1:O + 1, :, :]
        rhs = (b_odd - _mv(L_odd, x[..., :O, :])
               - _mv(_T(_pad_rows(L_up, O - L_up.shape[M3], M3)),
                     _pad_rows(x_next, O - x_next.shape[V2], V2)))
        x_full = x.new_zeros(x.shape[:-2] + (E + O, x.shape[-1]))
        x_full[..., 0::2, :] = x
        x_full[..., 1::2, :] = _mv(Dinv_o, rhs)
        x = x_full
    return x.reshape(g.shape[:-2] + (3 * M, P))[..., :N, :]
