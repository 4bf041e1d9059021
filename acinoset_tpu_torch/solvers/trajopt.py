"""FTE trajectory optimisation as a batched banded Gauss-Newton solver,
the counterpart of acinoset_tpu.solvers.trajopt.

The reference's collocation NLP (Pyomo -> IPOPT) with its equality
constraints eliminated: minimise over the active pose trajectory
X (N, P)

    sum_n |sqrt(1/Q) D3 X|^2 + sum redesc(w_meas (proj(FK(x_n)) - meas))
    + limit_penalty |violation of lo <= X <= hi|^2

by LM-damped Gauss-Newton with IRLS redescending weights (plain, then
robust after ``plain_iters``), a polish tail and a Jacobi-scaled
stationarity status. ``fte_solve`` is natively batched: it solves B
trajectories at once, with per-run accept/reject, damping and cost
where the JAX package vmaps a single-run solver.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.banded_cuda import banded_solve
from ..ops import losses
from ..utils.device import resolve_device
from ..utils.precision import f32_matmuls
from .banded import (
    banded_cg_solve,
    banded_solve_grouped,
    block_banded_cholesky,
    block_banded_marginal_covariance,
    block_banded_solve,
    block_banded_solve_unrolled,
    pcg_solve,
    spectral_minv,
)
from .cyclic import banded_solve_cr

LINEAR_SOLVERS = ("pcg", "cg", "chol", "chol_unrolled", "grouped", "cr", "pallas")
MEAS_LOSSES = ("redescending", "l1", "quadratic")
ASSEMBLIES = ("auto", "einsum", "vpu")


@dataclass(frozen=True)
class FteConfig:
    """Field names and defaults as the JAX FteConfig; see there for the
    measured reasons behind each default."""

    Ts: float  # timestep = 1/fps
    q_var: Tuple[float, ...]  # per-pose-param model variance
    lo: Tuple[float, ...]  # joint lower bounds (len P)
    hi: Tuple[float, ...]  # joint upper bounds
    meas_std_px: float = 5.0
    redesc: Tuple[float, float, float] = (3.0, 10.0, 20.0)
    meas_loss: str = "redescending"
    num_iters: int = 60
    plain_iters: int = 15
    #: 'pcg' (spectrally preconditioned CG on the unscaled system), or a
    #: solve of the Jacobi-scaled bands: 'cg' (plain CG), 'chol' (library
    #: Cholesky and triangular solves), 'chol_unrolled' (the banded
    #: Cholesky in plain PyTorch), 'grouped' (3-frame super-blocks), 'cr'
    #: (block cyclic reduction, solvers/cyclic.py) or 'pallas' (the
    #: hand-written CUDA kernel, kernels/banded_cuda.py; its plain
    #: version on CPU tensors)
    linear_solver: str = "chol_unrolled"
    cg_iters: int = 50
    pcg_iters: int = 16
    limit_penalty: float = 1e4
    lam0: float = 1e-2
    lam_init: Optional[float] = None
    lam_up: float = 4.0
    lam_down: float = 0.5
    relinearize_every: int = 1
    stat_tol: float = 0.05
    polish_iters: int = 1
    #: H/g assembly of the measurement pieces in hj_parts form: 'einsum'
    #: (per-marker cores A by einsum, G = A Jfk by matmul) or 'vpu' (A and
    #: G as broadcast-multiply-reduce, the JAX package's TPU order); the
    #: H = Jfk^T G product is one merged K = 3L matmul in both. 'auto'
    #: means 'einsum' (the JAX package picks 'vpu' on a TPU only)
    assembly: str = "auto"
    #: 'pcg' only: the measurement matvec multiplies H_meas and x rounded
    #: to bfloat16, accumulating in the working dtype; the diagonal it
    #: cancels is the rounded H's own
    pcg_meas_bf16: bool = False


def third_difference(X, Ts):
    """slack_model[n] = (x[n] - 3x[n-1] + 3x[n-2] - x[n-3]) / Ts^2, n >= 3,
    along axis -2 of X (..., N, P)."""
    return (X[..., 3:, :] - 3.0 * X[..., 2:-1, :] + 3.0 * X[..., 1:-2, :] - X[..., :-3, :]) / Ts**2


def _d3_correlate(v, Ts):
    """g = D3^T v for v (..., N-3, P): the adjoint of third_difference."""
    g = (
        F.pad(v, (0, 0, 3, 0))
        - 3.0 * F.pad(v, (0, 0, 2, 1))
        + 3.0 * F.pad(v, (0, 0, 1, 2))
        - F.pad(v, (0, 0, 0, 3))
    )
    return g / Ts**2


def _d3_gram_dense(N: int, Ts: float) -> np.ndarray:
    """Dense D3^T D3 (exact, boundary-corrected). Shape (N, N)."""
    c = np.array([-1.0, 3.0, -3.0, 1.0]) / Ts**2
    D = np.zeros((max(N - 3, 0), N))
    for r in range(max(N - 3, 0)):
        D[r, r : r + 4] = c
    return D.T @ D


def _d3_gram_bands(N: int, Ts: float) -> np.ndarray:
    """Scalar bands of D3^T D3. Shape (4, N)."""
    G = _d3_gram_dense(N, Ts)
    bands = np.zeros((4, N))
    for k in range(4):
        for n in range(k, N):
            bands[k, n] = G[n, n - k]
    return bands


def _meas_rho(cfg, e):
    a, b, c = cfg.redesc
    if cfg.meas_loss == "redescending":
        return losses.redescending_loss(e, a, b, c)
    if cfg.meas_loss == "l1":
        return losses.huber_loss(e, a)
    return 0.5 * e * e


def _meas_irls(cfg, e):
    a, b, c = cfg.redesc
    if cfg.meas_loss == "redescending":
        return losses.redescending_weight(e, a, b, c)
    if cfg.meas_loss == "l1":
        return losses.huber_weight(e, a)
    return torch.ones_like(e)


def fte_objective(X, h_fn, meas, w_meas, cfg: FteConfig):
    """The reference objective on unpadded trajectories X (..., N, P),
    with h_fn mapping poses (..., 25) to pixels (..., C, L, 2). The same
    function ``fte_solve`` minimises. Returns one value per trajectory."""
    q = torch.as_tensor(cfg.q_var, dtype=X.dtype, device=X.device)
    d3 = third_difference(X, cfg.Ts)
    model_term = torch.sum((1.0 / q) * d3 * d3, dim=(-2, -1))
    proj = h_fn(X)
    w = torch.where(torch.isfinite(w_meas), w_meas, torch.zeros_like(w_meas))
    e = w[..., None] * (proj - torch.nan_to_num(meas, nan=0.0))
    meas_term = torch.sum(_meas_rho(cfg, e), dim=(-4, -3, -2, -1))
    lo = torch.as_tensor(cfg.lo, dtype=X.dtype, device=X.device)
    hi = torch.as_tensor(cfg.hi, dtype=X.dtype, device=X.device)
    viol = torch.clamp(lo - X, min=0.0) + torch.clamp(X - hi, min=0.0)
    return model_term + meas_term + cfg.limit_penalty * torch.sum(viol**2, dim=(-2, -1))


def _check_config(cfg: FteConfig):
    if cfg.linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"unknown linear_solver {cfg.linear_solver!r}; choose from {LINEAR_SOLVERS}")
    if cfg.meas_loss not in MEAS_LOSSES:
        raise ValueError(f"unknown meas_loss {cfg.meas_loss!r}; choose from {MEAS_LOSSES}")
    if cfg.assembly not in ASSEMBLIES:
        raise ValueError(f"unknown assembly {cfg.assembly!r}; choose from {ASSEMBLIES}")


def pcg_meas_operator(H_meas: torch.Tensor, bf16: bool = False) -> Callable:
    """The measurement term of the 'pcg' operator: x (..., N, P) ->
    H_meas x less H's diagonal times x (the diagonal sits in the
    operator's diagonal term). With ``bf16`` (``FteConfig.pcg_meas_bf16``)
    H_meas and x are rounded to bfloat16, their products (exact in the
    working dtype) accumulated in the working dtype, and the diagonal
    cancelled is the rounded H's own; x in the diagonal term is not
    rounded."""
    dtype = H_meas.dtype
    if bf16:
        H_mv = H_meas.to(torch.bfloat16).to(dtype)

        def round_x(x):
            return x.to(torch.bfloat16).to(dtype)
    else:
        H_mv = H_meas

        def round_x(x):
            return x
    diag_H = torch.diagonal(H_mv, dim1=-2, dim2=-1)

    def meas_mul(x):
        return (H_mv @ round_x(x)[..., None])[..., 0] - diag_H * x

    return meas_mul


def fte_solve(
    hj_parts_fn: Optional[Callable],
    X0,  # (B, N, P) initial trajectories
    meas,  # (B, N, C, L, 2) pixel measurements
    w_meas,  # (B, N, C, L) weights: 1/R if trusted else 0
    cfg: FteConfig,
    n_valid=None,  # (B,) true trajectory lengths when frames are padded
    compute_cov: bool = False,
    device=None,
    *,
    h_fn: Optional[Callable] = None,
    hj_fn: Optional[Callable] = None,
    camera_sum: Optional[Callable] = None,
):
    """Solve B FTE trajectories at once. Returns (X (B, N, P), info) with
    per-run ``cost``, ``cost0``, ``cost_history`` (B, num_iters), ``lam``,
    ``converged`` and ``grad_norm``.

    The measurement model comes in one of three forms, exactly one given:
    ``hj_parts_fn`` maps poses (B, N, P) to the unassembled pieces (h
    (B, N, m), Jp (B, N, C, L, 2, 3), Jfk (B, N, L, 3, P)), see
    ``pipeline.ekf.make_hj_parts_fn``, and H is assembled from (3, 3)
    per-marker cores (``cfg.assembly``); ``hj_fn`` maps them to the fused
    (h (B, N, m), J (B, N, m, P)), see ``pipeline.ekf.make_hj_fn``; and
    ``h_fn`` maps them to pixels (B, N, C, L, 2), its Jacobian taken by
    forward mode (``torch.func``, one tangent per pose parameter). The
    last two assemble H = J^T W J from the dense J. The function must
    produce tensors on ``device``. Runs on ``device`` (CUDA unless
    ``device="cpu"``; no device and no CUDA raises), in the dtype of X0.

    ``n_valid`` masks third-difference rows touching frames >= n_valid
    (padded frames then carry zero measurement weight and zero model
    coupling and stay at their initialisation). ``converged`` tests the
    Jacobi-scaled gradient inf-norm at the final accepted solution
    against ``cfg.stat_tol``.

    ``compute_cov`` adds the Laplace posterior at the solution before the
    final clamp: ``pose_cov`` (B, N, P, P), the per-frame diagonal blocks
    of the inverse objective Hessian (``banded.
    block_banded_marginal_covariance``), and, in hj_parts form, the
    per-marker ``marker_cov`` (B, N, L, 3, 3) and ``marker_std``
    (B, N, L, 3) in metres. In float32 a ridge of 1e-6 on the
    Jacobi-scaled diagonal keeps the recurrence's pivots positive; the
    recurrence also runs at twice the ridge, and the Richardson
    extrapolation of each variance to no ridge gives the per-run
    ``cov_ridge_shrink`` (the worst relative variance deficit of a live
    pose direction) and, in hj_parts form, ``marker_std_ridge_shrink``
    (B, N, L, 3) and ``cov_ridge_frac`` (the share of live marker cells
    understated by more than 10% in variance). In float64 there is no
    ridge and ``cov_ridge_shrink`` is 0.

    With ``cfg.relinearize_every = k > 1`` the Jacobians refresh on
    iterations k-1, 2k-1, ... and after a rejected step, per run; the
    residual stays exact every iteration: every run takes the h of the
    iteration's one measurement pass.

    ``camera_sum`` is for ``parallel.mesh``: when the cameras of the
    measurements are a shard of the rig's, it returns the sum of a
    camera-partial tensor over every shard of the rig (the measurement
    term of the objective, the per-marker cores or H and g), the same on
    every shard."""
    forms = [f for f in (hj_parts_fn, hj_fn, h_fn) if f is not None]
    if len(forms) != 1:
        raise ValueError("give exactly one of hj_parts_fn, hj_fn and h_fn")
    _check_config(cfg)
    device = resolve_device(device)
    X0 = torch.as_tensor(X0, device=device)
    dtype = X0.dtype
    meas = torch.as_tensor(meas, dtype=dtype, device=device)
    w_meas = torch.as_tensor(w_meas, dtype=dtype, device=device)
    if hj_parts_fn is not None:
        form = "parts", hj_parts_fn
    elif hj_fn is not None:
        form = "dense", hj_fn
    else:
        form = "dense", _jacfwd(h_fn)
    with f32_matmuls():
        return _fte_solve(form, X0, meas, w_meas, cfg, n_valid, compute_cov, camera_sum)


def _jacfwd(h_fn):
    """(h, J) of a batched h_fn: h flattened to (..., m), J (..., m, P) by
    one forward-mode pass per pose parameter. Frames are independent, so
    the tangent e_p on every pose at once gives column p of every
    frame's Jacobian."""

    def hj(X):
        lead, P = X.shape[:-1], X.shape[-1]

        def h_flat(x):
            return h_fn(x).reshape(*lead, -1)

        def column(t):
            return torch.func.jvp(h_flat, (X,), (t,))

        eye = torch.eye(P, dtype=X.dtype, device=X.device)
        tangents = eye.reshape(P, *(1,) * len(lead), P).expand(P, *lead, P)
        h, J = torch.func.vmap(column)(tangents)
        return h[0], torch.movedim(J, 0, -1)

    return hj


def _fte_solve(form, X0, meas, w_meas, cfg, n_valid, compute_cov, camera_sum):
    kind, meas_fn = form
    parts = kind == "parts"
    csum = camera_sum or (lambda t: t)
    B, N, P = X0.shape
    dtype, device = X0.dtype, X0.device
    _, _, C, Lm, _ = meas.shape
    Ts = cfg.Ts

    def const(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)

    q, lo, hi = const(cfg.q_var), const(cfg.lo), const(cfg.hi)
    wq = 1.0 / q

    if cfg.linear_solver == "pcg":
        # eigenbasis of the static third-difference Gram: the spectral
        # preconditioner's basis (host numpy, once per call)
        e_np, U_np = np.linalg.eigh(_d3_gram_dense(N, Ts))
        U_pc, e_pc = const(U_np), const(np.maximum(e_np, 0.0))

    # third-difference row mask (row r involves frames r..r+3), per run
    if n_valid is None:
        row_mask = torch.ones((B, max(N - 3, 0)), dtype=dtype, device=device)
        live = torch.ones((B, N), dtype=torch.bool, device=device)
    else:
        nv = torch.as_tensor(n_valid, device=device).reshape(B, 1)
        row_mask = ((torch.arange(N - 3, device=device) + 3) < nv).to(dtype)
        live = torch.arange(N, device=device) < nv

    # gram bands of D3^T diag(row_mask) D3:
    # band_k[n] = sum_{j=k..3} c_j c_{j-k} row_mask[n-j]
    cst = np.array([-1.0, 3.0, -3.0, 1.0]) / Ts**2
    rm_pad = F.pad(row_mask, (3, 3))
    gram_bands = []
    for kk in range(4):
        acc = torch.zeros((B, N), dtype=dtype, device=device)
        for j in range(kk, 4):
            acc = acc + float(cst[j] * cst[j - kk]) * rm_pad[:, 3 - j : 3 - j + N]
        gram_bands.append(acc)

    meas = torch.nan_to_num(meas, nan=0.0)
    w = torch.where(torch.isfinite(w_meas), w_meas, torch.zeros_like(w_meas))
    w_flat = torch.repeat_interleave(w.reshape(B, N, -1), 2, dim=-1)  # (B, N, m)
    meas_flat = meas.reshape(B, N, -1)
    rmask = row_mask[..., None]

    def rsum(t):  # per-run sum
        return torch.sum(t, dim=(-2, -1))

    def objective_from_h(X, hX):
        d3 = third_difference(X, Ts) * rmask
        model_term = rsum(wq * d3 * d3)
        meas_term = csum(rsum(_meas_rho(cfg, w_flat * (hX - meas_flat))))
        viol = torch.clamp(lo - X, min=0.0) + torch.clamp(X - hi, min=0.0)
        return model_term + meas_term + cfg.limit_penalty * rsum(viol**2)

    vpu = cfg.assembly == "vpu"

    def meas_normal_pieces(hX, JX, robust_on):
        """Measurement GN Hessian blocks H_meas (B, N, P, P) and gradient
        g_meas (B, N, P). In hj_parts form they are contracted through
        the (L, 3, 3) per-marker cores: H = Jfk^T [sum_c Jp^T omega Jp] Jfk,
        g = Jfk^T [sum_c Jp^T omega e]; else H = J^T W J, g = J^T W e of
        the dense J. The camera sums run over every shard of the rig."""
        e = w_flat * (hX - meas_flat)
        w_irls = _meas_irls(cfg, e) if robust_on else torch.ones_like(e)
        if not parts:
            J = JX * w_flat[..., None]  # d e / d x (B, N, m, P)
            H_meas = csum(torch.einsum("bnmi,bnm,bnmj->bnij", J, w_irls, J))
            g_meas = csum(torch.einsum("bnmi,bnm,bnm->bni", J, w_irls, e))
            return H_meas, g_meas
        JpX, JfkX = JX
        omega = (w_flat**2 * w_irls).reshape(B, N, C, Lm, 2)
        er = (w_flat * w_irls * e).reshape(B, N, C, Lm, 2)
        if vpu:
            # broadcast-multiply-reduce over the (C, 2) axes, then over the
            # 3-wide marker axis
            Jw = JpX * omega[..., None]
            A = csum(torch.sum(Jw[..., :, None] * JpX[..., None, :], dim=(2, 4)))
            G = torch.sum(A[..., None] * JfkX[..., None, :, :], dim=-2)  # (B, N, L, 3, P)
        else:
            A = csum(torch.einsum("bnclui,bncluj->bnlij", JpX * omega[..., None], JpX))
            G = A @ JfkX
        H_meas = JfkX.reshape(B, N, Lm * 3, P).mT @ G.reshape(B, N, Lm * 3, P)
        bv = csum(torch.einsum("bnclui,bnclu->bnli", JpX, er))
        g_meas = torch.einsum("bnlxa,bnlx->bna", JfkX, bv)
        return H_meas, g_meas

    def limit_hessian(X):
        viol_lo = torch.clamp(lo - X, min=0.0)
        viol_hi = torch.clamp(X - hi, min=0.0)
        h_lim = 2.0 * cfg.limit_penalty * ((viol_lo > 0) | (viol_hi > 0)).to(dtype)
        return viol_lo, viol_hi, h_lim

    diag_model = 2.0 * gram_bands[0][..., None] * wq  # (B, N, P)

    def objective_grad_and_diag(X, H_meas, g_meas):
        """Full gradient g = g_meas + 2 g_model + g_lim and the undamped
        Jacobi diagonal, shared by the iteration and the status test."""
        d3 = third_difference(X, Ts) * rmask
        g_model = _d3_correlate(d3 * wq, Ts)
        viol_lo, viol_hi, h_lim = limit_hessian(X)
        g = g_meas + 2.0 * g_model + 2.0 * cfg.limit_penalty * (viol_hi - viol_lo)
        diag0 = diag_model + torch.diagonal(H_meas, dim1=-2, dim2=-1) + h_lim
        return g, diag0, h_lim

    def hessian_bands(H_meas, h_lim):
        """Undamped objective-Hessian bands: 2x the model gram, the
        measurement GN blocks and the active limit-penalty diagonal."""
        bands = [torch.diag_embed(2.0 * gram_bands[k][..., None] * wq) for k in range(4)]
        bands[0] = bands[0] + H_meas + torch.diag_embed(h_lim)
        return bands

    def jacobi_scale(bands, diag):
        """Bands scaled to unit diagonal, and the scale s (B, N, P)."""
        s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-20))
        s_shift = [s] + [F.pad(s[..., :-k, :], (0, 0, k, 0)) for k in range(1, 4)]
        return [bands[k] * s[..., :, None] * s_shift[k][..., None, :] for k in range(4)], s

    def solve_step(H_meas, g, diag0, damp, h_lim):
        if cfg.linear_solver == "pcg":
            # the unscaled system as a structured operator: the model term
            # as the D3 stencil, the measurement term as one batched
            # matvec with H's diagonal cancelled (it is in diag_extra)
            diag_extra = diag0 + damp - diag_model
            meas_mul = pcg_meas_operator(H_meas, cfg.pcg_meas_bf16)

            def A_mul(x):
                d3x = third_difference(x, Ts) * rmask
                model = 2.0 * _d3_correlate(d3x * wq, Ts)
                return model + meas_mul(x) + diag_extra * x

            c_pc = torch.clamp(torch.mean(diag_extra, dim=-2), min=1e-12)  # (B, P)
            return pcg_solve(A_mul, spectral_minv(U_pc, e_pc, wq, c_pc), -g,
                             num_iters=cfg.pcg_iters)
        bands = hessian_bands(H_meas, h_lim)
        bands[0] = bands[0] + torch.diag_embed(damp)
        # Jacobi scaling to unit diagonal: the model terms carry 1/Ts^4
        # (~1e7 at 90 fps) against O(1e4) measurement terms
        bands, s = jacobi_scale(bands, diag0 + damp)
        rhs = -g * s
        if cfg.linear_solver == "cg":
            return banded_cg_solve(bands, rhs, num_iters=cfg.cg_iters) * s
        if cfg.linear_solver == "chol":
            return block_banded_solve(block_banded_cholesky(bands), rhs) * s
        if cfg.linear_solver == "grouped":
            return banded_solve_grouped(bands, rhs) * s
        if cfg.linear_solver == "cr":
            return banded_solve_cr(bands, rhs) * s
        if cfg.linear_solver == "pallas":
            return banded_solve(bands, rhs) * s
        return block_banded_solve_unrolled(bands, rhs) * s

    def where_run(ok, a, b):
        return torch.where(ok.reshape((B,) + (1,) * (a.dim() - 1)), a, b)

    lag = max(int(cfg.relinearize_every), 1)

    def gn_step(state, it):
        X, hX, JX, lam, cost, need_refresh = state
        H_meas, g_meas = meas_normal_pieces(hX, JX, it >= cfg.plain_iters)
        g, diag0, h_lim = objective_grad_and_diag(X, H_meas, g_meas)
        damp = lam[:, None, None] * torch.clamp(diag0, min=1e-8)  # LM damping
        dX = solve_step(H_meas, g, diag0, damp, h_lim)
        X_new = X + dX
        h_new, J_new = hj_batch(X_new)  # the iteration's one measurement pass
        if lag > 1:
            # lagged Jacobians: a run refreshes on schedule or after a
            # rejected step and otherwise keeps its factors (the JAX
            # package's per-run cond under vmap, which runs both branches)
            refresh = need_refresh | (it % lag == lag - 1)
            J_new = choose(refresh, J_new, JX)
        new_cost = objective_from_h(X_new, h_new)
        ok = (new_cost < cost) & torch.isfinite(dX).all(dim=-1).all(dim=-1)
        X = where_run(ok, X_new, X)
        hX = where_run(ok, h_new, hX)
        JX = choose(ok, J_new, JX)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.clamp(torch.where(ok, lam * cfg.lam_down, lam * cfg.lam_up), 1e-10, 1e10)
        return X, hX, JX, lam, cost, ~ok

    def hj_batch(X):
        if not parts:
            return meas_fn(X)
        h, Jp, Jfk = meas_fn(X)
        return h, (Jp, Jfk)

    def choose(ok, a, b):  # per run: the flat J, or the (Jp, Jfk) factors
        if parts:
            return tuple(where_run(ok, x, y) for x, y in zip(a, b))
        return where_run(ok, a, b)

    def shrink(v1, v2):
        """Relative deficit of the variance v1 = v(r) against its
        extrapolation to r = 0, v0 ~ v(r) + (v(r) - v(2r)): 0 where the
        ridge does not matter, towards 1 for near-floppy directions."""
        return torch.clamp((v1 - v2) / torch.clamp(2.0 * v1 - v2, min=1e-30), 0.0, 1.0)

    def posterior(X, hX, JX):
        """The Laplace posterior at the final accepted (X, hX, JX): the
        undamped Hessian bands, Jacobi-scaled, selected-inverted, scaled
        back, and, in hj_parts form, pushed through the FK Jacobian to
        the markers."""
        H_f, _ = meas_normal_pieces(hX, JX, cfg.num_iters > cfg.plain_iters)
        bands = hessian_bands(H_f, limit_hessian(X)[2])
        eye = torch.eye(P, dtype=dtype, device=device)
        # padded frames hold an all-zero block, whose inverse would poison
        # the backward recurrence: pin them to identity precision
        bands[0] = bands[0] + (~live).to(dtype)[..., None, None] * eye
        bands, s = jacobi_scale(bands, torch.diagonal(bands[0], dim1=-2, dim2=-1))
        # float32: the scaled Hessian's ~1e8 conditioning exceeds 1/eps,
        # and rounding would drive Schur pivots negative; a weak ridge of
        # 1e-6 of the unit diagonal keeps them positive
        ridge = 1e-6 if dtype == torch.float32 else 0.0
        if ridge:
            bands[0] = bands[0] + ridge * eye
            # the same recurrence at twice the ridge, for the shrink
            # diagnostic below: one batch of 2B systems
            pair = [torch.stack([bands[0], bands[0] + ridge * eye])]
            Z, Z2 = block_banded_marginal_covariance(pair + [torch.stack([bk, bk]) for bk in bands[1:]])
        else:
            Z = block_banded_marginal_covariance(bands)
        pose_cov = Z * s[..., :, None] * s[..., None, :]
        if ridge:
            rel_pose = shrink(torch.diagonal(Z, dim1=-2, dim2=-1),
                              torch.diagonal(Z2, dim1=-2, dim2=-1))
            rel_pose = torch.where(live[..., None], rel_pose, torch.zeros_like(rel_pose))
            shrink_pose = torch.amax(rel_pose, dim=(-2, -1))
        else:
            shrink_pose = torch.zeros((B,), dtype=dtype, device=device)
        if not parts:  # no marker Jacobian to push the covariance through
            return dict(pose_cov=pose_cov, cov_ridge_shrink=shrink_pose)
        _Jp, Jfk = JX

        def marker_var(pc):
            return torch.clamp(torch.einsum("rnlxa,rnab,rnlxb->rnlx", Jfk, pc, Jfk), min=0.0)

        v1 = marker_var(pose_cov)
        out = dict(pose_cov=pose_cov,
                   marker_cov=torch.einsum("rnlxa,rnab,rnlyb->rnlxy", Jfk, pose_cov, Jfk),
                   marker_std=torch.sqrt(v1), cov_ridge_shrink=shrink_pose)
        if not ridge:
            return out
        rel = shrink(v1, marker_var(Z2 * s[..., :, None] * s[..., None, :]))
        out["marker_std_ridge_shrink"] = rel
        live_cells = live[..., None, None].to(dtype).expand_as(rel)
        hit = (rel > 0.1).to(dtype) * live_cells
        out["cov_ridge_frac"] = (torch.sum(hit, dim=(1, 2, 3))
                                 / torch.clamp(torch.sum(live_cells, dim=(1, 2, 3)), min=1.0))
        return out

    n_polish = min(max(int(cfg.polish_iters), 0), int(cfg.num_iters))
    n_main = int(cfg.num_iters) - n_polish
    h0, J0 = hj_batch(X0)
    cost0 = objective_from_h(X0, h0)
    lam_start = cfg.lam0 if cfg.lam_init is None else cfg.lam_init
    no_refresh = torch.zeros((B,), dtype=torch.bool, device=device)
    state = (X0, h0, J0, torch.full((B,), lam_start, dtype=dtype, device=device), cost0,
             no_refresh)
    cost_hist = []
    for it in range(n_main):
        state = gn_step(state, it)
        cost_hist.append(state[4])
    if n_polish > 0:
        # polish tail: re-evaluate the carry at the segment boundary and
        # clamp the LM damping to lam0 (the JAX package does this under a
        # pinned-f32 context; the port runs pinned throughout, so the
        # re-evaluation reproduces the carry and only the clamp acts)
        X_m = state[0]
        h_p, J_p = hj_batch(X_m)
        lam_p = torch.clamp(state[3], max=cfg.lam0)
        state = (X_m, h_p, J_p, lam_p, objective_from_h(X_m, h_p), no_refresh)
        for it in range(n_main, n_main + n_polish):
            state = gn_step(state, it)
            cost_hist.append(state[4])
    X, hX, JX, lam, cost, _ = state
    extra = posterior(X, hX, JX) if compute_cov else {}

    # status: Jacobi-scaled gradient inf-norm of the loss the last
    # iteration optimised, at the final accepted solution (the polish
    # tail's carried h/J are evaluations at that solution, unless lagged
    # Jacobians let an accepted polish step skip the refresh)
    h_st, J_st = (hX, JX) if n_polish > 0 and lag == 1 else hj_batch(X)
    H_st, g_meas_st = meas_normal_pieces(h_st, J_st, cfg.num_iters > cfg.plain_iters)
    g_st, diag_st, _ = objective_grad_and_diag(X, H_st, g_meas_st)
    grad_norm = torch.amax(
        torch.abs(g_st) * torch.rsqrt(torch.clamp(diag_st, min=1e-12)), dim=(-2, -1)
    )
    X = torch.clamp(X, lo, hi)
    empty = torch.zeros((B, 0), dtype=dtype, device=device)
    return X, dict(
        cost=cost, cost0=cost0,
        cost_history=torch.stack(cost_hist, dim=-1) if cost_hist else empty,
        lam=lam, converged=grad_norm <= cfg.stat_tol, grad_norm=grad_norm, **extra,
    )


def derivatives_from_trajectory(X, Ts):
    """dx, ddx consistent with the backward-Euler constraints, along
    axis -2 of X (..., N, P); the free boundary values copy their first
    defined neighbour."""
    if X.shape[-2] < 2:
        return torch.zeros_like(X), torch.zeros_like(X)
    dx = torch.diff(X, dim=-2) / Ts
    dx = torch.cat([dx[..., :1, :], dx], dim=-2)
    ddx = torch.diff(dx, dim=-2) / Ts
    if ddx.shape[-2] >= 2:
        ddx = torch.cat([ddx[..., 1:2, :], ddx[..., 1:2, :], ddx[..., 1:, :]], dim=-2)
    else:
        ddx = torch.zeros_like(X)
    return dx, ddx
