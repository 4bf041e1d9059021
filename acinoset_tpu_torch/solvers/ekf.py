"""Extended Kalman filter + RTS smoother on torch tensors, the counterpart
of acinoset_tpu.solvers.ekf (the reference EKF, AcinoSet
src/all_optimizations.py:569-865).

Constant-acceleration dynamics over [pose, vel, acc] blocks; the
measurement is every camera x marker x pixel through FK and the fisheye
rig, with an exact analytic Jacobian; 3-sigma innovation gating per
(x, y) pair; a pose-block conditioning update through two unrolled
(n_pose, n_pose) Cholesky inverses; and a backward Rauch-Tung-Striebel
pass, associative (log2(N) doubling levels) or sequential.

``run_ekf`` takes a leading batch of runs, where the JAX package vmaps,
and runs a Python loop over frames, where it scans. The loop holds no
host synchronisation: every per-run decision is a ``torch.where``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch

from ..utils.precision import f32_matmuls
from .banded import _chol_inv_blocked3, _chol_inv_unrolled


@dataclass(frozen=True)
class EkfConfig:
    dt: float
    sigma_bound: float = 3.0  # innovation gate (:609)
    dlc_thresh: float = 0.5
    meas_std_px: float = 5.0  # trusted-point sigma (:757)
    #: untrusted sigma = camera width (:610); a float, or a (B,) tensor
    #: with one value per run of the batch
    max_pixel_err: Union[float, torch.Tensor] = 1920.0


def constant_acc_F(n_pose: int, dt: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """State-transition Jacobian for [pos, vel, acc] blocks (:759-764)."""
    n = 3 * n_pose
    F = torch.eye(n, dtype=dtype, device=device)
    i = torch.arange(2 * n_pose, device=device)
    F[i, i + n_pose] = dt
    j = torch.arange(n_pose, device=device)
    F[j, j + 2 * n_pose] = dt**2 / 2
    return F


def constant_acc_Q(qb_std: np.ndarray, dt: float) -> np.ndarray:
    """Process covariance: [[dt^4/4, dt^3/2, dt^2/2], ...] x qb (:749-754)."""
    qb = np.diag(np.asarray(qb_std) / 2.0) ** 2
    return np.block(
        [
            [dt**4 / 4 * qb, dt**3 / 2 * qb, dt**2 / 2 * qb],
            [dt**3 / 2 * qb, dt**2 * qb, dt * qb],
            [dt**2 / 2 * qb, dt * qb, qb],
        ]
    )


def predict_next_state(x: torch.Tensor, dt: float, n_pose: int) -> torch.Tensor:
    """Constant-acceleration prediction (:624-631) over the last axis."""
    pos, vel, acc = x[..., :n_pose], x[..., n_pose:2 * n_pose], x[..., 2 * n_pose:]
    vel_p = vel + dt * acc
    pos_p = pos + dt * vel_p + 0.5 * dt**2 * acc
    return torch.cat([pos_p, vel_p, acc], dim=-1)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


@f32_matmuls()
def run_ekf(
    hj_fn: Callable[[torch.Tensor], tuple],
    pixels: torch.Tensor,
    likelihood: torch.Tensor,
    x0: torch.Tensor,
    P0: torch.Tensor,
    qb_std: np.ndarray,
    config: EkfConfig,
    smoother: str = "auto",
):
    """EKF + RTS smoother over a batch of B runs, on the inputs' device
    and dtype, with every float32 product in full float32.

    Args:
      hj_fn: poses (B, n_pose) -> (h (B, m), J (B, m, n_pose)), the
        measurement and its Jacobian (e.g. ``pipeline.ekf.make_hj_fn``);
        m = C * L * 2.
      pixels: (B, N, C, L, 2) measured pixels (NaN where missing).
      likelihood: (B, N, C, L) DLC likelihoods.
      x0: (B, 3 n_pose) initial states. P0: (3 n_pose, 3 n_pose) or
        (B, 3 n_pose, 3 n_pose) initial covariance.
      qb_std: (n_pose,) per-DoF process std (the reference's qb_list).
      config: EkfConfig; ``max_pixel_err`` may hold one value per run.
      smoother: 'associative' (log2(N) doubling levels of batched
        products), 'sequential' (an N-step reverse loop, less memory), or
        'auto' (associative up to N=256, sequential beyond).

    Returns a dict of (B, N, n_pose) states x, dx, ddx and smoothed_*,
    the pose-block covariances P and smoothed_P (B, N, n_pose, n_pose),
    and 'outliers' (B,), the gated pairs of each run.
    """
    dtype, device = x0.dtype, x0.device
    B, N = pixels.shape[:2]
    n_pose = x0.shape[-1] // 3
    n_states = 3 * n_pose
    dt = config.dt

    F = constant_acc_F(n_pose, dt, dtype, device)
    Q = torch.as_tensor(constant_acc_Q(qb_std, dt), dtype=dtype, device=device)
    # F = Fc (x) I_{n_pose} in [pos, vel, acc] blocks: F P F^T is a 3x3
    # scalar contraction over the block grid
    Fc = torch.tensor([[1.0, dt, dt * dt / 2.0], [0.0, 1.0, dt], [0.0, 0.0, 1.0]],
                      dtype=dtype, device=device)

    def fpft(P):
        Pb = P.reshape(*P.shape[:-2], 3, n_pose, 3, n_pose)
        return torch.einsum("ab,...bicj,dc->...aidj", Fc, Pb, Fc).reshape(P.shape)

    mpe = torch.as_tensor(config.max_pixel_err, dtype=dtype, device=device).reshape(-1, 1)
    x = x0
    P = P0.expand(B, n_states, n_states)
    x_h = torch.empty((B, N, n_states), dtype=dtype, device=device)
    P_h = torch.empty((B, N, n_states, n_states), dtype=dtype, device=device)
    outliers = torch.zeros(B, dtype=torch.int64, device=device)
    for i in range(N):
        # predict
        x_pred = predict_next_state(x, dt, n_pose)
        P_pred = fpft(P) + Q

        # measure (H = [Hp | 0] is never formed: every product below
        # factors through the pose block)
        h, Hp = hj_fn(x_pred[:, :n_pose])  # (B, m), (B, m, n_pose)
        trusted = (likelihood[:, i] > config.dlc_thresh).reshape(B, -1).repeat_interleave(2, -1)
        Rdiag = torch.where(trusted, config.meas_std_px, mpe) ** 2
        residual = pixels[:, i].reshape(B, -1) - h
        missing = torch.isnan(residual)
        residual = torch.where(missing, 0.0, residual)
        Rdiag = torch.where(missing, mpe**2, Rdiag)

        # 3-sigma gating per (x, y) pair from diag(S), S = H P H^T + R,
        # which touches only the pose-pose covariance block
        Ppp = P_pred[:, :n_pose, :n_pose]
        diagS = ((Hp @ Ppp) * Hp).sum(-1) + Rdiag
        over = torch.abs(residual) > config.sigma_bound * torch.sqrt(diagS)
        pair_over = over.reshape(B, -1, 2).any(-1)
        residual = torch.where(pair_over.repeat_interleave(2, -1), 0.0, residual)
        outliers = outliers + pair_over.sum(-1)

        # pose-block conditioning update (the optimal gain for diagonal
        # R): the pose marginal in information form, then the full state
        # through the prior regression of x on pose:
        #   Gp = Hp^T R^-1 Hp,  b = Hp^T R^-1 r,  Ci = (Ppp^-1 + Gp)^-1
        #   Lam = P_pred[:, :pose] Ppp^-1,  x_est = x_pred + Lam Ci b
        #   P_est = (P_pred - Lam U^T) + Lam Ci Lam^T   (U = P_pred[:, :pose])
        Rinv = 1.0 / Rdiag
        b = _mv(Hp.mT, Rinv * residual)
        Gp = Hp.mT @ (Rinv[..., None] * Hp)
        U = P_pred[:, :, :n_pose]
        _Lp, PiL = _chol_inv_unrolled(Ppp)
        Ppp_inv = PiL.mT @ PiL
        _Lm, CiL = _chol_inv_unrolled(Ppp_inv + Gp)
        Ci = CiL.mT @ CiL
        Lam = U @ Ppp_inv
        x = x_pred + _mv(Lam, _mv(Ci, b))
        P = P_pred - Lam @ U.mT + Lam @ Ci @ Lam.mT
        P = 0.5 * (P + P.mT)
        x_h[:, i] = x
        P_h[:, i] = P

    # the smoother's predicted quantities, in one batched pass from the
    # filtered history (the same ops on the same inputs as in the loop)
    x_pn = predict_next_state(x_h[:, :-1], dt, n_pose)  # (B, N-1, S)
    P_pn = fpft(P_h[:, :-1]) + Q  # (B, N-1, S, S)

    # RTS: xs_n = c_n + A_n xs_{n+1}, Ps_n = D_n + A_n Ps_{n+1} A_n^T,
    # with every gain A_n from one batched blocked Cholesky inverse and
    # one Newton/Schulz refinement X <- X + X (I - P X); the correction
    # is formed apart (X @ Rres, not X (2I - P X)) so that the small term
    # is not absorbed by the large one
    _Lc, Linv = _chol_inv_blocked3(P_pn, n_pose)
    Pinv = Linv.mT @ Linv
    del _Lc, Linv
    Rres = torch.eye(n_states, dtype=dtype, device=device) - P_pn @ Pinv
    Pinv = Pinv + Pinv @ Rres
    del Rres
    Pinv = 0.5 * (Pinv + Pinv.mT)
    A = P_h[:, :-1] @ F.T @ Pinv
    del Pinv
    c = x_h[:, :-1] - _mv(A, x_pn)
    D = P_h[:, :-1] - A @ P_pn @ A.mT
    del P_pn

    if smoother == "auto":
        smoother = "associative" if N <= 256 else "sequential"
    if smoother == "associative":
        # the recursion composes affine maps n -> n+1 -> ... -> N-1, an
        # associative monoid: a reverse suffix scan by doubling. At
        # distance d, element n (for n < N - d) becomes f o g with
        # f = element n (earlier, applied last) and g = element n + d
        # (later); elements n >= N - d already end in the terminal map
        # X -> x_est_{N-1}, and are final
        A_s = torch.cat([A, torch.zeros_like(A[:, :1])], 1)
        c_s = torch.cat([c, x_h[:, -1:]], 1)
        D_s = torch.cat([D, P_h[:, -1:]], 1)
        del A, c, D
        d = 1
        while d < N:
            Af, Ag = A_s[:, :N - d], A_s[:, d:]
            c_new = c_s[:, :N - d] + _mv(Af, c_s[:, d:])
            D_new = D_s[:, :N - d] + Af @ D_s[:, d:] @ Af.mT
            A_new = Af @ Ag
            c_s[:, :N - d] = c_new
            D_s[:, :N - d] = D_new
            A_s[:, :N - d] = A_new
            del c_new, D_new, A_new, Af, Ag
            d *= 2
        x_s = c_s
        P_s_pose = D_s[..., :n_pose, :n_pose]
    elif smoother == "sequential":
        # an N-step reverse loop: two batched products a step, and only
        # the pose block of each smoothed covariance is kept
        x_s = torch.empty_like(x_h)
        P_s_pose = torch.empty((B, N, n_pose, n_pose), dtype=dtype, device=device)
        xs, Ps = x_h[:, -1], P_h[:, -1]
        x_s[:, -1], P_s_pose[:, -1] = xs, Ps[:, :n_pose, :n_pose]
        for i in range(N - 2, -1, -1):
            A_i = A[:, i]
            xs = c[:, i] + _mv(A_i, xs)
            Ps = D[:, i] + A_i @ Ps @ A_i.mT
            x_s[:, i], P_s_pose[:, i] = xs, Ps[:, :n_pose, :n_pose]
    else:
        raise ValueError(f"unknown smoother {smoother!r}")

    v, a = n_pose, 2 * n_pose
    return dict(
        x=x_h[..., :v],
        dx=x_h[..., v:a],
        ddx=x_h[..., a:],
        smoothed_x=x_s[..., :v],
        smoothed_dx=x_s[..., v:a],
        smoothed_ddx=x_s[..., a:],
        P=P_h[..., :v, :v],
        smoothed_P=P_s_pose,
        outliers=outliers,
    )
