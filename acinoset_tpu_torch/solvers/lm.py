"""Batched Levenberg-Marquardt solvers on torch tensors, the counterpart
of acinoset_tpu.solvers.lm:

  * `lm_dense` - fixed-iteration damped LM on small dense problems, a
    batch of independent problems at once (the JAX package vmaps it);
  * `sba_points` - points-only bundle adjustment: with the cameras
    fixed, every 3D point is its own 3-parameter problem, so the solve
    is one batched LM over (P, 2C) residuals with per-point
    accept/reject;
  * `sba_points_extrinsics` - joint point and camera-pose refinement by
    Schur-complement LM: the (3, 3) point blocks are eliminated in
    closed form, leaving a dense (6C, 6C) camera system an iteration.

Robust losses enter as iteratively reweighted least squares, with the
weights frozen within a step, and accept/reject compares the true
robust cost. Jacobians come from ``torch.func.jacfwd`` under
``torch.func.vmap``. No host sync inside a loop: the iteration counts
are fixed and every decision is a ``torch.where``. Linear solves skip
torch's singularity check (which raises, and syncs on CUDA): a singular
system gives a non-finite step, which the step test rejects, as
``jnp.linalg.solve``'s inf/nan does in the JAX version.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..convert import rig_to_torch
from ..ops import camera as cam_ops
from ..ops import losses
from ..ops.rotations import rodrigues, rodrigues_inv
from ..utils.precision import f32_matmuls


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor  # final cost
    cost0: torch.Tensor  # initial cost
    lam: torch.Tensor


def solve(A, b):
    """A^-1 b for A (..., n, n) and b (..., n), with no singularity
    check (inf/nan where A is singular)."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def inv(A):
    """A^-1 for A (..., n, n), with no singularity check."""
    return torch.linalg.inv_ex(A)[0]


@f32_matmuls()
def lm_dense(
    residual_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    num_iters: int = 30,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    loss_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_step: Optional[float] = None,
    args: tuple = (),
) -> LMResult:
    """Damped Gauss-Newton / LM with multiplicative damping.

    residual_fn(x, *args): x (n,) -> r (m,) for one problem. x0 is (n,)
    or (..., n); the leading dimensions of x0, shared by every tensor in
    ``args``, index independent problems, each with its own damping and
    accept/reject. With weight_fn, each step uses IRLS weights
    w = weight_fn(r), frozen within the step. Accept/reject uses the true
    robust cost sum(loss_fn(r)) when loss_fn is given (the reweighted
    cost saturates for Cauchy weights and would reward divergence), else
    0.5 sum(w r^2). max_step clips the norm of the update.
    """
    batch, n = x0.shape[:-1], x0.shape[-1]
    nb = len(batch)
    x = x0.reshape(-1, n)
    args = tuple(a.reshape((x.shape[0],) + a.shape[nb:]) for a in args)
    res = vmap(residual_fn)
    jac = vmap(jacfwd(residual_fn))

    def cost_of(x):
        r = res(x, *args)
        if loss_fn is not None:
            return loss_fn(r).sum(-1)
        w = weight_fn(r) if weight_fn is not None else torch.ones_like(r)
        return 0.5 * (w * r * r).sum(-1)

    cost0 = cost = cost_of(x)
    lam = torch.full_like(cost, lam0)
    for _ in range(num_iters):
        r = res(x, *args)
        w = weight_fn(r) if weight_fn is not None else torch.ones_like(r)
        J = jac(x, *args)  # (B, m, n)
        Jw = J * w[..., None]
        H = Jw.mT @ J
        g = (Jw.mT @ r[..., None])[..., 0]
        H_damped = H + lam[:, None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
        dx = -solve(H_damped, g)
        if max_step is not None:
            norm = torch.sqrt((dx * dx).sum(-1, keepdim=True))  # jnp.linalg.norm's arithmetic
            dx = dx * torch.clamp(max_step / torch.clamp(norm, min=1e-12), max=1.0)
        x_new = x + dx
        new_cost = cost_of(x_new)
        ok = (new_cost < cost) & torch.isfinite(dx).all(-1)
        x = torch.where(ok[:, None], x_new, x)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.clamp(torch.where(ok, lam * lam_down, lam * lam_up), 1e-12, 1e12)
    return LMResult(x=x.reshape(x0.shape), cost=cost.reshape(batch),
                    cost0=cost0.reshape(batch), lam=lam.reshape(batch))


# --------------------------------------------------------------------------
# Points-only SBA (cameras fixed): one batched LM over the points
# --------------------------------------------------------------------------


def sba_points(
    pts2d,  # (P, C, 2) pixel observations (arbitrary where masked)
    mask,  # (P, C) bool
    k_arr, d_arr, r_arr, t_arr,  # stacked cameras, leading dim C
    x0_points,  # (P, 3) initial 3D points
    f_scale: float = 50.0,
    num_iters: int = 30,
    project_fn=cam_ops.project_points_fisheye,
):
    """Refine 3D points under fixed cameras with a Cauchy robust loss
    (the reference's bundle_adjust_points_only, loss='cauchy',
    f_scale=50). Each point is its own problem; masked residuals are
    zero. Runs where ``x0_points`` lies.

    Returns (points (P, 3), dict(before, after)) with the unweighted
    masked reprojection residuals, flattened.
    """
    x0 = x0_points
    pts2d = cam_ops._like(pts2d, x0)
    mask = torch.as_tensor(mask, device=x0.device)
    k, d, r, t = rig_to_torch(k_arr, d_arr, r_arr, t_arr, x0.device, x0.dtype)

    def point_residual(x, obs, m):
        res = (project_fn(x, k, d, r, t) - obs).reshape(-1)  # (2C,)
        return torch.where(m[:, None].expand(-1, 2).reshape(-1), res, 0.0)

    out = lm_dense(
        point_residual, x0, num_iters=num_iters, max_step=2.0, args=(pts2d, mask),
        weight_fn=lambda e: losses.cauchy_weight(e, f_scale),
        loss_fn=lambda e: losses.cauchy_loss(e, f_scale),
    )
    before = vmap(point_residual)(x0, pts2d, mask)
    after = vmap(point_residual)(out.x, pts2d, mask)
    return out.x, dict(before=before.reshape(-1), after=after.reshape(-1))


# --------------------------------------------------------------------------
# Points + extrinsics SBA: Schur-complement LM
# --------------------------------------------------------------------------


def sba_points_extrinsics(
    pts2d,  # (P, C, 2)
    mask,  # (P, C) bool
    k_arr, d_arr,  # intrinsics, fixed
    r_arr, t_arr,  # initial extrinsics (C, 3, 3), (C, 3[, 1])
    x0_points,  # (P, 3)
    f_scale: float = 1.0,
    num_iters: int = 50,
    project_fn=cam_ops.project_points_fisheye,
):
    """Joint refinement of camera poses (Rodrigues vector and
    translation) and points (the reference's
    bundle_adjust_points_and_extrinsics, scipy TRF, loss='cauchy',
    f_scale=1). Point blocks are eliminated by a Schur complement and the
    reduced (6C, 6C) system is solved densely each iteration. The
    per-observation Jacobians come from one vmapped jacfwd over the
    (P, C) grid. Runs where ``x0_points`` lies.

    Returns (points (P, 3), R (C, 3, 3), t (C, 3, 1), dict(before, after)).
    """
    pts0 = x0_points
    dtype = pts0.dtype
    pts2d = cam_ops._like(pts2d, pts0)
    k, d, r0, t0 = rig_to_torch(k_arr, d_arr, r_arr, t_arr, pts0.device, dtype)
    C = k.shape[0]
    maskf = cam_ops._like(mask, pts0)
    eye3 = torch.eye(3, dtype=dtype, device=pts0.device)
    eye6 = torch.eye(6, dtype=dtype, device=pts0.device)
    eyeC = torch.eye(C, dtype=dtype, device=pts0.device)
    cams0 = torch.cat([rodrigues_inv(r0), t0], dim=1)  # (C, 6)

    def obs_residual(cam6, pt, K, D, obs):
        return project_fn(pt, K, D, rodrigues(cam6[:3]), cam6[3:]) - obs  # (2,)

    def all_residuals(cams, pts):  # (P, C, 2)
        over_cams = vmap(obs_residual, in_dims=(0, None, 0, 0, 0))
        return vmap(over_cams, in_dims=(None, 0, None, None, 0))(cams, pts, k, d, pts2d)

    jac = jacfwd(obs_residual, argnums=(0, 1))
    all_jacobians = vmap(vmap(jac, in_dims=(0, None, 0, 0, 0)), in_dims=(None, 0, None, None, 0))

    def cost_of(cams, pts):
        # the true robust cost (the reweighted form saturates)
        return (losses.cauchy_loss(all_residuals(cams, pts), f_scale) * maskf[..., None]).sum()

    cams, pts = cams0, pts0
    cost = cost_of(cams, pts)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(num_iters):
        r = all_residuals(cams, pts)
        w = losses.cauchy_weight(r, f_scale) * maskf[..., None]
        Jc, Jp = all_jacobians(cams, pts, k, d, pts2d)  # (P, C, 2, 6), (P, C, 2, 3)
        wJc = w[..., None] * Jc
        wJp = w[..., None] * Jp
        Hcc = torch.einsum("pcki,pckj->cij", wJc, Jc)  # (C, 6, 6)
        Hpp = torch.einsum("pcki,pckj->pij", wJp, Jp)  # (P, 3, 3)
        B = torch.einsum("pcki,pckj->cpij", wJc, Jp)  # (C, P, 6, 3)
        gc = torch.einsum("pcki,pck->ci", wJc, r)  # (C, 6)
        gp = torch.einsum("pcki,pck->pi", wJp, r)  # (P, 3)

        # multiplicative damping on the block diagonals
        dcc = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-12)
        dpp = torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-12)
        Hcc_d = Hcc + lam * dcc[:, :, None] * eye6
        Hpp_d = Hpp + lam * dpp[:, :, None] * eye3
        Hpp_inv = inv(Hpp_d + 1e-12 * eye3)  # (P, 3, 3)

        # Schur complement S = blockdiag(Hcc) - B Hpp^-1 B^T
        BHinv = torch.einsum("cpij,pjk->cpik", B, Hpp_inv)  # (C, P, 6, 3)
        S = -torch.einsum("cpik,dpjk->cidj", BHinv, B) + torch.einsum("cd,cij->cidj", eyeC, Hcc_d)
        rhs = gc - torch.einsum("cpik,pk->ci", BHinv, gp)  # (C, 6)
        dc = -solve(S.reshape(6 * C, 6 * C), rhs.reshape(-1)).reshape(C, 6)
        dp = -(Hpp_inv @ (gp + torch.einsum("cpij,ci->pj", B, dc))[..., None])[..., 0]

        cams_new, pts_new = cams + dc, pts + dp
        new_cost = cost_of(cams_new, pts_new)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        cams = torch.where(ok, cams_new, cams)
        pts = torch.where(ok, pts_new, pts)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-10, 1e10)

    before = all_residuals(cams0, pts0) * maskf[..., None]
    after = all_residuals(cams, pts) * maskf[..., None]
    return (pts, rodrigues(cams[:, :3]), cams[:, 3:].reshape(C, 3, 1),
            dict(before=before.reshape(-1), after=after.reshape(-1)))
