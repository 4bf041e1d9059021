"""Robust losses and their IRLS weights on torch tensors, the
counterpart of acinoset_tpu.ops.losses (the reference's redescending
cost, src/build.py:380-395, plus Huber and Cauchy)."""
from __future__ import annotations

import torch


def _step(start, x):
    """Logistic step 1/(1+e^{-(x-start)})."""
    return 1.0 / (1.0 + torch.exp(-(x - start)))


def _piece(start, end, x):
    return _step(start, x) - _step(end, x)


def redescending_loss(err, a, b, c):
    """Exact reference redescending cost."""
    e = torch.abs(err)
    cost = (1.0 - _step(a, e)) / 2.0 * e**2
    cost = cost + _piece(a, b, e) * (a * e - (a**2) / 2.0)
    cost = cost + _piece(b, c, e) * (
        a * b - (a**2) / 2.0 + (a * (c - b) / 2.0) * (1.0 - ((c - e) / (c - b)) ** 2)
    )
    cost = cost + _step(c, e) * (a * b - (a**2) / 2.0 + (a * (c - b) / 2.0))
    return cost


def redescending_weight(err, a, b, c, eps: float = 1e-9):
    """IRLS weight psi(|e|)/|e| of the un-blended piecewise redescending psi."""
    e = torch.abs(err)
    w_quad = torch.ones_like(e)
    w_lin = a / torch.clamp(e, min=eps)
    w_desc = a * torch.clamp((c - e) / (c - b), 0.0, 1.0) / torch.clamp(e, min=eps)
    return torch.where(e <= a, w_quad, torch.where(e <= b, w_lin, w_desc))


def cauchy_loss(err, f_scale):
    """rho(e) = f^2/2 * log(1 + (e/f)^2)."""
    z = (err / f_scale) ** 2
    return 0.5 * f_scale**2 * torch.log1p(z)


def cauchy_weight(err, f_scale):
    """IRLS weight for the Cauchy loss: w = 1 / (1 + (e/f)^2)."""
    return 1.0 / (1.0 + (err / f_scale) ** 2)


def huber_loss(err, delta):
    e = torch.abs(err)
    return torch.where(e <= delta, 0.5 * e**2, delta * (e - 0.5 * delta))


def huber_weight(err, delta, eps: float = 1e-9):
    e = torch.abs(err)
    return torch.where(e <= delta, torch.ones_like(e), delta / torch.clamp(e, min=eps))
