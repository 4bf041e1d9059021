"""Carry the JAX package's state across to the port.

This system has no learned weights: its state is the camera rig, the
model tables (copied into ``models.cheetah``) and the solver config.
The functions here take the JAX side's parameters as numpy arrays (or a
plain dict of the JAX ``FteConfig`` dataclass's fields) and return the
port's tensors and config.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .solvers.trajopt import FteConfig


def rig_to_torch(k_arr, d_arr, r_arr, t_arr, device, dtype=torch.float64):
    """Camera stacks in the shapes ``pipeline.ekf.make_hj_parts_fn`` takes
    on the JAX side (K (C, 3, 3), D (C, 4) or (C, 4, 1), R (C, 3, 3),
    t (C, 3) or (C, 3, 1)), as numpy arrays, lists or tensors -> tensors
    K (C, 3, 3), D (C, 4), R (C, 3, 3), T (C, 3) on ``device``."""
    device = torch.device(device)

    def tensor(a):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    k = tensor(k_arr)
    C = k.shape[0]
    return k, tensor(d_arr).reshape(C, -1)[:, :4], tensor(r_arr), tensor(t_arr).reshape(C, 3)


def fte_config_from_dict(fields: dict) -> FteConfig:
    """The port's FteConfig from the JAX FteConfig's fields (e.g.
    ``dataclasses.asdict(jax_cfg)``). Raises on a field the port does not
    know; sequences come back as tuples, as the frozen dataclass holds them."""
    known = {f.name for f in dataclasses.fields(FteConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port's FteConfig: {unknown}")
    kw = {
        k: tuple(float(x) for x in v) if isinstance(v, (list, tuple, np.ndarray)) else v
        for k, v in fields.items()
    }
    return FteConfig(**kw)
