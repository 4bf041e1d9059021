"""Probe the patterns the batched banded kernel is built from, on the
port's Hopper kernels: the counterpart of scripts/probe_mosaic.py.

    python -m acinoset_tpu_torch.probes.probe_mosaic

prints one ``OK name: v0 v1`` line per probe, as the script does, and
exits non-zero if any probe fails. ``t1`` .. ``t8`` feed the script's own
inputs to the kernel wrappers of ``kernels.probes_cuda`` on ``device``
(CUDA unless the caller names another; on the CPU the wrappers run the
plain versions below). The ``*_plain`` functions are the plain PyTorch
versions of the kernels, used by the tests and by chip_smoke.py.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import probes_cuda as pk
from ..utils.device import resolve_device

B, P = 16, 32


def batched_dot_plain(a, b):
    """k1: (B, 32, 32) @ (B, 32, 32), as a broadcast product summed over k."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def bcast_mul_lane_reduce_plain(a, v):
    """k2: sum(a * v[:, None, :], -1)."""
    return torch.sum(a * v[:, None, :], dim=-1)


def value_at_set_static_plain(a):
    """k3: columns 0..3 times 2, the rest copied."""
    x = a.clone()
    x[..., :4] = x[..., :4] * 2.0
    return x


def dma_hbm_ring_plain(x):
    """k4: o[n] = x[n] + 1."""
    return x + 1.0


def ring_dyn_index_plain(a):
    """k5: o[n] = a[n] + o[n-1], added in the kernel's order."""
    o = torch.empty_like(a)
    prev = torch.zeros_like(a[0])
    for n in range(a.shape[0]):
        prev = a[n] + prev
        o[n] = prev
    return o


def dma_out_any_plain(x):
    """k6: o[n] = 3 x[n]."""
    return x * 3.0


def batched_matvec_plain(a, v):
    """k7: (B, 32, 32) @ (B, 32)."""
    return torch.sum(a * v[:, None, :], dim=-1)


def batched_transpose_plain(a):
    """k8: the last two axes swapped."""
    return a.transpose(-1, -2).contiguous()


def _ones(shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def t1(device=None):
    device = resolve_device(device)
    return pk.batched_dot(_ones((B, P, P), device), _ones((B, P, P), device))


def t2(device=None):
    device = resolve_device(device)
    return pk.bcast_mul_lane_reduce(_ones((B, P, P), device), 2.0 * _ones((B, P), device))


def t3(device=None):
    device = resolve_device(device)
    return pk.value_at_set_static(_ones((B, P, P), device))


def t4(device=None):
    device = resolve_device(device)
    x = torch.arange(4 * B * P, dtype=torch.float32, device=device).reshape(4, B, P)
    return pk.dma_hbm_ring(x)


def t5(device=None):
    device = resolve_device(device)
    return pk.ring_dyn_index(_ones((6, B, P), device))


def t6(device=None):
    device = resolve_device(device)
    return pk.dma_out_any(_ones((4, B, P), device))


def t7(device=None):
    device = resolve_device(device)
    return pk.batched_matvec(_ones((B, P, P), device), 2.0 * _ones((B, P), device))


def t8(device=None):
    device = resolve_device(device)
    a = torch.arange(B * P * P, dtype=torch.float32, device=device).reshape(B, P, P)
    return pk.batched_transpose(a)


PROBES = [("batched_dot", t1), ("bcast_mul_lane_reduce", t2), ("value_at_set_static", t3),
          ("dma_hbm_ring", t4), ("ring_dyn_index", t5), ("dma_out_any", t6),
          ("batched_matvec", t7), ("batched_transpose", t8)]


def report(name, fn) -> bool:
    """Run one probe and print OK with its first two values, or FAIL with
    the error; returns whether it ran."""
    try:
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        print(f"OK   {name}: {np.asarray(out.detach().cpu()).ravel()[:2]}", flush=True)
        return True
    except Exception as e:  # a probe's failure is its result: report it and go on
        msg = str(e).split(chr(10))[0][:160]
        print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main() -> int:
    ok = [report(name, t) for name, t in PROBES]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
