"""Second probe round, on the port's Hopper kernels: the counterpart of
scripts/probe_mosaic2.py.

1. 4-D shared scratch with a dynamic leading index (read + write);
2. a recurrence written in place (in a copy of the input);
3. transposed-contraction batched matvec (F^T x without a transpose);
4. timing: a chain of K dependent (TB, 32, 32) products in one kernel,
   at FP32 ("highest") and on the TF32 tensor cores ("default"), for TB
   in {1, 2, 4, 8}.

    python -m acinoset_tpu_torch.probes.probe_mosaic2

prints the script's ``OK name: v0 v1`` and ``TIME batched_matmul_chain
TB=.. prec=..: .. ns/op`` lines and exits non-zero if any probe fails.
Entry points run on ``device`` (CUDA unless the caller names another).
"""
from __future__ import annotations

import sys
import time

import torch

from ..kernels import probes_cuda as pk
from ..utils.device import resolve_device
from . import probe_mosaic as _pm

TB, P = 4, 32
PRECISIONS = ("highest", "default")


def dyn4d_scratch_plain(a):
    """k1: s[n] = a[n] + s[n-1], o = s."""
    o = torch.empty_like(a)
    for n in range(a.shape[0]):
        o[n] = a[n] + (o[n - 1] if n >= 1 else torch.zeros_like(a[n]))
    return o


def write_input_ref_plain(a):
    """k2: a[n] = 2 a[n] + a[n-1] in order, on a copy of a."""
    o = a.clone()
    for n in range(a.shape[0]):
        o[n] = o[n] * 2.0 + (o[n - 1] if n >= 1 else torch.zeros_like(o[n]))
    return o


def matvec_transposed_contract_plain(a, v):
    """k3: y[b, j] = sum_i a[b, i, j] v[b, i]."""
    return torch.sum(a * v[:, :, None], dim=-2)


def round_tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the tensor-core path's cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def chain_plain(a, K, prec="highest"):
    """chain_kernel: K steps x <- a @ x from x = a, a (TB, 32, 32) float32.
    ``prec="default"`` rounds a and every x to TF32 before the product,
    as the TF32 kernel does; the sums stay float32."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    tf32 = prec == "default"
    A = round_tf32(a) if tf32 else a
    x = a
    for _ in range(K):
        xr = round_tf32(x) if tf32 else x
        x = torch.sum(A[..., :, :, None] * xr[..., None, :, :], dim=-2)
    return x


def t1(device=None):
    device = resolve_device(device)
    return pk.dyn4d_scratch(torch.ones((5, TB, P, P), dtype=torch.float32, device=device))


def t2(device=None):
    device = resolve_device(device)
    return pk.write_input_ref(torch.ones((5, TB, P, P), dtype=torch.float32, device=device))


def t3(device=None):
    device = resolve_device(device)
    a = torch.arange(TB * P * P, dtype=torch.float32, device=device).reshape(TB, P, P) / 100.0
    v = torch.ones((TB, P), dtype=torch.float32, device=device)
    out = pk.matvec_transposed_contract(a, v)
    want = torch.einsum("bij,bi->bj", a, v)
    if not torch.allclose(out, want):
        raise AssertionError("wrong result")
    return out


def _seconds(fn, device):
    """Seconds of one call: CUDA events around it on a CUDA device, the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def time_chain(tb, K=2000, prec="highest", device=None):
    """Nanoseconds per step of the K-step chain on tb tiles of 0.999 I:
    one warm-up launch, then the least of three launches each timed
    alone. Prints the script's TIME line and returns the ns per step."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    device = resolve_device(device)
    a = (torch.eye(P, dtype=torch.float32, device=device)[None] * 0.999).repeat(tb, 1, 1)
    chain = pk.chain_highest if prec == "highest" else pk.chain_tf32
    chain(a, K)
    ns_per_op = min(_seconds(lambda: chain(a, K), device) for _ in range(3)) / K * 1e9
    print(f"TIME batched_matmul_chain TB={tb} prec={prec}: {ns_per_op:.0f} ns/op", flush=True)
    return ns_per_op


PROBES = [("dyn4d_scratch", t1), ("write_input_ref", t2), ("matvec_transposed_contract", t3)]


def main() -> int:
    ok = [_pm.report(name, t) for name, t in PROBES]
    for prec in PRECISIONS:
        for tb in (1, 2, 4, 8):
            try:
                time_chain(tb, prec=prec)
                ok.append(True)
            except Exception as e:  # a probe's failure is its result: report it and go on
                print(f"FAIL chain TB={tb} {prec}: {str(e).splitlines()[0][:160]}", flush=True)
                ok.append(False)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
