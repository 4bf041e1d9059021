#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (acinoset_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds the banded-Cholesky kernel from the checkout;
  3. kernel  - the kernel against its plain PyTorch version at the
               flagship shape (B=96, N=100, P=25) on a well-conditioned
               and an FTE-like ill-conditioned batch, with its time, the
               plain version's, a dense torch.linalg.solve yardstick's and
               the bound the card sets;
  4. main    - the batched flagship FTE solve (B=96, N=100, C=6, L=20,
               float32, 13 GN iterations, linear_solver='pallas') on
               bench.py's synthetic input, counting kernel launches;
  5. golden  - fte_run with the default config (pcg, float64) against
               tests/golden/fte_synthetic_n30.npz;
  6. profile - measurement only: the main path's time with each linear
               solver and a torch.profiler breakdown of one solve.

Any failed check raises. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package. Needs a CUDA device: without one, or
outside a checkout of the repository, it exits non-zero before printing
any result.
"""
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fte_synthetic_n30.npz")

# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _phase(name, t0, text):
    print(f"[{name}] {time.perf_counter() - t0:.2f} s  {text}", flush=True)


def _cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_banded_batch(rng, B, N, P, kind):
    """Batched SPD block-banded systems (float64 numpy), Jacobi-scaled to
    unit diagonal as the FTE solver does, mirroring
    tests/test_pallas_kernels.py: 'well' is diagonally dominant; 'fte' is
    the third-difference Gram at 90 fps plus frame-local measurement
    coupling and 1e-5 LM damping (kappa ~ 1/damping)."""
    from acinoset_tpu_torch.solvers.trajopt import _d3_gram_bands

    eye = np.eye(P)
    if kind == "well":
        bands = [rng.normal(size=(B, N, P, P)) for _ in range(4)]
        for k in range(1, 4):
            bands[k][:, :k] = 0.0
        bands[0] = bands[0] + bands[0].transpose(0, 1, 3, 2)
        row = np.abs(bands[0]).sum(-1)
        for k in range(1, 4):
            row = row + np.abs(bands[k]).sum(-1)  # lower blocks (n, n-k)
            row[:, :-k] += np.abs(bands[k][:, k:]).sum(-2)  # upper blocks (n, n+k)
        bands[0] = bands[0] + (row.max(axis=(1, 2)) + 1.0)[:, None, None, None] * eye
    else:
        gram = _d3_gram_bands(N, 1.0 / 90.0)
        bands = [np.broadcast_to(gram[k][None, :, None, None] * eye, (B, N, P, P)).copy()
                 for k in range(4)]
        M = rng.normal(size=(B, N, 8, P))
        bands[0] = bands[0] + np.einsum("bnmi,bnmj->bnij", M, M)
        d = np.diagonal(bands[0], axis1=-2, axis2=-1)
        bands[0] = bands[0] + 1e-5 * d[..., None] * eye
    s = 1.0 / np.sqrt(np.diagonal(bands[0], axis1=-2, axis2=-1))  # (B, N, P)
    shift = [s] + [np.concatenate([np.zeros((B, k, P)), s[:, :-k]], axis=1)[:, :N]
                   for k in range(1, 4)]
    bands = [bands[k] * s[..., :, None] * shift[k][..., None, :] for k in range(4)]
    return bands, rng.normal(size=(B, N, P))


def dense_from_bands(bands):
    """(B, N*P, N*P) symmetric matrices from the lower block bands."""
    B, N, P, _ = bands[0].shape
    A = torch.zeros((B, N, N, P, P), dtype=bands[0].dtype, device=bands[0].device)
    n = torch.arange(N, device=bands[0].device)
    A[:, n, n] = bands[0]
    for k in range(1, 4):
        m = n[k:]
        A[:, m, m - k] = bands[k][:, k:]
        A[:, m - k, m] = bands[k][:, k:].mT
    return A.permute(0, 1, 3, 2, 4).reshape(B, N * P, N * P)


def banded_bound_ms(B, N, P):
    """Least time the card could take for the factor+solve: the larger of
    the FP32 operations over the FP32 peak and the bytes (bands and g read
    once, x written once) over the memory rate. Per frame, the operations
    the recurrence needs (an FMA is two): three products with a
    triangular L0inv^T (P^3 each), three general products (2 P^3 each),
    three symmetric updates of S (P^3 each), the Cholesky and the
    triangular inverse (P^3/3 each); the two substitutions, three general
    and one triangular matvec each (14 P^2)."""
    flops = B * N * (3 * P**3 + 6 * P**3 + 3 * P**3 + 2 * P**3 / 3 + 14 * P**2)
    nbytes = 4 * (4 * B * N * P * P + 2 * B * N * P)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _phase("device", t0, f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    from acinoset_tpu_torch.kernels import banded_cuda

    t0 = time.perf_counter()
    path = banded_cuda.build()
    secs = time.perf_counter() - t0
    _phase("build", t0, f"{os.path.relpath(path, ROOT)} built in {secs:.2f} s")
    return secs


def phase_kernel(device, B=96, N=100, P=25):
    """The kernel against the plain version on the card. Tolerances:
    'well' (kappa ~ 3): max |x - x_plain64| <= 1e-5 max |x_plain64|, f32
    rounding of a well-conditioned solve; 'fte': residual parity with the
    plain version run in f32, |A x - g| <= 2 |A x_plain32 - g| + 1e-4 |g|
    per system, as tests/test_pallas_kernels.py holds the TPU kernel (both
    err ~ kappa eps_f32 there)."""
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.solvers.banded import banded_matvec, block_banded_solve_unrolled

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    out = {}
    for kind in ("well", "fte"):
        bands_np, g_np = make_banded_batch(rng, B, N, P, kind)
        b64 = [torch.as_tensor(a, device=device) for a in bands_np]
        g64 = torch.as_tensor(g_np, device=device)
        b32 = [a.float().contiguous() for a in b64]
        g32 = g64.float().contiguous()
        x_k = banded_solve(b32, g32)
        torch.cuda.synchronize()
        x_ref = block_banded_solve_unrolled(b64, g64)
        err = float((x_k.double() - x_ref).abs().max())
        scale = float(x_ref.abs().max())
        res_k = torch.linalg.vector_norm(banded_matvec(b64, x_k.double()) - g64, dim=(1, 2))
        gn = torch.linalg.vector_norm(g64, dim=(1, 2))
        if kind == "well":
            if not err <= 1e-5 * scale:
                raise AssertionError(f"kernel vs plain (well): max err {err:.3g} > 1e-5 * {scale:.3g}")
        else:
            x_p32 = block_banded_solve_unrolled(b32, g32)
            res_p = torch.linalg.vector_norm(banded_matvec(b64, x_p32.double()) - g64, dim=(1, 2))
            worst = float(torch.max(res_k - (2.0 * res_p + 1e-4 * gn)))
            if not worst <= 0:
                raise AssertionError(f"kernel residual exceeds 2x plain f32 + 1e-4|g| by {worst:.3g}")
        out[kind] = dict(max_abs_err=err, rel_err=err / scale,
                         rel_residual=float(torch.max(res_k / gn)))
        if kind == "fte":  # time on the system the solver actually sees
            kernel_ms = _cuda_ms(lambda: banded_solve(b32, g32), reps=20, warmup=3)
            plain_ms = _cuda_ms(lambda: block_banded_solve_unrolled(b32, g32), reps=2)
            A = dense_from_bands(b32)
            rhs = g32.reshape(B, N * P, 1)
            library_ms = _cuda_ms(lambda: torch.linalg.solve(A, rhs), reps=2)
            del A
    bound_ms, bound_by = banded_bound_ms(B, N, P)
    rec = dict(
        name="banded_chol", route="cuda",
        source="acinoset_tpu_torch/kernels/csrc/banded_chol.cu",
        replaces="acinoset_tpu/kernels/banded_pallas.py:238",
        launches=None, max_abs_err=out["well"]["max_abs_err"],
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms,
    )
    _phase("kernel", t0, f"B={B} N={N} P={P}: well max_abs_err {out['well']['max_abs_err']:.3g} "
           f"rel_res {out['well']['rel_residual']:.3g}; fte max_abs_err "
           f"{out['fte']['max_abs_err']:.3g} (rel {out['fte']['rel_err']:.3g}) rel_res {out['fte']['rel_residual']:.3g}; "
           f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.2f} library_ms {library_ms:.2f} "
           f"bound_ms {bound_ms:.4f} ({bound_by})")
    return rec


def _main_inputs(device, B, N, C, iters, solver):
    """bench.py's flagship input, through the port's entry points: the
    batched initial trajectory, the measurement pieces and the config."""
    from acinoset_tpu_torch.pipeline.ekf import make_hj_parts_fn
    from acinoset_tpu_torch.pipeline.fte import default_config, initial_trajectory_batch
    from acinoset_tpu_torch.utils import synthetic

    cams = synthetic.ring_cameras(n_cams=C)
    k_arr, d_arr, r_arr, t_arr, _res = cams
    X_true = synthetic.cheetah_gallop(N=N, fps=90.0)
    pixels, likelihood, pts3d = synthetic.render_measurements(
        X_true, cams, noise_px=1.5, outlier_frac=0.02, bad_lik_frac=0.05, seed=0
    )
    cfg = replace(default_config(90.0, num_iters=iters), plain_iters=5, linear_solver=solver)
    aux = [np.broadcast_to(a, (B,) + a.shape) for a in (k_arr, d_arr, r_arr, t_arr)]
    X0s = initial_trajectory_batch(
        np.broadcast_to(pixels, (B,) + pixels.shape),
        np.broadcast_to(likelihood, (B,) + likelihood.shape), aux, np.arange(N), 0.5,
        device=device,
    )
    rng = np.random.default_rng(1)  # replicas differ by small perturbations, as in bench.py
    X0b = np.stack([x + rng.normal(scale=1e-3, size=x.shape) for x in X0s])
    meas = np.broadcast_to(pixels.transpose(1, 0, 2, 3), (B, N, C) + pixels.shape[2:])
    w = (likelihood.transpose(1, 0, 2) > 0.5) / cfg.meas_std_px
    wb = np.broadcast_to(w, (B,) + w.shape)
    dt = torch.float32
    hj_parts = make_hj_parts_fn(k_arr, d_arr, r_arr, t_arr, dt, device)
    args = (torch.as_tensor(X0b, dtype=dt, device=device),
            torch.as_tensor(np.ascontiguousarray(meas), dtype=dt, device=device),
            torch.as_tensor(np.ascontiguousarray(wb), dtype=dt, device=device))
    return cfg, hj_parts, args, pts3d


def _solve_and_score(device, cfg, hj_parts, args, pts3d):
    """One synchronised solve: (seconds, X, info, mean marker error m)."""
    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.solvers.trajopt import fte_solve

    t1 = time.perf_counter()
    X, info = fte_solve(hj_parts, *args, cfg, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    mk = cheetah.fk25(X).cpu().numpy()
    if not np.isfinite(mk).all():
        raise AssertionError("non-finite marker positions")
    return secs, X, info, float(np.mean(np.linalg.norm(mk - pts3d[None], axis=-1)))


def phase_main(device, B=96, N=100, C=6, iters=13, reps=3):
    """The flagship batched FTE solve, as bench.py sets it up, through the
    port's entry points with linear_solver='pallas'. traj/s is B * reps
    over the summed time of the reps timed solves (after one warm-up)."""
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve

    t0 = time.perf_counter()
    inputs = _main_inputs(device, B, N, C, iters, "pallas")
    _solve_and_score(device, *inputs)  # warm-up: allocator, cuBLAS handles
    banded_solve.launches = 0
    secs, _X, info, mk_err = _solve_and_score(device, *inputs)
    launches = banded_solve.launches
    times = [secs] + [_solve_and_score(device, *inputs)[0] for _ in range(reps - 1)]
    n_conv = int(info["converged"].sum())
    gmax = float(info["grad_norm"].max())
    if not launches >= iters:
        raise AssertionError(f"kernel launched {launches} times in {iters} GN iterations")
    if not mk_err < 0.02:
        raise AssertionError(f"mean marker error {mk_err} m is not under 0.02 m")
    _phase("main", t0, f"B={B} N={N} C={C} L=20 f32 iters={iters} pallas: "
           f"traj/s {B * reps / sum(times):.2f} over {reps} solves "
           f"(solve s {', '.join(f'{t:.4f}' for t in times)}); "
           f"n_converged {n_conv}/{B}; max_grad_norm {gmax:.4g}; "
           f"mean_marker_err_m {mk_err:.5f}; banded_chol launches {launches}")
    return launches


def phase_profile(device, B=96, N=100, C=6, iters=13):
    """Measurement only, after the main path's counts are read: the main
    path's time with each linear solver (one warm-up, then one timed
    solve; the plain 'chol_unrolled' solve runs once, unwarmed), and a
    torch.profiler breakdown of one 'pallas' solve (device busy share and
    the kernels that hold the most device time)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for solver in ("pallas", "pcg", "chol_unrolled"):
        inputs = _main_inputs(device, B, N, C, iters, solver)
        if solver != "chol_unrolled":
            _solve_and_score(device, *inputs)
        secs, _X, info, mk_err = _solve_and_score(device, *inputs)
        print(f"[profile] {solver}: solve s {secs:.4f} traj/s {B / secs:.2f} n_converged "
              f"{int(info['converged'].sum())}/{B} max_grad_norm "
              f"{float(info['grad_norm'].max()):.4g} mean_marker_err_m {mk_err:.5f}", flush=True)
    inputs = _main_inputs(device, B, N, C, iters, "pallas")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = _solve_and_score(device, *inputs)[0]
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
    _phase("profile", t0, f"pallas solve {secs * 1e3:.1f} ms wall, device busy {dev_ms:.1f} ms "
           f"({100 * dev_ms / (secs * 1e3):.1f}%), {sum(e.count for e in ka)} device ops; top: "
           + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                       for e in top))


def phase_golden(device):
    """The port's fte_run (default config: pcg, float64) against the JAX
    package's golden fixture, with tests/test_golden.py's tolerances."""
    from acinoset_tpu_torch.pipeline.fte import fte_run
    from acinoset_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    cams = synthetic.ring_cameras(n_cams=4)
    k, d, r, t, _res = cams
    X = synthetic.cheetah_gallop(N=30, fps=90.0)
    pixels, likelihood, _ = synthetic.render_measurements(
        X, cams, noise_px=1.0, outlier_frac=0.01, bad_lik_frac=0.02, seed=11
    )
    out = fte_run(pixels, likelihood, k, d, r, t, fps=90.0, dlc_thresh=0.5, num_iters=40,
                  device=device)
    ref = np.load(GOLDEN)
    perr = float(np.abs(out["positions"] - ref["positions"]).max())
    if not perr <= 5e-4:
        raise AssertionError(f"golden positions differ by {perr} m > 5e-4")
    cref = float(ref["cost"])
    if not abs(out["cost"] - cref) < 0.001 * cref + 1.0:
        raise AssertionError(f"golden cost {out['cost']} vs {cref}")
    _phase("golden", t0, f"positions max err {perr:.3g} m (tol 5e-4); cost {out['cost']:.6f} "
           f"vs {cref:.6f}; converged {out['converged']}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    if not os.path.isdir(os.path.join(ROOT, "acinoset_tpu_torch")) or not os.path.exists(GOLDEN):
        sys.exit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()
    device = torch.device("cuda")
    phase_device()
    phase_build()
    rec = phase_kernel(device)
    rec["launches"] = phase_main(device)
    phase_golden(device)
    phase_profile(device)
    print(f"[total] {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
