#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (acinoset_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device  - the card's name and power limit (nvidia-smi), read again
               at the end, before the results;
  2. build   - nvcc builds the banded-Cholesky kernel, its phase-clocked
               variant and the probe kernels from the checkout, all at
               once, with each kernel's registers and spills;
  3. kernel  - the banded kernel against its plain PyTorch version at
               the flagship shape (B=96, N=100, P=25) on a
               well-conditioned and an FTE-like ill-conditioned batch,
               with its time (CUDA events and torch.profiler), the plain
               version's, a dense torch.linalg.solve yardstick's (events
               and torch.profiler), the bound the card sets, and where a
               solve's time goes inside the kernel (phase_split);
  4. main    - the batched flagship FTE solve (B=96, N=100, C=6, L=20,
               float32, 13 GN iterations, linear_solver='pallas') on
               bench.py's synthetic input, counting kernel launches;
     mesh    - the device mesh (parallel/mesh.py) on main's input: every
               visible card as one mesh through sharded_fte_solver
               (bit for bit fte_solve on one card, 13 banded launches a
               shard), a (data 1, model 2) mesh with both camera shards
               on the card (40 iterations of 'pcg', cost within 2% of
               the unsharded solve), a data mesh of 2 shards on the card
               beside one call, the h_fn and hj_fn forms, assembly='vpu'
               and pcg_meas_bf16 each in turns with its default, and
               solve_batch over the mesh against device= on 24 of the
               sweep's runs; with two cards or more, a data-only mesh
               over all of them;
  5. golden  - fte_run with the default config (pcg, float64) against
               tests/golden/fte_synthetic_n30.npz;
  6. probes  - the 13 probe kernels (scripts/probe_mosaic*.py's rows)
               against their plain versions on seeded random inputs and
               on the scripts' own inputs, with their times and bounds,
               their library calls' times (events and torch.profiler),
               an empty kernel's device time (the floor under them),
               where the host time of a launch of rows 5 and 9 goes
               (probe_host_split), and rows 1-11 at the flagship's shape,
               the banded kernel's factor-array size, each held to its
               plain version (probe_band_stream); then
               the probe path (every probe entry point and the
               time_chain table at both precisions, beside each
               precision's one-SM floor and the chain kernels'
               registers and spills), counting launches;
  7. sweep   - the sweep's batched FTE stage on 128 synthetic runs
               (8 rigs x 16 seeds, 80-100 frames): solve_batch in chunks
               of 96 (pcg, 13 iterations) and the rescue pass, timed;
  8. ekf     - the EKF slice: float64 run_cheetah_ekf against
               tests/golden/ekf_synthetic_n50.npz (the JAX package's
               outputs); the sweep's batched EKF stage (solve_batch_ekf,
               float32) on the sweep phase's 128 runs, with runs/s, peak
               memory a run, device ops a frame and the marker error;
               then the warm path, solve_batch from the EKF's smoothed
               poses, beside the cold sweep;
  9. generic - the generic-skeleton slice on two skeletons at full
               width, the cheetah exported as a tree (n_pose 63, 6
               cameras) and a human-width DAG (n_pose 48, 2 cameras), 96
               runs of 80-100 frames each: the analytic FK Jacobian
               against the jacfwd fallback on the card,
               solve_batch_generic (float32, chol_unrolled, 30
               iterations) with its rescue, device ops a GN iteration
               (the tree's), solve_batch_ekf_generic; then the 3-link tree (P = 12)
               through linear_solver='pallas', counting the banded
               kernel's launches, against chol_unrolled;
 10. sba     - the SBA reconstruction at the flagship's scene and width
               (6 cameras, N=100, P = 2,000 points, float64, 30
               iterations): the golden check against
               tests/golden/sba_calib_synthetic.npz (the JAX package's
               outputs), s a call, points/s, the robust init's share, the
               marker error against the truth (tests/test_sba.py's
               bounds) and the Cauchy cost before and after;
 11. calib   - camera calibration on a synthetic 6-camera fisheye rig
               (float64): the golden check, fisheye intrinsics (60 views
               a camera, one corrupted and dropped), the pairwise chain
               (30 shared views a pair, reversed corner sets), the board
               data and the board bundle adjustment, and one pinhole
               calibrate_camera and calibrate_pair_extrinsics, s a stage;
 12. images  - calibration from images, the user's path: the calib
               phase's rig rendered as 640 RGB PNG frames of 2704 x 1520
               (40 held-up intrinsics views a camera, 40 views a chain
               pair), calib.app.extract_corners_from_images a folder (the
               device detector), calibrate_fisheye_intrinsics a camera and
               `python -m acinoset_tpu_torch.cli calib`, on every found
               frame and again without the frames the truth shows off
               (the detector's lattice fault), the chain and the board
               SBA also from the true intrinsics; the corners against the
               truth, the device detector against the CPU port, the
               native engine against it, fx and fy, the chain's poses, the
               board SBA's RMS and undistort_image_fisheye against its
               CPU run; s a frame a stage and s a stage;
     video   - the port's mp4v codec at the rig's width: one camera's
               footage (a textured scene, a moving patch, the run's
               markers drawn), 200 frames of 2704 x 1520 at 90 fps,
               encoded and decoded on the card (frames/s with the host
               bitstream's share, MB, PSNR, each decoded frame equal to
               the encoder's reconstruction), get_frames' seeks, the
               first 12 frames on the card against the CPU (bytes and
               frames equal), animate_reconstruction of 200 frames, and
               whether the machine has NVDEC;
     nvdec   - GoPro-shaped H.264 and HEVC written by utils.h26x (H.264
               2704 x 1520, 90 fps, 200 frames, GOP 12 with B frames,
               BT.709 full range; 1920 x 1080 cropped from 1088 in the
               four (matrix, range) pairs; HEVC 2704 x 1520, 48 frames):
               the container's order and parameter sets, NVDEC's parser
               reading each stream's format on the card, the colour
               kernel (nv12_to_bgr, utils/csrc/nvdec.cu) against its
               plain version on the reconstructed frames, its device
               time against its bound; every stream decoded by the
               port's software decoders, H.264's or HEVC's (every frame
               against the reconstruction, one launch a frame, seeks,
               frames/s and the host's share); every frame decoded on NVDEC against
               the reconstruction, one launch a frame, seeks and the
               labelled video's bytes (skipped only where the
               environment visibly withholds the video engine, and then
               the refusal named, no fallback; any other refusal fails);
     h264    - the software H.264 decoder (utils/csrc/h264.cpp) on the
               random-syntax writer's streams (utils.h26x.RandomH264,
               CAVLC and CABAC with B frames, 2704 x 1520 and 1920 x 1080
               from 1088): MP4 and frame SHA-256 equal to cv2's on the
               CPU, one launch a frame, NVDEC's frames against the
               software decoder's where NVDEC decodes, and frames/s at
               2704 x 1520 with the host's share;
     hevc    - the software HEVC decoder (utils/csrc/hevc.cpp) on the
               random-syntax writer's streams (utils.h26x.RandomHEVC, B
               pictures, SAO, deblocking, tiles or wavefronts, 2704 x 1520
               and 1920 x 1080, 8-bit and 10-bit): the same gates as
               h264; each 10-bit frame's conversion (yuv420p10_to_bgr,
               utils/csrc/nvdec.cu) equal to its plain version on the
               same surface, and the kernel's device time at 2704 x 1520
               against its bound;
 13. files   - the file-level pipeline, the user's path: a run directory
               at full width (make_synthetic_run_dir: 6 cameras x 200
               frames x 20 markers, 2704 x 1520, its DLC .h5 files written
               by utils.hdf5 and read back bit for bit, six mp4v
               cam*.mp4 of footage with the markers drawn beside them),
               `cli all` (dlc's six labelled videos, read back at their
               sources' frame count, size and fps, then tri, sba, ekf,
               fte; each held to
               tests/test_pipeline_e2e.py's bounds, tri to the CPU port,
               fte's six reprojected .h5 files to its positions
               projected; fte.svg, ekf.pdf and reconstructions.png read
               back), a seventh camera, H.264, and an eighth, HEVC, each
               through `cli dlc` in a directory of its own (labelled
               through the software decoders, their bytes against
               mpeg4.Writer fed the labels drawn on the reconstruction), `cli eval --hist` against the truth's projections
               (the histogram's counts against np.histogram), `cli view`,
               and `cli sweep --stages fte,ekf` over 8 such runs in two
               fps groups; s a stage, .h5 MB/s, frames/s of the
               videos written and labelled, the runs converged before
               the rescue and the s the plots and histogram add;
 14. uncertainty - the main path's solve with compute_cov=True (the
               Laplace posterior), timed in turns with the plain solve,
               its error bars checked for symmetry, calibration against
               the ground truth and against a float64 solve on the card,
               and its float32 ridge diagnostics checked per run;
 15. solvers - the main path's input through 'chol', 'grouped', 'cr',
               'cg' and 'pcg' with relinearize_every=3, timed once each;
 16. sweep uncertainty - the sweep's 128 runs once with
               uncertainty=True, beside the plain solve's time;
 17. profile - measurement only: the main path's time with 'pallas',
               'pcg' and 'chol_unrolled' (the solvers phase times the
               others) and a torch.profiler breakdown of one solve.

The phases run in the sweep's own stage order: the EKF stage (8) before
the FTE stage with uncertainty (14-16). ekf_after_posterior, which the
script does not run, times the EKF stage after the posterior in one
process; video_profile, which it does not run either, shows where a
frame's time goes in the codec (torch.profiler).

Any failed check raises. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package. Needs a CUDA device: without one, or
outside a checkout of the repository, it exits non-zero before printing
any result.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fte_synthetic_n30.npz")

# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
H100_SMS = 132  # streaming multiprocessors: one SM's share of a peak is peak / 132


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


def _kernel_name(mangled):
    """The name of a ``*_kernel`` function in an Itanium-mangled symbol
    (each name in it is preceded by its length)."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):  # the length may follow other digits
            n = int(m.group()[k:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                return name[:-len("_kernel")]
    return mangled


def _ptxas_stats(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} from nvcc -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = [None, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def _ptxas_summary(log):
    """'kernel N regs' per kernel, and its spills if any, from nvcc -Xptxas -v."""
    return ", ".join(f"{k} {r} regs" + (f", {k} spills {st}/{ld} bytes" if st or ld else "")
                     for k, (r, st, ld) in _ptxas_stats(log).items())


def phase_build():
    """Build the six libraries at once (one nvcc each and the software
    H.264 and HEVC decoders' g++, started together)."""
    from acinoset_tpu_torch.kernels import _nvcc, banded_cuda, probes_cuda
    from acinoset_tpu_torch.utils import h264, hevc, nvdec

    t0 = time.perf_counter()

    def timed(build):
        t1 = time.perf_counter()
        return build(), time.perf_counter() - t1

    with ThreadPoolExecutor(6) as pool:
        futures = [pool.submit(timed, f) for f in (banded_cuda.build, probes_cuda.build,
                                                   lambda: banded_cuda.build(clocked=True),
                                                   nvdec.build)]
        # g++: the software H.264 and HEVC decoders
        software = [pool.submit(timed, f) for f in (h264.build, hevc.build)]
        built = [f.result() for f in futures]
        for path, secs in (f.result() for f in software):
            print(f"[build] {os.path.relpath(path, ROOT)} (g++) built in {secs:.2f} s", flush=True)
    for path, secs in built:
        log = _nvcc.log_path(path).read_text()
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {os.path.relpath(path, ROOT)} built in {secs:.2f} s; spill stores "
              f"{sum(int(v) for v in spills)} bytes; {_ptxas_summary(log)}", flush=True)
    _phase("build", t0, "all libraries")


def phase_kernel(device, B=96, N=100, P=25):
    """The kernel against the plain version on the card. Tolerances:
    'well' (kappa ~ 3): max |x - x_plain64| <= 1e-5 max |x_plain64|, f32
    rounding of a well-conditioned solve; 'fte': residual parity with the
    plain version run in f32, |A x - g| <= 2 |A x_plain32 - g| + 1e-4 |g|
    per system, as tests/test_pallas_kernels.py holds the TPU kernel (both
    err ~ kappa eps_f32 there)."""
    from acinoset_tpu_torch.kernels import banded_cuda
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
            library_device_ms = kernel_device_ms(lambda: torch.linalg.solve(A, rhs), reps=1)
            del A
    device_ms = kernel_device_ms(lambda: banded_solve(b32, g32), "banded_chol_kernel")
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
           f"kernel_ms {kernel_ms:.4f} (device {device_ms:.4f}) plain_ms {plain_ms:.2f} "
           f"library_ms {library_ms:.2f} (device {library_device_ms:.2f}) bound_ms {bound_ms:.4f} "
           f"({bound_by})")
    phase_split(device, banded_cuda.build(clocked=True), bands_np, g_np)
    return rec


def _device_events(events, name=None):
    """The kernels in torch.profiler's key_averages() that ran on the
    device: those of the __global__ function `name`, or with no name all."""
    return [e for e in events if e.self_device_time_total > 0
            and (name is None or f"::{name}(" in e.key)]


def _ms_per_launch(events, name):
    """Mean device ms per launch of the __global__ function `name`, from
    torch.profiler's key_averages(); nan if none ran."""
    hits = _device_events(events, name)
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else float("nan")


def kernel_device_ms(launch, name=None, reps=10, tries=3):
    """Device ms per call of `launch` (torch.profiler), over `reps` calls
    after one warm-up: the __global__ function `name`'s own time per
    launch, or with no name every kernel the call launches. The profiler
    now and then drops device events: a session whose count of kernels is
    not a whole multiple of `reps` (for `name`, not `reps`) is run again,
    up to `tries` sessions; nan if none was whole."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        hits = _device_events(prof.key_averages(), name)
        n = sum(e.count for e in hits)
        if n == reps if name is not None else n > 0 and n % reps == 0:
            return sum(e.self_device_time_total for e in hits) / 1e3 / reps
    return float("nan")


#: the phases between a frame's clock stamps in the banded kernel, and
#: the stamps per frame (banded_chol.cu, banded_chol_solve_clocked)
SPLIT_PHASES = ("loads", "products", "factor", "forward")
SPLIT_SLOTS = 16


def phase_split(device, library, bands_np, g_np, skip=3):
    """Measurement only: where one solve's time goes inside the banded
    kernel. Runs the phase-clocked library (banded_cuda.build(clocked=True))
    on the given float64 systems (in float32) and reads block 0's clock64()
    stamps: microseconds per frame in each phase (from the frame's start
    past its first barrier; the products up to S, and each of their six
    phases; the Cholesky factor and its inverse; the factor's write-back
    and the forward substitution, up to the next frame's start), averaged
    over the frames past the first and last `skip`; then the frame loop,
    the backward substitution and the whole kernel; and the spread of the
    blocks' own spans (global timer), first start to last end. The clock
    rate comes from the global timer read beside block 0's first and last
    stamp."""
    import ctypes

    B, N, P = g_np.shape
    lib = ctypes.CDLL(str(library))
    f = lib.banded_chol_solve_clocked
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    f.restype = ctypes.c_int
    b32 = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous() for a in bands_np]
    g32 = torch.as_tensor(g_np, dtype=torch.float32, device=device).contiguous()
    x = torch.empty_like(g32)
    fac = torch.empty((B, N, 4, 32, 32), dtype=torch.float32, device=device)
    S = SPLIT_SLOTS
    clk = torch.zeros(N * S + 8 + 2 * B, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(2):  # the first launch warms the caches
        err = f(*(ctypes.c_void_p(t.data_ptr()) for t in (*b32, g32, x, fac)), B, N, P,
                ctypes.c_void_p(stream), ctypes.c_void_p(clk.data_ptr()))
        if err != 0:
            raise RuntimeError(f"banded_chol_solve_clocked failed to launch: CUDA error {err}")
    torch.cuda.synchronize()
    c = clk.cpu().numpy().astype(np.float64)
    ghz = (c[N * S + 2] - c[N * S]) / (c[N * S + 3] - c[N * S + 1])
    fr = c[:N * S].reshape(N, S)
    ends = np.concatenate([fr[1:, 0], [c[N * S + 4]]])  # a frame ends where the next starts
    marks = np.stack([fr[:, 0], fr[:, 1], fr[:, 7], fr[:, 8], ends], axis=1)
    sel = slice(skip, N - skip) if N > 2 * skip else slice(None)
    per = np.diff(marks, axis=1)[sel] / ghz / 1e3  # (frames, 4) us
    split = {name: float(per[:, i].mean()) for i, name in enumerate(SPLIT_PHASES)}
    split["frame"] = float(per.sum(axis=1).mean())
    split["product_phases"] = [float(v) for v in (np.diff(fr[sel, 1:8], axis=1) / ghz / 1e3).mean(0)]
    us = lambda cycles: float(cycles / ghz / 1e3)  # noqa: E731
    split.update(loop=us(c[N * S + 4] - c[N * S]), backward=us(c[N * S + 2] - c[N * S + 4]),
                 kernel=us(c[N * S + 2] - c[N * S]))
    spans = c[N * S + 8:].reshape(B, 2)
    split.update(block_min=float((spans[:, 1] - spans[:, 0]).min() / 1e3),
                 block_max=float((spans[:, 1] - spans[:, 0]).max() / 1e3),
                 blocks=float((spans[:, 1].max() - spans[:, 0].min()) / 1e3))
    sub = ", ".join(f"{v:.3f}" for v in split["product_phases"])
    print(f"[kernel] phase split ({os.path.basename(str(library))}, block 0, clock {ghz:.3f} GHz), "
          f"us per frame: loads {split['loads']:.3f}, products {split['products']:.3f} ({sub}), "
          f"factor and inverse {split['factor']:.3f}, forward {split['forward']:.3f}; frame "
          f"{split['frame']:.3f}; frame loop {split['loop']:.1f} us, backward "
          f"{split['backward']:.1f} us, kernel {split['kernel']:.1f} us; blocks' spans "
          f"{split['block_min']:.1f}-{split['block_max']:.1f} us, first start to last end "
          f"{split['blocks']:.1f} us", flush=True)
    return split


def _main_inputs(device, B, N, C, iters, solver, dt=torch.float32, **cfg_kw):
    """bench.py's flagship input, through the port's entry points: the
    batched initial trajectory, the measurement pieces and the config
    (``cfg_kw`` overrides its fields). Replica i is the same for every B."""
    from acinoset_tpu_torch.pipeline.ekf import make_hj_parts_fn
    from acinoset_tpu_torch.pipeline.fte import default_config, initial_trajectory_batch
    from acinoset_tpu_torch.utils import synthetic

    cams = synthetic.ring_cameras(n_cams=C)
    k_arr, d_arr, r_arr, t_arr, _res = cams
    X_true = synthetic.cheetah_gallop(N=N, fps=90.0)
    pixels, likelihood, pts3d = synthetic.render_measurements(
        X_true, cams, noise_px=1.5, outlier_frac=0.02, bad_lik_frac=0.05, seed=0
    )
    cfg = replace(default_config(90.0, num_iters=iters), plain_iters=5, linear_solver=solver,
                  **cfg_kw)
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
    hj_parts = make_hj_parts_fn(k_arr, d_arr, r_arr, t_arr, dt, device)
    args = (torch.as_tensor(X0b, dtype=dt, device=device),
            torch.as_tensor(np.ascontiguousarray(meas), dtype=dt, device=device),
            torch.as_tensor(np.ascontiguousarray(wb), dtype=dt, device=device))
    return cfg, hj_parts, args, pts3d


def _solve_and_score(device, cfg, hj_parts, args, pts3d, compute_cov=False):
    """One synchronised solve: (seconds, X, info, mean marker error m)."""
    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.solvers.trajopt import fte_solve

    t1 = time.perf_counter()
    X, info = fte_solve(hj_parts, *args, cfg, compute_cov=compute_cov, device=device)
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


#: tests/test_parallel.py's rule for camera-sharded 'pcg': every run's
#: cost within 2% of the unsharded solve's after 40 iterations
MESH_PCG_ITERS, MESH_PCG_COST_RTOL = 40, 0.02
#: runs of the sweep phase's set that phase_mesh solves through solve_batch
MESH_SWEEP_RUNS = 24


def _sync_time(fn):
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t1, out


def _mean_marker_err(X, pts3d):
    from acinoset_tpu_torch.models import cheetah

    mk = cheetah.fk25(X).cpu().numpy()
    if not np.isfinite(mk).all():
        raise AssertionError("non-finite marker positions")
    return float(np.mean(np.linalg.norm(mk - pts3d[None], axis=-1)))


def _worker_launches(devices, reset):
    """The banded kernel's launch count in this process (a mesh row's
    worker process), set to 0 first when ``reset``."""
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve

    if reset:
        banded_solve.launches = 0
    return banded_solve.launches


def _worker_solve_s(devices, B, N, C, iters):
    """Seconds of two 'pallas' solves of the main path's input made and
    solved on the row's device inside a mesh row's worker process (no
    pipe in the time): the rows' own speed."""
    d = devices[0]
    cfg, hj_parts, args, _pts = _main_inputs(d, B, N, C, iters, "pallas")
    from acinoset_tpu_torch.solvers.trajopt import fte_solve

    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        fte_solve(hj_parts, *args, cfg, device=d)
        torch.cuda.synchronize(d)
        times.append(time.perf_counter() - t1)
    return times[1:]


def mesh_launches(mesh, reset=False):
    """The banded kernel's launches by a mesh's rows: this process's count
    for a mesh of one row, else the sum of the rows' worker processes'."""
    from acinoset_tpu_torch.parallel import mesh as mesh_lib

    n = mesh.shape["data"]
    return sum(mesh_lib.run_rows(mesh, _worker_launches, [(reset,)] * n))


def phase_mesh(device, B=96, N=100, C=6, iters=13):
    """The device mesh (parallel/mesh.py) and the solver's last options on
    the main path's input. (a) every visible card as one mesh
    (``make_mesh()``) through ``sharded_fte_solver(with_status=True)``
    with 'pallas': on one card bit for bit ``fte_solve``, 13 banded
    launches a shard; (b) a (data 1, model 2) mesh with both camera
    shards on this card, 40 iterations of 'pcg', every run's cost within
    2% of the unsharded solve's; a data mesh of 2 rows on this card
    beside one call (the rows' worker processes, timed); (c) the h_fn
    and hj_fn forms, assembly='vpu' ('pallas') and pcg_meas_bf16
    ('pcg'), each in turns with its default, mean marker error under
    0.02 m; (d)
    solve_batch over the mesh against the same call with device= (on
    several cards, with max_batch at each card's share: the same work),
    on the first 24 runs of the sweep phase's set (a whole share a
    card), mean marker error under 0.02 m; (e) with two cards or more, a
    data-only mesh over all of them, at B and at B a card, and the rows'
    own solve s inside their workers."""
    from acinoset_tpu_torch.parallel import mesh as mesh_lib
    from acinoset_tpu_torch.pipeline import ekf as tekf
    from acinoset_tpu_torch.pipeline.sweep import solve_batch
    from acinoset_tpu_torch.solvers.trajopt import fte_objective, fte_solve

    t0 = time.perf_counter()
    cfg, hj_parts, args, pts3d = _main_inputs(device, B, N, C, iters, "pallas")
    h_fn = tekf.make_h_fn(*hj_parts.rig, torch.float32, device)

    def say(line):
        print(f"[mesh] {line}", flush=True)

    # (a) every visible card as one mesh
    mesh = mesh_lib.make_mesh()
    s_ref, (X_ref, info_ref) = _sync_time(lambda: fte_solve(hj_parts, *args, cfg, device=device))
    solver = mesh_lib.sharded_fte_solver(mesh, None, cfg, hj_parts_fn=hj_parts, with_status=True)
    if mesh.shape["data"] > 1:
        solver(*args)  # warm-up: the rows' worker processes and their cards
    mesh_launches(mesh, reset=True)
    s_mesh, (X, conv, gn) = _sync_time(lambda: solver(*args))
    launches = mesh_launches(mesh)
    if launches != iters * mesh.size:
        raise AssertionError(f"{launches} banded launches over {mesh.size} shards, "
                             f"not {iters} a shard")
    if mesh.size == 1:
        if not (torch.equal(X, X_ref) and torch.equal(conv, info_ref["converged"])
                and torch.equal(gn, info_ref["grad_norm"])):
            raise AssertionError("a one-card mesh is not fte_solve bit for bit")
        same = "bit for bit fte_solve"
    else:
        same = f"max |X - fte_solve X| {float((X.to(device) - X_ref).abs().max()):.3g}"
    mk = _mean_marker_err(X, pts3d)
    if not mk < 0.02:
        raise AssertionError(f"mesh solve mean marker error {mk} m is not under 0.02 m")
    say(f"(a) mesh {mesh.shape} ('pallas'): solve s {s_mesh:.4f} (fte_solve "
        f"{s_ref:.4f}); {same}; banded_chol launches {launches} "
        f"({launches // mesh.size} a shard); mean_marker_err_m {mk:.5f}")

    # (b) the camera reduction: two camera shards on this card
    cfg_pcg = replace(cfg, linear_solver="pcg", num_iters=MESH_PCG_ITERS)
    s1, (X1, _i1) = _sync_time(lambda: fte_solve(hj_parts, *args, cfg_pcg, device=device))
    mesh_c = mesh_lib.make_mesh(devices=[device, device], model_size=2)
    solver_c = mesh_lib.sharded_fte_solver(mesh_c, None, cfg_pcg, hj_parts_fn=hj_parts)
    s2, X2 = _sync_time(lambda: solver_c(*args))
    c1 = fte_objective(X1, h_fn, args[1], args[2], cfg_pcg)
    c2 = fte_objective(X2, h_fn, args[1], args[2], cfg_pcg)
    gap = (c2 - c1).abs() / c1
    if not bool((gap < MESH_PCG_COST_RTOL).all()):
        raise AssertionError(f"camera-sharded pcg cost gap {float(gap.max())} over "
                             f"{MESH_PCG_COST_RTOL}")
    say(f"(b) mesh {mesh_c.shape} on one card ('pcg', {MESH_PCG_ITERS} iterations, "
        f"camera sums by {mesh_lib.TRANSPORT}): solve s {s2:.4f} (unsharded "
        f"{s1:.4f}); cost gap max {float(gap.max()):.3g}, median "
        f"{float(gap.median()):.3g}; mean_marker_err_m {_mean_marker_err(X2, pts3d):.5f}")
    mesh_d = mesh_lib.make_mesh(devices=[device, device], model_axis=False)
    solver_d = mesh_lib.sharded_fte_solver(mesh_d, None, cfg, hj_parts_fn=hj_parts)
    solver_d(*args)  # warm-up: the rows' worker processes
    sd, Xd = _sync_time(lambda: solver_d(*args))
    say(f"    mesh {mesh_d.shape} on one card ('pallas', B={B // 2} a shard): solve s "
        f"{sd:.4f} (one call {s_ref:.4f}); mean_marker_err_m "
        f"{_mean_marker_err(Xd, pts3d):.5f}")

    # (c) the measurement forms and the options, each in turns with its default
    cfg_bf = replace(cfg, linear_solver="pcg")
    variants = [
        ("h_fn (jacfwd)", cfg, dict(h_fn=h_fn), cfg),
        ("hj_fn", cfg, dict(hj_fn=tekf.make_hj_fn(*hj_parts.rig, torch.float32, device)), cfg),
        ("assembly='vpu'", replace(cfg, assembly="vpu"), {}, cfg),
        ("pcg_meas_bf16", replace(cfg_bf, pcg_meas_bf16=True), {}, cfg_bf),
    ]
    for name, cfg_v, kw, cfg_d in variants:
        def run_v():
            return fte_solve(None if kw else hj_parts, *args, cfg_v, device=device, **kw)

        def run_d():
            return fte_solve(hj_parts, *args, cfg_d, device=device)

        times_v, times_d = [], []
        for _ in range(2):
            sv, (Xv, _iv) = _sync_time(run_v)
            sdf, (Xdf, _idf) = _sync_time(run_d)
            times_v.append(sv)
            times_d.append(sdf)
        mk_v, mk_d = _mean_marker_err(Xv, pts3d), _mean_marker_err(Xdf, pts3d)
        if not mk_v < 0.02:
            raise AssertionError(f"{name}: mean marker error {mk_v} m is not under 0.02 m")
        say(f"(c) {name} ({cfg_v.linear_solver}): solve s "
            f"{', '.join(f'{t:.4f}' for t in times_v)} against the default's "
            f"{', '.join(f'{t:.4f}' for t in times_d)}; mean_marker_err_m {mk_v:.5f} "
            f"(default {mk_d:.5f})")

    # (d) one stage over the mesh, on a whole share of runs a card
    mesh_s = mesh_lib.make_mesh(model_axis=False)
    n_rows = mesh_s.shape["data"]
    runs, truth = make_sweep_runs(limit=MESH_SWEEP_RUNS // n_rows * n_rows)
    kw = dict(num_iters=iters, plain_iters=5)
    if mesh_s.shape["data"] > 1:
        solve_batch(runs, 0.5, mesh=mesh_s, **kw)  # warm-up: the rows' cards
    s_dev, by_dev = _sync_time(lambda: solve_batch(runs, 0.5, device=device, **kw))
    s_msh, by_mesh = _sync_time(lambda: solve_batch(runs, 0.5, mesh=mesh_s, **kw))
    def equal(got, want):
        return all(np.array_equal(rg["x"], rw["x"]) and rg["cost"] == rw["cost"]
                   and rg["converged"] == rw["converged"] for rg, rw in zip(got, want))

    def cost_gap(got, want):
        return max(abs(rg["cost"] - rw["cost"]) / abs(rw["cost"]) for rg, rw in zip(got, want))

    err_dev, err_mesh = (np.mean([np.mean(np.linalg.norm(r["positions"] - p, axis=-1))
                                  for r, p in zip(res, truth)]) for res in (by_dev, by_mesh))
    if not err_mesh < 0.02:
        raise AssertionError(f"solve_batch(mesh=) mean marker error {err_mesh} m is not under "
                             "0.02 m")
    if n_rows == 1:
        if not equal(by_mesh, by_dev):
            raise AssertionError("solve_batch(mesh=) differs from device=")
        same = "equal"
    else:
        # each card solves its share of the batch, padded as the whole batch
        # is: the work of device= with max_batch at that share, bit for bit;
        # the cost gap to one batch of every run is what the batch size
        # alone changes in the rounding
        share = len(runs) // n_rows
        by_share = solve_batch(runs, 0.5, device=device, max_batch=share, **kw)
        if not equal(by_mesh, by_share):
            raise AssertionError(f"solve_batch(mesh=) differs from device= in batches of "
                                 f"{share} (max cost gap {cost_gap(by_mesh, by_share):.3g})")
        same = (f"equal to device= in batches of {share}; against one batch of {len(runs)}: "
                f"cost gap max {cost_gap(by_mesh, by_dev):.3g}, converged "
                f"{sum(r['converged'] for r in by_mesh)} against "
                f"{sum(r['converged'] for r in by_dev)}")
    say(f"(d) solve_batch of {len(runs)} runs over mesh {mesh_s.shape}: "
        f"{s_msh:.4f} s, device= {s_dev:.4f} s; {same}; mean_marker_err_m {err_mesh:.5f} "
        f"(device= {err_dev:.5f})")

    # (e) a data-only mesh over every card
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh_e = mesh_lib.make_mesh(model_axis=False)
        solver_e = mesh_lib.sharded_fte_solver(mesh_e, None, cfg, hj_parts_fn=hj_parts)
        solver_e(*args)  # warm-up: every card's allocator and cuBLAS handles
        mesh_launches(mesh_e, reset=True)
        se, Xe = _sync_time(lambda: solver_e(*args))
        mk_e = _mean_marker_err(Xe, pts3d)
        launches_e = mesh_launches(mesh_e)
        if not (mk_e < 0.02 and launches_e == iters * n_cards):
            raise AssertionError(f"data mesh over {n_cards} cards: marker error {mk_e}, "
                                 f"{launches_e} launches")
        say(f"(e) data mesh {mesh_e.shape} over {n_cards} cards ('pallas'): solve s "
            f"{se:.4f} against one card's {s_ref:.4f}; mean_marker_err_m {mk_e:.5f}")
        # the same B runs a card: n_cards times the main path's batch
        big = tuple(torch.cat([a] * n_cards) for a in args)
        solver_e(*big)
        sb, Xb = _sync_time(lambda: solver_e(*big))
        say(f"    {n_cards * B} runs ({B} a card) over the mesh: solve s {sb:.4f}, "
            f"{n_cards * B / sb:.2f} traj/s against one card's {B / s_ref:.2f}; "
            f"mean_marker_err_m {_mean_marker_err(Xb, pts3d):.5f}")
        inner = mesh_lib.run_rows(mesh_e, _worker_solve_s, [(B, N, C, iters)] * n_cards)
        say(f"    inside each row's worker, {B} runs made there: solve s "
            f"{'; '.join(', '.join(f'{t:.4f}' for t in row) for row in inner)}")
    else:
        say("(e) not run: one card is visible (the data mesh over every card needs two "
            "or more)")
    mesh_lib.shutdown_workers()  # the rows' worker processes end with the phase
    _phase("mesh", t0, f"B={B} N={N} C={C} f32 iters={iters}")


#: the calibration rule of tests/test_fte.py's posterior test: frames
#: trimmed at each end, the bounds on std(z) and the share within 3 sigma
CAL_TRIM, CAL_STD_Z, CAL_IN_3SIGMA = 3, (0.2, 1.5), 0.99


def phase_uncertainty(device, B=96, N=100, C=6, iters=13, reps=3, n64=8):
    """The Laplace-posterior pass on the main path's input ('pallas',
    float32, fte_solve(compute_cov=True)): one warm-up, then reps turns of
    a plain solve and a compute_cov solve, every kernel count set to 0
    before the first compute_cov solve and read after it. Fails unless
    marker_std is finite and positive, pose_cov is symmetric to 1e-6 of
    its scale, the error bars are calibrated against the ground truth
    (tests/test_fte.py's rule), the banded kernel ran at least once a GN
    iteration, and on the first n64 runs the float32 marker_std over a
    float64 solve's ('chol': the kernel takes float32) has a median ratio
    in [0.9, 1.1]. The float32 ridge diagnostics must reduce over each
    run: cov_ridge_frac is the share of the run's cells whose
    marker_std_ridge_shrink exceeds 0.1 (recounted on the host, 1e-6),
    cov_ridge_shrink lies in [0, 1], and the first n64 runs solved again
    as a batch of B copies of them (the same shapes, so the same
    rounding) read each run's diagnostics within 1e-6."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.models import cheetah

    t0 = time.perf_counter()
    inputs = _main_inputs(device, B, N, C, iters, "pallas")
    pts3d = inputs[-1]
    _solve_and_score(device, *inputs, compute_cov=True)  # warm-up
    counted = [banded_solve] + list(pk.KERNELS.values())
    plain, cov = [], []
    for rep in range(reps):
        plain.append(_solve_and_score(device, *inputs)[0])
        if rep == 0:
            for f in counted:
                f.launches = 0
        secs, X, info, mk_err = _solve_and_score(device, *inputs, compute_cov=True)
        if rep == 0:
            launches = banded_solve.launches
            others = sum(f.launches for f in counted[1:])
        cov.append(secs)
    if not (launches >= iters and others == 0):
        raise AssertionError(f"compute_cov path: banded_chol launched {launches} times in {iters} "
                             f"GN iterations, probe kernels {others}")
    ms = info["marker_std"].double()
    if not (torch.isfinite(ms).all() and float(ms.min()) > 0):
        raise AssertionError("marker_std is not finite and positive")
    pc = info["pose_cov"]
    asym = float((pc - pc.mT).abs().max() / pc.abs().max())
    if not asym <= 1e-6:
        raise AssertionError(f"pose_cov asymmetric by {asym} of its scale")
    std = ms.cpu().numpy()
    err = cheetah.fk25(X).double().cpu().numpy() - pts3d[None]
    z = (err / std)[:, CAL_TRIM:-CAL_TRIM]
    z = z[np.isfinite(z)]
    std_z, inside = float(np.std(z)), float(np.mean(np.abs(z) < 3.0))
    if not (CAL_STD_Z[0] < std_z < CAL_STD_Z[1] and inside > CAL_IN_3SIGMA):
        raise AssertionError(f"error bars not calibrated: std(z) {std_z}, within 3 sigma {inside}")
    rel, frac = info["marker_std_ridge_shrink"], info["cov_ridge_frac"]
    frac_gap = float((frac.double() - (rel > 0.1).double().mean(dim=(1, 2, 3))).abs().max())
    shrink = info["cov_ridge_shrink"]
    if not (frac_gap <= 1e-6 and bool(((shrink >= 0) & (shrink <= 1)).all())):
        raise AssertionError(f"cov_ridge_frac {frac_gap} from its recount, or cov_ridge_shrink "
                             "outside [0, 1]")
    copies = torch.arange(B, device=device) // (B // n64)  # run j fills rows j*B/n64 ...
    cfg, hj_parts, args, _pts = inputs
    _s, _X, info_c, _e = _solve_and_score(device, cfg, hj_parts, tuple(a[copies] for a in args),
                                          pts3d, compute_cov=True)
    rows = torch.arange(n64, device=device) * (B // n64)
    copy_gap = max(float((info_c[k][rows] - info[k][:n64]).abs().max())
                   for k in ("cov_ridge_shrink", "cov_ridge_frac", "marker_std_ridge_shrink"))
    if not copy_gap <= 1e-6:
        raise AssertionError(f"the ridge diagnostics of {n64} runs solved as copies differ by "
                             f"{copy_gap} from the batch's")
    in64 = _main_inputs(device, n64, N, C, iters, "chol", dt=torch.float64)
    _s, _X, info64, _e = _solve_and_score(device, *in64, compute_cov=True)
    ratio = float(np.median(std[:n64] / info64["marker_std"].cpu().numpy()))
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"float32 / float64 marker_std median ratio {ratio} outside [0.9, 1.1]")
    med_plain, med_cov = float(np.median(plain)), float(np.median(cov))
    _phase("uncertainty", t0, f"B={B} N={N} C={C} f32 iters={iters} pallas compute_cov: "
           f"uncertainty_sec median {med_cov:.4f} (solve s {', '.join(f'{t:.4f}' for t in cov)}) "
           f"against plain {med_plain:.4f} ({', '.join(f'{t:.4f}' for t in plain)}), in turns: "
           f"overhead {med_cov - med_plain:.4f} s ({100 * (med_cov / med_plain - 1):.1f}%); "
           f"marker_std median {1e3 * float(np.median(std)):.3f} mm; max cov_ridge_frac "
           f"{float(info['cov_ridge_frac'].max()):.4g}; max cov_ridge_shrink "
           f"{float(shrink.max()):.4g} (runs 0-{n64 - 1}: "
           f"{', '.join(f'{float(x):.4f}' for x in shrink[:n64])}); ridge diagnostics per run: "
           f"frac recount gap {frac_gap:.3g}, copies gap {copy_gap:.3g}; calibration std(z) "
           f"{std_z:.4f}, within "
           f"3 sigma {inside:.5f}; pose_cov asymmetry {asym:.3g}; f32/f64 marker_std median "
           f"ratio {ratio:.4f} on {n64} runs; banded_chol launches {launches}; "
           f"mean_marker_err_m {mk_err:.5f}")


#: 'cg' (50 unpreconditioned inner iterations) ends far from the optimum
#: after 13 GN iterations in the JAX package as well: its float32 solve
#: of replica 0 of the flagship input reaches a mean marker error of
#: 0.0496156 m on the CPU (tests/test_torch_solvers.py::
#: test_chip_smoke_cg_bound_is_set_from_jax_float32 holds this value to
#: that run at 2%). The solvers phase bounds 'cg' by 1.1 times it and the
#: other solvers by the main path's 0.02 m.
CG_JAX_F32_ERR_M = 0.0496156
CG_MARKER_ERR_BOUND_M = 1.1 * CG_JAX_F32_ERR_M

#: the linear solvers of the solvers phase: (label, linear_solver, config fields)
OTHER_SOLVERS = (("chol", "chol", {}), ("grouped", "grouped", {}), ("cr", "cr", {}),
                 ("cg", "cg", {}), ("pcg lag 3", "pcg", {"relinearize_every": 3}))


def phase_solvers(device, B=96, N=100, C=6, iters=13):
    """The main path's input through the other linear solvers and through
    'pcg' with lagged Jacobians: one warm-up, then one timed solve each,
    every kernel count set to 0 before it and read after it (none of
    these paths reaches a hand kernel). Fails on a non-finite result, a
    hand-kernel launch or a mean marker error over 0.02 m ('cg':
    CG_MARKER_ERR_BOUND_M)."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve

    t0 = time.perf_counter()
    counted = [banded_solve] + list(pk.KERNELS.values())
    for label, solver, kw in OTHER_SOLVERS:
        inputs = _main_inputs(device, B, N, C, iters, solver, **kw)
        _solve_and_score(device, *inputs)  # warm-up
        for f in counted:
            f.launches = 0
        secs, X, info, mk_err = _solve_and_score(device, *inputs)
        hand = sum(f.launches for f in counted)
        if hand:
            raise AssertionError(f"the {label} path launched {hand} hand kernels")
        if not torch.isfinite(X).all():
            raise AssertionError(f"the {label} solve is not finite")
        bound = CG_MARKER_ERR_BOUND_M if solver == "cg" else 0.02
        if not mk_err <= bound:
            raise AssertionError(f"the {label} solve's mean marker error {mk_err} m exceeds {bound} m")
        print(f"[solvers] {label}: solve s {secs:.4f} traj/s {B / secs:.2f} n_converged "
              f"{int(info['converged'].sum())}/{B} max_grad_norm "
              f"{float(info['grad_norm'].max()):.4g} mean_marker_err_m {mk_err:.5f}", flush=True)
    _phase("solvers", t0, f"B={B} N={N} C={C} f32 iters={iters}: "
           f"{', '.join(label for label, _s, _k in OTHER_SOLVERS)} finite, no hand-kernel "
           f"launch, marker error under 0.02 m (cg: {CG_MARKER_ERR_BOUND_M:.5f} m)")


def phase_profile(device, B=96, N=100, C=6, iters=13):
    """Measurement only, after the main path's counts are read: the main
    path's time with 'pallas', 'pcg' and 'chol_unrolled' (one warm-up,
    then one timed solve; the plain 'chol_unrolled' solve runs once,
    unwarmed; phase_solvers times the other solvers), and a
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


# ---- probes: the Mosaic probe kernels (scripts/probe_mosaic*.py) ----

#: the chains' step count on their seeded random inputs
CHAIN_K_RANDOM = 16


def probe_cases():
    """Per probe kernel: its __global__ function, its plain version, the
    TPU kernel it replaces, inputs at the probe path's shapes (seeded
    random, and the scripts' own), the tolerance, its operations as a
    function of its inputs, and the one PyTorch call that computes the
    same function, timed and never held to the kernel. For
    value_at_set_static that call is torch.mul(a, s) with the constant
    (32,) row s = [2, 2, 2, 2, 1, ..., 1], made once per device on the
    first call (the warm-up), as dma_hbm_ring's is torch.add(x, 1.0).
    write_input_ref computes 2 * cumsum(a, 0); its call is
    torch.cumsum(a, 0), without the x2, which flatters the library by
    one pass. The chains' is torch.linalg.matrix_power(a, K + 1), under
    f32_matmuls() at HIGHEST and with TF32 matmuls allowed at DEFAULT: it
    reaches a^(K+1) by about log2 K squarings, other work than the K
    dependent steps the probe times.

    Tolerances, against the plain version on the same card: 'exact' for
    the rows that move or scale data and for the recurrences (the same
    float32 additions in the same order); ('rtol', 1e-5) of the largest
    value for the FP32 products, summed in another order (32 terms: at
    most 32 * 2^-24 of the sum of |terms|, under 1e-5 of the largest
    value on these inputs); ('frob', bound) on the chains' random inputs,
    a = 0.9 Q with Q orthogonal, so that no step amplifies an error: at
    FP32 a step's sums move by at most 32 * 2^-24 of its norm, so K steps
    stay within K * 32 * 2^-24 in the Frobenius norm; at TF32 the plain
    version rounds a and x to TF32 as the kernel does, but its sums run
    in another order, so a rounding of x may break the other way, by at
    most 2 * 2^-11 of the step's norm: K * 2^-10. On the script's 0.999 I
    both chains are exact (one nonzero term per sum)."""
    from acinoset_tpu_torch.probes import probe_mosaic as pm
    from acinoset_tpu_torch.probes import probe_mosaic2 as pm2

    B, P, TB, K = 16, 32, 4, 2000
    S3 = (B, P, P)

    def rnd(*shape):
        return lambda r, d: torch.as_tensor(r.normal(size=shape), dtype=torch.float32, device=d)

    def ones(*shape, v=1.0):
        return lambda r, d: torch.full(shape, v, dtype=torch.float32, device=d)

    def arange(*shape, div=1.0):
        return lambda r, d: (torch.arange(int(np.prod(shape)), dtype=torch.float32, device=d)
                             .reshape(shape) / div)

    def orth(tb):
        def make(r, d):
            q, _ = np.linalg.qr(r.normal(size=(tb, P, P)))
            return torch.as_tensor(0.9 * q, dtype=torch.float32, device=d)
        return make

    def eye(tb):
        return lambda r, d: (torch.eye(P, dtype=torch.float32, device=d)[None] * 0.999).repeat(
            tb, 1, 1)

    def const(v):
        return lambda r, d: v

    def col_scale_mul():
        rows = {}

        def call(a):
            s = rows.get(a.device)
            if s is None:
                s = rows[a.device] = torch.tensor([2.0] * 4 + [1.0] * (P - 4), device=a.device)
            return torch.mul(a, s)
        return call

    def numel(a):
        return a.numel()

    def chain_flops(a, k):
        return k * a.shape[0] * 2 * P**3

    def matrix_power(a, k):
        return torch.linalg.matrix_power(a, k + 1)

    def matrix_power_tf32(a, k):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.linalg.matrix_power(a, k + 1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    PM, PM2 = "scripts/probe_mosaic.py", "scripts/probe_mosaic2.py"
    rt = ("rtol", 1e-5)
    return {
        "batched_dot": dict(
            kernel="batched_dot_kernel",
            replaces=f"{PM}:34", plain=pm.batched_dot_plain, tol=rt,
            flops=lambda a, b: 2 * a.numel() * P, random=[rnd(*S3), rnd(*S3)],
            script=[ones(*S3), ones(*S3)], library=lambda a, b: torch.bmm(a, b)),
        "bcast_mul_lane_reduce": dict(
            kernel="lane_reduce_kernel",
            replaces=f"{PM}:49", plain=pm.bcast_mul_lane_reduce_plain, tol=rt,
            flops=lambda a, v: 2 * a.numel(), random=[rnd(*S3), rnd(B, P)],
            script=[ones(*S3), ones(B, P, v=2.0)],
            library=lambda a, v: torch.matmul(a, v[..., None])),
        "value_at_set_static": dict(
            kernel="scale_cols_kernel",
            replaces=f"{PM}:67", plain=pm.value_at_set_static_plain, tol="exact",
            flops=lambda a: a.numel() // P * 4, random=[rnd(*S3)], script=[ones(*S3)],
            library=col_scale_mul()),
        "dma_hbm_ring": dict(
            kernel="dma_ring_kernel",
            replaces=f"{PM}:90", plain=pm.dma_hbm_ring_plain, tol="exact", flops=numel,
            random=[rnd(4, B, P)], script=[arange(4, B, P)],
            library=lambda x: torch.add(x, 1.0)),
        "ring_dyn_index": dict(
            kernel="ring_prefix_kernel",
            replaces=f"{PM}:117", plain=pm.ring_dyn_index_plain, tol="exact", flops=numel,
            random=[rnd(6, B, P)], script=[ones(6, B, P)],
            library=lambda a: torch.cumsum(a, 0)),
        "dma_out_any": dict(
            kernel="dma_out_kernel",
            replaces=f"{PM}:141", plain=pm.dma_out_any_plain, tol="exact", flops=numel,
            random=[rnd(4, B, P)], script=[ones(4, B, P)],
            library=lambda x: torch.mul(x, 3.0)),
        "batched_matvec": dict(
            kernel="matvec_kernel",
            replaces=f"{PM}:161", plain=pm.batched_matvec_plain, tol=rt,
            flops=lambda a, v: 2 * a.numel(), random=[rnd(*S3), rnd(B, P)],
            script=[ones(*S3), ones(B, P, v=2.0)],
            library=lambda a, v: torch.bmm(a, v[..., None])),
        "batched_transpose": dict(
            kernel="transpose_kernel",
            replaces=f"{PM}:176", plain=pm.batched_transpose_plain, tol="exact",
            flops=lambda a: 0, random=[rnd(*S3)], script=[arange(*S3)],
            library=lambda a: a.transpose(-1, -2).contiguous()),
        "dyn4d_scratch": dict(
            kernel="dyn4d_kernel",
            replaces=f"{PM2}:44", plain=pm2.dyn4d_scratch_plain, tol="exact",
            flops=numel, random=[rnd(5, TB, P, P)], script=[ones(5, TB, P, P)],
            library=lambda a: torch.cumsum(a, 0)),
        "write_input_ref": dict(
            kernel="recur_kernel",
            replaces=f"{PM2}:66", plain=pm2.write_input_ref_plain, tol="exact",
            flops=lambda a: 2 * a.numel(), random=[rnd(5, TB, P, P)],
            script=[ones(5, TB, P, P)], library=lambda a: torch.cumsum(a, 0)),
        "matvec_transposed_contract": dict(
            kernel="matvec_t_kernel",
            replaces=f"{PM2}:84", plain=pm2.matvec_transposed_contract_plain, tol=rt,
            flops=lambda a, v: 2 * a.numel(), random=[rnd(TB, P, P), rnd(TB, P)],
            script=[arange(TB, P, P, div=100.0), ones(TB, P)],
            library=lambda a, v: torch.bmm(a.mT, v[..., None])),
        "chain_highest": dict(
            kernel="chain_fp32_kernel",
            replaces=f"{PM2}:108", plain=lambda a, k: pm2.chain_plain(a, k, "highest"),
            tol=("frob", CHAIN_K_RANDOM * 32 * 2.0**-24),
            flops=chain_flops, random=[orth(8), const(CHAIN_K_RANDOM)],
            script=[eye(8), const(K)], library=matrix_power, script_tol="exact"),
        "chain_tf32": dict(
            kernel="chain_tf32_kernel",
            replaces=f"{PM2}:108", plain=lambda a, k: pm2.chain_plain(a, k, "default"),
            tol=("frob", CHAIN_K_RANDOM * 2.0**-10), flops=chain_flops, peak=PEAK_TF32_FLOPS,
            random=[orth(8), const(CHAIN_K_RANDOM)], script=[eye(8), const(K)],
            library=matrix_power_tf32, script_tol="exact"),
    }


def probe_error(got, want, tol):
    """max |got - want|; raises if it breaks the case's tolerance."""
    err = float((got - want).abs().max())
    if tol == "exact":
        ok = torch.equal(got, want)
    elif tol[0] == "rtol":
        ok = err <= tol[1] * float(want.abs().max())
    else:
        ok = bool(torch.all(torch.linalg.matrix_norm(got - want)
                            <= tol[1] * torch.linalg.matrix_norm(want)))
    if not ok:
        raise AssertionError(f"kernel vs plain: max abs err {err:.3g} breaks {tol}")
    return err


def check_probe(case, wrapper, inputs, device, rng):
    """The kernel against its plain version on one set of inputs; returns
    (max abs err, the inputs, the output's size)."""
    from acinoset_tpu_torch.utils.precision import f32_matmuls

    args = [make(rng, device) for make in case[inputs]]
    with f32_matmuls():
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = case["plain"](*args)
    tol = case.get("script_tol", case["tol"]) if inputs == "script" else case["tol"]
    return probe_error(got, want, tol), args, got.numel()


def probe_device_ms(cases, args_by_name, reps=50):
    """Each probe kernel's own device time (torch.profiler), ms per launch:
    the event timing of back-to-back launches also holds the host's
    wrapper and ctypes call when they are slower than the kernel. Then
    each case's library call's device time, ms per call: every kernel it
    launches, in a profiler session of its own (None where the case has
    no library call). Returns (kernel ms, library ms) by name."""
    from torch.profiler import ProfilerActivity, profile

    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.utils.precision import f32_matmuls

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, args in args_by_name.items():
            for _ in range(3 if name.startswith("chain") else reps):
                pk.KERNELS[name](*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernel = {name: _ms_per_launch(events, cases[name]["kernel"]) for name in args_by_name}
    library = {}
    for name, args in args_by_name.items():
        lib = cases[name]["library"]
        with f32_matmuls():
            library[name] = (None if lib is None
                             else kernel_device_ms(lambda: lib(*args), reps=reps))
    return kernel, library


#: the probe rows whose host cost per launch probe_host_split takes apart
HOST_SPLIT_ROWS = {"ring_dyn_index": "probe_ring_prefix", "dyn4d_scratch": "probe_dyn4d"}


def _host_us(fn, calls=10_000):
    """Host microseconds per call of `fn`: perf_counter_ns over `calls`
    back-to-back calls after one warm-up, with one synchronize at the
    end. A call that enqueues device work costs the larger of its host
    time and its device time once the launch queue is full."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t) / calls / 1e3


def probe_host_split(device, args_by_name):
    """Measurement only: where the host time of one probe launch goes, for
    the rows of HOST_SPLIT_ROWS on the probe path's inputs. Microseconds
    per call (_host_us) of the whole wrapper and of each piece of a launch
    path timed alone: the device guard (torch.cuda.device), the stream
    lookup through a Stream object and as a raw handle, the wrapper's
    checks, a row length read through a view (x[0].numel()), the output's
    torch.empty_like, and the C launcher called through ctypes on
    prepared integers (its CUDA calls and the kernel's enqueue); and
    torch.cumsum(x, 0), the library call, beside them. Returns
    {row: {piece: us}} and prints one line."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk

    lib = pk._library()
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream

    def guard():
        with torch.cuda.device(device):
            pass

    split = {}
    for name, launcher in HOST_SPLIT_ROWS.items():
        (x,) = args_by_name[name]
        o = torch.empty_like(x)
        fn = getattr(lib, launcher)
        ints = (x.data_ptr(), o.data_ptr(), x.shape[0], x.numel() // x.shape[0], stream)
        pieces = {
            "wrapper": lambda: pk.KERNELS[name](x),
            "device guard": guard,
            "Stream object": lambda: torch.cuda.current_stream(device).cuda_stream,
            "raw stream": lambda: torch._C._cuda_getCurrentRawStream(index),
            "checks": lambda: pk._check_cuda(x),
            "row view": lambda: x[0].numel(),
            "empty_like": lambda: torch.empty_like(x),
            "ctypes launch": lambda: fn(*ints),
            "cumsum": lambda: torch.cumsum(x, 0),
        }
        split[name] = {piece: _host_us(f) for piece, f in pieces.items()}
    print("[probes] host us per call (10^4 calls, one sync): " + "; ".join(
        f"{name}: " + ", ".join(f"{p} {v:.3f}" for p, v in s.items()) for name, s in split.items()),
        flush=True)
    return split


#: the probe rows at the flagship's shape: the banded kernel's factor
#: array fac, (B, N, 4, 32, 32) at the flagship batch (157.3 MB). The rows
#: that scan or stream rows take it frames first, N = 100 rows of
#: 96 x 4 x 32 x 32 floats (rows 9 and 10 as (100, 384, 32, 32)); the tile
#: rows take it as its 38,400 tiles of 32 x 32, with a (38,400, 32) vector
#: where the row has one
BAND_STREAM_SHAPE = (100, 96, 4, 32, 32)
_TILES = (100 * 96 * 4, 32, 32)
_VECS = (100 * 96 * 4, 32)
BAND_STREAM_INPUTS = {
    "batched_dot": [_TILES, _TILES],
    "bcast_mul_lane_reduce": [_TILES, _VECS],
    "value_at_set_static": [_TILES],
    "dma_hbm_ring": [BAND_STREAM_SHAPE],
    "ring_dyn_index": [BAND_STREAM_SHAPE],
    "dma_out_any": [BAND_STREAM_SHAPE],
    "batched_matvec": [_TILES, _VECS],
    "batched_transpose": [_TILES],
    "dyn4d_scratch": [(100, 384, 32, 32)],
    "write_input_ref": [(100, 384, 32, 32)],
    "matvec_transposed_contract": [_TILES, _VECS],
}
#: tiles a chunk of a tile row's plain version takes at a time: row 1's
#: broadcast product of all 38,400 tiles would hold 5 GB at once
PLAIN_CHUNK = 4096


def _plain_at(case, name, args):
    """The case's plain version on `args`, in chunks of PLAIN_CHUNK tiles
    for the tile rows (each tile's result depends on that tile alone)."""
    if BAND_STREAM_INPUTS[name][0] != _TILES:
        return case["plain"](*args)
    return torch.cat([case["plain"](*(a[i:i + PLAIN_CHUNK] for a in args))
                      for i in range(0, args[0].shape[0], PLAIN_CHUNK)])


def probe_band_stream(device, cases, reps=20):
    """Measurement and check: every probe row 1-11 at the flagship's shape
    (BAND_STREAM_INPUTS) on seeded random inputs, each held to its plain
    version with the case's tolerance; the kernel's ms by events and on
    the device (torch.profiler), its library call's the same two ways,
    and the share of the bound (each input read once, the output written
    once, against the operations at the case's peak) that each reaches.
    Returns {row: {"bound_ms", "bound_by", "ms", "device_ms",
    "library_ms", "library_device_ms", "max_abs_err"}}."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.utils.precision import f32_matmuls

    gen = torch.Generator(device=device).manual_seed(9)
    out = {}
    for name, shapes in BAND_STREAM_INPUTS.items():
        case, wrapper, lib = cases[name], pk.KERNELS[name], cases[name]["library"]
        args = [torch.randn(shape, device=device, generator=gen) for shape in shapes]
        with f32_matmuls():
            got = wrapper(*args)
            torch.cuda.synchronize()
            err = probe_error(got, _plain_at(case, name, args), case["tol"])
            nbytes = 4 * (sum(a.numel() for a in args) + got.numel())
            del got
            t_ops = case["flops"](*args) / case.get("peak", PEAK_FP32_FLOPS)
            t_bytes = nbytes / PEAK_BYTES_PER_S
            r = dict(ms=_cuda_ms(lambda: wrapper(*args), reps),
                     device_ms=kernel_device_ms(lambda: wrapper(*args), case["kernel"], reps),
                     library_ms=_cuda_ms(lambda: lib(*args), reps),
                     library_device_ms=kernel_device_ms(lambda: lib(*args), reps=reps))
        bound = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[probes] flagship shape {name} {[tuple(a.shape) for a in args]} "
              f"({nbytes / 1e6:.1f} MB moved; max_abs_err {err:.3g}, tol {case['tol']}): "
              f"bound_ms {bound:.4f} ({bound_by}); " + ", ".join(
                  f"{k} {v:.4f} ({100 * bound / v:.1f}% of bound)" for k, v in r.items()),
              flush=True)
        out[name] = dict(r, bound_ms=bound, bound_by=bound_by, max_abs_err=err)
        del args
    return out


def phase_probes(device):
    """Every probe kernel against its plain version, timed at the probe
    path's shapes (the scripts' inputs), then the probe path itself: every
    probe entry point and the time_chain table, with the launch counts set
    to 0 just before and read just after."""
    from acinoset_tpu_torch.kernels import _nvcc
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.probes import probe_mosaic as pm
    from acinoset_tpu_torch.probes import probe_mosaic2 as pm2
    from acinoset_tpu_torch.utils.precision import f32_matmuls

    t0 = time.perf_counter()
    cases = probe_cases()
    recs, path_args = {}, {}
    for i, (name, case) in enumerate(cases.items()):
        wrapper = pk.KERNELS[name]
        err, _, _ = check_probe(case, wrapper, "random", device, np.random.default_rng(i))
        err_s, args, n_out = check_probe(case, wrapper, "script", device, np.random.default_rng(i))
        path_args[name] = args
        long = name.startswith("chain")
        with f32_matmuls():
            ms = _cuda_ms(lambda: wrapper(*args), reps=3 if long else 200, warmup=2)
            plain_ms = _cuda_ms(lambda: case["plain"](*args), reps=1 if long else 20)
            lib = case["library"]
            library_ms = _cuda_ms(lambda: lib(*args), reps=200, warmup=2) if lib else None
        tensors = [a for a in args if torch.is_tensor(a)]
        nbytes = 4 * (sum(a.numel() for a in tensors) + n_out)
        t_ops = case["flops"](*args) / case.get("peak", PEAK_FP32_FLOPS)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        recs[name] = dict(
            name=name, route="cuda", source="acinoset_tpu_torch/kernels/csrc/probes.cu",
            replaces=case["replaces"], launches=None, max_abs_err=max(err, err_s), ms=ms,
            plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms)
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f}"
        print(f"[probes] {name}: max_abs_err random {err:.3g} script {err_s:.3g} "
              f"(tol {case['tol']}); ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_txt} "
              f"bound_ms {recs[name]['bound_ms']:.2e} ({recs[name]['bound_by']})", flush=True)

    device_ms, library_device_ms = probe_device_ms(cases, path_args)
    print("[probes] device ms per launch (torch.profiler): "
          + ", ".join(f"{k} {v:.5f}" for k, v in device_ms.items()), flush=True)
    print("[probes] library call's device ms per call (torch.profiler): "
          + ", ".join(f"{k} {'none' if v is None else f'{v:.5f}'}"
                      for k, v in library_device_ms.items()), flush=True)
    floor_ms = kernel_device_ms(lambda: pk.empty(device), "empty_kernel", reps=50)
    print(f"[probes] floor: empty kernel {floor_ms:.5f} device ms per launch (torch.profiler, "
          f"50 launches); at the scripts' shapes torch.add {library_device_ms['dma_hbm_ring']:.5f}, "
          f"torch.mul {library_device_ms['dma_out_any']:.5f}", flush=True)
    probe_host_split(device, path_args)
    probe_band_stream(device, cases)

    # the probe path, through the entry points a user calls
    for f in pk.KERNELS.values():
        f.launches = 0
    for probe_name, t in pm.PROBES + pm2.PROBES:
        out = t()
        torch.cuda.synchronize()
        print(f"[probes] OK   {probe_name}: {out.reshape(-1)[:2].cpu().numpy()}", flush=True)
    table = {prec: [pm2.time_chain(tb, prec=prec) for tb in (1, 2, 4, 8)]
             for prec in pm2.PRECISIONS}
    launches = {name: f.launches for name, f in pk.KERNELS.items()}
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"probe kernels not launched on the probe path: {missing}")
    for name, n in launches.items():
        recs[name]["launches"] = n
    # a step is one 32 x 32 product a tile (2 * 32^3 operations) on one SM
    floor = {prec: 1e9 * 2 * 32**3 * H100_SMS / (PEAK_FP32_FLOPS if prec == "highest" else
                                                  PEAK_TF32_FLOPS) for prec in table}
    print("[probes] time_chain ns/step (K=2000)   TB=1     TB=2     TB=4     TB=8  one-SM floor",
          flush=True)
    for prec, row in table.items():
        label = "highest (FP32 FMA)" if prec == "highest" else "default (TF32 MMA)"
        print(f"[probes]   {label:<30}" + "".join(f"{v:9.1f}" for v in row)
              + f"{floor[prec]:14.1f}", flush=True)
    ptxas = _ptxas_stats(_nvcc.log_path(pk.LIBRARY).read_text())
    print("[probes] chain kernels (ptxas): " + ", ".join(
        f"{k} {r} registers, spills {st}/{ld} bytes (stores/loads)"
        for k, (r, st, ld) in ptxas.items() if k.startswith("chain_")), flush=True)
    _phase("probes", t0, f"13 kernels match their plain versions; launches {launches}")
    return list(recs.values())


# ---- sweep: the batched FTE stage with chunking and rescue ----

def make_sweep_runs(n_rigs=8, n_seeds=16, seed=0, limit=None):
    """128 synthetic runs: 8 rigs (6 cameras, radius 10..14 m) x 16
    seeds, 80..100 frames at 90 fps, the flagship's noise. Returns
    (RunData list, ground-truth marker positions per run); ``limit`` keeps
    the first runs of the same set."""
    from acinoset_tpu_torch.pipeline.sweep import RunData
    from acinoset_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    lengths = rng.integers(80, 101, size=n_rigs * n_seeds)
    lengths[0] = 100
    runs, truth = [], []
    for ri, radius in enumerate(np.linspace(10.0, 14.0, n_rigs)):
        cams = synthetic.ring_cameras(n_cams=6, radius=float(radius))
        k, d, r, t, res = cams
        for si in range(n_seeds):
            i = ri * n_seeds + si
            if limit is not None and i >= limit:
                return runs, truth
            X = synthetic.cheetah_gallop(N=int(lengths[i]), fps=90.0)
            px, lik, pts3d = synthetic.render_measurements(
                X, cams, noise_px=1.5, outlier_frac=0.02, bad_lik_frac=0.05, seed=1000 + i)
            runs.append(RunData(data_dir=f"synthetic_{i:03d}", pixels=px, likelihood=lik,
                                cams=(k, d.reshape(-1, 4), r, t.reshape(-1, 3)), fps=90.0,
                                start_frame=0, scene_fpath="", cam_res=res))
            truth.append(pts3d)
    return runs, truth


def _sweep_once(runs, device, iters):
    """solve_batch with bench.py's headline schedule, then the rescue pass
    wired as sweep() wires it: (solve s, rescue s, results before, after)."""
    from acinoset_tpu_torch.pipeline.sweep import _rescue_unconverged, solve_batch

    t1 = time.perf_counter()
    before = solve_batch(runs, 0.5, num_iters=iters, plain_iters=5, device=device)
    t2 = time.perf_counter()
    after = _rescue_unconverged(
        list(before), "", iters,
        lambda bad, X0s, budget: solve_batch(
            [runs[i] for i in bad], 0.5, num_iters=budget, X0_override=X0s,
            plain_iters=0, device=device),
    )
    return t2 - t1, time.perf_counter() - t2, before, after


def phase_sweep(device, iters=13):
    """The sweep's batched stage on 128 runs (chunks of 96: 96, then 32
    padded to 96) and the rescue; traj/s counts the second call of solve
    plus rescue. Fails if the rescue changed a converged run or the mean
    marker error exceeds 0.02 m."""
    t0 = time.perf_counter()
    runs, truth = make_sweep_runs()
    t_make = time.perf_counter() - t0
    _sweep_once(runs, device, iters)  # warm-up: allocator, cuBLAS handles
    t_solve, t_rescue, before, after = _sweep_once(runs, device, iters)
    secs = t_solve + t_rescue
    for rb, ra in zip(before, after):
        if rb["converged"] and not (ra is rb or np.array_equal(ra["x"], rb["x"])):
            raise AssertionError(f"rescue changed the converged run {rb['data_dir']}")
    n_before = sum(r["converged"] for r in before)
    n_after = sum(r["converged"] for r in after)
    rescued = sum(not r["converged"] for r in before)
    errs = [float(np.mean(np.linalg.norm(r["positions"] - pts, axis=-1)))
            for r, pts in zip(after, truth)]
    if not all(np.isfinite(r["positions"]).all() and r["x"].shape == (len(p), 25)
               for r, p in zip(after, truth)):
        raise AssertionError("non-finite or misshapen sweep results")
    if not n_after >= n_before:
        raise AssertionError(f"rescue lost converged runs: {n_before} -> {n_after}")
    mk = float(np.mean(errs))
    if not mk <= 0.02:
        raise AssertionError(f"sweep mean marker error {mk} m exceeds 0.02 m")
    mk_before = float(np.mean([np.mean(np.linalg.norm(r["positions"] - pts, axis=-1))
                               for r, pts in zip(before, truth)]))
    _phase("sweep", t0, f"{len(runs)} runs (8 rigs x 16 seeds, 80-100 frames, C=6, f32, pcg, "
           f"iters={iters}, plain_iters=5; made in {t_make:.2f} s): rescue-inclusive traj/s "
           f"{len(runs) / secs:.2f} (solve {t_solve:.4f} s + rescue {t_rescue:.4f} s); "
           f"converged {n_before} -> "
           f"{n_after}/{len(runs)}; rescued {rescued}; max_grad_norm "
           f"{max(r['grad_norm'] for r in after):.4g}; mean_marker_err_m {mk:.5f} "
           f"(worst run {max(errs):.5f})")
    return dict(runs=runs, truth=truth, n_before=n_before, mk_before=mk_before, t_solve=t_solve)


def phase_sweep_uncertainty(device, sweep, iters=13):
    """The sweep phase's 128 runs through solve_batch once with
    uncertainty=True (no rescue), timed beside that phase's plain solve.
    Fails if a run's marker_std is misshapen, not finite or not positive
    on its frames."""
    from acinoset_tpu_torch.pipeline.sweep import solve_batch

    t0 = time.perf_counter()
    unc = solve_batch(sweep["runs"], 0.5, num_iters=iters, plain_iters=5, device=device,
                      uncertainty=True)
    t_unc = time.perf_counter() - t0
    for r, pts in zip(unc, sweep["truth"]):
        ms = r["marker_std"]
        if not (ms.shape == pts.shape and np.isfinite(ms).all() and ms.min() > 0):
            raise AssertionError(f"marker_std of {r['data_dir']} is misshapen, non-finite or not "
                                 "positive")
    ms_all = np.concatenate([r["marker_std"].ravel() for r in unc])
    _phase("sweep", t0, f"{len(unc)} runs with uncertainty=True (no rescue): {t_unc:.4f} s against "
           f"the plain solve's {sweep['t_solve']:.4f} s; marker_std median "
           f"{1e3 * float(np.median(ms_all)):.3f} mm; max cov_ridge_frac "
           f"{max(r['cov_ridge_frac'] for r in unc):.4g}; max cov_ridge_shrink "
           f"{max(r['cov_ridge_shrink'] for r in unc):.4g}")


# ---- ekf: the EKF + RTS smoother and the sweep's batched EKF stage ----

GOLDEN_EKF = os.path.join(ROOT, "tests", "golden", "ekf_synthetic_n50.npz")
#: the JAX package's float32 EKF stage on eight of make_sweep_runs()'s
#: runs (the first of each rig): the median of their mean smoothed marker
#: errors, measured on the CPU by tests/test_torch_ekf.py::
#: test_chip_smoke_marker_bound_is_set_from_jax_float32 (which holds this
#: value to that run at 2%). The ekf phase bounds the median over all
#: 128 runs by 1.25 times it: the cold line-fit init loses track of some
#: runs in both packages, so the mean is not a statistic to hold.
EKF_JAX_F32_MEDIAN_ERR_M = 0.0397969
EKF_MARKER_ERR_BOUND_M = 1.25 * EKF_JAX_F32_MEDIAN_ERR_M


def _ekf_golden_check(device):
    """The port's float64 run_cheetah_ekf on the card against the JAX
    package's outputs in GOLDEN_EKF, at tests/test_torch_ekf.py's
    tolerances; returns the largest error relative to each key's scale."""
    from acinoset_tpu_torch.pipeline.ekf import marker_std_from_smoothed, run_cheetah_ekf

    g = np.load(GOLDEN_EKF)
    out = run_cheetah_ekf(g["pixels"], g["likelihood"], g["k"], g["d"], g["r"], g["t"],
                          fps=float(g["fps"]), cam_res=(float(g["cam_width"]), 0),
                          dlc_thresh=float(g["dlc_thresh"]), x0_pose=g["x0_pose"],
                          dtype=torch.float64, device=device)
    got = {k: out[k] for k in ("x", "dx", "ddx", "smoothed_x", "smoothed_dx", "smoothed_ddx")}
    for k in ("P", "smoothed_P"):
        got[f"{k}_diag"] = np.diagonal(out[k], axis1=-2, axis2=-1)
    worst = 0.0
    for k, v in got.items():
        w = g[k]
        np.testing.assert_allclose(v, w, rtol=1e-6 if k.endswith("_diag") else 1e-8,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)
        worst = max(worst, float(np.abs(v - w).max() / np.abs(w).max()))
    ms = marker_std_from_smoothed(out["smoothed_x"], out["smoothed_P"], device=device)
    np.testing.assert_allclose(ms, g["marker_std"], rtol=1e-8, atol=1e-12, err_msg="marker_std")
    if int(out["outliers"]) != int(g["outliers"]):
        raise AssertionError(f"golden EKF outliers {out['outliers']} vs {g['outliers']}")
    return worst, int(out["outliers"])


def _run_errs(results, truth):
    return np.array([np.mean(np.linalg.norm(r["positions"] - pts, axis=-1))
                     for r, pts in zip(results, truth)])


def phase_ekf(device, sweep, iters=13):
    """The EKF slice: the float64 golden check on the card, then the
    sweep's batched EKF stage (float32) on the sweep phase's 128 runs, in
    chunks of 96 (96, then 32 padded to 96): runs/s from the second of two
    calls, the peak memory a run beside _ekf_mem_cap's model, and a
    torch.profiler count of the device ops of one chunk; then the warm
    path, solve_batch from the EKF's smoothed poses (plain_iters=4), read
    beside the cold sweep. Fails on a golden mismatch, a non-finite or
    misshapen result, hand-kernel launches (the EKF reaches none), or a
    median marker error over EKF_MARKER_ERR_BOUND_M."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.pipeline.sweep import (MAX_PROGRAM_BATCH, ekf_warm_starts, solve_batch,
                                                   solve_batch_ekf)

    t0 = time.perf_counter()
    worst, n_out = _ekf_golden_check(device)
    _phase("ekf", t0, f"golden (float64, N=50, C=4): states within {worst:.3g} of each key's "
           f"scale (tol 1e-9 + rtol); outliers {n_out} as the JAX package")

    runs, truth = sweep["runs"], sweep["truth"]
    N = max(r.pixels.shape[1] for r in runs)
    n_states = 3 * cheetah.N_ACTIVE
    solve_batch_ekf(runs, 0.5, device=device)  # warm-up: allocator, cuBLAS handles
    _phase("ekf", t0, f"warm-up call ({len(runs)} runs) done")
    counted = [banded_solve] + list(pk.KERNELS.values())
    for f in counted:
        f.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    res = solve_batch_ekf(runs, 0.5, device=device)
    secs = time.perf_counter() - t1
    B = min(len(runs), MAX_PROGRAM_BATCH)  # the runs of one chunk
    per_run = (torch.cuda.max_memory_allocated() - base) / B
    hand = sum(f.launches for f in counted)
    if hand:
        raise AssertionError(f"the EKF path launched {hand} hand kernels")
    model = 9.5 * N * n_states ** 2 * 4
    for r, pts in zip(res, truth):
        st = r["states"]
        if not (all(np.isfinite(v).all() for v in st.values()) and np.isfinite(r["positions"]).all()):
            raise AssertionError(f"non-finite EKF result for {r['data_dir']}")
        if st["smoothed_x"].shape != (len(pts), cheetah.N_ACTIVE) or r["positions"].shape != pts.shape:
            raise AssertionError(f"misshapen EKF result for {r['data_dir']}")
    errs = _run_errs(res, truth)
    med = float(np.median(errs))
    if not med <= EKF_MARKER_ERR_BOUND_M:
        raise AssertionError(f"EKF median marker error {med} m exceeds {EKF_MARKER_ERR_BOUND_M} m")

    # device activity only: a chunk launches ~117k kernels, and reading
    # back their CPU-side op events as well is the slow part
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        solve_batch_ekf(runs[:B], 0.5, device=device)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t2
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    _phase("ekf", t0, f"sweep stage: {len(runs)} runs (N={N}, C=6, f32, chunks of {B}): runs/s "
           f"{len(runs) / secs:.2f} ({secs:.4f} s); peak {per_run / 1e6:.2f} MB a run "
           f"(cap model 9.5 x N x {n_states}^2 x 4 B = {model / 1e6:.2f} MB); one chunk profiled: "
           f"{len(dev)} device ops, {len(dev) / N:.1f} a frame, device busy {dev_ms:.1f} ms of "
           f"{chunk_s * 1e3:.1f} ms wall; outliers {sum(r['outliers'] for r in res)}; marker error "
           f"median {med:.5f} m (bound {EKF_MARKER_ERR_BOUND_M:.5f}), mean {errs.mean():.5f}, "
           f"runs over 0.1 m {int((errs > 0.1).sum())}; hand-kernel launches {hand}")

    t3 = time.perf_counter()
    warm = solve_batch(runs, 0.5, num_iters=iters, X0_override=ekf_warm_starts(res),
                       plain_iters=4, device=device)
    warm_s = time.perf_counter() - t3
    if not all(np.isfinite(r["positions"]).all() and r["x"].shape == (len(p), cheetah.N_ACTIVE)
               for r, p in zip(warm, truth)):
        raise AssertionError("non-finite or misshapen warm-path results")
    werrs = _run_errs(warm, truth)
    _phase("ekf", t0, f"warm path (solve_batch from the EKF, plain_iters=4, iters={iters}, "
           f"{warm_s:.4f} s): converged before rescue {sum(r['converged'] for r in warm)}/"
           f"{len(runs)} (cold {sweep['n_before']}); mean marker error {werrs.mean():.5f} m, "
           f"median {np.median(werrs):.5f} (cold before rescue: mean {sweep['mk_before']:.5f})")


def ekf_after_posterior(device=None, reps=2, iters=13):
    """Measurement only, not run by main(): does the posterior slow the
    EKF stage that runs after it in the same process? On the sweep
    phase's 128 runs, solve_batch_ekf is timed reps times fresh, after a
    plain solve_batch, after solve_batch(uncertainty=True), after each of
    the two once more, and after gc.collect() and
    torch.cuda.empty_cache(). Each call prints its seconds, the caching
    allocator's segments, reserved bytes and cudaMalloc/cudaFree calls
    during the call, the Python objects gc tracks and the gc pauses
    during the call; a cProfile of one call fresh and one after the
    posterior prints its top functions by own time.

        python3 -c "import chip_smoke as c; c.ekf_after_posterior()"
    """
    import cProfile
    import gc
    import io
    import pstats

    from acinoset_tpu_torch.pipeline.sweep import solve_batch, solve_batch_ekf

    device = device or torch.device("cuda")
    runs, _truth = make_sweep_runs()
    pauses, started = [], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - started[0])

    def ekf_calls(label):
        for _ in range(reps):
            pauses.clear()
            s0 = torch.cuda.memory_stats()
            t = time.perf_counter()
            solve_batch_ekf(runs, 0.5, device=device)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            s1 = torch.cuda.memory_stats()
            print(f"[ekf_after_posterior] {label}: {secs:.4f} s ({len(runs) / secs:.2f} runs/s); "
                  f"segments {s1['segment.all.current']}, reserved "
                  f"{s1['reserved_bytes.all.current'] / 1e6:.1f} MB, cudaMalloc "
                  f"{s1['num_device_alloc'] - s0['num_device_alloc']}, cudaFree "
                  f"{s1['num_device_free'] - s0['num_device_free']}; gc objects "
                  f"{len(gc.get_objects())}, gc passes {len(pauses)} "
                  f"({1e3 * sum(pauses):.1f} ms)", flush=True)

    def profiled(label):
        prof = cProfile.Profile()
        prof.enable()
        solve_batch_ekf(runs, 0.5, device=device)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        st = pstats.Stats(prof, stream=out)
        print(f"[ekf_after_posterior] cProfile {label}: {st.total_tt:.3f} s", flush=True)
        st.sort_stats("tottime").print_stats(8)
        print("\n".join(ln for ln in out.getvalue().splitlines()[-10:] if ln.strip()), flush=True)

    gc.callbacks.append(on_gc)
    try:
        solve_batch_ekf(runs, 0.5, device=device)  # warm-up: allocator, cuBLAS handles
        ekf_calls("fresh")
        profiled("fresh")
        for round_ in (1, 2):
            for unc in (False, True):
                solve_batch(runs, 0.5, num_iters=iters, plain_iters=5, device=device,
                            uncertainty=unc)
                ekf_calls(f"after {'the posterior' if unc else 'a plain solve'} ({round_})")
        profiled(f"after the posterior and {reps} EKF calls")
        gc.collect()
        torch.cuda.empty_cache()
        ekf_calls("after gc.collect() and empty_cache()")
    finally:
        gc.callbacks.remove(on_gc)


# ---- generic: the generic-skeleton slice (models/skeleton, the generic stages) ----

#: the 3-link tree of tests/test_sweep.py's generic harness (n_pose 12):
#: the one skeleton of the phase whose GN blocks the banded kernel takes
#: (it refuses P > 32, as the TPU kernel does, banded_pallas.py:249-250)
TREE3 = dict(
    links=[["root"], ["root", "mid"], ["mid", "tip"]],
    positions=dict(root=[0.0, 0.0, 0.0], mid=[0.4, 0.0, 0.0], tip=[0.8, 0.0, 0.0]),
    dofs=dict(root=[1, 1, 1], mid=[0, 1, 1], tip=[0, 1, 0]),
    markers=["root", "mid", "tip"],
)

#: a human at the width of bench.py's generic block (15 markers, n_pose
#: 48, 2 cameras): 'pelvis' is the child of both hips, as the shipped
#: human's hip1 is, so compat="tpu" takes the DAG Jacobian; 'neck' is a
#: marker, so the default exclude_markers=("neck",) drops its pixels
HUMAN_DAG = dict(
    links=[["forehead"], ["forehead", "neck"], ["neck", "l_shoulder"], ["neck", "r_shoulder"],
           ["l_shoulder", "l_elbow"], ["l_elbow", "l_wrist"], ["r_shoulder", "r_elbow"],
           ["r_elbow", "r_wrist"], ["neck", "l_hip"], ["neck", "r_hip"], ["l_hip", "pelvis"],
           ["r_hip", "pelvis"], ["l_hip", "l_knee"], ["l_knee", "l_ankle"],
           ["r_hip", "r_knee"], ["r_knee", "r_ankle"]],
    positions=dict(
        forehead=[0.0, 0.0, 1.7], neck=[0.0, 0.0, 1.5], l_shoulder=[0.0, 0.2, 1.45],
        r_shoulder=[0.0, -0.2, 1.45], l_elbow=[0.0, 0.25, 1.15], r_elbow=[0.0, -0.25, 1.15],
        l_wrist=[0.05, 0.25, 0.9], r_wrist=[0.05, -0.25, 0.9], l_hip=[0.0, 0.1, 1.0],
        r_hip=[0.0, -0.1, 1.0], pelvis=[0.0, 0.0, 0.95], l_knee=[0.02, 0.1, 0.55],
        r_knee=[0.02, -0.1, 0.55], l_ankle=[0.0, 0.1, 0.1], r_ankle=[0.0, -0.1, 0.1]),
    dofs={p: [1, 1, 1] for p in (
        "forehead", "neck", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow", "l_wrist",
        "r_wrist", "l_hip", "r_hip", "pelvis", "l_knee", "r_knee", "l_ankle", "r_ankle")},
    markers=["forehead", "neck", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow", "l_wrist",
             "r_wrist", "l_hip", "r_hip", "pelvis", "l_knee", "r_knee", "l_ankle", "r_ankle"],
)

#: tests/test_sweep.py:314's bound on the generic FTE's mean marker error
#: (and here on the generic EKF's median)
GENERIC_MARKER_ERR_BOUND_M = 0.05
GENERIC_ITERS = 30
#: the float32 generic EKF against float64 on its first runs: the largest
#: smoothed pose gap (rad or m) that still means the filter held (an
#: H100 reads 0.048 for the cheetah tree and 0.007 for the human). The
#: pose angles themselves are no test: angle combinations that move no
#: marker (a part's turn about its bone) random-walk in the filter, past
#: pi within 100 frames in most runs, in float64 as in float32; the
#: filter is the JAX package's (tests/test_torch_generic.py)
EKF_F64_RUNS = 8
EKF_F32_POSE_GAP = 0.1


def make_generic_runs(model, B, n_cams, seed, n_range=(80, 100), fps=90.0):
    """B runs of a skeleton, n_range frames each (the first at the most)
    at 90 fps, rendered through the port's FK and fisheye projection in
    float64 on the CPU: a root line plus sinusoidal angles of amplitude
    0.3 with seeded frequencies and phases (tests/test_sweep.py's generic
    harness) on a ring_cameras(n_cams) rig, 1.5 px noise, all likelihoods
    1. Returns (RunData list, ground-truth FK rows per run)."""
    from acinoset_tpu_torch.ops import camera as cam_ops
    from acinoset_tpu_torch.pipeline.sweep import RunData
    from acinoset_tpu_torch.utils import synthetic

    k, d, r, t, res = synthetic.ring_cameras(n_cams=n_cams)
    d, t = d.reshape(n_cams, 4), t.reshape(n_cams, 3)
    rig = [torch.as_tensor(a, dtype=torch.float64)[:, None, None] for a in (k, d, r, t)]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(n_range[0], n_range[1] + 1, size=B)
    lengths[0] = n_range[1]
    runs, truth = [], []
    for i, n in enumerate(lengths):
        tt = np.arange(n) / fps
        X = np.zeros((n, model.n_pose))
        X[:, 0] = -1.0 + 6.0 * tt
        X[:, 1] = 0.2 * np.sin(2 * np.pi * tt + i)
        X[:, 2] = 0.6 + 0.05 * np.sin(2 * np.pi * 2 * tt)
        X[:, 3:] = 0.3 * np.sin(2 * np.pi * tt[:, None] * rng.uniform(0.5, 1.5, model.n_pose - 3)
                                + rng.uniform(0, 6, model.n_pose - 3))
        pts = model.fk(torch.as_tensor(X))  # (n, L, 3)
        pix = cam_ops.project_points_fisheye(pts[None], *rig).numpy()  # (C, n, L, 2)
        pix += rng.normal(scale=1.5, size=pix.shape)
        runs.append(RunData(data_dir=f"generic_{i:03d}", pixels=pix, likelihood=np.ones(pix.shape[:3]),
                            cams=(k, d, r, t), fps=fps, start_frame=0, scene_fpath="",
                            cam_res=res))
        truth.append(pts.numpy())
    return runs, truth


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _profiled(fn, device):
    """One call of fn under torch.profiler, device activity only (CPU
    activity on the CPU, for rehearsals): (device ops, device busy ms,
    wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t1 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t1
    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    ops = [e for e in prof.events() if e.device_type == kind]
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3, wall * 1e3


def _profiled_solve(device, model, runs, init_marker, iters):
    """One solve_batch_generic call (no rescue) under _profiled."""
    from acinoset_tpu_torch.pipeline.sweep import solve_batch_generic

    return _profiled(lambda: solve_batch_generic(model, runs, 0.5, num_iters=iters,
                                                 device=device, init_marker=init_marker,
                                                 rescue=False), device)


def generic_skeleton(device, label, model, n_cams, init_marker, B=96, iters=GENERIC_ITERS,
                     seed=0, n_range=(80, 100), profile=True):
    """One skeleton through the generic slice on ``device``: the analytic
    FK Jacobian against the jacfwd fallback in float32 (1e-5 of scale);
    one warm-up call of each stage at B=4, N=20; solve_batch_generic
    (float32, the default 'chol_unrolled', no rescue) timed, then the
    rescue as solve_batch_generic wires it, timed; every hand kernel's
    count set to 0 before and read after (the path reaches none); two
    profiled solves (1 and 2 iterations: their difference is one GN
    iteration's device ops); solve_batch_ekf_generic (float32) timed with
    its peak memory a run (the profiled solves only with profile). Fails
    on a Jacobian mismatch, non-finite or
    misshapen results, a hand-kernel launch, a rescue that changed a
    converged run or lost one, a mean FTE marker error at or over
    GENERIC_MARKER_ERR_BOUND_M, EKF outliers on 20% of a run's pairs or
    more, float32 EKF poses over EKF_F32_POSE_GAP from a float64 solve of
    the first EKF_F64_RUNS runs, or a median EKF marker error at or over
    GENERIC_MARKER_ERR_BOUND_M."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.models.skeleton import SkeletonModel, fk_and_jac_any
    from acinoset_tpu_torch.pipeline.sweep import (_rescue_unconverged, solve_batch_ekf_generic,
                                                   solve_batch_generic)

    t0 = time.perf_counter()
    runs, truth = make_generic_runs(model, B, n_cams, seed, n_range)
    N = max(r.pixels.shape[1] for r in runs)
    L = model.n_markers

    x = torch.as_tensor(np.random.default_rng(seed).normal(scale=0.5, size=(B, N, model.n_pose)),
                        dtype=torch.float32, device=device)
    pts, J = model.fk_and_jac(x)
    pts_f, J_f = fk_and_jac_any(SkeletonModel(**{**vars(model), "fk_and_jac": None}))(x)
    jac_err = float((J - J_f).abs().max() / J_f.abs().max())
    pts_err = float((pts - pts_f).abs().max() / pts_f.abs().max())
    if not (jac_err <= 1e-5 and pts_err <= 1e-5):
        raise AssertionError(f"{label}: analytic FK Jacobian vs jacfwd {jac_err:.3g}, FK "
                             f"{pts_err:.3g} of scale (tol 1e-5)")
    del x, pts, J, pts_f, J_f
    _phase("generic", t0, f"{label}: {model.fk_and_jac.__name__} vs jacfwd on {B}x{N} float32 "
           f"poses: {jac_err:.3g} of scale (FK {pts_err:.3g}; tol 1e-5)")

    kw = dict(device=device, init_marker=init_marker)
    warm = [replace(r, pixels=r.pixels[:, :20], likelihood=r.likelihood[:, :20]) for r in runs[:4]]
    solve_batch_generic(model, warm, 0.5, num_iters=iters, **kw)  # allocator, cuBLAS handles
    solve_batch_ekf_generic(model, warm, 0.5, **kw)
    counted = [banded_solve] + list(pk.KERNELS.values())
    for f in counted:
        f.launches = 0
    _sync(device)
    t1 = time.perf_counter()
    before = solve_batch_generic(model, runs, 0.5, num_iters=iters, rescue=False, **kw)
    t2 = time.perf_counter()
    after = _rescue_unconverged(
        list(before), "generic ", iters,
        lambda bad, X0s, budget: solve_batch_generic(
            model, [runs[i] for i in bad], 0.5, num_iters=budget, X0_override=X0s,
            rescue=False, plain_iters=0, **kw))
    t3 = time.perf_counter()
    hand = sum(f.launches for f in counted)
    t_solve, t_rescue = t2 - t1, t3 - t2
    for rb, ra in zip(before, after):
        if rb["converged"] and ra is not rb:
            raise AssertionError(f"{label}: the rescue changed the converged run {rb['data_dir']}")
    for r, p in zip(after, truth):
        if not (np.isfinite(r["positions"]).all() and r["positions"].shape == p.shape
                and r["x"].shape == (len(p), model.n_pose)):
            raise AssertionError(f"{label}: non-finite or misshapen FTE result {r['data_dir']}")
    n_before = sum(r["converged"] for r in before)
    n_after = sum(r["converged"] for r in after)
    if not n_after >= n_before:
        raise AssertionError(f"{label}: the rescue lost converged runs: {n_before} -> {n_after}")
    errs = _run_errs(after, truth)
    mk = float(errs.mean())
    if not mk < GENERIC_MARKER_ERR_BOUND_M:
        raise AssertionError(f"{label}: FTE mean marker error {mk} m is not under "
                             f"{GENERIC_MARKER_ERR_BOUND_M} m")
    if hand:
        raise AssertionError(f"{label}: the generic path launched {hand} hand kernels")
    _phase("generic", t0, f"{label} FTE: B={B} N={N} C={n_cams} L={L} P={model.n_pose} f32 "
           f"chol_unrolled iters={iters}: rescue-inclusive traj/s {B / (t_solve + t_rescue):.2f} "
           f"(solve {t_solve:.4f} s + rescue {t_rescue:.4f} s), without the rescue "
           f"{B / t_solve:.2f}; converged {n_before} -> {n_after}/{B}; max_grad_norm "
           f"{max(r['grad_norm'] for r in after):.4g}; mean_marker_err_m {mk:.5f} (bound "
           f"{GENERIC_MARKER_ERR_BOUND_M}, worst run {errs.max():.5f}); hand-kernel launches "
           f"{hand}")

    if profile:
        ops1, _busy1, _wall1 = _profiled_solve(device, model, runs, init_marker, 1)
        ops2, busy2, wall2 = _profiled_solve(device, model, runs, init_marker, 2)
        _phase("generic", t0, f"{label} profiled: {ops2 - ops1} device ops a GN iteration "
               f"({ops2} in a 2-iteration solve); device busy {busy2:.1f} ms of {wall2:.1f} ms "
               f"wall ({100 * busy2 / wall2:.1f}%)")

    for f in counted:
        f.launches = 0
    if device.type == "cuda":
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t4 = time.perf_counter()
    res = solve_batch_ekf_generic(model, runs, 0.5, **kw)
    t_ekf = time.perf_counter() - t4
    peak = (torch.cuda.max_memory_allocated() - base) / B if device.type == "cuda" else float("nan")
    hand = sum(f.launches for f in counted)
    if hand:
        raise AssertionError(f"{label}: the generic EKF launched {hand} hand kernels")
    for r, p in zip(res, truth):
        st = r["states"]
        if not (all(np.isfinite(v).all() for v in st.values()) and np.isfinite(r["positions"]).all()
                and r["positions"].shape == p.shape):
            raise AssertionError(f"{label}: non-finite or misshapen EKF result {r['data_dir']}")
        n_pairs = len(p) * n_cams * L
        if not r["outliers"] < 0.2 * n_pairs:
            raise AssertionError(f"{label}: EKF gated {r['outliers']} of {n_pairs} pairs in "
                                 f"{r['data_dir']}")
    # float32 divergence: the same filter in float64 on the first runs
    res64 = solve_batch_ekf_generic(model, runs[:EKF_F64_RUNS], 0.5, dtype=torch.float64, **kw)
    gap = max(float(np.abs(a["states"]["smoothed_x"] - b["states"]["smoothed_x"]).max())
              for a, b in zip(res, res64))
    eerrs = _run_errs(res, truth)
    med = float(np.median(eerrs))
    if not (gap <= EKF_F32_POSE_GAP and med < GENERIC_MARKER_ERR_BOUND_M):
        raise AssertionError(f"{label}: EKF float32 poses {gap:.3g} from float64 (tol "
                             f"{EKF_F32_POSE_GAP}), median marker error {med} m (bound "
                             f"{GENERIC_MARKER_ERR_BOUND_M})")
    ang = np.array([np.abs(r["states"]["smoothed_x"][:, 3:]).max() for r in res])
    _phase("generic", t0, f"{label} EKF: runs/s {B / t_ekf:.2f} ({t_ekf:.4f} s); peak "
           f"{peak / 1e6:.2f} MB a run; outliers {sum(r['outliers'] for r in res)} (worst run "
           f"{max(r['outliers'] for r in res)}); float32 poses within {gap:.3g} of float64 on "
           f"{EKF_F64_RUNS} runs; marker error median {med:.5f} m, mean {eerrs.mean():.5f}; max "
           f"|angle| {ang.max():.4f} rad, past pi in {int((ang >= np.pi).sum())}/{B} runs; "
           f"hand-kernel launches {hand}")
    return dict(t_solve=t_solve, t_rescue=t_rescue, n_before=n_before, n_after=n_after, mk=mk,
                t_ekf=t_ekf)


class _FirstCall:
    """Wraps a function and keeps a copy of the arguments of its first
    call (a GN step's banded system, as the solver hands it over)."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, bands, rhs):
        if self.args is None:
            self.args = ([b.detach().clone() for b in bands], rhs.detach().clone())
        return self.fn(bands, rhs)


def generic_pallas(device, B=96, iters=GENERIC_ITERS, seed=1):
    """The banded kernel on the generic path: the 3-link tree (P = 12)
    at B=96, N=100 (80-100 frames padded), 6 cameras, float32, through
    solve_batch_generic with _cfg_override={'linear_solver': 'pallas'}
    and no rescue, every kernel count set to 0 before and read after;
    then the same call with the default 'chol_unrolled'. Fails unless
    banded_solve launched at least once a GN iteration, the first GN
    system the solver handed the kernel satisfies the kernel phase's
    'fte' residual rule against the plain version in float32 (|A x - g| <=
    2 |A x_plain32 - g| + 1e-4 |g| per system), each solve's mean marker
    error is under GENERIC_MARKER_ERR_BOUND_M, and every run's cost
    agrees with 'chol_unrolled''s within 1e-3 relative."""
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.models.skeleton import build_skeleton_model
    from acinoset_tpu_torch.pipeline.sweep import solve_batch_generic
    from acinoset_tpu_torch.solvers import trajopt
    from acinoset_tpu_torch.solvers.banded import banded_matvec, block_banded_solve_unrolled

    t0 = time.perf_counter()
    model = build_skeleton_model(TREE3)
    runs, truth = make_generic_runs(model, B, 6, seed)
    N = max(r.pixels.shape[1] for r in runs)
    kw = dict(num_iters=iters, device=device, init_marker="root", exclude_markers=(),
              rescue=False)
    solve_batch_generic(model, runs[:4], 0.5, _cfg_override={"linear_solver": "pallas"}, **kw)
    counted = [banded_solve] + list(pk.KERNELS.values())
    for f in counted:
        f.launches = 0
    first = _FirstCall(trajopt.banded_solve)
    trajopt.banded_solve = first
    try:
        _sync(device)
        t1 = time.perf_counter()
        res_p = solve_batch_generic(model, runs, 0.5, _cfg_override={"linear_solver": "pallas"},
                                    **kw)
        t_p = time.perf_counter() - t1
    finally:
        trajopt.banded_solve = first.fn
    launches = banded_solve.launches
    others = sum(f.launches for f in counted[1:])
    t2 = time.perf_counter()
    res_c = solve_batch_generic(model, runs, 0.5, **kw)
    t_c = time.perf_counter() - t2
    if not (launches >= iters and others == 0):
        raise AssertionError(f"tree3: banded_solve launched {launches} times in {iters} GN "
                             f"iterations, other hand kernels {others}")

    b32, g32 = first.args
    x_k = banded_solve(b32, g32)
    x_p32 = block_banded_solve_unrolled(b32, g32)
    b64, g64 = [b.double() for b in b32], g32.double()
    resid_k = torch.linalg.vector_norm(banded_matvec(b64, x_k.double()) - g64, dim=(1, 2))
    resid_p = torch.linalg.vector_norm(banded_matvec(b64, x_p32.double()) - g64, dim=(1, 2))
    gn = torch.linalg.vector_norm(g64, dim=(1, 2))
    worst = float(torch.max(resid_k - (2.0 * resid_p + 1e-4 * gn)))
    if not worst <= 0:
        raise AssertionError(f"tree3: kernel residual exceeds 2x plain f32 + 1e-4|g| by {worst:.3g}")
    errs_p, errs_c = _run_errs(res_p, truth), _run_errs(res_c, truth)
    cost_gap = max(abs(a["cost"] - b["cost"]) / abs(b["cost"]) for a, b in zip(res_p, res_c))
    if not (errs_p.mean() < GENERIC_MARKER_ERR_BOUND_M and errs_c.mean() < GENERIC_MARKER_ERR_BOUND_M
            and cost_gap <= 1e-3):
        raise AssertionError(f"tree3: pallas marker error {errs_p.mean()}, chol_unrolled "
                             f"{errs_c.mean()}, cost gap {cost_gap:.3g}")
    _phase("generic", t0, f"tree3 pallas: B={B} N={N} C=6 P={model.n_pose} f32 iters={iters}, no "
           f"rescue: {B / t_p:.2f} traj/s ({t_p:.4f} s) against chol_unrolled {B / t_c:.2f} "
           f"({t_c:.4f} s); banded_chol launches {launches}; first GN system "
           f"{tuple(b32[0].shape)}: rel residual {float(torch.max(resid_k / gn)):.3g} (plain f32 "
           f"{float(torch.max(resid_p / gn)):.3g}); converged {sum(r['converged'] for r in res_p)} "
           f"(chol_unrolled {sum(r['converged'] for r in res_c)})/{B}; mean marker error "
           f"{errs_p.mean():.5f} m (chol_unrolled {errs_c.mean():.5f}); max cost gap "
           f"{cost_gap:.3g}")
    return launches


def phase_generic(device):
    """The generic-skeleton slice: the cheetah exported as a tree
    skeleton at full width (20 markers, n_pose 63, ring_cameras(6)),
    the human-width DAG (15 markers, n_pose 48, 2 cameras, not profiled),
    each through generic_skeleton, then the banded kernel on the generic path
    (generic_pallas, P = 12)."""
    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.models.skeleton import build_skeleton_model

    tree = build_skeleton_model(cheetah.to_skeleton_dict(), allow_fk_mismatch=True)
    human = build_skeleton_model(HUMAN_DAG)
    generic_skeleton(device, "cheetah tree", tree, 6, "nose")
    # the DAG's profiled solves are left out to keep the script in its time
    # limit: the tree's show where a GN iteration's device time goes
    generic_skeleton(device, "human DAG", human, 2, "forehead", profile=False)
    return generic_pallas(device)


# ---- sba and calib: the SBA reconstruction and camera calibration ----

GOLDEN_SBA = os.path.join(ROOT, "tests", "golden", "sba_calib_synthetic.npz")
#: Tolerances holding the port's float64 results to GOLDEN_SBA (the JAX
#: package's), from the CPU comparison (tests/test_torch_lm_sba.py,
#: tests/test_torch_calib.py). An LM accepts or rejects a step by a cost
#: comparison that rounding decides once a problem has converged: such a
#: flip moves a converged point by up to ~sqrt(eps cost / H) (the golden
#: check reads ~1e-8 of scale) while its cost agrees to rounding. So the LM
#: results are held by their final robust cost at 1e-8 (relative) and
#: their positions, rotations and translations at 1e-6; the results of
#: well-conditioned problems (the calibrations' intrinsics and the pair's
#: relative pose) at 1e-8.
LM_COST_RTOL = 1e-8
LM_STATE_ATOL = 1e-6
CALIB_RTOL = 1e-8
SBA_ITERS = 30
SBA_F_SCALE = 50.0
#: tests/test_sba.py's bounds on the SBA reconstruction's marker error (m)
SBA_MEDIAN_ERR_M = 0.025
SBA_MEAN_ERR_M = 0.12


def _close(name, got, want, rtol=0.0, atol=0.0):
    """assert_allclose that returns the largest error relative to the
    reference's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.nanmax(np.abs(got - want)) / max(np.nanmax(np.abs(want)), 1e-300))


def _point_costs(residuals, n_points, f_scale):
    """Per-point Cauchy cost of flattened (P, 2C) residuals."""
    e = np.asarray(residuals, np.float64).reshape(n_points, -1) / f_scale
    return 0.5 * f_scale**2 * np.log1p(e * e).sum(-1)


def golden_sba_compare(out, g):
    """Hold results in the golden file's keys (whichever sections ``out``
    has) to the file's JAX outputs ``g`` at the tolerances above. Returns
    the largest error of each key relative to its scale."""
    worst = {}
    if "sba_positions" in out:
        pos = out["sba_positions"]
        if not np.array_equal(np.isnan(pos), np.isnan(g["sba_positions"])):
            raise AssertionError("golden SBA: NaN patterns differ")
        n = pos.shape[0] * pos.shape[1]
        worst["sba_before"] = _close("sba_before", out["sba_before"], g["sba_before"], rtol=1e-8,
                                     atol=1e-8 * np.abs(g["sba_before"]).max())
        worst["sba point cost"] = _close(
            "sba point cost", _point_costs(out["sba_after"], n, SBA_F_SCALE),
            _point_costs(g["sba_after"], n, SBA_F_SCALE), rtol=LM_COST_RTOL)
        worst["sba_positions"] = _close("sba_positions", pos, g["sba_positions"],
                                        atol=LM_STATE_ATOL)
    if "spe_pts" in out:
        worst["spe cost"] = _close("spe cost", _point_costs(out["spe_after"], 1, 1.0),
                                   _point_costs(g["spe_after"], 1, 1.0), rtol=LM_COST_RTOL)
        for key in ("spe_pts", "spe_R", "spe_T"):
            worst[key] = _close(key, out[key], g[key], atol=LM_STATE_ATOL)
    if "fi_k" in out:
        if not np.array_equal(out["fi_used"], g["fi_used"]):
            raise AssertionError(f"golden intrinsics: used {out['fi_used']} vs {g['fi_used']}")
        worst["fi_k"] = _close("fi_k", out["fi_k"], g["fi_k"], rtol=CALIB_RTOL)
        worst["fi_d"] = _close("fi_d", out["fi_d"], g["fi_d"], rtol=CALIB_RTOL,
                               atol=CALIB_RTOL * np.abs(g["fi_d"]).max())
        for key in ("fi_rms", "fi_frame_rms"):
            worst[key] = _close(key, out[key], g[key], rtol=CALIB_RTOL)
        for key in ("fi_rvecs", "fi_tvecs"):
            worst[key] = _close(key, out[key], g[key], atol=CALIB_RTOL)
    if "fp_R" in out:
        for key in ("fp_R", "fp_t"):
            worst[key] = _close(key, out[key], g[key], atol=CALIB_RTOL)
        worst["fp_rms"] = _close("fp_rms", out["fp_rms"], g["fp_rms"], rtol=CALIB_RTOL)
    return worst


def golden_sba_run(device, g):
    """The port's float64 sba_run and sba_points_extrinsics on the golden
    file's inputs, in its keys."""
    from acinoset_tpu_torch.pipeline.sba import sba_run
    from acinoset_tpu_torch.solvers.lm import sba_points_extrinsics

    pos, res = sba_run(g["sba_pixels"], g["sba_valid"], g["sba_k"], g["sba_d"], g["sba_r"],
                       g["sba_t"], f_scale=SBA_F_SCALE, num_iters=SBA_ITERS, device=device)
    dt = torch.float64
    pts, R, T, spe = sba_points_extrinsics(
        torch.as_tensor(g["spe_obs"], dtype=dt, device=device),
        torch.as_tensor(g["spe_mask"], device=device), g["spe_k"], g["spe_d"], g["spe_r"],
        g["spe_t"], torch.as_tensor(g["spe_x0"], dtype=dt, device=device), f_scale=1.0,
        num_iters=int(g["spe_iters"]))
    out = dict(sba_positions=pos, sba_before=res["before"], sba_after=res["after"], spe_pts=pts,
               spe_R=R, spe_T=T, spe_before=spe["before"], spe_after=spe["after"])
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def golden_calib_run(device, g):
    """The port's float64 calibrate_fisheye_camera (F = 12, one bad view)
    and calibrate_pair_extrinsics_fisheye on the golden file's inputs, in
    its keys."""
    from acinoset_tpu_torch.calib.extrinsics import calibrate_pair_extrinsics_fisheye
    from acinoset_tpu_torch.calib.intrinsics import calibrate_fisheye_camera

    cal = calibrate_fisheye_camera(g["fi_obj"], g["fi_img"], tuple(g["fi_res"]), device=device)
    rms, R, t = calibrate_pair_extrinsics_fisheye(
        g["fp_obj"], g["fp_p1"], g["fp_p2"], g["fp_K"], g["fp_D"], g["fp_K"], g["fp_D"],
        (2704, 1520), num_iters=int(g["fp_iters"]), device=device)
    out = {f"fi_{k}": getattr(cal, k) for k in ("k", "d", "rvecs", "tvecs", "rms", "frame_rms",
                                                "used")}
    out.update(fp_rms=rms, fp_R=R, fp_t=t)
    return out


def _fmt_worst(worst):
    return ", ".join(f"{k} {v:.3g}" for k, v in worst.items())


def phase_sba(device):
    """The SBA reconstruction at the flagship's scene and width:
    ring_cameras(6), cheetah_gallop(N=100), 1.5 px noise, 2% outliers,
    5% low likelihood, seed 0 (P = 2,000 points): sba_run in float64
    (30 iterations, f_scale 50), s a call (the median of 3 after a
    warm-up), points/s, the robust init's share, and the marker error
    against the synthetic truth, gated by tests/test_sba.py's bounds and
    a Cauchy cost that did not rise; first the golden check on the card.
    The path reaches no hand kernel."""
    from acinoset_tpu_torch.convert import rig_to_torch
    from acinoset_tpu_torch.kernels import probes_cuda as pk
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.pipeline import sba
    from acinoset_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    worst = golden_sba_compare(golden_sba_run(device, dict(np.load(GOLDEN_SBA))),
                               np.load(GOLDEN_SBA))
    _phase("sba", t0, f"golden (float64, 4 cameras, N=20; and sba_points_extrinsics, P=160): "
           f"largest errors relative to each key's scale: {_fmt_worst(worst)}")

    cams = synthetic.ring_cameras(n_cams=6)
    k, d, r, t, _res = cams
    X = synthetic.cheetah_gallop(N=100, fps=90.0)
    px, lik, truth = synthetic.render_measurements(X, cams, noise_px=1.5, outlier_frac=0.02,
                                                   bad_lik_frac=0.05, seed=0)
    valid = lik > 0.5
    P = truth.shape[0] * truth.shape[1]

    def run():
        return sba.sba_run(px, valid, k, d, r, t, f_scale=SBA_F_SCALE, num_iters=SBA_ITERS,
                           device=device)

    rig = rig_to_torch(k, d, r, t, device)
    pxt = torch.as_tensor(np.nan_to_num(px), device=device)
    vt = torch.as_tensor(valid, device=device)

    def init():
        sba._robust_triangulation_init(pxt, vt, *rig)
        _sync(device)

    run()  # warm-up
    init()
    counted = [banded_solve] + list(pk.KERNELS.values())
    for f in counted:
        f.launches = 0
    secs, init_secs = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        pos, res = run()
        secs.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        init()
        init_secs.append(time.perf_counter() - t1)
    hand = sum(f.launches for f in counted)
    if hand:
        raise AssertionError(f"the SBA path launched {hand} hand kernels")
    n_ops, busy_ms, wall_ms = _profiled(run, device)
    if pos.shape != truth.shape:
        raise AssertionError(f"SBA positions {pos.shape} vs {truth.shape}")
    err = np.linalg.norm(pos - truth, axis=-1)
    med, mean = float(np.nanmedian(err)), float(np.nanmean(err))
    c_before = float(_point_costs(res["before"], 1, SBA_F_SCALE)[0])
    c_after = float(_point_costs(res["after"], 1, SBA_F_SCALE)[0])
    s, s_init = float(np.median(secs)), float(np.median(init_secs))
    _phase("sba", t0, f"sba_run (float64, C=6, N=100, P={P}, {SBA_ITERS} iterations): "
           f"{s:.4f} s a call (median of 3: {', '.join(f'{x:.4f}' for x in secs)}), "
           f"{P / s:.1f} points/s; robust init {s_init:.4f} s ({100 * s_init / s:.1f}%); "
           f"seen {int(np.isfinite(err).sum())}/{P}; marker error median {med:.5f} m "
           f"(bound {SBA_MEDIAN_ERR_M}), mean {mean:.5f} m (bound {SBA_MEAN_ERR_M}); Cauchy cost "
           f"{c_before:.2f} -> {c_after:.2f}; hand-kernel launches {hand}; one call profiled: "
           f"{n_ops} device ops, device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall")
    if not (med < SBA_MEDIAN_ERR_M and mean < SBA_MEAN_ERR_M):
        raise AssertionError(f"SBA marker error median {med} m, mean {mean} m")
    if not c_after <= c_before:
        raise AssertionError(f"SBA Cauchy cost rose: {c_before} -> {c_after}")


#: calibration phase: 6 chained fisheye cameras (tests/test_calib.py's
#: K, D and pair pose between neighbours), 60 intrinsics views a camera,
#: 30 shared views a pair with 3 of the second camera's corner sets
#: reversed
CALIB_CAMS = 6
CALIB_VIEWS = 60
CALIB_PAIR_VIEWS = 30
CALIB_REVERSED = 3
#: intrinsics views: tests/test_calib.py's stereo rule puts the board at
#: 2-5 m near the axis, where focal length and distortion trade off and
#: fx can miss the 1% gate at 60 views; these nearer, wider poses spread
#: the corners over the fisheye's field as an intrinsics session does
#: (poses much wider still can send the calibration into a wrong basin)
CALIB_INTRINSIC_POSES = dict(rot_scale=0.4, t_range=((-1.2, 1.2), (-0.7, 0.7), (0.8, 2.0)))
#: chained cameras' pose error bounds a link of the chain (deg, m): the
#: errors add up along the chain, link by link
CALIB_ROT_DEG_PER_LINK = 0.1
CALIB_T_M_PER_LINK = 0.005
#: the board SBA starts from the chained extrinsics, cameras 1-5
#: perturbed by N(0, 0.003) rad and N(0, 1 cm) a component (from the
#: chain itself its start is already at the noise floor, ~0.1 px), and
#: must bring the residual RMS under 0.5 px and 0.2 x its start. At
#: tests/test_sba.py's larger perturbation, 0.01 rad and 3 cm, the board
#: data's ordering test (triangulate in two views, reproject into the
#: first) flips correct corner sets on some seeds, in the JAX package as
#: in the port: the phase counts them on CALIB_FLIP_SEEDS, ungated
CALIB_BA_PERTURB = (0.003, 0.01)
CALIB_TEST_PERTURB = (0.01, 0.03)
CALIB_FLIP_SEEDS = range(10)
CALIB_BA_ITERS = 80


def _rms_observed(residuals, mask):
    r = np.asarray(residuals).reshape(mask.shape + (2,))[mask]
    return float(np.sqrt(np.mean(r**2)))


def _perturbed(r_arr, t_arr, scale, seed):
    """The extrinsics with cameras 1.. perturbed by N(0, scale[0]) rad
    and N(0, scale[1]) m a component."""
    from acinoset_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(seed)
    r_pert, t_pert = [r_arr[0]], [t_arr[0]]
    for r, t in zip(r_arr[1:], t_arr[1:]):
        r_pert.append(syn._rot(rng.normal(scale=scale[0], size=3)) @ r)
        t_pert.append(t + rng.normal(scale=scale[1], size=(3, 1)))
    return r_pert, t_pert


def _board_data_wrong(obs, mask, img_arr, names, rev):
    """(view name, camera, kept) of every corner set of chained_pair_views'
    data that prepare_calib_board_data's (obs, mask) dropped or holds out
    of order, the reversed sets judged against their true order."""
    wrong = []
    shared = sorted({n for ns in names for n in ns})
    M = img_arr[0].shape[1]
    for j, name in enumerate(shared):
        i = int(name.split("_")[0])
        for c in (i, i + 1):
            want = img_arr[c][names[c].index(name)]
            want = want[::-1] if (c == i + 1 and name in rev) else want
            sl = slice(j * M, (j + 1) * M)
            if not (mask[sl, c].all() and np.array_equal(obs[sl, c], want)):
                wrong.append((name, c, bool(mask[sl, c].all())))
    return wrong


def _view_pose_errors(obj, p1, p2, device):
    """Each shared view's own relative pose, camera 1 -> 2, from the two
    board poses calib.pnp.board_pose_fisheye gives (what the pairwise
    consensus compares), against the chain's true pair pose: (deg, m)."""
    from acinoset_tpu_torch.calib import extrinsics as ext
    from acinoset_tpu_torch.calib import pnp
    from acinoset_tpu_torch.utils import synthetic as syn

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    def pose(p):
        return (a.cpu().numpy() for a in pnp.board_pose_fisheye(
            t(obj)[:, :2], t(p), t(syn.FISHEYE_K), t(syn.FISHEYE_D)))

    (R1, t1), (R2, t2) = pose(p1), pose(p2)
    Rr = np.einsum("fij,fkj->fik", R2, R1)
    tr = t2 - np.einsum("fij,fj->fi", Rr, t1)
    rot = np.array([ext._rot_geodesic_deg(r, syn._rot(syn.PAIR_RVEC)) for r in Rr])
    return rot, np.linalg.norm(tr - syn.PAIR_T, axis=1)


def phase_calib(device):
    """Camera calibration on a synthetic 6-camera fisheye rig at
    2704 x 1520 (float64): calibrate_fisheye_camera a camera (60 views,
    one corrupted so that the drop round runs), calibrate_pairwise_
    extrinsics along the chain (30 shared views a pair, 10% of the second
    camera's corner sets reversed), bundle_adjust_board_points_and_
    extrinsics (80 iterations), and one pinhole calibrate_camera and
    calibrate_pair_extrinsics at tests/test_pinhole_calib.py's shapes;
    s a stage, and the gates the module constants state. First the
    golden check on the card. Readings not gated: the intrinsics on
    tests/test_calib.py's stereo views, why the pairwise consensus drops
    views, and the board data's flipped sets at tests/test_sba.py's
    perturbation on CALIB_FLIP_SEEDS."""
    from acinoset_tpu_torch.calib import extrinsics as ext
    from acinoset_tpu_torch.calib import intrinsics as intr
    from acinoset_tpu_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    worst = golden_sba_compare(golden_calib_run(device, dict(np.load(GOLDEN_SBA))),
                               np.load(GOLDEN_SBA))
    _phase("calib", t0, f"golden (float64; fisheye intrinsics F=12, one bad view; a fisheye "
           f"pair, F=8): largest errors relative to each key's scale: {_fmt_worst(worst)}")

    K, D, res = syn.FISHEYE_K, syn.FISHEYE_D, syn.FISHEYE_RES
    rng = np.random.default_rng(0)
    t1 = time.perf_counter()
    fx_err = []
    for c in range(CALIB_CAMS):
        obj, v = syn.board_views(rng, CALIB_VIEWS, [(K, D, np.eye(3), np.zeros(3))],
                                 **CALIB_INTRINSIC_POSES)
        img = v[0]
        bad = int(rng.integers(CALIB_VIEWS))
        img[bad] += rng.normal(scale=5.0, size=img[bad].shape)
        cal = intr.calibrate_fisheye_camera(obj, img, res, device=device)
        fx_err.append(max(abs(cal.k[0, 0] / K[0, 0] - 1), abs(cal.k[1, 1] / K[1, 1] - 1)))
        dropped = np.where(~cal.used)[0].tolist()
        if not (float(cal.rms) < 0.5 and fx_err[-1] < 0.01 and dropped == [bad]):
            raise AssertionError(f"camera {c}: rms {float(cal.rms)}, fx {cal.k[0, 0]}, "
                                 f"fy {cal.k[1, 1]}, dropped {dropped} (corrupted {bad})")
    s_intr = time.perf_counter() - t1
    _phase("calib", t0, f"intrinsics: {CALIB_CAMS} cameras x {CALIB_VIEWS} views "
           f"(M=54, float64): {s_intr:.3f} s, {s_intr / CALIB_CAMS:.3f} s a camera; each drop "
           f"round dropped the corrupted view; rms < 0.5 px; fx, fy off by at most "
           f"{100 * max(fx_err):.3f}% (bound 1%)")
    # the same run on tests/test_calib.py's stereo views, boards at 2-5 m
    # near the axis, its own RNG (seed 0); a reading, not gated
    rng_s, readings = np.random.default_rng(0), []
    for c in range(CALIB_CAMS):
        obj, v = syn.board_views(rng_s, CALIB_VIEWS, [(K, D, np.eye(3), np.zeros(3))],
                                 **syn.FISHEYE_POSES)
        img = v[0]
        bad = int(rng_s.integers(CALIB_VIEWS))
        img[bad] += rng_s.normal(scale=5.0, size=img[bad].shape)
        cal = intr.calibrate_fisheye_camera(obj, img, res, device=device)
        readings.append(f"cam {c}: fx {100 * (cal.k[0, 0] / K[0, 0] - 1):+.3f}%, fy "
                        f"{100 * (cal.k[1, 1] / K[1, 1] - 1):+.3f}%, rms {float(cal.rms):.4f} px, "
                        f"D {np.array2string(np.asarray(cal.d).ravel(), precision=4)}, dropped "
                        f"{np.where(~cal.used)[0].tolist()} (corrupted {bad})")
    _phase("calib", t0, f"intrinsics on tests/test_calib.py's stereo views (not gated; "
           f"D true {D.tolist()}): {'; '.join(readings)}")

    obj, img_arr, names, rev = syn.chained_pair_views(rng, CALIB_CAMS, CALIB_PAIR_VIEWS,
                                                      reversed_views=CALIB_REVERSED)
    R_true, T_true = syn.chained_rig(CALIB_CAMS, ext.WORLD_R1)
    found = kept = 0
    s_align, keeps, rot_e, tr_e = 0.0, [], [], []
    for i in range(CALIB_CAMS - 1):
        p2 = img_arr[i + 1][:CALIB_PAIR_VIEWS]  # the pair (i, i+1)'s views in camera i+1
        p1 = img_arr[i][-CALIB_PAIR_VIEWS:]
        t1 = time.perf_counter()
        p2_fixed, keep = ext._align_pair_orderings(obj, p1, p2, K, D, K, D, device=device)
        s_align += time.perf_counter() - t1
        want = p2.copy()
        want[:CALIB_REVERSED] = want[:CALIB_REVERSED, ::-1]
        if not np.array_equal(p2_fixed[keep], want[keep]):
            raise AssertionError(f"pair {i}: a kept corner set is out of order (keep {keep})")
        found += int(keep[:CALIB_REVERSED].sum())
        kept += int(keep.sum())
        keeps.append(keep)
        rot, tr = _view_pose_errors(obj, p1, want, device)
        rot_e.append(rot)
        tr_e.append(tr)
    keeps, rot_e, tr_e = np.concatenate(keeps), np.concatenate(rot_e), np.concatenate(tr_e)
    t1 = time.perf_counter()
    r_arr, t_arr = ext.calibrate_pairwise_extrinsics(
        ext.calibrate_pair_extrinsics_fisheye, img_arr, names, [K] * CALIB_CAMS,
        [D] * CALIB_CAMS, res, (9, 6), 0.04, device=device)
    s_chain = time.perf_counter() - t1
    errs = []
    for c in range(1, CALIB_CAMS):
        rot = float(ext._rot_geodesic_deg(r_arr[c], R_true[c]))
        tr = float(np.linalg.norm(t_arr[c] - T_true[c]))
        errs.append(f"cam {c}: {rot:.4f} deg, {tr:.5f} m")
        if not (rot < CALIB_ROT_DEG_PER_LINK * c and tr < CALIB_T_M_PER_LINK * c):
            raise AssertionError(f"chained camera {c}: {rot} deg, {tr} m off")
    _phase("calib", t0, f"extrinsics: {CALIB_CAMS - 1} pairs x {CALIB_PAIR_VIEWS} views: "
           f"alignment alone {s_align:.3f} s, kept {kept}/{(CALIB_CAMS - 1) * CALIB_PAIR_VIEWS} "
           f"views (the rest off the consensus by > 10 deg or 0.3 m), each in order, {found}/"
           f"{len(rev)} reversed sets among them; calibrate_pairwise_extrinsics "
           f"{s_chain:.3f} s; pose error ({CALIB_ROT_DEG_PER_LINK} deg and "
           f"{CALIB_T_M_PER_LINK} m a link): {'; '.join(errs)}")
    _phase("calib", t0, f"why views are dropped: each view's own relative pose from its two "
           f"board_pose_fisheye poses, against the true pair pose: kept views median "
           f"{np.median(rot_e[keeps]):.3f} deg, {np.median(tr_e[keeps]):.4f} m (max "
           f"{rot_e[keeps].max():.3f} deg, {tr_e[keeps].max():.4f} m); dropped views median "
           f"{np.median(rot_e[~keeps]):.3f} deg, {np.median(tr_e[~keeps]):.4f} m (max "
           f"{rot_e[~keeps].max():.3f} deg, {tr_e[~keeps].max():.4f} m); views over 10 deg or "
           f"0.3 m: {int(((rot_e > 10) | (tr_e > 0.3)).sum())}/{len(keeps)}")

    def board_data(r_pert, t_pert):
        return ext.prepare_calib_board_data(img_arr, names, (9, 6), [K] * CALIB_CAMS,
                                            [D] * CALIB_CAMS, r_pert, t_pert, device=device)

    r_pert, t_pert = _perturbed(r_arr, t_arr, CALIB_BA_PERTURB, seed=7)
    t1 = time.perf_counter()
    obs, mask, _ = board_data(r_pert, t_pert)
    s_prep = time.perf_counter() - t1
    # every corner set in the board data, the reversed ones put back in order
    wrong = _board_data_wrong(obs, mask, img_arr, names, rev)
    if wrong:
        raise AssertionError(f"board data: sets missing or out of order: {wrong}")
    _phase("calib", t0, f"board data: all {len(rev)} reversed sets found and put back in order, "
           f"every set kept ({s_prep:.3f} s)")
    survey = []
    for seed in CALIB_FLIP_SEEDS:
        o, m, _ = board_data(*_perturbed(r_arr, t_arr, CALIB_TEST_PERTURB, seed))
        w = _board_data_wrong(o, m, img_arr, names, rev)
        survey.append(f"seed {seed}: {sum(k for *_, k in w)} flipped, "
                      f"{sum(not k for *_, k in w)} dropped")
    _phase("calib", t0, f"board data at tests/test_sba.py's perturbation, {CALIB_TEST_PERTURB[0]} "
           f"rad and {CALIB_TEST_PERTURB[1]} m (not gated), of the {len(mask) // len(obj)} second "
           f"cameras' sets: {'; '.join(survey)}")
    t1 = time.perf_counter()
    pts, r_ba, t_ba, resid = ext.bundle_adjust_board_points_and_extrinsics(
        img_arr, names, (9, 6), [K] * CALIB_CAMS, [D] * CALIB_CAMS, r_pert, t_pert,
        num_iters=CALIB_BA_ITERS, device=device)
    s_ba = time.perf_counter() - t1
    before, after = _rms_observed(resid["before"], mask), _rms_observed(resid["after"], mask)
    _phase("calib", t0, f"board SBA: P={mask.shape[0]} corners x {CALIB_CAMS} cameras, "
           f"{int(mask.sum())} observations, {CALIB_BA_ITERS} iterations: {s_ba:.3f} s (with its "
           f"board data prep); residual RMS {before:.4f} -> {after:.4f} px "
           f"(bounds 0.5 px and 0.2 x before)")
    if not (np.isfinite(pts).all() and after < 0.5 and after < 0.2 * before):
        raise AssertionError(f"board SBA: residual RMS {before} -> {after} px")

    Kp, Dq, res_p = syn.PINHOLE_K, syn.PINHOLE_PAIR_D, syn.PINHOLE_RES
    t1 = time.perf_counter()
    k_p, _d, _rv, _tv, rms_p = intr.calibrate_camera(*syn.pinhole_views(), res_p, device=device)
    s_pin = time.perf_counter() - t1
    fp_err = max(abs(k_p[0, 0] / Kp[0, 0] - 1), abs(k_p[1, 1] / Kp[1, 1] - 1))
    t1 = time.perf_counter()
    rms_q, R_q, t_q = ext.calibrate_pair_extrinsics(*syn.pinhole_pair_views(), Kp, Dq, Kp, Dq,
                                                    res_p, num_iters=40, device=device)
    s_pair = time.perf_counter() - t1
    R_rel, t_rel = syn._rot(syn.PINHOLE_PAIR_RVEC), syn.PINHOLE_PAIR_T
    rot_q = float(ext._rot_geodesic_deg(R_q, R_rel))
    tq_err = float(np.linalg.norm(t_q.ravel() - t_rel))
    _phase("calib", t0, f"pinhole: calibrate_camera (F=12, 12 + 6F parameters) {s_pin:.3f} s, "
           f"rms {float(rms_p):.4f} px, fx/fy off {100 * fp_err:.3f}%; calibrate_pair_extrinsics "
           f"(F=8) {s_pair:.3f} s, rms {float(rms_q):.4f} px, pose error {rot_q:.4f} deg, "
           f"{tq_err:.5f} m")
    if not (float(rms_p) < 0.5 and fp_err < 0.01 and float(rms_q) < 0.5):
        raise AssertionError(f"pinhole calibration: rms {rms_p}, {rms_q}; fx/fy off {fp_err}")


# ---- calibration from images ----

#: rendered frames of the calib phase's chained rig: IMAGES_VIEWS
#: intrinsics views a camera and IMAGES_PAIR_VIEWS views a chain pair;
#: N(0, IMAGES_NOISE) grey levels a channel. The boards are held up to
#: the camera (utils.synthetic.held_board_poses), tilted 14-46 degrees:
#: the intrinsics boards over the calib phase's box (CALIB_INTRINSIC_
#: POSES' t_range), the pair boards facing the pair's first camera at
#: 1-2.5 m (at tests/test_calib.py's 5 m a 0.04 m square spans ~5 px,
#: under the detector's 9 x 9 peak window). Under CALIB_INTRINSIC_POSES'
#: random rotations the detector misses about a third of the boards, the
#: steeply tilted ones, and the fronto-parallel rest leave fx to the
#: calibration's start (images_pose_survey). The counts give the
#: calibrations about the calib phase's views once the detector's misses
#: are out (at 20 views a pair, 6-13 were found in both cameras and the
#: chain missed its bounds)
IMAGES_VIEWS = 40
IMAGES_INTRINSIC_POSES = dict(tilt=(0.25, 0.8), t_range=CALIB_INTRINSIC_POSES["t_range"])
IMAGES_PAIR_VIEWS = 40
IMAGES_PAIR_POSES = dict(tilt=(0.25, 0.8), t_range=((-0.5, 0.5), (-0.3, 0.3), (1.0, 2.5)))
IMAGES_NOISE = 2.0
#: tests/test_calib.py:57's rule a found frame (median, max px against
#: the projected truth). The lattice the JAX package grows (copied as is)
#: puts a row, a column or a few cells a square off the board on 1-7% of
#: found frames (images_pose_survey; ROADMAP Queue 3): at most
#: IMAGES_LATTICE_SHARE of the found frames may miss the rule
IMAGES_CORNER_PX = (0.5, 2.0)
IMAGES_LATTICE_SHARE = 0.05
#: the native engine against the device detector, median px a frame:
#: tests/test_native.py:39's rule
IMAGES_NATIVE_MEDIAN_PX = 0.3
#: the device detector against the CPU port: frames, corners' bound (px)
IMAGES_CPU_FRAMES = 4
IMAGES_CPU_PX = 1e-3
IMAGES_SBA_RMS_PX = 0.5
#: undistort_image_fisheye on the card against the CPU, of the 0-255 range
IMAGES_UNDISTORT_TOL = 1e-4 * 255


def render_calib_frames(device, root, rng):
    """Render the rig's frames on ``device`` (utils.synthetic's fisheye
    renderer, 2x supersampled) and write them as PNGs under ``root``:
    intrinsic_calib/frames/<cam>/<view>.png and
    extrinsic_calib/frames/<cam>/<pair>_<view>.png, cameras numbered
    from 1. Returns {path: true corners (54, 2)}."""
    from acinoset_tpu_torch.ops import camera as cam_ops
    from acinoset_tpu_torch.utils import synthetic as syn

    K, D, res = syn.FISHEYE_K, syn.FISHEYE_D, syn.FISHEYE_RES
    rays = syn.fisheye_rays(K, D, res, device)
    obj = torch.as_tensor(syn.create_board_object_pts((9, 6), 0.04), dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(0)
    r = syn._rot(syn.PAIR_RVEC)
    jobs = []
    for c in range(1, CALIB_CAMS + 1):
        for v, (Rb, tb) in enumerate(syn.held_board_poses(rng, IMAGES_VIEWS,
                                                          **IMAGES_INTRINSIC_POSES)):
            path = os.path.join(root, "intrinsic_calib", "frames", str(c), f"{v}.png")
            jobs.append((path, Rb, tb))
    for i in range(1, CALIB_CAMS):
        for v, (Rb, tb) in enumerate(syn.held_board_poses(rng, IMAGES_PAIR_VIEWS,
                                                          **IMAGES_PAIR_POSES)):
            for c, R, t in ((i, Rb, tb), (i + 1, r @ Rb, r @ tb + syn.PAIR_T)):
                jobs.append((os.path.join(root, "extrinsic_calib", "frames", str(c),
                                          f"{i}_{v}.png"), R, t))
    truth = {}
    with ThreadPoolExecutor(8) as pool:
        writes = []
        for path, R, t in jobs:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            frame = syn.render_board_frame(rays, R, t, gen, noise=IMAGES_NOISE).cpu().numpy()
            writes.append(pool.submit(syn.write_png, path, frame))
            truth[path] = cam_ops.project_points_fisheye(obj, K, D, R, t).numpy()
        for w in writes:
            w.result()
    return truth


def _corner_errors(points_fpath, frames_dir, truth):
    """The found frames' names in a points JSON and their (median, max)
    px against the truth, nearest true corner to each detected one
    (tests/test_calib.py:57)."""
    from scipy.spatial import cKDTree

    from acinoset_tpu_torch.pipeline import data as data_io

    pts, names, *_ = data_io.load_points(points_fpath)
    errs = []
    for p, name in zip(pts, names):
        d, _ = cKDTree(truth[os.path.join(frames_dir, name)]).query(p.reshape(-1, 2))
        errs.append((np.median(d), d.max()))
    return names, np.array(errs).reshape(-1, 2)


def _within_rule(grid, truth):
    """Whether a found grid (NaN where not found) meets tests/test_calib.py:57's
    rule against the true corners."""
    from scipy.spatial import cKDTree

    if not np.isfinite(grid).all():
        return False
    d, _ = cKDTree(truth).query(grid.reshape(-1, 2))
    return bool(np.median(d) < IMAGES_CORNER_PX[0] and d.max() < IMAGES_CORNER_PX[1])


def _calibrate_scene(device, root, true_intrinsics=False):
    """The user's path from a scene's points files to its cameras:
    calibrate_fisheye_intrinsics a camera (root/intrinsic_calib/points/
    points_<c>.json -> camera_<c>.json; with ``true_intrinsics`` the
    rig's K and D are written there instead), then ``cli calib`` on
    root/extrinsic_calib. Returns its readings against the rig's truth."""
    from acinoset_tpu_torch import cli
    from acinoset_tpu_torch.calib import app
    from acinoset_tpu_torch.calib import extrinsics as ext
    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.utils import synthetic as syn

    K = syn.FISHEYE_K
    intr, extr = os.path.join(root, "intrinsic_calib"), os.path.join(root, "extrinsic_calib")
    out = dict(fx_err=[], rms=[], used=[])
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        for c in range(1, CALIB_CAMS + 1):
            if true_intrinsics:
                data_io.save_camera(os.path.join(intr, f"camera_{c}.json"), syn.FISHEYE_RES, K,
                                    syn.FISHEYE_D.reshape(4, 1))
                continue
            k, _d, _res, cal = app.calibrate_fisheye_intrinsics(
                os.path.join(intr, "points", f"points_{c}.json"),
                os.path.join(intr, f"camera_{c}.json"), device=device)
            out["fx_err"].append(max(abs(k[0, 0] / K[0, 0] - 1), abs(k[1, 1] / K[1, 1] - 1)))
            out["rms"].append(float(cal.rms))
            out["used"].append(f"{int(cal.used.sum())}/{len(cal.used)}")
    out["s_intr"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cli.main(["calib", "--scene_dir", extr, "--device", device.type])
    out["s_cli"] = time.perf_counter() - t1
    names = [data_io.load_points(os.path.join(extr, "points", f"points_cam{c}.json"))[1]
             for c in range(1, CALIB_CAMS + 1)]
    out["shared"] = [len(set(a) & set(b)) for a, b in zip(names, names[1:])]
    out["dropped"] = [int(m) for m in re.findall(r"dropped (\d+) inconsistent", log.getvalue())]
    sba = re.search(r"Board SBA: RMS (\S+) -> (\S+) px", log.getvalue())
    out["sba"] = float(sba.group(1)), float(sba.group(2))
    scene = os.path.join(extr, f"{CALIB_CAMS}_cam_scene.json")
    _, _, r_arr, t_arr, _ = data_io.load_scene(scene)
    R_true, T_true = syn.chained_rig(CALIB_CAMS, ext.WORLD_R1)
    out["pose"] = [(float(ext._rot_geodesic_deg(r_arr[c], R_true[c])),
                    float(np.linalg.norm(t_arr[c] - T_true[c]))) for c in range(1, CALIB_CAMS)]
    return out


def _scene_text(r):
    pose = "; ".join(f"cam {c + 2}: {rot:.4f} deg, {tr:.5f} m" for c, (rot, tr) in
                     enumerate(r["pose"]))
    intrinsics = (f"calibrate_fisheye_intrinsics {r['s_intr']:.3f} s (rms "
                  f"{', '.join(f'{x:.4f}' for x in r['rms'])} px; frames used "
                  f"{', '.join(r['used'])}; fx, fy off by "
                  f"{', '.join(f'{100 * e:.3f}' for e in r['fx_err'])}%)" if r["rms"]
                  else "the true intrinsics")
    return (f"{intrinsics}, cli calib "
            f"{r['s_cli']:.3f} s (shared views a pair {r['shared']}, kept by the pairwise "
            f"consensus {sum(r['shared']) - sum(r['dropped'])}/{sum(r['shared'])}; pose error "
            f"{pose}; board SBA RMS {r['sba'][0]} -> {r['sba'][1]} px)")


def _detector_split(device, imgs):
    """The device detector's stages on ``imgs``, in its own chunks: the
    device pass (grey frames, candidates and the refinement; CUDA events
    on the card) and the host lattice (s)."""
    from acinoset_tpu_torch.calib import corners

    H, W = imgs[0].shape[:2]
    step = max(1, corners.CHUNK_BYTES // (corners.INTERMEDIATES * 4 * H * W))

    def timed(fn):
        if device.type != "cuda":
            t1 = time.perf_counter()
            return fn(), time.perf_counter() - t1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    def candidates(chunk):
        gray = corners._gray(chunk, device)
        return gray, corners.find_corner_candidates(gray)

    device_s, host_s = 0.0, 0.0
    for s in range(0, len(imgs), step):
        _sync(device)
        (gray, (cand, scores)), s_cand = timed(lambda: candidates(imgs[s:s + step]))
        t1 = time.perf_counter()
        lattices = [corners._grow_grid(c, sc, (9, 6))
                    for c, sc in zip(cand.cpu().numpy(), scores.cpu().numpy())]
        host_s += time.perf_counter() - t1
        start = np.stack([g.reshape(-1, 2) for g, ok in lattices if ok]).astype(np.float32)
        hit = [i for i, (_, ok) in enumerate(lattices) if ok]
        _, s_refine = timed(lambda: corners.refine_subpixel(
            gray[hit], torch.as_tensor(start, device=device)))
        device_s += s_cand + s_refine
    return device_s, host_s


def survey_rules():
    """The rules behind the images phase's views, for
    images_pose_survey: the calib phase's intrinsics rule with a one- and
    a two-square margin, the images phase's held boards, and pairs at
    its distances with random rotations (rot_scale 0.4) and held."""
    from acinoset_tpu_torch.utils import synthetic as syn

    def random_rotations(rng, n):
        return syn.board_poses(rng, n, **CALIB_INTRINSIC_POSES)

    def held(rng, n):
        return syn.held_board_poses(rng, n, **IMAGES_INTRINSIC_POSES)

    def pairs(rng, n):
        return syn.held_board_poses(rng, n, **IMAGES_PAIR_POSES)

    def pairs_random(rng, n):
        return syn.board_poses(rng, n, rot_scale=0.4, t_range=IMAGES_PAIR_POSES["t_range"])

    return {"calib rule, margin 1": (random_rotations, False, 1),
            "calib rule, margin 2": (random_rotations, False, 2),
            "held, margin 2": (held, False, 2),
            "pairs with random rotations, margin 2": (pairs_random, True, 2),
            "held pairs, margin 2": (pairs, True, 2)}


def images_pose_survey(device, rules, n_views=60, seed=0, out_dir=None):
    """Measurement only, not run by main: the device detector on frames
    of the rig's camera (tests/test_calib.py's K and D, 2704 x 1520)
    rendered in memory under each board-pose rule of ``rules`` (a dict
    of name -> (poses(rng, n) -> [(R, t)], paired, margin in squares));
    for a paired rule the board is posed in a chain pair's first camera
    and seen by both. A
    line a rule: frames found, frames whose corners miss IMAGES_CORNER_PX
    against the truth and their worst errors, and for an unpaired rule
    calibrate_fisheye_camera on the found frames (fx, fy against the
    truth). With ``out_dir``, each rule's worst frame is written there
    as a PNG at half resolution."""
    from scipy.spatial import cKDTree

    from acinoset_tpu_torch.calib import corners, intrinsics
    from acinoset_tpu_torch.ops import camera as cam_ops
    from acinoset_tpu_torch.utils import synthetic as syn

    K, D, res = syn.FISHEYE_K, syn.FISHEYE_D, syn.FISHEYE_RES
    rays = syn.fisheye_rays(K, D, res, device)
    obj = syn.create_board_object_pts((9, 6), 0.04)
    obj_t = torch.as_tensor(obj, dtype=torch.float64)
    r = syn._rot(syn.PAIR_RVEC)
    for name, (make_poses, paired, margin) in rules.items():
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=device).manual_seed(seed)
        poses = make_poses(rng, n_views)
        if paired:
            poses = poses + [(r @ R, r @ t + syn.PAIR_T) for R, t in poses]
        frames = [syn.render_board_frame(rays, R, t, gen, noise=IMAGES_NOISE, margin=margin)
                  .cpu().numpy() for R, t in poses]
        truth = [cam_ops.project_points_fisheye(obj_t, K, D, R, t).numpy() for R, t in poses]
        grids, found = corners.find_corners_batch(frames, (9, 6), device=device)
        errs = np.full((len(poses), 2), np.nan)
        for i in np.where(found)[0]:
            d, _ = cKDTree(truth[i]).query(grids[i].reshape(-1, 2))
            errs[i] = np.median(d), d.max()
        bad = found & ((errs[:, 0] >= IMAGES_CORNER_PX[0]) | (errs[:, 1] >= IMAGES_CORNER_PX[1]))
        both = ", in both cameras of a pair" if paired else ""
        text = (f"{name}{both}: found "
                f"{int(found.sum())}/{len(poses)}, over the corner bounds {int(bad.sum())}"
                f" (worst medians {np.sort(errs[bad, 0])[::-1][:5].round(2).tolist()} px, worst "
                f"max {errs[found, 1].max() if found.any() else np.nan:.2f} px)")
        if not paired and found.sum() >= 4:
            pts = grids[found].transpose(0, 2, 1, 3).reshape(int(found.sum()), -1, 2)
            with contextlib.redirect_stdout(io.StringIO()):
                cal = intrinsics.calibrate_fisheye_camera(obj, pts, res, device=device)
            text += (f"; calibrated on them: fx {100 * (cal.k[0, 0] / K[0, 0] - 1):+.3f}%, fy "
                     f"{100 * (cal.k[1, 1] / K[1, 1] - 1):+.3f}%, rms {float(cal.rms):.4f} px, "
                     f"{int(cal.used.sum())} frames used")
        if out_dir and found.any():
            worst = int(np.nanargmax(np.where(found, errs[:, 1], -1)))
            os.makedirs(out_dir, exist_ok=True)
            syn.write_png(os.path.join(out_dir, f"{name}_{worst}.png"), frames[worst][::2, ::2])
        _phase("survey", t0, text)


def phase_images(device):
    """Calibration from images on the card, the user's path: the rig's
    frames rendered at 2704 x 1520 and written as PNGs
    (render_calib_frames), then calib.app.extract_corners_from_images a
    camera folder (the device detector), calibrate_fisheye_intrinsics a
    camera, and ``python -m acinoset_tpu_torch.cli calib`` (pairwise
    extrinsics and the board SBA); s a stage. The calibrations run on
    every found frame (readings), then on points files without the
    frames whose corners miss tests/test_calib.py's rule against the
    truth: one such frame, the detector's inherited lattice fault, in a
    camera's intrinsics set can break its calibration (ROADMAP Queue 3).
    There fx and fy are gated, and the chain's poses and the board SBA's
    RMS are gated from the true intrinsics, as the calib phase gates them
    (from the calibrated intrinsics they are readings). Gates, the
    IMAGES_* constants: the share of frames that miss the rule, the
    device detector against the CPU port, the native engine against the
    device detector, fx and fy, the chain's poses (the calib phase's
    bounds), the board SBA's RMS, and undistort_image_fisheye against
    its CPU run. Readings not gated: s a frame for the PNG read, the
    device pass, the host lattice and the native engine, and the views
    the pairwise consensus kept. Every reading is printed before a
    failed gate raises."""
    import tempfile

    from acinoset_tpu_torch.calib import app, corners, native
    from acinoset_tpu_torch.ops import camera as cam_ops
    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.utils import png
    from acinoset_tpu_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    failed = []
    res = syn.FISHEYE_RES
    with tempfile.TemporaryDirectory() as root:
        intr, extr = os.path.join(root, "intrinsic_calib"), os.path.join(root, "extrinsic_calib")
        t1 = time.perf_counter()
        truth = render_calib_frames(device, root, np.random.default_rng(0))
        s_render = time.perf_counter() - t1
        _phase("images", t0, f"rendered and wrote {len(truth)} RGB frames of {res[0]} x {res[1]} "
               f"({CALIB_CAMS} cameras x {IMAGES_VIEWS} intrinsics views, {CALIB_CAMS - 1} pairs "
               f"x {IMAGES_PAIR_VIEWS} views in both cameras): {s_render:.3f} s")

        t1 = time.perf_counter()
        folders = []
        with contextlib.redirect_stdout(io.StringIO()):  # a line a frame
            for c in range(1, CALIB_CAMS + 1):
                for frames, points in ((os.path.join(intr, "frames", str(c)),
                                        os.path.join(intr, "points", f"points_{c}.json")),
                                       (os.path.join(extr, "frames", str(c)),
                                        os.path.join(extr, "points", f"points_cam{c}.json"))):
                    app.extract_corners_from_images(frames, points, (9, 6), 0.04, device=device)
                    folders.append((frames, points))
        s_extract = time.perf_counter() - t1
        found = [_corner_errors(p, f, truth) for f, p in folders]
        errs = np.concatenate([e for _, e in found])
        miss = (errs[:, 0] >= IMAGES_CORNER_PX[0]) | (errs[:, 1] >= IMAGES_CORNER_PX[1])
        off, kept = int(miss.sum()), errs[~miss]
        _phase("images", t0, f"extract_corners_from_images, {len(folders)} folders: "
               f"{s_extract:.3f} s, {s_extract / len(truth):.4f} s a frame; found {len(errs)}/"
               f"{len(truth)} frames; against the truth, median of the frames' medians "
               f"{np.median(errs[:, 0]):.4f} px; frames missing {IMAGES_CORNER_PX} px: {off} "
               f"(medians {errs[miss, 0].round(3).tolist()}, max {errs[miss, 1].round(2).tolist()} "
               f"px; share bound {IMAGES_LATTICE_SHARE}); the others' worst median "
               f"{kept[:, 0].max():.4f} px, worst max {kept[:, 1].max():.4f} px")
        if off > IMAGES_LATTICE_SHARE * len(errs):
            failed.append(f"corners: {off} of {len(errs)} frames miss {IMAGES_CORNER_PX} px")

        user = _calibrate_scene(device, root)
        _phase("images", t0, f"the user's path on every found frame (not gated: a frame with "
               f"the lattice fault in a camera's intrinsics set can break its calibration): "
               f"{_scene_text(user)}")
        # the same path on points files without the frames that miss the
        # rule (told by the truth): gated
        clean = os.path.join(root, "clean")
        for (frames, points), (names, e) in zip(folders, found):
            pts, _names, board, square, cam_res = data_io.load_points(points)
            bad = (e[:, 0] >= IMAGES_CORNER_PX[0]) | (e[:, 1] >= IMAGES_CORNER_PX[1])
            data_io.save_points(os.path.join(clean, os.path.relpath(points, root)), pts[~bad],
                                [n for n, b in zip(names, bad) if not b], board, square, cam_res)
        gated = _calibrate_scene(device, clean)
        _phase("images", t0, f"the same without the {off} frames off the truth (gated: fx, fy "
               f"within 1%): {_scene_text(gated)}")
        if max(gated["fx_err"]) >= 0.01:
            failed.append(f"fx/fy off by {100 * max(gated['fx_err']):.3f}%")
        # the chain and the board SBA gated as the calib phase gates them,
        # from the true intrinsics
        chain = _calibrate_scene(device, clean, true_intrinsics=True)
        _phase("images", t0, f"the same from the true intrinsics (gated: "
               f"{CALIB_ROT_DEG_PER_LINK} deg and {CALIB_T_M_PER_LINK} m a link, board SBA RMS "
               f"{IMAGES_SBA_RMS_PX} px): {_scene_text(chain)}")
        for c, (rot, tr) in enumerate(chain["pose"], start=1):
            if not (rot < CALIB_ROT_DEG_PER_LINK * c and tr < CALIB_T_M_PER_LINK * c):
                failed.append(f"chained camera {c + 1}: {rot} deg, {tr} m off")
        if not chain["sba"][1] < IMAGES_SBA_RMS_PX:
            failed.append(f"board SBA RMS {chain['sba'][1]} px")

        # 40 of one camera's extrinsic frames: the stages a frame, the
        # native engine, and the CPU port on a few frames
        paths = sorted(os.path.join(extr, "frames", "2", n) for n in os.listdir(
            os.path.join(extr, "frames", "2")))[:40]
        t1 = time.perf_counter()
        imgs = [png.read_png(p) for p in paths]
        s_read = (time.perf_counter() - t1) / len(imgs)
        s_device, s_host = _detector_split(device, imgs)
        t1 = time.perf_counter()
        g_nat, ok_nat = native.find_corners_batch(imgs, (9, 6))
        s_native = time.perf_counter() - t1
        g_dev, ok_dev = corners.find_corners_batch(imgs, (9, 6), device=device)
        right = [_within_rule(g, truth[p]) for p, g in zip(paths, g_nat)]
        both = ok_nat & ok_dev & np.array(right) & np.array(
            [_within_rule(g, truth[p]) for p, g in zip(paths, g_dev)])
        nat_med = np.median(np.linalg.norm(g_nat[both] - g_dev[both], axis=-1).reshape(
            int(both.sum()), -1), axis=1)
        _phase("images", t0, f"{len(imgs)} of camera 2's frames, s a frame: PNG read "
               f"{s_read:.4f}, "
               f"device pass {s_device / len(imgs):.4f} (CUDA events), host lattice "
               f"{s_host / len(imgs):.4f}, native engine {s_native / len(imgs):.4f} (its thread "
               f"pool, {os.cpu_count()} CPUs); native found {int(ok_nat.sum())} "
               f"({int((ok_nat & ~np.array(right)).sum())} off the truth), device "
               f"{int(ok_dev.sum())}; native against the device detector on the {int(both.sum())} "
               f"frames both get right: median px a frame, worst {nat_med.max():.4f} (bound "
               f"{IMAGES_NATIVE_MEDIAN_PX})")
        if not (nat_med < IMAGES_NATIVE_MEDIAN_PX).all():
            failed.append(f"native engine off the device detector by {nat_med.max()} px")

        few = imgs[:IMAGES_CPU_FRAMES]
        cands = [corners.find_corner_candidates(corners._gray(few, d)) for d in (device, "cpu")]
        (xy_d, sc_d), (xy_c, sc_c) = [(a.cpu().numpy(), b.cpu().numpy()) for a, b in cands]
        g_cpu, ok_cpu = corners.find_corners_batch(few, (9, 6), device="cpu")
        same = bool(np.array_equal(ok_cpu, ok_dev[:IMAGES_CPU_FRAMES]))
        d_cpu = np.abs(g_cpu[ok_cpu] - g_dev[:IMAGES_CPU_FRAMES][ok_cpu]).max() if same else np.inf
        _phase("images", t0, f"device against the CPU port on {IMAGES_CPU_FRAMES} frames: "
               f"candidates identical {np.array_equal(xy_d, xy_c)}, scores' largest difference "
               f"{np.abs(sc_d - sc_c).max():.3e}; found the same {same}; corners' largest "
               f"difference {d_cpu:.3e} px (bound {IMAGES_CPU_PX})")
        if not (np.array_equal(xy_d, xy_c) and d_cpu < IMAGES_CPU_PX):
            failed.append("the device detector differs from the CPU port")

        k, d, _res = data_io.load_camera(os.path.join(intr, "camera_2.json"))
        _sync(device)
        t1 = time.perf_counter()
        und = cam_ops.undistort_image_fisheye(imgs[0], k, d, device=device)
        _sync(device)
        s_und = time.perf_counter() - t1
        und_cpu = cam_ops.undistort_image_fisheye(imgs[0], k, d, device="cpu")
        und_err = float((und.cpu() - und_cpu).abs().max())
        _phase("images", t0, f"undistort_image_fisheye ({res[0]} x {res[1]} RGB, {und.dtype}): "
               f"{s_und:.4f} s on the card (first call); against the CPU {und_err:.3e} (bound "
               f"{IMAGES_UNDISTORT_TOL:.4f})")
        if not und_err <= IMAGES_UNDISTORT_TOL:
            failed.append(f"undistort_image_fisheye off its CPU run by {und_err}")
    if failed:
        raise AssertionError("images: " + "; ".join(failed))


#: the video phase: one camera of the rig, at its size and rate
VIDEO_RES = (2704, 1520)
VIDEO_FPS = 90.0
VIDEO_N = 200
#: the first frames, encoded and decoded on the CPU too, held byte for byte
VIDEO_CPU_N = 12
#: the frames video_profile encodes, then decodes (two GOPs)
VIDEO_PROFILE_N = 24
#: the frames get_frames seeks to, scattered, the last one past the end
VIDEO_SEEKS = (150, 7, 199, 12, 11, 100, 0, 57, VIDEO_N)
#: the least PSNR (dB) of the decoded frames against their sources: the
#: writer's quantiser 3 gives ~35 dB on this footage (a gross fault, a
#: drifting reference or a wrong colour matrix, gives far less)
VIDEO_PSNR_DB = 30.0
#: the camera's temporal noise (levels, standard deviation) of the second
#: and third footage settings, each encoded and decoded at full size: the
#: first setting's background is frozen, so its P-VOPs code little more
#: than the moving patch and the markers
VIDEO_SENSOR_NOISE = (2.0, 4.0)
#: the most the video work may take, s: phase_video, the files phase's six
#: cam*.mp4 and cli all's dlc stage
VIDEO_BUDGET_S = 120.0


def _psnr(a, b):
    mse = float(((a.float() - b.float()) ** 2).mean())
    return 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")


def _codec_round_trip(frames, path, device):
    """Encode frames on the card into path, then decode it frame by
    frame: the seconds and mpeg4.COUNTERS each way, MB, the decoded
    frames, how many equal the encoder's reconstruction, and each one's
    PSNR against its source."""
    from acinoset_tpu_torch.utils import mpeg4

    for k in mpeg4.COUNTERS:
        mpeg4.COUNTERS[k] = 0
    recon = []
    _sync(device)
    t1 = time.perf_counter()
    with mpeg4.Writer(path, VIDEO_RES, VIDEO_FPS, device) as writer:
        for f in frames:
            writer.write(f)
            recon.append(tuple(p.clone() for p in writer.planes))
    _sync(device)
    s_enc = time.perf_counter() - t1
    enc = dict(mpeg4.COUNTERS)
    recon = [mpeg4.yuv420_to_bgr(*p, VIDEO_RES) for p in recon]
    for k in mpeg4.COUNTERS:
        mpeg4.COUNTERS[k] = 0
    t1 = time.perf_counter()
    with mpeg4.Reader(path, device) as reader:
        info = (reader.n_frames, reader.size, reader.fps)
        decoded = [reader.read_tensor(n).clone() for n in range(reader.n_frames)]
    _sync(device)
    s_dec = time.perf_counter() - t1
    return dict(s_enc=s_enc, enc=enc, s_dec=s_dec, dec=dict(mpeg4.COUNTERS), info=info,
                mb=os.path.getsize(path) / 1e6, decoded=decoded,
                same=sum(bool(torch.equal(a, b)) for a, b in zip(decoded, recon)),
                psnr=[_psnr(a, b) for a, b in zip(decoded, frames)])


def _round_trip_gates(rt, what, failed):
    """phase_video's gates on one _codec_round_trip, and its line."""
    if rt["info"] != (VIDEO_N, VIDEO_RES, VIDEO_FPS):
        failed.append(f"{what}: the video reads back as {rt['info']}")
    if rt["same"] != VIDEO_N:
        failed.append(f"{what}: {VIDEO_N - rt['same']} decoded frames differ from the "
                      "encoder's reconstruction")
    psnr, enc, dec, mb = rt["psnr"], rt["enc"], rt["dec"], rt["mb"]
    if not min(psnr) >= VIDEO_PSNR_DB:
        failed.append(f"{what}: PSNR {min(psnr)} dB against the source (bound {VIDEO_PSNR_DB})")
    s_enc, s_dec = rt["s_enc"], rt["s_dec"]
    return (f"{what}: encode {s_enc:.3f} s, {VIDEO_N / s_enc:.2f} frames/s (host bitstream "
            f"{enc['host_s']:.3f} s, {100 * enc['host_s'] / s_enc:.1f}%; copied to the card "
            f"{enc['to_device_bytes'] / 1e6:.1f} MB, back {enc['to_host_bytes'] / 1e6:.1f} MB); "
            f"decode {s_dec:.3f} s, {VIDEO_N / s_dec:.2f} frames/s (host bitstream "
            f"{dec['host_s']:.3f} s, {100 * dec['host_s'] / s_dec:.1f}%; copied to the card "
            f"{dec['to_device_bytes'] / 1e6:.1f} MB); {mb:.3f} MB, {mb / VIDEO_N * 1e3:.1f} kB a "
            f"frame; decoded equal to the reconstruction {rt['same']}/{VIDEO_N}; PSNR against the "
            f"source mean {np.mean(psnr):.3f} dB, min {min(psnr):.3f} dB (bound {VIDEO_PSNR_DB})")


def phase_video(device):
    """The port's mp4v codec (utils/mpeg4.py, utils/csrc/mpeg4_vlc.cpp) at
    the rig's width: one camera's footage (utils.synthetic.scene_frames:
    a textured static scene, a patch moving 1.5 and 0.5 pixels a frame,
    the run's projected markers drawn), VIDEO_N frames of 2704 x 1520 at
    90 fps, encoded on the card, then decoded frame by frame (each frame
    equal to the encoder's reconstruction, PSNR against its source),
    seeked (get_frames at VIDEO_SEEKS, each frame equal to the sequential
    decode's, the index past the end skipped), and animate_reconstruction
    of the run's 200-frame result (640 x 480 at 15 fps, read back). The
    first VIDEO_CPU_N frames are encoded on the card and on the CPU (the
    same bytes) and that file decoded on both (the same frames). Then the
    same footage with each VIDEO_SENSOR_NOISE, encoded and decoded under
    the same gates. Readings: frames/s each way with the host's share (the
    C++ bitstream calls) and the bytes copied, MB a video, a 12.3 MB
    frame's copy each way, and whether the card's machine has NVDEC
    (ctypes.util.find_library). Returns the phase's seconds."""
    import ctypes.util
    import tempfile

    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.pipeline.plots import CHEETAH_LINKS, animate_reconstruction
    from acinoset_tpu_torch.utils import mpeg4
    from acinoset_tpu_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    failed = []
    W, H = VIDEO_RES
    _phase("video", t0, f"NVDEC library (ctypes.util.find_library('nvcuvid')): "
           f"{ctypes.util.find_library('nvcuvid')}")
    frame_bytes = W * H * 3
    host_copy_ms = back_copy_ms = float("nan")
    if device.type == "cuda":
        host = torch.empty((H, W, 3), dtype=torch.uint8)
        host_copy_ms = _cuda_ms(lambda: host.to(device), 5)
        dev_frame = host.to(device)
        back_copy_ms = _cuda_ms(lambda: dev_frame.cpu(), 5)
    cams = syn.ring_cameras(n_cams=1, res=VIDEO_RES)
    px, _lik, pts3d = syn.render_measurements(syn.cheetah_gallop(N=VIDEO_N, fps=VIDEO_FPS), cams,
                                              noise_px=0.0, outlier_frac=0.0, bad_lik_frac=0.0)
    t1 = time.perf_counter()
    frames = list(syn.scene_frames(VIDEO_RES, VIDEO_N, px[0], device=device))
    _sync(device)
    s_scene = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "cam1.mp4")
        mpeg4.Writer(path, VIDEO_RES, VIDEO_FPS, device).close()  # builds the library
        rt = _codec_round_trip(frames, path, device)
        decoded = rt.pop("decoded")
        _phase("video", t0, f"{VIDEO_N} frames of {W} x {H} at {VIDEO_FPS} fps ({s_scene:.3f} s "
               f"to draw them on the card), " + _round_trip_gates(rt, "frozen background",
                                                                  failed)
               + f"; a {frame_bytes / 1e6:.1f} MB frame's copy to the card {host_copy_ms:.3f} "
               f"ms, back {back_copy_ms:.3f} ms (pageable)")

        t1 = time.perf_counter()
        got = video.get_frames(path, VIDEO_SEEKS, device=device)
        s_seek = time.perf_counter() - t1
        seek_ok = ([i for i, _f in got] == [i for i in VIDEO_SEEKS if i < VIDEO_N]
                   and all(np.array_equal(f, decoded[i].cpu().numpy()) for i, f in got))
        if not seek_ok:
            failed.append(f"get_frames at {VIDEO_SEEKS} gives {[i for i, _f in got]} or other "
                          "frames than the sequential decode")
        del decoded

        cut = [os.path.join(root, f"cut_{d}.mp4") for d in ("card", "cpu")]
        for p, dev in zip(cut, (device, torch.device("cpu"))):
            with mpeg4.Writer(p, VIDEO_RES, VIDEO_FPS, dev) as writer:
                for f in frames[:VIDEO_CPU_N]:
                    writer.write(f.to(dev))
        bytes_same = open(cut[0], "rb").read() == open(cut[1], "rb").read()
        with mpeg4.Reader(cut[0], device) as a, mpeg4.Reader(cut[0], "cpu") as b:
            frames_same = all(np.array_equal(a.read(n), b.read(n)) for n in range(VIDEO_CPU_N))
        if not (bytes_same and frames_same):
            failed.append(f"card against CPU on {VIDEO_CPU_N} frames: bytes equal {bytes_same}, "
                          f"frames equal {frames_same}")

        result = os.path.join(root, "fte.pickle")
        data_io.save_pickle(result, dict(positions=pts3d, markers=cheetah.get_markers()))
        anim = os.path.join(root, "anim.mp4")
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            animate_reconstruction(result, anim, skel_links=CHEETAH_LINKS, max_frames=VIDEO_N,
                                   device=device)
        s_anim = time.perf_counter() - t1
        with mpeg4.Reader(anim, device) as r:
            anim_info = (r.n_frames, r.size, r.fps, r.read(r.n_frames - 1) is not None)
        if anim_info != (VIDEO_N, (640, 480), 15.0, True):
            failed.append(f"animate_reconstruction's video reads back as {anim_info}")
        _phase("video", t0, f"get_frames at {list(VIDEO_SEEKS)}: {s_seek:.3f} s, frames equal to "
               f"the sequential decode's {seek_ok}; card against CPU on {VIDEO_CPU_N} frames: "
               f"bytes equal {bytes_same}, decoded frames equal {frames_same}; "
               f"animate_reconstruction of a {VIDEO_N}-frame result: {s_anim:.3f} s, "
               f"{VIDEO_N / s_anim:.2f} frames/s, reads back as {anim_info[0]} frames of "
               f"{anim_info[1][0]} x {anim_info[1][1]} at {anim_info[2]} fps, "
               f"{os.path.getsize(anim) / 1e6:.3f} MB")

        for sigma in VIDEO_SENSOR_NOISE:
            frames = list(syn.scene_frames(VIDEO_RES, VIDEO_N, px[0], device=device,
                                           sensor_noise=sigma))
            rt = _codec_round_trip(frames, os.path.join(root, f"noise_{sigma}.mp4"), device)
            del rt["decoded"]
            _phase("video", t0, _round_trip_gates(rt, f"temporal noise of {sigma} levels",
                                                  failed))
    del frames
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("video: " + "; ".join(failed))
    return time.perf_counter() - t0


def video_profile(device=None, n=VIDEO_PROFILE_N):
    """Measurement only (phase_video does not run it): where a frame's
    time goes in the codec at the rig's width, under torch.profiler:
    the first n frames of phase_video's footage encoded, then decoded;
    a frame's wall ms, device busy ms and share, device ops, and the
    C++ bitstream's ms (on the codec's worker thread, its GIL waits
    included). On the GPU, ~40 s:
    python3 -c "import chip_smoke as c; c.video_profile()"."""
    import tempfile

    from acinoset_tpu_torch.utils import mpeg4
    from acinoset_tpu_torch.utils import synthetic as syn

    device = torch.device(device or "cuda")
    phase_device()
    t0 = time.perf_counter()
    cams = syn.ring_cameras(n_cams=1, res=VIDEO_RES)
    px = syn.render_measurements(syn.cheetah_gallop(N=n, fps=VIDEO_FPS), cams, noise_px=0.0,
                                 outlier_frac=0.0, bad_lik_frac=0.0)[0]
    frames = list(syn.scene_frames(VIDEO_RES, n, px[0], device=device))
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "profiled.mp4")
        mpeg4.Writer(path, VIDEO_RES, VIDEO_FPS, device).close()  # builds the library

        def encode():
            with mpeg4.Writer(path, VIDEO_RES, VIDEO_FPS, device) as w:
                for f in frames:
                    w.write(f)

        def decode():
            with mpeg4.Reader(path, device) as r:
                for i in range(n):
                    r.read_tensor(i)

        for name, fn in (("encode", encode), ("decode", decode)):
            fn()  # warm
            mpeg4.COUNTERS["host_s"] = 0.0
            n_ops, busy, wall = _profiled(fn, device)
            _phase("video profile", t0, f"{name} {n} frames of {VIDEO_RES[0]} x {VIDEO_RES[1]}: "
                   f"{wall / n:.3f} ms a frame, device busy {busy / n:.3f} ms "
                   f"({100 * busy / wall:.1f}%), {n_ops / n:.0f} device ops a frame, C++ "
                   f"bitstream {mpeg4.COUNTERS['host_s'] * 1e3 / n:.3f} ms a frame")


#: the nvdec phase: GoPro-shaped streams of the port's writers (utils.h26x):
#: H.264 at the rig's size, rate and length with B frames, BT.709 full range
NVDEC_RES = (2704, 1520)
NVDEC_FPS = 90.0
NVDEC_N = 200
NVDEC_GOP = 12
#: a cropped H.264 stream (1080 lines of 1088 coded) in each of the four
#: (matrix, range) pairs the conversion takes
NVDEC_CROP_RES = (1920, 1080)
NVDEC_CROP_N = 14
NVDEC_CROP_CASES = ((1, True), (1, False), (6, True), (6, False))
#: HEVC at the rig's size
NVDEC_HEVC_N = 48
#: frames of each smaller stream held kernel against plain (the rig's
#: H.264 is held on every frame)
NVDEC_SUBSET = 6
#: the surface pitch NVDEC gives a 2704-wide frame (a multiple of 512), so
#: that the kernel reads the reconstruction as it reads a mapped surface
NVDEC_PITCH_ALIGN = 512
#: launches a timing of the kernel
NVDEC_REPS = 200
#: the h264 phase: streams of the random-syntax writer (utils.h26x.RandomH264)
#: at the rig's widths, CAVLC and CABAC with B frames: (label, size, frames,
#: the writer's options)
H264_STREAMS = (
    ("cavlc 2704x1520", (2704, 1520), 8, dict(
        seed=41, b_frames=2, refs=3, transform8x8=True, weighted="explicit", direct="both",
        slices=3, deblock=(0, 1, 2), deblock_offsets=True, qp=(22, 36))),
    ("cabac 2704x1520", (2704, 1520), 8, dict(
        seed=42, cabac=True, b_frames=2, refs=4, transform8x8=True, scaling=True,
        weighted="implicit", direct="temporal", slices=2, deblock=(0, 2), mmco=True,
        long_term=True, qp=(20, 34))),
    ("cavlc 1920x1080", (1920, 1080), 8, dict(
        seed=43, b_frames=1, poc_type=1, matrix=6, full_range=False, qp=(24, 38))),
    ("cabac 1920x1080", (1920, 1080), 8, dict(
        seed=44, cabac=True, b_frames=2, b_refs=True, mmco5=True, constrained_intra=True,
        transform8x8=True, matrix=1, full_range=False, qp=(18, 32))),
)
#: each stream's MP4 SHA-256 and its frames' SHA-256 (BGR, H x W x 3) as
#: cv2 reads them on the CPU (tests/test_torch_h264_decode.py holds cv2 to
#: these digests)
H264_DIGESTS = {
    "cavlc 2704x1520": ("2eb9ebec29725ed3d2044f8d37220ba589416cb6415c7ab2ef3ad5df43f07b9f", (
        "521670c437bbfdc0c680110334b81e2008c97b3b5f7aaea545ac8d36c31416ab",
        "b21facc6a08efe8899e8e0cc97ee8252b54ccf123256ae53bebdd70810bbacd4",
        "8bbb9d85769ab2accbec69cc2d3bf00e3e7769d1926ea2273fc174d05914a0d7",
        "acd5c8364762089d45d5244f78dc602aaaa68db2d3cc4f6ef39adb3f847cc9bc",
        "d6ffc5900a811f830cdec0f2a03caf369f048a19535ce038dc2f744c78d4276d",
        "464c608598d4549f1b969e5308f0cbd0c0ce6d512a4d6eac692a485a14784d6e",
        "69ee112ed7a3c4d9b8509733efbb3377951f3ee757f21a08ba22b634196c2fe1",
        "a9ecaf468982c9e77fc44fdefc339d5ad0bcdb7a37953f057c85930976848ce9",
    )),
    "cabac 2704x1520": ("3330f7db1475ee9bd04c818223537ea4399a0c4c9a8d1300f445622369f67b1f", (
        "36204005de66d72142e1f446a9cacc0e551168c73236f28144f1bc61c289b40e",
        "562930f0986f7ca2a389801dfdfd57175450422869bc10dfb3f437f890ac4b30",
        "7da415fb3e49eb844436922dcca5c5c62ece21d2d2f3eb060ac3830d06c5e5db",
        "0ebc02fa9a33a441793710420765d682eb564e6677e6dd8ce6ad76be2e6c99e4",
        "78316dca37da094b3d2039202168ac0a1dc465331ff5f08a062f166433fbcf29",
        "fdf901dd37fe04798aff6f877254dd74f99fee22f4d4939fc15928257ed4625a",
        "aeb705519acf49da96767258cbc855603da9bba8a607b5c20df20d863bdcc812",
        "8c281b24201bf71aabe5888157b8e523cd006b9f8cf444e583e67a3d1912c758",
    )),
    "cavlc 1920x1080": ("bbe0baa24deef272a1a1f68f34b7f177edb362191c7eb5ee7cb7911f87c86ab3", (
        "180388048f7ab265b9a56517394541c9ac23a1f3b1d98ee6f65f831df0e19502",
        "1fcc7a26b3094e01e2f839e322c14bb294353ac74b98092a4b26c192357519b4",
        "68a45c5b3997a45c131b43a16acea5dd77187be85f59eb1544924047977263b8",
        "98c25c98ba35b4592bf2f19ca75a36f7742888b008efc6a5bb8372459fefb35e",
        "81f100e9a1ab049400c7194ac64cc823d15b3e6669a47cf514c066e86d762491",
        "cab473c3d8ff63c3994dea252de621dbc97e89d29fde467a5e57cadf6131aff3",
        "c486364311faeb486ef33e1b5d36d118a49ab91a787f66309aa44bd8b4c52c56",
        "4fa1f2b3465b505f7eec206b5aa3d07c27de2559bc3b6eb705ab5748c9cc3724",
    )),
    "cabac 1920x1080": ("e9b7fcfabd11dc3ece457d7bb0e9fe4f901b179441d0d56b1863c7f29beaa756", (
        "4a0f3a128c5b218142f0bb55bc923a1413713333bcfcee0ab77d40a26aacc906",
        "bef6a45c2eb6aeefe66f714dc983672d41742d0fbc91b23ac43a73c67129a278",
        "5653d7b54a7ec97bc88a599e980c4a261db9dbd5ff43636629ddf19cefdd17b5",
        "43b6d3840b5c485cc8775a895f10949abbd50428521146ad838915ff3c1fe51e",
        "bcd001ced5098c9440564c8551c3354f74eef3cf674878ab3d1197d5a9f8715d",
        "9053adb6c326762e2653e788fbc2938c50a24a85c038eb6e9e2fc329366b1f30",
        "93204dfef7d3d9a7520a3d27a5e216260a6d0de2877b8095b1faee0f8b4ec4fa",
        "f79478ec6bd65708cfeac16102d4d3276757b972146b2f873e1e2c2438a8ca04",
    )),
}

#: the hevc phase: streams of the random-syntax writer (utils.h26x.RandomHEVC)
#: at the rig's widths, with B pictures, SAO, deblocking, and tiles or
#: wavefronts (WPP): (label, size, frames, the writer's options)
HEVC_STREAMS = (
    ("tiles 2704x1520", (2704, 1520), 8, dict(
        seed=51, ctb=64, b_frames=3, sao=True, tiles=(4, 3), slices=4, deblock="override",
        deblock_offsets=True, cu_qp_delta=True, amp=True, transform_skip=True, sign_hiding=True,
        qp=(24, 38))),
    ("wpp 2704x1520", (2704, 1520), 8, dict(
        seed=52, ctb=32, wpp=True, slices=3, dependent_slices=True, b_frames=2, sao=True,
        weighted=True, long_term=True, scaling="sps", qp=(22, 36))),
    ("tiles 1920x1080", (1920, 1080), 8, dict(
        seed=53, ctb=32, tiles=(3, 2), uniform_tiles=False, open_gop=True, gop=4, b_frames=3,
        sao=True, pcm=True, bypass=True, matrix=6, full_range=False, qp=(24, 40))),
    ("wpp 1920x1080", (1920, 1080), 8, dict(
        seed=54, ctb=16, wpp=True, b_frames=1, sao=True, constrained_intra=True, scaling="pps",
        list_mod=True, parallel_merge=3, matrix=1, full_range=False, qp=(20, 34))),
    # Main 10, as GoPros record with 10-bit colour on: QPs below 0, SAO
    # offsets past 7, PCM of up to 10 bits; BT.709, and BT.2020 cropped
    # from 1088 rows
    ("main10 tiles 2704x1520", (2704, 1520), 8, dict(
        seed=55, bit_depth=10, ctb=64, tiles=(4, 3), slices=2, b_frames=3, sao=True,
        weighted=True, pcm=True, cu_qp_delta=True, matrix=1, full_range=False, qp=(-4, 32))),
    ("main10 wpp 1920x1080", (1920, 1080), 8, dict(
        seed=56, bit_depth=10, ctb=32, min_cb=16, wpp=True, slices=2, dependent_slices=True,
        b_frames=2, sao=True, deblock_offsets=True, transform_skip=True, matrix=9,
        full_range=False, qp=(-12, 26), chroma_qp_offsets=(-2, 3))),
)
#: each stream's MP4 SHA-256 and its frames' SHA-256 (BGR, H x W x 3) as
#: cv2 reads them on the CPU (tests/test_torch_hevc_decode.py holds cv2 to
#: these digests)
HEVC_DIGESTS = {
    "tiles 2704x1520": ("05716ccf7122a4553c1c1043d1f49ff15d6478966083604ddeb7944f80076ade", (
        "b2f7c81925e323f6d6a17ba73ce5f7f3441a119c6de65c0619d2e4ac17a750cd",
        "9cbfddca69c1d72d277a9e817365155fc42e49c99195ce8ea4a4f9523707da07",
        "3b4f335afdbae5a9193fc42bdc5d03f5b3c8bd83f7a0f9f1222468cc5907ba5c",
        "ce9474a1401776a12be9356fe006cf69cbec8d495bd6290db84252a2da9be537",
        "501d89fde0c99f427b2db58c63d95258c9546898821ded68093fdef5a00a8d99",
        "e708088248a9c25689b6a6227f62897a1ecac1bf2d091816dbd2994251f5187c",
        "fda4851bad12762f4e33f26c796c9a63f46423778ade91843e67dc7fcad6e0bb",
        "f5336a520e205d412287561ec1fb40c2f7d983bb43aa052c4b3ba91eae88887a",
    )),
    "wpp 2704x1520": ("12408ed60c634de523bec30c1e15d32ce084861f1f520de092c1d7ca6e9822b5", (
        "21f1d5ed4d3001aa1542aa69ca5c0f38fc16302036c1f99121a4fa9cd923411a",
        "4452b43b3701b9e6b7d98cfde9aa4bc1f04afe3683851a35e92fbeb2937967df",
        "51f3e79f2ba1bebbff39b8cc0e7837c265d6e93f5505e2fcdc48575711b304b6",
        "4acff7307a29abcd28a3cab7e97a1c96994e959377321d6e4ce620ba71e7ff1d",
        "1e73cd3bb2cbf0cbb6ce355841fd296bee0d52c9d955a14486653bcc43e7d489",
        "b599b985dd74ef6a6db54379fa00b83cd0268497e213a2d300deab6b4439e518",
        "62d312047aa3b67c797809b3b902dc0831e66ed0d57e4e91970ee7efb230d2c0",
        "b1939ecc9261543ac7253711ae3a464bf79b3e5207248b4fa4f04a48c74eea66",
    )),
    "tiles 1920x1080": ("3245a4125bf0c063ac65e70dab8ab78d8723b682ad17983e587f7c6f732e28b7", (
        "86f2b4902ffe7defd80f9075ba34707f535b4849ef7f03598cd01e3cfb6438b5",
        "947baa4410649bf8709395138b159e29846ed1d0fce493e79212786eef08b070",
        "a2647263b8aa29ec6d3ec8dcffdc10b65144629e1037f0860b51a9aaebab8238",
        "e1a79124fc2286fc452ff3632350b22582e3965968e147451e22bc7b828c7edd",
        "12ea554ccc84fef2c64d7e9d4ff4d89b62d42530edb4008b59028d8402a52b09",
        "80de97fcc7af8a3ea2765f15986ca9a55c39e2feffe08f799f937cce7c7c5504",
        "d6854e018718b5956e6959a928ba54e4f8140f4d15e919d1a8e32b146f24b752",
        "2801fe6768920ead2157edb6478599395240a8887f340011562b0b0292a2f164",
    )),
    "wpp 1920x1080": ("abaece8043f5621de5a8ad6e50552cf25bd2c9eb66ebd8a12d1d65f9f2586a29", (
        "a1e9f940de09f39a1c832f6c36dee7fd5ba0e370c8209d025245c9adf81d19ef",
        "5584939c145ddb4ca23caf91e0754132654074d3f0c819817fbd5e53b76351c1",
        "b69c777cb55012984b16769d0e86c3b751cb5499f82b85350218cd92429495b8",
        "c6ca8d93baffd39408dc8ac024611d89f937fb6db3db1a12ce94f65d95688951",
        "8743606f5921d9d575ce3454b467fd4c4d01ac6ccedd4f9a05f1e27282a95dc7",
        "38cdbd0f64e4e18f3398c969abd4d634dc5fa3f56be84d298d9be1d233f1ac4f",
        "8d9bc0ab3a7187f442dceb86e1839244c6adb6754c4304adafbf3fb70e444069",
        "a3cdaf1a64bb38eee91100536d7c3243f952eb2edb07d47ea7c837abbdda71b9",
    )),
    "main10 tiles 2704x1520": ("d41cd11bcdecaa37166ac50eb2c2a04f87dcd7e87bc85a599e8a374acad4bf9b", (
        "b78e8fdfdd1d3e0b3cb27da582aabc46f04722e5827faef07fb2f472bd7e10a9",
        "8a3a7a36e6b4f464c9e97feb40e929882cd3eafc993027dc1ff02bf89056b25d",
        "f9650fa2cade00558d27aa839b34a30e820c13cba3b0f37ccc01db2ff78f341c",
        "77a2a44747a1ead4ab80f01f7964e23e46f7460f9ce31bb445aa703d29e3eb66",
        "8cc1f25ec7e104ce1ce699f36edd34f6301ceef755619b43f6cd6c670031c8e2",
        "13bcd043b837497137ab84a80183bdf781c518e32c0145489c86033df0d4082d",
        "d9434b1636b1fc91c6540e1c8d10664459984c59b43565e73f71e3246e2c7947",
        "9b3caa3c341b304b6b19128aa4d4a6d0d59917fbb2b096d80a2ef279049c6f14",
    )),
    "main10 wpp 1920x1080": ("b9cf5a98bd7c73d3a27783b6690088eecdcc095ef045b3fc0e59248e8e37140d", (
        "7ee27165c876fec025e21e0beeb65622ce7d1616be7e59d059051c4b49663eeb",
        "e0c5519f065251d7b7726be04db3b601dea6f407117a0469307d92ede499e589",
        "13055af1518fe049066e245da5025f41b55032b789a325a7cc159f663baaff58",
        "bf0a486a5b1444a90f0a1224cbc44b4b1da1ed88a3e77185e304c8e50571c2a0",
        "d5a600075eb0d8f81ed46a2c4888db5d400da75b59c71a7065fc40a50b03b946",
        "9079ed0a9054f80fe17189c0109184962cbacf6472f21872145088725674c954",
        "aa2ad735127d1dc8d78935931eccf5f422fb51ab2880c867e29e29d8b9d4e62e",
        "14cff468a75960e728076debd1128810790f480d4c17f6b28809f94bef2ace8c",
    )),
}

def _nvdec_streams():
    """(label, stream, sample entry) of the phase's streams."""
    from acinoset_tpu_torch.utils import h26x

    out = [(f"H.264 {NVDEC_RES[0]} x {NVDEC_RES[1]} BT.709 full", h26x.H264Stream(
        NVDEC_RES, NVDEC_N, gop=NVDEC_GOP, seed=1, matrix=h26x.BT709, full_range=True), "avc1")]
    for i, (matrix, full) in enumerate(NVDEC_CROP_CASES):
        out.append((f"H.264 {NVDEC_CROP_RES[0]} x {NVDEC_CROP_RES[1]} matrix {matrix} "
                    f"{'full' if full else 'limited'}", h26x.H264Stream(
                        NVDEC_CROP_RES, NVDEC_CROP_N, gop=NVDEC_GOP, seed=2 + i, matrix=matrix,
                        full_range=full), "avc3" if i % 2 else "avc1"))
    out.append((f"HEVC {NVDEC_RES[0]} x {NVDEC_RES[1]}", h26x.HevcStream(
        NVDEC_RES, NVDEC_HEVC_N, gop=NVDEC_GOP, seed=7, matrix=h26x.BT709, full_range=True),
        "hvc1"))
    return out


def phase_nvdec(device):
    """The reading of GoPro footage (utils/nvdec.py, utils/csrc/nvdec.cu,
    utils/h26x.py, utils/mp4.py): the streams of _nvdec_streams written
    into MP4 by the port's writers, each read back by the container
    (frame count, presentation order through ctts/elst, parameter sets)
    and by NVDEC's parser on the card (coded size, display area, chroma
    format, bit depth, progressive, VUI matrix and range, as written); the
    colour kernel (nv12_to_bgr) against its plain version on each
    reconstructed frame as a pitched NV12 surface (every frame of the
    rig's H.264, NVDEC_SUBSET of the others), and its device time against
    its bound. Every stream is decoded by the port's software decoder,
    H.264's or HEVC's (_software_decode: every frame equal to the
    reconstruction with one launch a frame; for the rig's streams seeks and
    the decode rate). Then NVDEC's
    decode gates: every frame decoded equal to the
    writer's reconstruction in cv2's colours with one launch a frame,
    get_frames at VIDEO_SEEKS equal to the sequential decode, frames/s
    with the host's share, and create_labeled_video's bytes equal to
    mpeg4.Writer fed draw_labels of the reconstruction. They are skipped
    only where cuvidGetDecoderCaps fails and the environment visibly
    withholds the video engine (nvdec.withheld); then every reading
    function must raise UnsupportedVideo naming NVDEC and that reason (no
    fallback). A refusal on any other ground fails the phase. Returns the
    kernel's record (for main's kernels line)."""
    import tempfile

    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.utils import h26x, mp4, mpeg4, nvdec

    t0 = time.perf_counter()
    failed = []
    caps = {c: nvdec.caps(device, c) for c in ("avc1", "hvc1")}
    usable = all(why is None and cap["supported"] for cap, why in caps.values())
    env = nvdec.withheld()
    # the decode gates are skipped only where the machine visibly keeps
    # the video engine from this process; any other refusal is a fault
    skip = not usable and env is not None and any(why for _cap, why in caps.values())
    if not usable and not skip:
        failed.append(f"NVDEC refused where the environment does not withhold the video engine: "
                      f"{caps}")
    _phase("nvdec", t0, f"Video Codec SDK headers at build: {nvdec.sdk_headers()}; NVDEC "
           f"capabilities: " + "; ".join(f"{c}: {cap if why is None else why}"
                                          for c, (cap, why) in caps.items())
           + f"; the environment: {env or 'grants the video engine'}; decoding on the card "
           + ("runs" if usable else "is refused (no fallback); the decode gates are "
              + ("skipped" if skip else "failed")))
    plain_ms = kernel_ms = float("nan")
    worst = path_launches = 0
    with tempfile.TemporaryDirectory() as root:
        for label, stream, entry in _nvdec_streams():
            W, H = stream.size
            path = os.path.join(root, f"{entry}_{W}x{H}_{stream.seed}.mp4")
            t1 = time.perf_counter()
            h26x.write_mp4(path, stream, NVDEC_FPS, codec=entry)
            s_write = time.perf_counter() - t1
            tr = mp4.read_video_track(path)
            order_ok = (tr.n_frames == stream.n
                        and [stream.decode[i] for i in tr.order] == list(range(stream.n))
                        and list(tr.param_sets) == stream.param_sets
                        and mp4.video_info(path) == ((W, H), NVDEC_FPS, stream.n))
            if not order_ok:
                failed.append(f"{label}: the container reads {tr.n_frames} frames in another "
                              "order, or other parameter sets")
            fmt = nvdec.stream_format(path, device)
            want = dict(chroma_format=1, luma_minus8=0, progressive=1, left=0, top=0, right=W,
                        bottom=H, coded_width=stream.coded[0], coded_height=stream.coded[1],
                        matrix=stream.matrix, full_range=int(stream.full_range))
            fmt_ok = bool(fmt["have"]) and all(fmt[k] == v for k, v in want.items())
            if not fmt_ok:
                failed.append(f"{label}: NVDEC's parser reads {fmt}, the writer wrote {want}")
            coefs = nvdec.colour_coefs(stream.matrix, stream.full_range)
            frames = range(stream.n) if stream.n == NVDEC_N else range(min(NVDEC_SUBSET,
                                                                             stream.n))
            same = 0
            for k in frames:
                surf = stream.surface(k, device, NVDEC_PITCH_ALIGN)
                got = nvdec.nv12_to_bgr(surf, stream.coded[1], (W, H), coefs)
                plain = nvdec.nv12_to_bgr_plain(surf, stream.coded[1], (W, H), coefs)
                worst = max(worst, int((got.int() - plain.int()).abs().max()))
                same += bool(torch.equal(got, plain))
            if same != len(frames):
                failed.append(f"{label}: the kernel differs from its plain version on "
                              f"{len(frames) - same} of {len(frames)} frames")
            text = (f"{label}, {stream.n} frames ({''.join(stream.types[:NVDEC_GOP])}...), "
                    f"{entry}: written in {s_write:.3f} s, {os.path.getsize(path) / 1e6:.3f} MB; "
                    f"container order and parameter sets {order_ok}; NVDEC's parser reads coded "
                    f"{fmt['coded_width']} x {fmt['coded_height']}, display {fmt['right']} x "
                    f"{fmt['bottom']}, matrix {fmt['matrix']}, full range {fmt['full_range']}, "
                    f"as written {fmt_ok}; kernel equal to its plain version on {same}/"
                    f"{len(frames)} frames")
            more, n = _software_decode(device, stream, path, coefs, failed, label)
            text += "; " + more
            path_launches += n
            if usable:
                more, n = _nvdec_decode(device, stream, path, coefs, failed, label)
                text += "; " + more
                path_launches += n
            elif skip:
                why = []
                for call in (lambda: nvdec.Reader(path, device),
                             lambda: video.get_frames(path, [0], device=device, decoder="nvdec")):
                    try:
                        call()
                        why.append(None)
                    except mpeg4.UnsupportedVideo as err:
                        why.append(err.reason)
                if not all(w and "NVDEC" in w and env in w for w in why):
                    failed.append(f"{label}: reading on the card gives {why}, not a refusal "
                                  f"naming NVDEC and {env!r}")
                text += f"; reading it on the card raises UnsupportedVideo: {why[0]}"
            _phase("nvdec", t0, text)
            if stream.n == NVDEC_N:
                surf = stream.surface(0, device, NVDEC_PITCH_ALIGN)
                kernel_ms = kernel_device_ms(
                    lambda: nvdec.nv12_to_bgr(surf, stream.coded[1], (W, H), coefs),
                    "nv12_to_bgr_kernel", reps=NVDEC_REPS)
                plain_ms = _cuda_ms(lambda: nvdec.nv12_to_bgr_plain(surf, stream.coded[1], (W, H),
                                                                    coefs), 20)
                events_ms = _cuda_ms(lambda: nvdec.nv12_to_bgr(surf, stream.coded[1], (W, H),
                                                                coefs), NVDEC_REPS)
                in_b, out_b = W * H * 3 // 2, W * H * 3
                bound_ms = (in_b + out_b) / PEAK_BYTES_PER_S * 1e3
            del stream
    launches = path_launches
    rec = dict(name="nv12_to_bgr", route="cuda", source="acinoset_tpu_torch/utils/csrc/nvdec.cu",
               replaces=None, launches=launches, max_abs_err=worst, ms=kernel_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None)
    _phase("nvdec", t0, f"nv12_to_bgr at {NVDEC_RES[0]} x {NVDEC_RES[1]}: device {kernel_ms:.5f} ms "
           f"a frame (profiler; events {events_ms:.5f} ms), bound {bound_ms:.5f} ms ({in_b / 1e6:.2f}"
           f" MB in, {out_b / 1e6:.2f} MB out at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, "
           f"{100 * bound_ms / kernel_ms:.1f}% of it), plain version {plain_ms:.4f} ms; launches "
           f"on the decode path {launches} (it replaces no TPU kernel: the JAX package converts "
           f"on the host in cv2)")
    if failed:
        raise AssertionError("nvdec: " + "; ".join(failed))
    return rec


def h264_streams():
    """(label, RandomH264) of H264_STREAMS, written on the host."""
    from acinoset_tpu_torch.utils import h26x

    for label, size, n, opts in H264_STREAMS:
        yield label, h26x.RandomH264(size, n, **opts)


def phase_h264(device):
    """The port's software H.264 decoder (utils/h264.py,
    utils/csrc/h264.cpp) on the random-syntax writer's streams at the rig's
    widths (H264_STREAMS): _random_syntax_phase."""
    from acinoset_tpu_torch.utils import h264

    _random_syntax_phase(device, "h264", h264_streams(), H264_DIGESTS, h264, "avc1")


def hevc_streams(bit_depth=None):
    """(label, RandomHEVC) of HEVC_STREAMS (those of bit_depth where it is
    given), written on the host."""
    from acinoset_tpu_torch.utils import h26x

    for label, size, n, opts in HEVC_STREAMS:
        if bit_depth in (None, opts.get("bit_depth", 8)):
            yield label, h26x.RandomHEVC(size, n, **opts)


def phase_hevc(device):
    """The port's software HEVC decoder (utils/hevc.py,
    utils/csrc/hevc.cpp) on the random-syntax writer's streams at the rig's
    widths (HEVC_STREAMS), 8-bit and 10-bit: _random_syntax_phase. Returns
    the 10-bit kernel's record (for main's kernels line)."""
    from acinoset_tpu_torch.utils import hevc

    return _random_syntax_phase(device, "hevc", hevc_streams(), HEVC_DIGESTS, hevc, "hvc1")


def _hold_to_plain(reader, device, errs):
    """Make a 10-bit reader hold each frame's conversion to the plain
    version on the same surface, on the card: appends |kernel - plain|'s
    largest value for each frame to errs; returns a list whose one entry
    sums the seconds the checks take (left out of the decode rate)."""
    from acinoset_tpu_torch.utils import nvdec

    convert, spent = reader._convert, [0.0]

    def held():
        out = convert()
        t0 = time.perf_counter()
        info = reader.info
        plain = nvdec.yuv420p10_to_bgr_plain(
            reader._nv12.to(device), info["coded_height"], reader.size, reader._coefs,
            (info["left"], info["top"]), nvdec.chroma_siting(info["chroma_loc"]))
        errs.append(int((out.int() - plain.int()).abs().max()))
        spent[0] += time.perf_counter() - t0
        return out

    reader._convert = held
    return spent


def _p10_record(device, reader, launches, errs):
    """The 10-bit kernel's record: its device time on the reader's last
    surface (profiler; CUDA events beside it), the plain version's, and
    the bound (bytes: 3 W H in, 3 W H out)."""
    from acinoset_tpu_torch.utils import nvdec

    info = reader.info
    W, H = reader.size
    surf = reader._nv12.to(device)
    args = (surf, info["coded_height"], (W, H), reader._coefs, (info["left"], info["top"]),
            nvdec.chroma_siting(info["chroma_loc"]))
    kernel_ms = kernel_device_ms(lambda: nvdec.yuv420p10_to_bgr(*args),
                                 "yuv420p10_to_bgr_kernel", reps=NVDEC_REPS)
    events_ms = _cuda_ms(lambda: nvdec.yuv420p10_to_bgr(*args), NVDEC_REPS)
    plain_ms = _cuda_ms(lambda: nvdec.yuv420p10_to_bgr_plain(*args), 20)
    in_b, out_b = 2 * W * H * 3 // 2, 3 * W * H
    bound_ms = (in_b + out_b) / PEAK_BYTES_PER_S * 1e3
    text = (f"yuv420p10_to_bgr at {W} x {H}: device {kernel_ms:.5f} ms a frame (profiler; "
            f"events {events_ms:.5f} ms), bound {bound_ms:.5f} ms ({in_b / 1e6:.2f} MB in, "
            f"{out_b / 1e6:.2f} MB out at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, "
            f"{100 * bound_ms / kernel_ms:.1f}% of it), plain version {plain_ms:.4f} ms; launches "
            f"on the decode path {launches}, largest |kernel - plain| {max(errs, default=0)} over "
            f"{len(errs)} frames (it replaces no TPU kernel: the JAX package converts on the host "
            f"in cv2)")
    return dict(name="yuv420p10_to_bgr", route="cuda",
                source="acinoset_tpu_torch/utils/csrc/nvdec.cu", replaces=None, launches=launches,
                max_abs_err=max(errs, default=0), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None), text


def _random_syntax_phase(device, phase, streams, digests, module, entry):
    """A software decoder (``module``: utils.h264 or utils.hevc) on a
    random-syntax writer's streams: each written on the host, its MP4's
    SHA-256 equal to ``digests``' (the stream cv2 read on the CPU), decoded
    on the card through open_video with one conversion launch a frame
    (nv12_to_bgr, or yuv420p10_to_bgr for 10 bits: each such frame's
    output equal to the plain version's on the same surface), and each
    frame's SHA-256 equal to cv2's. Where NVDEC decodes on this
    card (nvdec.refusal is None), its frames equal the software decoder's;
    where it is refused, only the environment's visible withholding of the
    video engine (nvdec.withheld) skips that gate. Prints the decode rate
    at 2704 x 1520 and the host's share, 8-bit and 10-bit apart. Returns
    the 10-bit kernel's record where a stream has 10 bits, else None."""
    import hashlib
    import tempfile

    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.utils import h26x, nvdec

    t0 = time.perf_counter()
    failed = []
    rig = {8: [0, 0.0, 0.0], 10: [0, 0.0, 0.0]}  # frames, seconds, host seconds at 2704 x 1520
    p10 = [0, [], None]  # the 10-bit path's launches, |kernel - plain| a frame, its record
    with tempfile.TemporaryDirectory() as root:
        for label, stream in streams:
            W, H = stream.size
            depth = getattr(stream, "bit_depth", 8)
            kernel = nvdec.yuv420p10_to_bgr if depth > 8 else nvdec.nv12_to_bgr
            path = os.path.join(root, label.replace(" ", "_") + ".mp4")
            t1 = time.perf_counter()
            h26x.write_mp4(path, stream, NVDEC_FPS)
            s_write = time.perf_counter() - t1
            with open(path, "rb") as f:
                file_sha = hashlib.sha256(f.read()).hexdigest()
            for k in module.COUNTERS:
                module.COUNTERS[k] = 0.0
            errs, spent = [], [0.0]
            kernel.launches = 0
            _sync(device)
            t1 = time.perf_counter()
            with video.open_video(path, device) as reader:
                kind = type(reader).__module__
                if depth > 8:
                    spent = _hold_to_plain(reader, device, errs)
                frames = [reader.read_tensor(k) for k in range(reader.n_frames)]
                _sync(device)
                s_dec = time.perf_counter() - t1 - spent[0]
                launches = kernel.launches
                if depth > 8:
                    p10[0] += launches
                    p10[1] += errs
                    if any(errs):
                        failed.append(f"{label}: yuv420p10_to_bgr differs from its plain version "
                                      f"on {sum(e > 0 for e in errs)} of {len(errs)} frames")
                    if (W, H) == NVDEC_RES:
                        p10[2] = reader
            host = module.COUNTERS["host_s"]
            shas = [hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest() for f in frames]
            want_file, want_frames = digests.get(label, (None, []))
            same = sum(a == b for a, b in zip(shas, want_frames))
            ok = (file_sha == want_file and same == len(want_frames) == len(shas)
                  and launches == len(shas) and kind == module.__name__)
            if not ok:
                failed.append(f"{label}: read with {kind}; MP4 SHA-256 {file_sha} (want "
                              f"{want_file}); {same}/{len(want_frames)} frames with cv2's SHA-256 "
                              f"({len(shas)} read); {launches} launches")
            if (W, H) == NVDEC_RES:
                rig[depth][0] += len(shas)
                rig[depth][1] += s_dec
                rig[depth][2] += host
            why = nvdec.refusal(device, entry, stream.size)
            if why is None:
                with video.open_video(path, device, "nvdec") as reader:
                    hw = [reader.read_tensor(k) for k in range(reader.n_frames)]
                hw_same = sum(torch.equal(a, b) for a, b in zip(hw, frames))
                nv_text = f"NVDEC's frames equal the software decoder's on {hw_same}/{len(frames)}"
                if hw_same != len(frames) or len(hw) != len(frames):
                    failed.append(f"{label}: {nv_text}")
            elif nvdec.withheld():
                nv_text = f"NVDEC not compared (the environment withholds it: {why})"
            else:
                nv_text = f"NVDEC refused where the environment does not withhold it: {why}"
                failed.append(f"{label}: {nv_text}")
            _phase(phase, t0, f"{label}, {stream.n} pictures ({''.join(stream.types)}), "
                   f"{os.path.getsize(path) / 1e6:.3f} MB written in {s_write:.3f} s; {len(shas)} "
                   f"frames decoded on the card in {s_dec:.3f} s, {len(shas) / s_dec:.2f} frames/s "
                   f"(host decoder {host:.3f} s, {100 * host / s_dec:.1f}%); MP4 and frames equal "
                   f"cv2's digests {ok} ({same}/{len(want_frames)}); {kernel.__name__} launches "
                   f"{launches}" + (f", each frame equal to the plain version's {not any(errs)}"
                                    if depth > 8 else "") + f"; {nv_text}")
    for depth, (n, s, host) in rig.items():
        if n:
            _phase(phase, t0, f"software decode at {NVDEC_RES[0]} x {NVDEC_RES[1]} of the "
                   f"{depth}-bit random-syntax streams: {n / s:.2f} frames/s, the host decoder's "
                   f"share {100 * host / s:.1f}%")
    rec = None
    if p10[2] is not None:
        rec, text = _p10_record(device, p10[2], p10[0], p10[1])
        _phase(phase, t0, text)
    if failed:
        raise AssertionError(f"{phase}: " + "; ".join(failed))
    return rec


def _software_decode(device, stream, path, coefs, failed, label):
    """The software decoder's gates on an H.264 or HEVC stream of known
    reconstruction (utils/h264.py or utils/hevc.py through open_video's
    default for ``avc1``/``avc3`` and ``hvc1``): every frame equal to the
    reconstruction in cv2's colours with one nv12_to_bgr launch a frame;
    for the rig's streams, get_frames at VIDEO_SEEKS equal to the
    sequential decode, and the decode rate with the host's share. Returns
    (its text, the launches)."""
    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.utils import h26x, h264, hevc, nvdec

    W, H = stream.size
    module = hevc if isinstance(stream, h26x.HevcStream) else h264
    for k in module.COUNTERS:
        module.COUNTERS[k] = 0.0
    nvdec.nv12_to_bgr.launches = 0  # the decode path's launches: each frame's conversion
    _sync(device)
    t1 = time.perf_counter()
    with video.open_video(path, device) as reader:
        kind = type(reader).__module__
        decoded = [reader.read_tensor(k) for k in range(reader.n_frames)]
    _sync(device)
    s_dec = time.perf_counter() - t1
    launches = nvdec.nv12_to_bgr.launches
    same = sum(f is not None and torch.equal(f, nvdec.nv12_to_bgr_plain(
        stream.surface(k, device, NVDEC_PITCH_ALIGN), stream.coded[1], (W, H), coefs))
        for k, f in enumerate(decoded))
    if kind != module.__name__ or same != stream.n or launches != stream.n:
        failed.append(f"{label}: open_video read it with {kind}; {stream.n - same} frames differ "
                      f"from the reconstruction; {launches} launches for {stream.n} frames")
    host = module.COUNTERS["host_s"]
    text = (f"software decode ({kind}) {s_dec:.3f} s, {stream.n / s_dec:.2f} frames/s (host "
            f"decoder {host:.3f} s, {100 * host / s_dec:.1f}%; copy and kernel "
            f"{module.COUNTERS['device_s']:.3f} s); equal to the reconstruction {same}/{stream.n}; "
            f"kernel launches {launches}")
    if stream.size == NVDEC_RES:
        seeks = [i for i in VIDEO_SEEKS if i < stream.n] + [stream.n]
        t1 = time.perf_counter()
        got = video.get_frames(path, seeks, device=device)
        s_seek = time.perf_counter() - t1
        seek_ok = ([i for i, _f in got] == seeks[:-1]
                   and all(np.array_equal(f, decoded[i].cpu().numpy()) for i, f in got))
        if not seek_ok:
            failed.append(f"{label}: get_frames at {seeks} differs from the sequential decode")
        text += f"; get_frames at {seeks} equal to the sequential decode {seek_ok} ({s_seek:.3f} s)"
    return text, launches


def _nvdec_decode(device, stream, path, coefs, failed, label):
    """The decode gates of phase_nvdec where the card's NVDEC decodes:
    every frame against the reconstruction, launches a frame, seeks, and
    (for the rig's H.264) create_labeled_video's bytes. Returns its text."""
    import tempfile

    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.pipeline.plots import CHEETAH_LINKS
    from acinoset_tpu_torch.utils import mpeg4, nvdec

    W, H = stream.size
    for k in nvdec.COUNTERS:
        nvdec.COUNTERS[k] = 0
    nvdec.nv12_to_bgr.launches = 0  # the decode path's launches: each frame's conversion
    _sync(device)
    t1 = time.perf_counter()
    with video.open_video(path, device) as reader:
        decoded = [reader.read_tensor(k) for k in range(reader.n_frames)]
    _sync(device)
    s_dec = time.perf_counter() - t1
    launches = nvdec.nv12_to_bgr.launches
    recon = [nvdec.nv12_to_bgr_plain(stream.surface(k, device, NVDEC_PITCH_ALIGN), stream.coded[1], (W, H),
                                     coefs) for k in range(stream.n)]
    same = sum(f is not None and torch.equal(f, r) for f, r in zip(decoded, recon))
    if same != stream.n or launches != stream.n:
        failed.append(f"{label}: {stream.n - same} frames differ from the reconstruction; "
                      f"{launches} launches for {stream.n} frames")
    seeks = [i for i in VIDEO_SEEKS if i < stream.n] + [stream.n]
    got = video.get_frames(path, seeks, device=device)
    seek_ok = ([i for i, _f in got] == seeks[:-1]
               and all(np.array_equal(f, decoded[i].cpu().numpy()) for i, f in got))
    if not seek_ok:
        failed.append(f"{label}: get_frames at {seeks} differs from the sequential decode")
    host = nvdec.COUNTERS["host_s"]
    text = (f"decoded on NVDEC {s_dec:.3f} s, {stream.n / s_dec:.2f} frames/s (host: samples and "
            f"parser {host:.3f} s, {100 * host / s_dec:.1f}%; waiting in map "
            f"{nvdec.COUNTERS['map_s']:.3f} s); equal to the reconstruction {same}/{stream.n}; "
            f"kernel launches {launches} ({launches / stream.n:.2f} a frame); get_frames at "
            f"{seeks} equal to the sequential decode {seek_ok}")
    if stream.n == NVDEC_N:
        with tempfile.TemporaryDirectory() as root:
            markers = ["nose", "r_eye"]
            pts = np.stack([np.full(stream.n, 100.0 + 50 * i) for i in range(2)], 1)
            xy = np.stack([pts, pts], -1)
            labels = os.path.join(root, "cam1.h5")
            data_io.save_dlc_points_h5(labels, xy, np.ones((stream.n, 2)), markers)
            with contextlib.redirect_stdout(io.StringIO()):
                out = video.create_labeled_video(path, 0, root, label_fpaths=[labels],
                                                 device=device)
            ref = os.path.join(root, "ref.mp4")
            colours = np.array(video.marker_colours(2), np.uint8)
            links = [(markers.index(a), markers.index(b)) for a, b in CHEETAH_LINKS
                     if a in markers and b in markers]
            with mpeg4.Writer(ref, (W, H), NVDEC_FPS, device) as w:
                for k, f in enumerate(recon):
                    seg, dots, which = video._frame_labels(
                        np.concatenate([xy[k], np.ones((2, 1))], 1), links, 0.5, True)
                    w.write(video.draw_labels(f.clone(), seg, dots, colours[which]))
            bytes_ok = open(out, "rb").read() == open(ref, "rb").read()
        if not bytes_ok:
            failed.append(f"{label}: create_labeled_video's bytes differ from mpeg4.Writer fed "
                          "draw_labels of the reconstruction")
        text += f"; create_labeled_video's bytes equal mpeg4.Writer's of the labels drawn {bytes_ok}"
    return text, launches


#: the files phase: one full-width run (the reference's GoPro rig size),
#: then a dataset root of FILES_SWEEP_RUNS such runs in two fps groups
FILES_CAMS = 6
FILES_N = 200
FILES_RES = (2704, 1520)
FILES_FPS = (90.0, 120.0)
FILES_SWEEP_RUNS = 8
#: tests/test_pipeline_e2e.py's bounds: tri and sba median marker error,
#: the EKF's mean from frame 20 on, the FTE's mean; eval's RMSE and PCK
FILES_TRI_MEDIAN_M = 0.05
FILES_SBA_MEDIAN_M = 0.05
FILES_EKF_MEAN_M = 0.12
FILES_EKF_SKIP = 20
FILES_FTE_MEAN_M = 0.05
FILES_EVAL_RMSE_PX = 5.0
FILES_EVAL_PCK = 0.95
#: tri on the card against the CPU port (float64, the same DLT)
FILES_TRI_CPU_M = 1e-9
#: the most the files phase's plots and histogram may add, s (the
#: videos' seconds are under VIDEO_BUDGET_S)
FILES_SLICE_S = 10.0
#: the series polylines of fte.svg: the 25 states
FILES_STATES = 25
#: the histogram's bins (eval.metrics.save_error_histogram's default)
FILES_HIST_BINS = 20
#: the sweep runs (their index) whose batched EKF loses the track in the
#: JAX package's own float32 stage too: the inherited cold-init fault
#: (ROADMAP Queue 3). Their EKF error is a reading, not gated; their FTE
#: is. tests/test_torch_files_inherited.py holds this to the JAX package.
FILES_EKF_JAX_LOST = (0,)


class _StageClock(io.TextIOBase):
    """Collects what the CLI prints and the time of each stage header it
    prints (``========== TRI ==========``)."""

    def __init__(self):
        self.marks, self.parts, self.end = [], [], None

    def write(self, s):
        m = re.match(r"========== (\w+) ==========", s)
        if m:
            self.marks.append((m.group(1).lower(), time.perf_counter()))
        self.parts.append(s)
        return len(s)

    def seconds(self):
        ends = [t for _n, t in self.marks[1:]] + [self.end]
        return {n: e - t for (n, t), e in zip(self.marks, ends)}

    @property
    def text(self):
        return "".join(self.parts)


def _cli(argv):
    """cli.main(argv) with its output collected: (clock, seconds)."""
    from acinoset_tpu_torch import cli

    clock = _StageClock()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        rc = cli.main(argv)
    clock.end = time.perf_counter()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return clock, clock.end - t1


class _Seconds:
    """Times every call of ``owner.name`` while it is entered: .s, .calls."""

    def __init__(self, owner, name):
        self.owner, self.name, self.s, self.calls = owner, name, 0.0, 0

    def __enter__(self):
        fn = self.orig = getattr(self.owner, self.name)

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s += time.perf_counter() - t
                self.calls += 1

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _pdf_xref_ok(path):
    """Each offset of a PDF's xref table lands on its 'n 0 obj'."""
    data = open(path, "rb").read()
    m = re.search(rb"startxref\n(\d+)\n%%EOF\n$", data)
    if not m or not data[int(m.group(1)):].startswith(b"xref\n0 "):
        return False
    rows = data[int(m.group(1)):].split(b"\n")
    n = int(rows[1].split()[1])
    return n > 1 and all(data[int(row[:10]):].startswith(f"{i} 0 obj".encode())
                         for i, row in enumerate(rows[3:2 + n], 1))


def files_plots_check(run, failed):
    """The plots ``cli all`` wrote in a run directory, read back: fte.svg
    parses with FILES_STATES series polylines, ekf.pdf's xref offsets
    land on their objects, reconstructions.png reads at its size with
    pixels off the dark background, and plot_cheetah_states of
    fte.pickle's x holds x's columns bit for bit. Returns the readings."""
    import xml.etree.ElementTree as ET

    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.pipeline.plots import plot_cheetah_states
    from acinoset_tpu_torch.utils.png import read_png

    svg = ET.parse(os.path.join(run, "fte", "fte.svg")).getroot()
    n_svg = sum(e.get("class") == "series"
                for e in svg.iter("{http://www.w3.org/2000/svg}polyline"))
    if n_svg != FILES_STATES:
        failed.append(f"fte.svg holds {n_svg} series polylines, not {FILES_STATES}")
    pdf_ok = _pdf_xref_ok(os.path.join(run, "ekf", "ekf.pdf"))
    if not pdf_ok:
        failed.append("ekf.pdf's xref offsets do not land on their objects")
    img = read_png(os.path.join(run, "reconstructions.png"))
    lit = int((img != 0).any(axis=-1).sum())
    if img.shape != (600, 1400, 3) or not lit:
        failed.append(f"reconstructions.png: {img.shape}, {lit} pixels off the background")
    x = data_io.load_pickle(os.path.join(run, "fte", "fte.pickle"))["x"]
    fig = plot_cheetah_states(x)
    held = all(np.array_equal(ax.lines[0].data[1], x[:, i])
               and np.array_equal(ax.lines[0].data[0], np.arange(len(x)))
               for i, ax in enumerate(fig.flat[:x.shape[1]]))
    if not held:
        failed.append("plot_cheetah_states does not hold fte.pickle's x bit for bit")
    return (f"fte.svg {n_svg} series polylines, ekf.pdf xref {pdf_ok}, reconstructions.png "
            f"{img.shape[1]} x {img.shape[0]} with {lit} lit pixels, plot_cheetah_states holds "
            f"x {x.shape} bit for bit {held}")


def _printed_metrics(text):
    import ast

    rows = {}
    for line in text.splitlines():
        cam, sep, rest = line.partition(" ")
        if sep and rest.startswith("{"):
            rows[cam] = ast.literal_eval(rest)
    return rows


def _files_errors(run, truth):
    """Each stage's marker errors (m) against the truth, from its pickle."""
    from acinoset_tpu_torch.pipeline import data as data_io

    out = {}
    for stage in ("tri", "sba", "ekf", "fte"):
        payload = data_io.load_pickle(os.path.join(run, stage, f"{stage}.pickle"))
        out[stage] = (np.linalg.norm(payload["positions"] - truth, axis=-1), payload)
    return out


def _files_gates(label, errs, failed):
    """tests/test_pipeline_e2e.py's bounds on one run's stages; returns
    the readings as text."""
    tri = float(np.nanmedian(errs["tri"][0]))
    sba = float(np.nanmedian(errs["sba"][0]))
    ekf = float(np.nanmean(errs["ekf"][0][FILES_EKF_SKIP:]))
    fte = float(np.nanmean(errs["fte"][0]))
    conv = bool(errs["fte"][1]["converged"])
    for name, val, bound in (("tri median", tri, FILES_TRI_MEDIAN_M),
                             ("sba median", sba, FILES_SBA_MEDIAN_M),
                             ("ekf mean", ekf, FILES_EKF_MEAN_M),
                             ("fte mean", fte, FILES_FTE_MEAN_M)):
        if not val < bound:
            failed.append(f"{label}: {name} marker error {val} m (bound {bound})")
    if not conv:
        failed.append(f"{label}: fte not converged")
    return (f"tri median {tri:.5f} m, sba median {sba:.5f} m, ekf mean {ekf:.5f} m, "
            f"fte mean {fte:.5f} m converged {conv}")


def files_sweep_run(root, i):
    """Run i of the files phase's dataset root: the full-width run with
    seed i + 1 at FILES_FPS[i % 2]. Returns make_synthetic_run_dir's
    (run_dir, cams, X_true, pts3d)."""
    from acinoset_tpu_torch.utils import synthetic as syn

    return syn.make_synthetic_run_dir(os.path.join(root, f"r{i}"), n_cams=FILES_CAMS, N=FILES_N,
                                      fps=FILES_FPS[i % 2], cam_res=FILES_RES, seed=i + 1)


def files_h264_camera(root, px, lik, markers, device, failed):
    """A seventh camera, GoPro's H.264 (utils.h26x.H264Stream):
    _files_camera."""
    return _files_camera(root, px, lik, markers, device, failed, "h264")


def files_hevc_camera(root, px, lik, markers, device, failed):
    """An eighth camera, GoPro's HEVC (utils.h26x.HevcStream):
    _files_camera."""
    return _files_camera(root, px, lik, markers, device, failed, "hevc")


def _files_camera(root, px, lik, markers, device, failed, codec):
    """A camera of GoPro's H.264 or HEVC (utils.h26x.H264Stream or
    HevcStream at the run's size, rate and length), through ``cli dlc`` in
    a run directory of its own (the stages after dlc take every dlc/*.h5 as
    a camera of the scene): labelled through the port's software decoder
    on every card, with no Not written: line, the labelled video read back
    at the source's frame count, size and fps, and its bytes equal to
    mpeg4.Writer fed draw_labels of the stream's reconstruction (the frames
    it decodes to). Returns its text."""
    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.pipeline import video
    from acinoset_tpu_torch.utils import h26x, mp4, mpeg4, nvdec

    extra = os.path.join(root, codec)
    os.makedirs(extra)
    t1 = time.perf_counter()
    kind = h26x.HevcStream if codec == "hevc" else h26x.H264Stream
    number = FILES_CAMS + (2 if codec == "hevc" else 1)
    stream = kind(FILES_RES, FILES_N, gop=NVDEC_GOP, seed=number)
    src = h26x.write_mp4(os.path.join(extra, "cam1.mp4"), stream, FILES_FPS[0])
    s_write = time.perf_counter() - t1
    labels = os.path.join(extra, "dlc", f"cam{number}DLC_cam1.h5")
    data_io.save_dlc_points_h5(labels, px, lik, markers)
    clock, s_dlc = _cli(["dlc", "--data_dir", extra, "--device", device.type])
    out = os.path.join(extra, "dlc", "cam1_labeled.mp4")
    got = None
    if os.path.exists(out):
        with mpeg4.Reader(out, device) as r:
            got = (r.n_frames, r.size, r.fps, r.read(r.n_frames - 1) is not None)
    not_written = [ln for ln in clock.text.splitlines() if ln.startswith("Not written")]
    want = (FILES_N, FILES_RES, FILES_FPS[0], True)
    # what the labelled video must hold: the cli's own drawing (pcutoff the
    # dlc stage's default 0.8) on the frames the stream decodes to
    t1 = time.perf_counter()
    frames_idx, names, vals = video._load_2d_labels(labels)
    names = list(names)
    links = [(names.index(a), names.index(b)) for a, b in video.CHEETAH_LINKS
             if a in names and b in names]
    colours = np.array(video.marker_colours(len(names)), np.uint8).reshape(-1, 3)
    rows = {int(f): i for i, f in enumerate(frames_idx)}
    coefs = nvdec.colour_coefs(stream.matrix, stream.full_range)
    ref = os.path.join(extra, "ref.mp4")
    with mpeg4.Writer(ref, FILES_RES, mp4.read_video_track(src).fps, device) as w:
        for k in range(FILES_N):
            frame = nvdec.nv12_to_bgr_plain(stream.surface(k, device), stream.coded[1],
                                            stream.size, coefs)
            if k in rows:
                seg, dots, which = video._frame_labels(vals[rows[k]], links, 0.8, True)
                video.draw_labels(frame, seg, dots, colours[which])
            w.write(frame)
    s_ref = time.perf_counter() - t1
    bytes_ok = got is not None and open(out, "rb").read() == open(ref, "rb").read()
    ok = got == want and not not_written and bytes_ok
    name = "HEVC" if codec == "hevc" else "H.264"
    if not ok:
        failed.append(f"cli dlc on the {name} camera wrote a labelled video that reads back as "
                      f"{got} (want {want}), printed {not_written}, bytes equal to mpeg4.Writer "
                      f"fed the labels drawn on the reconstruction {bytes_ok}")
    return (f"a camera of {name} ({os.path.getsize(src) / 1e6:.3f} MB, written in "
            f"{s_write:.3f} s), through cli dlc in {s_dlc:.3f} s (software decoder): labelled, "
            f"read back as {got}, no Not written: line {not not_written}, bytes equal to "
            f"mpeg4.Writer fed draw_labels of the reconstruction {bytes_ok} (reference written "
            f"in {s_ref:.3f} s) {ok}")


def phase_files(device, video_s):
    """The file-level pipeline on the card, the user's path: a run
    directory at full width (make_synthetic_run_dir: 6 cameras, N=200,
    2704 x 1520, the 20 cheetah markers, its DLC .h5 files written by
    utils.hdf5, renamed to end in cam{c}.h5, the name
    create_labeled_videos looks for), each .h5 read back bit for bit, and
    mp4v cam1..6.mp4 of its size, fps and frames beside them, the run's
    markers drawn on footage (utils.synthetic.write_scene_mp4;
    get_vid_info reads the sidecar's values from them); ``cli all`` (the
    dlc stage's six labelled videos, each read back by the port's decoder
    at its source's frame count, size and fps, then tri, sba, ekf, fte in
    float64) with each stage held to tests/test_pipeline_e2e.py's bounds,
    and a seventh camera, H.264, and an eighth, HEVC, each through ``cli
    dlc`` (files_h264_camera, files_hevc_camera); tri against the CPU port and fte's six reprojected .h5 files against the projection
    of its positions, and its plots read back (files_plots_check);
    ``cli eval --hist`` against ground-truth label files (the noiseless
    projections of the truth, as tests/test_pipeline_e2e.py evaluates),
    the histogram's counts against np.histogram of the reprojection
    errors and their sum against the finite errors; what the plots and
    histogram add, under FILES_SLICE_S; the video work (video_s, phase_video's
    seconds, the six cam*.mp4 and the dlc stage) under VIDEO_BUDGET_S; ``cli sweep --stages
    fte,ekf`` on a root of FILES_SWEEP_RUNS such runs in two fps groups
    (float32), every run's pickles present and held to the same bounds
    (the EKF of the runs in FILES_EKF_JAX_LOST, which the JAX package's
    float32 stage loses too, a reading); ``cli view``. Readings not
    gated: s a stage, the .h5 read and write MB/s, the runs converged
    before the rescue, and eval against the run's own DLC files (which
    hold the synthetic outliers). No hand kernel lies on this path (the
    FTE stage runs 'pcg'); the banded kernel's launch count over the
    phase is printed."""
    import tempfile

    from acinoset_tpu_torch.eval import metrics
    from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
    from acinoset_tpu_torch.models import cheetah
    from acinoset_tpu_torch.pipeline import app
    from acinoset_tpu_torch.pipeline import data as data_io
    from acinoset_tpu_torch.pipeline import tri as tri_mod
    from acinoset_tpu_torch.utils import mpeg4
    from acinoset_tpu_torch.utils import synthetic as syn
    from acinoset_tpu_torch.utils.figure import Figure
    from acinoset_tpu_torch.utils.png import read_png_text

    t0 = time.perf_counter()
    failed = []
    banded_solve.launches = 0
    markers = cheetah.get_markers()
    with tempfile.TemporaryDirectory() as root:
        run, cams, X_true, truth = syn.make_synthetic_run_dir(
            os.path.join(root, "one"), n_cams=FILES_CAMS, N=FILES_N, fps=FILES_FPS[0],
            cam_res=FILES_RES)
        px, lik, _ = syn.render_measurements(X_true, cams, noise_px=1.0, outlier_frac=0.01,
                                             bad_lik_frac=0.02, seed=0)
        fpaths = [os.path.join(run, "dlc", f"cam{c + 1}DLC.h5") for c in range(FILES_CAMS)]
        t1 = time.perf_counter()
        reads = [data_io._read_dlc_h5(f) for f in fpaths]
        s_read = time.perf_counter() - t1
        exact = all(np.array_equal(fr, np.arange(FILES_N)) and bp == markers
                    and np.array_equal(v[..., :2], px[c]) and np.array_equal(v[..., 2], lik[c])
                    for c, (fr, bp, v) in enumerate(reads))
        if not exact:
            failed.append("a DLC .h5 file does not read back bit for bit")
        t1 = time.perf_counter()
        for c in range(FILES_CAMS):
            data_io.save_dlc_points_h5(os.path.join(root, "rewrite", f"cam{c + 1}.h5"), px[c],
                                       lik[c], markers)
        s_write = time.perf_counter() - t1
        mb = sum(os.path.getsize(f) for f in fpaths) / 1e6
        _phase("files", t0, f"run of {FILES_CAMS} cameras x {FILES_N} frames x 20 markers "
               f"({FILES_RES[0]} x {FILES_RES[1]}): {FILES_CAMS} .h5 files, {mb:.3f} MB, read "
               f"back bit for bit {exact}; .h5 read {mb / s_read:.2f} MB/s, write "
               f"{mb / s_write:.2f} MB/s (host)")

        # create_labeled_videos finds camera c's labels as dlc/*cam{c}.h5
        # (the JAX package's rule); the other stages read every dlc/*.h5
        for c, f in enumerate(fpaths):
            fpaths[c] = os.path.join(run, "dlc", f"cam{c + 1}DLC_cam{c + 1}.h5")
            os.rename(f, fpaths[c])
        t1 = time.perf_counter()
        vids = [syn.write_scene_mp4(os.path.join(run, f"cam{c + 1}.mp4"), FILES_RES,
                                    FILES_FPS[0], FILES_N, px[c], seed=c, device=device)
                for c in range(FILES_CAMS)]
        s_videos = time.perf_counter() - t1
        video_mb = sum(os.path.getsize(v) for v in vids) / 1e6
        with open(os.path.join(run, "video_info.json")) as f:
            sidecar = json.load(f)
        info = app.get_vid_info(run)
        vid_ok = (info[0] == tuple(sidecar["resolution"]) and info[1] == sidecar["fps"]
                  and info[2] == sidecar["tot_frames"] and info[3] == vids)
        if not vid_ok:
            failed.append(f"get_vid_info reads {info[:3]} from the videos, the sidecar {sidecar}")
        with _Seconds(Figure, "save") as saves:
            clock, s_all = _cli(["all", "--data_dir", run, "--device", device.type])
        secs = clock.seconds()
        labelled = []
        for v in vids:
            out = v.replace(".mp4", "_labeled.mp4").replace(run, os.path.join(run, "dlc"))
            if not os.path.exists(out):
                labelled.append(None)
                continue
            with mpeg4.Reader(out, device) as r:
                labelled.append((r.n_frames, r.size, r.fps, r.read(r.n_frames - 1) is not None))
        want_video = (FILES_N, FILES_RES, FILES_FPS[0], True)
        not_written = [ln for ln in clock.text.splitlines() if ln.startswith("Not written")]
        labelled_ok = labelled == [want_video] * FILES_CAMS and not not_written
        if not labelled_ok:
            failed.append(f"cli all's dlc stage wrote labelled videos that read back as "
                          f"{labelled} and printed {not_written}, not {FILES_CAMS} of "
                          f"{want_video}")
        s_video_work = video_s + s_videos + secs["dlc"]
        if not s_video_work < VIDEO_BUDGET_S:
            failed.append(f"the video work takes {s_video_work} s (bound {VIDEO_BUDGET_S})")
        h264_text = files_h264_camera(root, px[0], lik[0], markers, device, failed)
        h264_text += "; " + files_hevc_camera(root, px[0], lik[0], markers, device, failed)
        t1 = time.perf_counter()
        plots_text = files_plots_check(run, failed)
        s_slice = time.perf_counter() - t1 + saves.s
        errs = _files_errors(run, truth)
        text = _files_gates("all", errs, failed)
        tri_cpu = tri_mod.tri(run, 1, -1, 0.8, save=False, device="cpu")["positions"]
        tri_card = errs["tri"][1]["positions"]
        same_nan = bool(np.array_equal(np.isnan(tri_cpu), np.isnan(tri_card)))
        d_tri = float(np.nanmax(np.abs(tri_cpu - tri_card))) if same_nan else np.inf
        if not d_tri <= FILES_TRI_CPU_M:
            failed.append(f"tri on the card off the CPU port by {d_tri} m")
        k, d, r, t, *_ = data_io.find_scene_file(run, verbose=False)
        fte_pos = errs["fte"][1]["positions"]
        reproj_ok = True
        for c in range(FILES_CAMS):
            fr, _bp, v = data_io._read_dlc_h5(
                os.path.join(run, "fte", f"cheetah_reprojected_cam{c + 1}.h5"))
            want = metrics.reproject_positions(fte_pos, k[c], d[c], r[c], t[c], device=device)
            reproj_ok &= bool(np.array_equal(fr, np.arange(FILES_N))
                              and np.array_equal(v[..., :2], want)
                              and np.array_equal(v[..., 2], np.isfinite(want[..., 0]) * 1.0))
        if not reproj_ok:
            failed.append("fte's reprojected .h5 files differ from its positions projected")
        _phase("files", t0, f"cli all: {s_all:.3f} s (" + ", ".join(
            f"{n} {v:.3f}" for n, v in secs.items()) + f" s); {text}; tri against the CPU port "
            f"{d_tri:.3e} m (bound {FILES_TRI_CPU_M}); fte's {FILES_CAMS} reprojections equal "
            f"its positions projected {reproj_ok}")
        _phase("files", t0, f"{FILES_CAMS} mp4v cam*.mp4 of the run's markers drawn on "
               f"footage (utils.synthetic.write_scene_mp4 on the card): {s_videos:.3f} s, "
               f"{FILES_CAMS * FILES_N / s_videos:.2f} frames/s, {video_mb:.3f} MB; cli all's "
               f"dlc stage {secs['dlc']:.3f} s, {FILES_CAMS * FILES_N / secs['dlc']:.2f} frames/s "
               f"decoded, labelled and encoded; its {FILES_CAMS} labelled videos read back as "
               f"{labelled[0]} each {labelled_ok}; get_vid_info reads the "
               f"sidecar's {info[0][0]} x {info[0][1]}, {info[1]} fps, {info[2]} frames from the "
               f"videos {vid_ok}; the video work (phase_video {video_s:.3f} s, these videos and "
               f"the dlc stage) {s_video_work:.3f} s (bound {VIDEO_BUDGET_S}); {h264_text}; "
               f"{plots_text}; the {saves.calls} plots written in cli all in {saves.s:.3f} s")

        gt_dir = os.path.join(root, "gt")
        gt, gt_px = [], []
        for c in range(FILES_CAMS):
            p = metrics.reproject_positions(truth, k[c], d[c], r[c], t[c], device=device)
            gt.append(os.path.join(gt_dir, f"cam{c + 1}.h5"))
            gt_px.append(p)
            data_io.save_dlc_points_h5(gt[-1], p, np.ones(p.shape[:2]), markers)
        cams_arg = [str(c) for c in range(FILES_CAMS)]
        result = os.path.join(run, "fte", "fte.pickle")
        hist = os.path.join(root, "hist.png")
        with _Seconds(Figure, "save") as saves:
            clock, s_eval = _cli(["eval", "--result", result, "--gt_h5", *gt, "--cams", *cams_arg,
                                  "--hist", hist, "--device", device.type])
        ev = _printed_metrics(clock.text)["overall"]
        if not (ev["rmse_px"] < FILES_EVAL_RMSE_PX and ev["pck"] > FILES_EVAL_PCK):
            failed.append(f"eval against the truth: rmse {ev['rmse_px']} px, pck {ev['pck']}")
        t1 = time.perf_counter()
        errs_px = metrics.reprojection_errors(fte_pos, gt_px, k, d.reshape(-1, 4), r, t,
                                              cam_indices=range(FILES_CAMS), device=device)
        want_counts = np.histogram(errs_px, FILES_HIST_BINS)[0]
        counts = np.array([float(v) for v in
                           read_png_text(hist)["axes 1 bars 1 heights"].split()])
        n_finite = sum(int(np.isfinite(np.linalg.norm(
            metrics.reproject_positions(fte_pos, k[c], d[c], r[c], t[c], device=device)
            - gt_px[c], axis=-1)).sum()) for c in range(FILES_CAMS))
        hist_line = f"saved histogram: {hist} ({errs_px.size} points)"
        hist_ok = (np.array_equal(counts, want_counts) and counts.sum() == n_finite
                   and hist_line in clock.text.splitlines())
        if not hist_ok:
            failed.append(f"eval --hist: counts {counts.tolist()} against np.histogram's "
                          f"{want_counts.tolist()} over {n_finite} finite errors")
        s_slice += time.perf_counter() - t1 + saves.s
        if not s_slice < FILES_SLICE_S:
            failed.append(f"the plots and histogram add {s_slice} s (bound {FILES_SLICE_S})")
        own = _printed_metrics(_cli(["eval", "--result", result, "--gt_h5", *fpaths, "--cams",
                                     *cams_arg, "--device", device.type])[0].text)["overall"]
        clock, s_view = _cli(["view", "--result", result, "--device", device.type])
        html = os.path.join(run, "fte", "fte.html")
        m = re.search(r"const DATA = (.*);\n", open(html).read())
        view_ok = bool(m) and len(json.loads(m.group(1))["positions"]) == FILES_N
        if not view_ok:
            failed.append(f"cli view's page does not hold the {FILES_N} frames")
        _phase("files", t0, f"cli eval --hist against the truth's projections, cameras 0-5: "
               f"{s_eval:.3f} s, rmse {ev['rmse_px']:.4f} px (bound {FILES_EVAL_RMSE_PX}), pck "
               f"{ev['pck']:.4f} (bound {FILES_EVAL_PCK}); histogram of {n_finite} finite errors, "
               f"{FILES_HIST_BINS} counts equal to np.histogram's {hist_ok}, written in "
               f"{saves.s:.3f} s; the plots and histogram add {s_slice:.3f} s (bound "
               f"{FILES_SLICE_S}); against the run's own DLC files "
               f"(outliers in): rmse {own['rmse_px']:.4f} px, pck {own['pck']:.4f}; cli view "
               f"{s_view:.3f} s, {os.path.getsize(html) / 1e6:.3f} MB")

        sweep_root = os.path.join(root, "dataset")
        truths = [files_sweep_run(sweep_root, i)[::3] for i in range(FILES_SWEEP_RUNS)]
        clock, s_sweep = _cli(["sweep", "--root_dir", sweep_root, "--stages", "fte,ekf",
                               "--device", device.type])
        first = [int(m.group(1)) for m in re.finditer(
            r"rescue: (\d+) unconverged runs re-solved at 60 iterations", clock.text)]
        lines = []
        for i, (r_i, tr) in enumerate(truths):
            errs = {}
            for stage in ("fte", "ekf"):
                fp = os.path.join(r_i, stage, f"{stage}.pickle")
                if not os.path.exists(fp):
                    failed.append(f"sweep wrote no {fp}")
                    continue
                payload = data_io.load_pickle(fp)
                errs[stage] = np.linalg.norm(payload["positions"] - tr, axis=-1)
                if stage == "fte" and not payload["converged"]:
                    failed.append(f"sweep: {r_i} not converged")
            if len(errs) < 2:
                continue
            fte = float(np.nanmean(errs["fte"]))
            ekf = float(np.nanmean(errs["ekf"][FILES_EKF_SKIP:]))
            lost = i in FILES_EKF_JAX_LOST
            lines.append(f"{fte:.5f}/{ekf:.5f}" + (" (EKF lost in JAX too)" if lost else ""))
            if not (fte < FILES_FTE_MEAN_M and (lost or ekf < FILES_EKF_MEAN_M)):
                failed.append(f"sweep: {r_i} fte mean {fte} m, ekf mean {ekf} m")
        _phase("files", t0, f"cli sweep --stages fte,ekf, {FILES_SWEEP_RUNS} runs in "
               f"{len(FILES_FPS)} fps groups (f32): {s_sweep:.3f} s; converged before the "
               f"rescue {FILES_SWEEP_RUNS - sum(first)}/{FILES_SWEEP_RUNS}; fte/ekf mean marker "
               f"error a run (m): {', '.join(lines)}; banded kernel launches in the phase "
               f"{banded_solve.launches} (the path runs none)")
    if failed:
        raise AssertionError("files: " + "; ".join(failed))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    if not (os.path.isdir(os.path.join(ROOT, "acinoset_tpu_torch")) and os.path.exists(GOLDEN)
            and os.path.exists(GOLDEN_EKF) and os.path.exists(GOLDEN_SBA)):
        sys.exit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()
    device = torch.device("cuda")
    phase_device()
    phase_build()
    rec = phase_kernel(device)
    rec["launches"] = phase_main(device)
    phase_mesh(device)
    phase_golden(device)
    probe_recs = phase_probes(device)
    sweep = phase_sweep(device)
    phase_ekf(device, sweep)
    phase_generic(device)
    phase_sba(device)
    phase_calib(device)
    phase_images(device)
    video_s = phase_video(device)
    nvdec_rec = phase_nvdec(device)
    phase_h264(device)
    p10_rec = phase_hevc(device)
    phase_files(device, video_s)
    phase_uncertainty(device)
    phase_solvers(device)
    phase_sweep_uncertainty(device, sweep)
    phase_profile(device)
    phase_device()  # again: the card and its power limit beside the results
    print(f"[total] {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": [rec] + probe_recs + [nvdec_rec, p10_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
