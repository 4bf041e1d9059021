"""The sweep's batched stages, the counterpart of the array-level part
of acinoset_tpu.pipeline.sweep: a group of runs (same fps) padded to one
(frames, cameras) shape and solved as one batch, in chunks of at most
``MAX_PROGRAM_BATCH`` runs. Two stages, each for the cheetah and for any
generic skeleton (``models.skeleton``): the FTE (``solve_batch``,
``solve_batch_generic``, each with the rescue pass that re-solves the
runs whose stationarity test failed) and the EKF + RTS smoother
(``solve_batch_ekf``, ``solve_batch_ekf_generic``, whose smoothed poses
are the FTE's warm start, ``ekf_warm_starts``).

Per-run camera rigs ride along as batched inputs: the measurement
pieces are ``pipeline.ekf.hj_parts_aux`` (or, for a skeleton,
``make_hj_parts_aux_generic`` of its FK with Jacobian) with each run's
rig broadcast over its frames. ``fte_solve`` and ``run_ekf`` are
natively batched, so where the JAX package caches one jitted program per
configuration, the port calls the stage directly (``solve_stage``,
``ekf_stage``, ``solve_stage_generic``, ``ekf_stage_generic``).

Each stage runs over a device mesh (``parallel.mesh``), as in the JAX
package: the batch is padded to the mesh's data extent (``pad_batch``,
the padded runs' results dropped) and each data row solves its slice on
its own device, in a worker process of its own (``_on_mesh``). With
neither ``mesh`` nor ``device`` given that is every visible CUDA device;
with a ``device`` it is that one device, solved in the calling process.

The file level: ``discover_runs`` finds the run directories under a
dataset root, ``load_run`` reads one (DLC ``.h5`` files, scene, video
info), and ``sweep`` / ``sweep_generic`` solve every run, grouped by fps,
through the stages (over every visible CUDA device unless given a mesh
or a device), and write per-run pickles (the reference's all_flick.sh
workload). The
JAX package's XLA compile cache (``enable_persistent_cache``) has no
counterpart.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import cheetah
from ..models.skeleton import fk_and_jac_any
from ..ops import camera as cam_ops
from ..parallel import mesh as mesh_lib
from ..solvers import ekf as ekf_solver
from ..solvers import trajopt
from ..utils.device import resolve_device
from . import app
from . import data as data_io
from .ekf import (assemble_hj, ekf_P0, hj_parts_aux, make_h_fn_aux_generic,  # noqa: F401
                  make_hj_parts_aux_generic, make_marker_std_fn)
from .fte import default_config
from .generic import generic_config


@dataclass
class RunData:
    data_dir: str
    pixels: np.ndarray  # (C, N, L, 2)
    likelihood: np.ndarray  # (C, N, L)
    cams: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # k, d, r, t
    fps: float
    start_frame: int
    scene_fpath: str
    cam_res: Tuple[int, int] = (2704, 1520)  # per-run sensor resolution


def discover_runs(root_dir: str) -> List[str]:
    """Run directories under ``root_dir``: every directory holding a dlc/
    subdirectory with .h5 files, sorted."""
    out = []
    for dirpath, _dirnames, _filenames in os.walk(root_dir):
        if os.path.basename(dirpath) == "dlc" and glob(os.path.join(dirpath, "*.h5")):
            out.append(os.path.dirname(dirpath))
    return sorted(out)


def load_run(
    data_dir: str,
    start_frame: int = 1,
    end_frame: int = -1,
    max_cams: Optional[int] = None,
    markers: Optional[Sequence[str]] = None,
) -> RunData:
    """One run directory as RunData: its DLC points (in ``markers`` order,
    the cheetah's by default) over frames [start_frame - 1, end_frame)
    (``start_frame`` 1-based, ``end_frame`` -1 the last), the scene found
    at or above it, and the fps of its videos or sidecar (120 when it has
    neither). ``max_cams`` is accepted and unused, as in the JAX package."""
    k_arr, d_arr, r_arr, t_arr, cam_res, n_cams, scene_fpath = data_io.find_scene_file(
        data_dir, verbose=False
    )
    try:
        _res, fps, _tot, _ = app.get_vid_info(data_dir)
    except FileNotFoundError:
        fps = 120.0
    fpaths = sorted(glob(os.path.join(data_dir, "dlc", "*.h5")))
    p2d = data_io.load_dlc_points(fpaths, markers=(markers or cheetah.get_markers()))
    start0 = start_frame - 1
    end = p2d.pixels.shape[1] if end_frame == -1 else end_frame
    win = p2d.window(start0, end)
    return RunData(
        data_dir=data_dir,
        pixels=win.pixels,
        likelihood=np.nan_to_num(win.likelihood, nan=-1.0),
        cams=(k_arr, d_arr.reshape(-1, 4), r_arr, np.asarray(t_arr).reshape(-1, 3)),
        fps=float(fps),
        start_frame=start0,
        scene_fpath=scene_fpath,
        cam_res=tuple(int(v) for v in cam_res),
    )


def _pad_run(run: RunData, N: int, C: int):
    """Pad a run to (C, N, L, 2) frames/cameras; padded entries weight 0."""
    c0, n0, L, _ = run.pixels.shape
    pix = np.zeros((C, N, L, 2))
    lik = np.full((C, N, L), -1.0)
    pix[:c0, :n0] = np.nan_to_num(run.pixels)
    lik[:c0, :n0] = run.likelihood
    k, d, r, t = run.cams
    K = np.tile(np.eye(3), (C, 1, 1))
    D = np.zeros((C, 4))
    R = np.tile(np.eye(3), (C, 1, 1))
    T = np.zeros((C, 3))
    T[:, 2] = 10.0  # benign pose for padded cameras
    K[:c0], D[:c0], R[:c0], T[:c0] = k, d, r, t
    return pix, lik, (K, D, R, T), n0


def _pack_runs(runs, N: int, C: int):
    """The stages' packed inputs, each run padded by ``_pad_run``: pixels
    and likelihood (B, C, N, L, 3), rigs (B, C, 25) (K 9, D 4, R 9, T 3)
    and the frames of each run (B,)."""
    packed, auxp, n_valid = [], [], []
    for run in runs:
        pix, lik, (K, D, R, T), n0 = _pad_run(run, N, C)
        packed.append(np.concatenate([pix, lik[..., None]], axis=-1))
        auxp.append(np.concatenate([
            K.reshape(C, 9), D.reshape(C, 4), R.reshape(C, 9), np.asarray(T).reshape(C, 3),
        ], axis=1))
        n_valid.append(n0)
    return np.stack(packed), np.stack(auxp), np.asarray(n_valid)


#: per-batch cap: groups larger than this solve as sequential chunks of
#: exactly this size, the last padded with repeats of its final run. The
#: value is the JAX package's, measured on a TPU v5e (its throughput knee
#: and a compiler safety wall there); it is still to be re-measured on
#: the H100, where the port compiles nothing per shape.
MAX_PROGRAM_BATCH = 96

#: device-memory budget (bytes) for the EKF chunk cap below: the JAX
#: package's share of its TPU v5e (13e9 of 15.75e9 bytes, 82.5%) applied
#: to the H100's 80e9, leaving the same headroom for the measurement
#: buffers and the allocator
EKF_HBM_BUDGET = 66e9


def _ekf_mem_cap(N: int, n_pose: int) -> int:
    """Largest batch of runs the EKF + RTS stage fits in device memory,
    at ~9.5 full-state (N, 3n, 3n) float32 buffers a run: the JAX
    package's coefficient, calibrated from an out-of-memory failure on a
    TPU (the filter history, the smoother's predicted covariances,
    gains and doubling-scan levels). Groups beyond the cap chunk through
    ``_solve_chunked``."""
    bytes_per_run = 9.5 * N * (3 * n_pose) ** 2 * 4
    return max(1, int(EKF_HBM_BUDGET / bytes_per_run))


def _solve_chunked(runs, max_batch, solve_chunk, X0_override=None):
    """Split an oversized group into <=max_batch chunks and solve each
    with ``solve_chunk(chunk_runs, chunk_X0) -> results``. The last
    partial chunk is padded by repeating its final run (results
    discarded) so all chunks share one shape."""
    results = []
    for i in range(0, len(runs), max_batch):
        chunk = list(runs[i : i + max_batch])
        Xc = (list(X0_override[i : i + max_batch])
              if X0_override is not None else None)
        n_real = len(chunk)
        if n_real < max_batch and i > 0:  # pad to the shared shape
            chunk += [chunk[-1]] * (max_batch - n_real)
            if Xc is not None:
                Xc += [Xc[-1]] * (max_batch - n_real)
        results.extend(solve_chunk(chunk, Xc)[:n_real])
    return results


def _track_linreg(pix, lik, cams, marker, thresh, live):
    """Triangulate one marker's track and fit a straight line by weighted
    normal equations over finite live frames, falling back to the track
    mean below 2 points: the counterpart of ``_jit_track_linreg``,
    batched over any leading dimensions.

    pix (..., C, N, L, 2), lik (..., C, N, L), cams (K (..., C, 3, 3),
    D (..., C, 4), R (..., C, 3, 3), T (..., C, 3)), live (..., N) bool.
    Returns (slope (..., 3), intercept (..., 3)) in frame units."""
    K, D, R, T = cams
    dtype = pix.dtype
    Nn = pix.shape[-3]
    valid = (lik[..., marker:marker + 1] > thresh) & live[..., None, :, None]
    track = cam_ops.triangulate_pairwise_mean(
        pix[..., marker:marker + 1, :], valid, K, D, R, T
    )[0][..., 0, :]  # (..., N, 3)
    ok = torch.all(torch.isfinite(track), dim=-1) & live
    okf = ok.to(dtype)
    tr0 = torch.where(ok[..., None], track, torch.zeros_like(track))
    nok = torch.sum(okf, dim=-1, keepdim=True)
    f = torch.arange(Nn, dtype=dtype, device=pix.device)
    Sx = torch.sum(okf * f, dim=-1, keepdim=True)
    Sxx = torch.sum(okf * f * f, dim=-1, keepdim=True)
    Sy = torch.sum(okf[..., None] * tr0, dim=-2)
    Sxy = torch.sum((okf * f)[..., None] * tr0, dim=-2)
    det = nok * Sxx - Sx * Sx
    big = torch.abs(det) > 1e-12
    fit = (nok >= 2.0) & big
    zero = torch.zeros_like(Sy)
    slope = torch.where(fit, (nok * Sxy - Sx * Sy) / torch.where(big, det, torch.ones_like(det)),
                        zero)
    intercept = torch.where(fit, (Sy - slope * Sx) / torch.clamp(nok, min=1.0),
                            Sy / torch.clamp(nok, min=1.0))
    return slope, intercept


def _unpack_rig(auxp):
    """(B, C, 25) packed rig -> K (B, C, 3, 3), D (B, C, 4), R, T (B, C, 3)."""
    lead = auxp.shape[:-1]
    return (auxp[..., :9].reshape(*lead, 3, 3), auxp[..., 9:13],
            auxp[..., 13:22].reshape(*lead, 3, 3), auxp[..., 22:25])


def solve_stage(cfg, packed, auxp, n_valid, dlc_thresh, X0=None, compute_cov=False):
    """The fused FTE stage over a batch of padded runs, the counterpart of
    ``_cached_batch_solver``'s ``solve_one`` vmapped over runs.

    packed (B, C, N, L, 3): pixels and likelihood; auxp (B, C, 25): each
    run's rig (K 9, D 4, R 9, T 3); n_valid (B,) frames per run; X0
    (B, N, P) or None for the cold init: the nose track's straight line
    and yaw, held at the last valid frame through padding. All on one
    device, in the solve's dtype. Weights are ``lik > dlc_thresh`` over
    ``cfg.meas_std_px`` on live frames. ``compute_cov`` adds fte_solve's
    Laplace posterior to its info. Returns (X (B, N, P), marker positions
    (B, N, L, 3), fte_solve's info)."""
    B, C, Nn = packed.shape[:3]
    dtype, device = packed.dtype, packed.device
    K, D, R, T = _unpack_rig(auxp)
    pix, lik = packed[..., :2], packed[..., 2]
    n = torch.as_tensor(n_valid, device=device).reshape(B, 1)
    fidx = torch.arange(Nn, device=device)
    live = fidx[None] < n  # (B, N)
    thresh = float(dlc_thresh)
    w = (lik > thresh).to(dtype) / cfg.meas_std_px
    w = w * live[:, None, :, None].to(dtype)
    meas = pix.permute(0, 2, 1, 3, 4).contiguous()  # (B, N, C, L, 2)
    wT = w.permute(0, 2, 1, 3).contiguous()
    if X0 is None:
        pp = cheetah.get_pose_params()
        nose = cheetah.get_markers().index("nose")
        slope, intercept = _track_linreg(pix, lik, (K, D, R, T), nose, thresh, live)
        f_eff = torch.minimum(fidx[None], n - 1).to(dtype)  # (B, N)
        X0 = torch.zeros((B, Nn, cheetah.N_ACTIVE), dtype=dtype, device=device)
        line = f_eff[..., None] * slope[:, None] + intercept[:, None]
        X0[..., [pp["x_0"], pp["y_0"], pp["z_0"]]] = line
        X0[..., pp["psi_0"]] = torch.atan2(slope[:, 1], slope[:, 0])[:, None]
    rig = tuple(a[:, None] for a in (K, D, R, T))  # (B, 1, C, ...): broadcast over frames
    X, info = trajopt.fte_solve(lambda x: hj_parts_aux(x, rig), X0, meas, wT, cfg,
                                n_valid=n[:, 0], compute_cov=compute_cov, device=device)
    return X, cheetah.fk25(X), info


def _stage_mesh(mesh, device) -> "mesh_lib.Mesh":
    """The mesh a stage runs over: ``mesh``; else the one ``device``; else
    a data-only mesh of every visible CUDA device (raises without CUDA)."""
    if mesh is not None:
        if device is not None:
            raise ValueError("give a mesh or a device, not both")
        return mesh
    if device is not None:
        return mesh_lib.make_mesh(devices=[resolve_device(device)], model_axis=False)
    resolve_device(None)  # no CUDA device: raises
    return mesh_lib.make_mesh(model_axis=False)


def _on_mesh(mesh, stage, const, arrays):
    """Run ``stage(device, *const, *row_arrays) -> {key: host array (b,
    ...)}`` on every data row of the mesh (``mesh.run_rows``: in this
    process for one row, else a worker process a row; on the row's first
    device, as the stages use no 'model' axis). ``stage`` is a module's
    function; ``arrays`` are the batch's host arrays (None passes
    through), padded to the data extent by repeating the first run.
    Returns the rows' outputs joined along the batch and cut to the real
    runs."""
    n = mesh.shape["data"]
    B0 = len(arrays[0])
    full = [None if a is None else mesh_lib.pad_batch([a], n)[0][0] for a in arrays]
    b = len(full[0]) // n
    row_args = [(stage, const, [None if a is None else a[i * b:(i + 1) * b] for a in full])
                for i in range(n)]
    outs = mesh_lib.run_rows(mesh, _stage_row, row_args)
    return {k: np.concatenate([o[k] for o in outs])[:B0] for k in outs[0]}


def _stage_row(devices, stage, const, arrays):
    return stage(devices[0], *const, *arrays)


def solve_batch(
    runs: Sequence[RunData],
    dlc_thresh: float,
    num_iters: int = 60,
    device=None,
    dtype=torch.float32,
    X0_override: Optional[Sequence[np.ndarray]] = None,
    relinearize_every: int = 1,
    plain_iters: Optional[int] = None,
    uncertainty: bool = False,
    max_batch: Optional[int] = MAX_PROGRAM_BATCH,
    pad_frames: Optional[int] = None,
    pad_cams: Optional[int] = None,
    mesh=None,
) -> List[Dict]:
    """Solve a group of runs (same fps) as one batch over ``mesh``, or on
    ``device`` alone, or over every visible CUDA device when neither is
    given (raises without CUDA).

    Groups beyond ``max_batch`` runs solve as sequential chunks padded to
    a shared (frames, cams, batch) shape. ``pad_frames``/``pad_cams`` pin
    the padded shapes (used by the chunk recursion). ``X0_override`` (one
    (n_i, P) array per run) replaces the cold init; rows beyond each run's
    length are held at its last frame. ``plain_iters`` overrides the
    graduated-robustness schedule; ``relinearize_every`` forwards to
    FteConfig (lagged Jacobians). Returns one dict per run with
    positions, x, dx, ddx (host numpy, float64) and the solver status.
    ``uncertainty`` adds fte_solve's Laplace posterior: each dict gains
    ``marker_std`` (n_i, L, 3), per-marker 1-sigma error bars, and the
    run's ``cov_ridge_shrink`` and ``cov_ridge_frac`` (0 in float64)."""
    fps = runs[0].fps
    N = pad_frames or max(r.pixels.shape[1] for r in runs)
    C = pad_cams or max(r.pixels.shape[0] for r in runs)
    if max_batch and len(runs) > max_batch:
        return _solve_chunked(
            runs, max_batch,
            lambda chunk, Xc: solve_batch(
                chunk, dlc_thresh, num_iters=num_iters, device=device,
                dtype=dtype, X0_override=Xc,
                relinearize_every=relinearize_every,
                plain_iters=plain_iters, uncertainty=uncertainty,
                max_batch=None, pad_frames=N, pad_cams=C, mesh=mesh,
            ),
            X0_override=X0_override,
        )
    cfg = default_config(fps, num_iters=num_iters)
    if relinearize_every != 1:
        cfg = dc_replace(cfg, relinearize_every=relinearize_every)
    if plain_iters is not None:
        cfg = dc_replace(cfg, plain_iters=plain_iters)

    mesh = _stage_mesh(mesh, device)
    packed, auxp, n_valid = _pack_runs(runs, N, C)
    host = _on_mesh(mesh, _fte_stage_host, (cfg, dtype, dlc_thresh, uncertainty),
                    [packed, auxp, n_valid, _pad_X0(X0_override, N)])
    return _stage_results(runs, n_valid, fps, host, uncertainty)


def _fte_stage_host(dev, cfg, dtype, dlc_thresh, uncertainty, packed, auxp, n_valid, X0):
    """``solve_stage`` on ``dev`` from host arrays, its outputs as host
    arrays (``_stage_host``)."""
    X, pts, info = solve_stage(
        cfg,
        torch.as_tensor(packed, dtype=dtype, device=dev),
        torch.as_tensor(auxp, dtype=dtype, device=dev),
        torch.as_tensor(n_valid, dtype=torch.int64, device=dev),
        dlc_thresh, _tensor(X0, dtype, dev), compute_cov=uncertainty,
    )
    return _stage_host(X, pts, info, uncertainty)


def _tensor(a, dtype, device):
    return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)


def _pad_X0(X0_override, N: int):
    """Per-run initial trajectories (n_i, P) as one (B, N, P) array, each
    held at its last frame through padding; None stays None."""
    if X0_override is None:
        return None
    X0_b = []
    for Xw in X0_override:
        Xw = np.asarray(Xw, np.float64)
        Xp = np.zeros((N, Xw.shape[1]))
        Xp[: len(Xw)] = Xw
        Xp[len(Xw):] = Xw[-1]  # hold the last frame through padding
        X0_b.append(Xp)
    return np.stack(X0_b)


def _stage_host(X, pts, info, uncertainty):
    """An FTE stage's batched outputs as host arrays: x, positions and the
    status (with the posterior's keys when ``uncertainty``)."""
    keys = ("cost", "cost0", "converged", "grad_norm")
    if uncertainty:
        keys += ("marker_std", "cov_ridge_shrink")
    host = {k: info[k].cpu().numpy() for k in keys}
    if uncertainty:  # float64 has no ridge and no cov_ridge_frac: 0
        host["cov_ridge_frac"] = info.get(
            "cov_ridge_frac", torch.zeros_like(info["cov_ridge_shrink"])).cpu().numpy()
    host["x"], host["positions"] = X.cpu().numpy(), pts.cpu().numpy()
    return host


def _stage_results(runs, n_valid, fps, status, uncertainty):
    """One result dict per run from an FTE stage's host outputs
    (``_stage_host``), cut to the run's length, with host-side
    derivatives."""
    Xb, positions_b = status["x"], status["positions"]
    results = []
    Ts = 1.0 / fps
    for i, run in enumerate(runs):
        n0 = n_valid[i]
        X = Xb[i, :n0].astype(np.float64)
        # backward-difference derivatives on host (cheap numpy)
        dx = np.diff(X, axis=0) / Ts
        dx = np.concatenate([dx[:1], dx], axis=0) if len(X) > 1 else np.zeros_like(X)
        ddx = np.diff(dx, axis=0) / Ts
        ddx = (
            np.concatenate([ddx[1:2], ddx[1:2], ddx[1:]], axis=0)
            if len(X) > 2 else np.zeros_like(X)
        )
        results.append(
            dict(
                data_dir=run.data_dir,
                positions=positions_b[i, :n0].astype(np.float64),
                x=X,
                dx=dx,
                ddx=ddx,
                start_frame=run.start_frame,
                scene_fpath=run.scene_fpath,
                cost=float(status["cost"][i]),
                cost0=float(status["cost0"][i]),
                converged=bool(status["converged"][i]),
                grad_norm=float(status["grad_norm"][i]),
            )
        )
        if uncertainty:
            results[-1].update(
                marker_std=status["marker_std"][i, :n0].astype(np.float64),
                cov_ridge_shrink=float(status["cov_ridge_shrink"][i]),
                cov_ridge_frac=float(status["cov_ridge_frac"][i]),
            )
    return results


def ekf_stage(cfg, packed, auxp, n_valid, P0):
    """The fused EKF stage over a batch of padded runs, the counterpart of
    ``_cached_batch_ekf_solver``'s ``one`` vmapped over runs.

    packed (B, C, N, L, 3) pixels and likelihood, auxp (B, C, 25) each
    run's rig, n_valid (B,) frames per run, P0 (S, S) the initial
    covariance; ``cfg.max_pixel_err`` holds a (B,) tensor, one value per
    run. All on one device, in the stage's dtype. The initial state is
    the nose track's straight line at frame 0 (x, y, z), its yaw and its
    velocity. Returns the ``run_ekf`` dict (outliers (B,)) with
    ``marker_std`` and the smoothed marker ``positions`` (B, N, L, 3)."""
    B, C, Nn = packed.shape[:3]
    dtype, device = packed.dtype, packed.device
    n_pose = cheetah.N_ACTIVE
    pp = cheetah.get_pose_params()
    cams = _unpack_rig(auxp)
    pix, lik = packed[..., :2], packed[..., 2]
    live = torch.arange(Nn, device=device)[None] < n_valid.reshape(B, 1)
    nose = cheetah.get_markers().index("nose")
    slope, intercept = _track_linreg(pix, lik, cams, nose, float(cfg.dlc_thresh), live)
    line_cols = [pp["x_0"], pp["y_0"], pp["z_0"]]
    x0 = torch.zeros((B, 3 * n_pose), dtype=dtype, device=device)
    x0[:, line_cols] = intercept
    x0[:, pp["psi_0"]] = torch.atan2(slope[:, 1], slope[:, 0])
    x0[:, [n_pose + c for c in line_cols]] = slope * (1.0 / float(cfg.dt))  # per second

    def hj(p):
        return assemble_hj(*hj_parts_aux(p, cams))

    out = ekf_solver.run_ekf(hj, pix.transpose(1, 2), lik.transpose(1, 2), x0, P0,
                             cheetah.EKF_QB, cfg)
    out["marker_std"] = make_marker_std_fn(cheetah.fk25_and_jac, n_pose)(
        out["smoothed_x"], out["smoothed_P"])
    out["positions"] = cheetah.fk25(out["smoothed_x"])
    return out


def solve_batch_ekf(
    runs: Sequence[RunData],
    dlc_thresh: float,
    device=None,
    dtype=torch.float32,
    max_batch: Optional[int] = MAX_PROGRAM_BATCH,
    pad_frames: Optional[int] = None,
    pad_cams: Optional[int] = None,
    mesh=None,
) -> List[Dict]:
    """Batched EKF + RTS across a group of runs (same fps) over ``mesh``,
    on ``device`` or over every visible CUDA device (raises without CUDA
    when neither is given), padded as ``solve_batch`` pads them. Groups beyond
    ``max_batch`` or the memory cap (``_ekf_mem_cap``, which holds even
    at ``max_batch=None``) chunk. Each run's untrusted-measurement sigma
    is its own camera width. Returns one dict per run: ``states`` (the
    six state arrays and ``marker_std``, cut to the run's length),
    ``positions``, ``max_pixel_err`` and ``outliers`` (gated pairs)."""
    fps = runs[0].fps
    N = pad_frames or max(r.pixels.shape[1] for r in runs)
    C = pad_cams or max(r.pixels.shape[0] for r in runs)
    n_pose = cheetah.N_ACTIVE
    cap = _ekf_mem_cap(N, n_pose)
    eff_max = min(max_batch, cap) if max_batch else cap
    if len(runs) > eff_max:
        return _solve_chunked(
            runs, eff_max,
            lambda chunk, _Xc: solve_batch_ekf(
                chunk, dlc_thresh, device=device, dtype=dtype,
                max_batch=None, pad_frames=N, pad_cams=C, mesh=mesh,
            ),
        )

    mesh = _stage_mesh(mesh, device)
    packed, auxp, n_valid = _pack_runs(runs, N, C)
    mpe = np.asarray([float(r.cam_res[0]) for r in runs])
    host = _on_mesh(mesh, _ekf_stage_host, (fps, dtype, dlc_thresh),
                    [packed, auxp, n_valid, mpe])
    return _ekf_results(runs, n_valid, mpe, host)


def _ekf_stage_host(dev, fps, dtype, dlc_thresh, packed, auxp, n_valid, mpe):
    """``ekf_stage`` on ``dev`` from host arrays, its outputs as host
    arrays (``_ekf_host``)."""

    def up(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    cfg = ekf_solver.EkfConfig(dt=1.0 / fps, dlc_thresh=dlc_thresh,
                               meas_std_px=cheetah.MEAS_STD_PX, max_pixel_err=up(mpe))
    out = ekf_stage(cfg, up(packed), up(auxp), up(n_valid, torch.int64),
                    up(ekf_P0(cheetah.N_ACTIVE)))
    return _ekf_host(out, dtype)


#: the EKF stage outputs a result keeps
EKF_KEYS = ("x", "dx", "ddx", "smoothed_x", "smoothed_dx", "smoothed_ddx", "marker_std",
            "positions")


def _ekf_host(out, dtype):
    """An EKF stage's batched outputs as host arrays (one download for the
    batch): ``EKF_KEYS`` and ``outliers``."""
    B = out["x"].shape[0]
    flat = torch.cat([out[k].reshape(B, -1) for k in EKF_KEYS]
                     + [out["outliers"].to(dtype).reshape(B, 1)], dim=1).cpu().numpy()
    host, o = {}, 0
    for k in EKF_KEYS:
        shape = out[k].shape[1:]
        size = int(np.prod(shape))
        host[k] = flat[:, o:o + size].reshape(B, *shape)
        o += size
    host["outliers"] = flat[:, o]
    return host


def _ekf_results(runs, n_valid, mpe, host):
    """One result dict per run from an EKF stage's host outputs
    (``_ekf_host``), cut to the run's length."""
    host = dict(host)
    pos_all = host.pop("positions")
    outliers = host.pop("outliers")
    results = []
    for i, run in enumerate(runs):
        n0 = n_valid[i]
        results.append(dict(
            data_dir=run.data_dir, positions=pos_all[i, :n0].astype(np.float64),
            states={k: v[i][:n0] for k, v in host.items()},
            start_frame=run.start_frame, scene_fpath=run.scene_fpath,
            max_pixel_err=float(mpe[i]), outliers=int(outliers[i]),
        ))
    return results


def ekf_warm_starts(ekf_results: Sequence[Dict]) -> List[np.ndarray]:
    """Per-run FTE initializations from batched-EKF results: the
    RTS-smoothed pose block, one (n_i, P) array per run."""
    return [np.asarray(r["states"]["smoothed_x"], np.float64) for r in ekf_results]


def _rescue_unconverged(results, label, num_iters, resolve):
    """Runs whose stationarity flag came back unconverged re-solve as
    their own batch, warm-started from their current solutions (the
    caller's ``resolve`` continues the graduated solve with robust
    weights on from iteration 0): first at 1x the budget, then the
    holdouts at 3x. The rescue batch is padded to the next power of two
    (repeats of the last failure, results discarded), as the JAX package
    does to bound its compiled shapes. Only failures are replaced; a
    rescued run can honestly remain unconverged."""
    for mult in (1, 3):
        bad = [i for i, r in enumerate(results) if not r["converged"]]
        if not bad:
            return results
        print(f"rescue: {len(bad)} unconverged {label}runs re-solved at "
              f"{mult * num_iters} iterations")
        n_pad = 1 << (len(bad) - 1).bit_length()
        bad_p = bad + [bad[-1]] * (n_pad - len(bad))
        rr = resolve(bad_p, [results[i]["x"] for i in bad_p],
                     mult * num_iters)
        for i, res in zip(bad, rr[: len(bad)]):
            results[i] = res
    return results


def resolve_warm_start(warm_start) -> bool:
    """Resolve the warm_start knob ('auto'/True/False): 'auto' is the cold
    init at every horizon (the JAX package measured the EKF init landing
    in a worse basin); truthy values force the EKF init."""
    return False if warm_start == "auto" else bool(warm_start)


# ---- generic skeletons: the same two stages for any SkeletonModel ----

def solve_stage_generic(model, cfg, packed, auxp, n_valid, dlc_thresh, X0=None, init_idx=None,
                        excl_idx=(), compute_cov=False):
    """The fused generic-skeleton FTE stage over a batch of padded runs,
    the counterpart of ``_cached_batch_solver_generic``'s ``solve_one``
    vmapped over runs (inputs as ``solve_stage``'s).

    With ``X0`` None the cold init is the straight line of marker
    ``init_idx``'s triangulated track in x, y, z over f = 0..N-1 (no yaw,
    no clamp at the last valid frame), zero angles. Weights are
    ``lik > dlc_thresh`` over ``cfg.meas_std_px`` on live frames, zero for
    the markers in ``excl_idx``. Returns (X (B, N, P), FK rows
    (B, N, R, 3), fte_solve's info)."""
    B, C, Nn, L = packed.shape[:4]
    dtype, device = packed.dtype, packed.device
    cams = _unpack_rig(auxp)
    pix, lik = packed[..., :2], packed[..., 2]
    n = torch.as_tensor(n_valid, device=device).reshape(B, 1)
    fidx = torch.arange(Nn, device=device)
    live = fidx[None] < n  # (B, N)
    thresh = float(dlc_thresh)
    keep = np.ones(L)
    keep[list(excl_idx)] = 0.0
    w = (lik > thresh).to(dtype) / cfg.meas_std_px
    w = w * torch.as_tensor(keep, dtype=dtype, device=device) * live[:, None, :, None].to(dtype)
    meas = pix.permute(0, 2, 1, 3, 4).contiguous()  # (B, N, C, L, 2)
    wT = w.permute(0, 2, 1, 3).contiguous()
    if X0 is None:
        slope, intercept = _track_linreg(pix, lik, cams, init_idx, thresh, live)
        line = fidx.to(dtype)[None, :, None] * slope[:, None] + intercept[:, None]
        X0 = torch.cat([line, torch.zeros((B, Nn, model.n_pose - 3), dtype=dtype, device=device)],
                       dim=-1)
    hj_aux = make_hj_parts_aux_generic(fk_and_jac_any(model))
    rig = tuple(a[:, None] for a in cams)  # (B, 1, C, ...): broadcast over frames
    X, info = trajopt.fte_solve(lambda x: hj_aux(x, rig), X0, meas, wT, cfg,
                                n_valid=n[:, 0], compute_cov=compute_cov, device=device)
    return X, model.fk(X), info


def solve_batch_generic(
    model,
    runs: Sequence[RunData],
    dlc_thresh: float = 0.4,
    num_iters: int = 60,
    device=None,
    dtype=torch.float32,
    init_marker: str = "forehead",
    huber_delta: float = 3.0,
    exclude_markers: Sequence[str] = ("neck",),
    X0_override: Optional[Sequence[np.ndarray]] = None,
    uncertainty: bool = False,
    rescue: bool = True,
    plain_iters: Optional[int] = None,
    warm_start="auto",
    relinearize_every: int = 1,
    max_batch: Optional[int] = MAX_PROGRAM_BATCH,
    pad_frames: Optional[int] = None,
    pad_cams: Optional[int] = None,
    _cfg_override: Optional[Dict] = None,
    mesh=None,
) -> List[Dict]:
    """Batched generic-skeleton FTE (the src/build.py path at sweep
    scale) over ``mesh``, on ``device`` or over every visible CUDA device
    (raises without CUDA when neither is given): a group of runs of any
    skeleton (same fps, ``runs[i].pixels`` in the model's marker order)
    padded and chunked as ``solve_batch`` does, with ``generic_config``.

    ``warm_start=True`` replaces the cold init by the batched generic
    EKF's smoothed poses, with ``plain_iters=4`` unless given ('auto' is
    the cold init). ``rescue`` re-solves unconverged runs from their
    solutions with robust weights from iteration 0 (1x, then 3x the
    budget). ``uncertainty`` adds ``marker_std``, ``cov_ridge_shrink``
    and ``cov_ridge_frac`` to each result. ``_cfg_override``: raw
    FteConfig fields (e.g. ``{'linear_solver': 'pallas'}``). Returns one
    dict per run: positions, x, dx, ddx, markers and the solver status."""
    fps = runs[0].fps
    N = pad_frames or max(r.pixels.shape[1] for r in runs)
    C = pad_cams or max(r.pixels.shape[0] for r in runs)
    if max_batch and len(runs) > max_batch:
        # chunk before the warm-start EKF, so that stage is bounded too
        return _solve_chunked(
            runs, max_batch,
            lambda chunk, Xc: solve_batch_generic(
                model, chunk, dlc_thresh, num_iters=num_iters, device=device,
                dtype=dtype, init_marker=init_marker,
                huber_delta=huber_delta, exclude_markers=exclude_markers,
                X0_override=Xc, uncertainty=uncertainty, rescue=rescue,
                plain_iters=plain_iters, warm_start=warm_start,
                relinearize_every=relinearize_every,
                max_batch=None, pad_frames=N, pad_cams=C,
                _cfg_override=_cfg_override, mesh=mesh,
            ),
            X0_override=X0_override,
        )
    cfg = generic_config(model, fps, num_iters=num_iters, huber_delta=huber_delta)
    if _cfg_override:
        cfg = dc_replace(cfg, **_cfg_override)
    if X0_override is None and resolve_warm_start(warm_start):
        X0_override = ekf_warm_starts(solve_batch_ekf_generic(
            model, runs, dlc_thresh, device=device, dtype=dtype, init_marker=init_marker,
            pad_frames=N, pad_cams=C, mesh=mesh,
        ))
        if plain_iters is None:
            plain_iters = 4  # the EKF init is already near the optimum and 3-sigma gated
    if plain_iters is not None:
        cfg = dc_replace(cfg, plain_iters=plain_iters)
    if relinearize_every != 1:
        cfg = dc_replace(cfg, relinearize_every=relinearize_every)

    excl_idx = tuple(sorted(model.markers.index(m) for m in (exclude_markers or ())
                            if m in model.markers))
    stage_mesh = _stage_mesh(mesh, device)
    packed, auxp, n_valid = _pack_runs(runs, N, C)
    host = _on_mesh(stage_mesh, _generic_stage_host,
                    (model, cfg, dtype, dlc_thresh, model.markers.index(init_marker), excl_idx,
                     uncertainty),
                    [packed, auxp, n_valid, _pad_X0(X0_override, N)])
    results = _stage_results(runs, n_valid, fps, host, uncertainty)
    for r in results:
        r["markers"] = list(model.markers)

    if rescue:
        results = _rescue_unconverged(
            results, "generic ", num_iters,
            lambda bad, X0s, budget: solve_batch_generic(
                model, [runs[i] for i in bad], dlc_thresh,
                num_iters=budget, device=device, dtype=dtype,
                init_marker=init_marker, huber_delta=huber_delta,
                exclude_markers=exclude_markers, X0_override=X0s,
                uncertainty=uncertainty, rescue=False,
                plain_iters=0,  # continuing a graduated solve
                relinearize_every=relinearize_every, mesh=mesh,
            ),
        )
    return results


def _generic_stage_host(dev, model, cfg, dtype, dlc_thresh, init_idx, excl_idx, uncertainty,
                        packed, auxp, n_valid, X0):
    """``solve_stage_generic`` on ``dev`` from host arrays, its outputs as
    host arrays (``_stage_host``)."""
    X, pts, info = solve_stage_generic(
        model, cfg,
        torch.as_tensor(packed, dtype=dtype, device=dev),
        torch.as_tensor(auxp, dtype=dtype, device=dev),
        torch.as_tensor(n_valid, dtype=torch.int64, device=dev),
        dlc_thresh, _tensor(X0, dtype, dev), init_idx=init_idx, excl_idx=excl_idx,
        compute_cov=uncertainty,
    )
    return _stage_host(X, pts, info, uncertainty)


def ekf_stage_generic(model, cfg, packed, auxp, n_valid, P0, qb, init_idx, smoother="auto"):
    """The fused generic-skeleton EKF stage over a batch of padded runs,
    the counterpart of ``_cached_batch_ekf_solver_generic``'s ``one``
    vmapped over runs (inputs as ``ekf_stage``'s; ``qb`` (n_pose,) the
    process std). The initial state is marker ``init_idx``'s track line:
    its intercept in x, y, z and its slope (per second) in their
    velocities, no yaw. Returns the ``run_ekf`` dict with
    ``marker_std`` and the smoothed FK rows ``positions``."""
    B, C, Nn = packed.shape[:3]
    dtype, device = packed.dtype, packed.device
    n_pose = model.n_pose
    cams = _unpack_rig(auxp)
    pix, lik = packed[..., :2], packed[..., 2]
    live = torch.arange(Nn, device=device)[None] < n_valid.reshape(B, 1)
    slope, intercept = _track_linreg(pix, lik, cams, init_idx, float(cfg.dlc_thresh), live)
    zeros = torch.zeros((B, n_pose - 3), dtype=dtype, device=device)
    x0 = torch.cat([intercept, zeros, slope * (1.0 / float(cfg.dt)), zeros,
                    torch.zeros((B, n_pose), dtype=dtype, device=device)], dim=-1)
    fkj = fk_and_jac_any(model)
    hj_aux = make_hj_parts_aux_generic(fkj)

    def hj(p):
        return assemble_hj(*hj_aux(p, cams))

    out = ekf_solver.run_ekf(hj, pix.transpose(1, 2), lik.transpose(1, 2), x0, P0, qb, cfg,
                             smoother=smoother)
    out["marker_std"] = make_marker_std_fn(fkj, n_pose)(out["smoothed_x"], out["smoothed_P"])
    out["positions"] = model.fk(out["smoothed_x"])
    return out


def solve_batch_ekf_generic(
    model,
    runs: Sequence[RunData],
    dlc_thresh: float,
    device=None,
    dtype=torch.float32,
    init_marker: str = "forehead",
    meas_std_px: float = 8.0,
    pos_process_std: float = 5.0,
    ang_process_std: float = 5.0,
    ang_prior_std: float = np.pi / 8,
    max_batch: Optional[int] = MAX_PROGRAM_BATCH,
    pad_frames: Optional[int] = None,
    pad_cams: Optional[int] = None,
    smoother: str = "auto",
    mesh=None,
) -> List[Dict]:
    """Batched EKF + RTS for any skeleton over ``mesh``, on ``device`` or
    over every visible CUDA device (raises without CUDA when neither is
    given), padded and chunked as ``solve_batch_ekf`` (the memory cap holds even at
    ``max_batch=None``). Process noise is blanket per kind: root jerk
    ``pos_process_std`` m/s^3, angle jerk ``ang_process_std`` rad/s^3,
    with the angle prior ``ang_prior_std``. The soft defaults (8 px, 5
    rad/s^3, pi/8) are the JAX package's, measured so that a float32
    filter on a 2-camera human does not diverge. ``smoother`` passes
    through to ``run_ekf``. Returns one dict per run as
    ``solve_batch_ekf``'s."""
    fps = runs[0].fps
    N = pad_frames or max(r.pixels.shape[1] for r in runs)
    C = pad_cams or max(r.pixels.shape[0] for r in runs)
    n_pose = model.n_pose
    cap = _ekf_mem_cap(N, n_pose)
    eff_max = min(max_batch, cap) if max_batch else cap
    if len(runs) > eff_max:
        return _solve_chunked(
            runs, eff_max,
            lambda chunk, _Xc: solve_batch_ekf_generic(
                model, chunk, dlc_thresh, device=device, dtype=dtype,
                init_marker=init_marker, meas_std_px=meas_std_px,
                pos_process_std=pos_process_std, ang_process_std=ang_process_std,
                ang_prior_std=ang_prior_std, max_batch=None, pad_frames=N, pad_cams=C,
                smoother=smoother, mesh=mesh,
            ),
        )

    mesh = _stage_mesh(mesh, device)
    packed, auxp, n_valid = _pack_runs(runs, N, C)
    mpe = np.asarray([float(r.cam_res[0]) for r in runs])
    qb = np.concatenate([np.full(3, pos_process_std), np.full(n_pose - 3, ang_process_std)])
    p_ang = np.ones(n_pose - 3)
    P0 = np.diag(np.concatenate([
        np.ones(3) * 9.0, p_ang * ang_prior_std**2,  # pose
        np.ones(3) * 25.0, p_ang * 9.0,              # velocity
        np.ones(3) * 9.0, p_ang * 25.0,              # acceleration
    ]))
    host = _on_mesh(mesh, _generic_ekf_stage_host,
                    (model, fps, dtype, dlc_thresh, meas_std_px, P0, qb,
                     model.markers.index(init_marker), smoother),
                    [packed, auxp, n_valid, mpe])
    return _ekf_results(runs, n_valid, mpe, host)


def _generic_ekf_stage_host(dev, model, fps, dtype, dlc_thresh, meas_std_px, P0, qb, init_idx,
                            smoother, packed, auxp, n_valid, mpe):
    """``ekf_stage_generic`` on ``dev`` from host arrays, its outputs as
    host arrays (``_ekf_host``)."""

    def up(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    cfg = ekf_solver.EkfConfig(dt=1.0 / fps, dlc_thresh=dlc_thresh, meas_std_px=meas_std_px,
                               max_pixel_err=up(mpe))
    out = ekf_stage_generic(model, cfg, up(packed), up(auxp), up(n_valid, torch.int64), up(P0),
                            qb, init_idx, smoother=smoother)
    return _ekf_host(out, dtype)


# ---- the file level: every run under a dataset root ----

def _group_by_fps(runs: Sequence[RunData]) -> Dict[float, List[RunData]]:
    groups: Dict[float, List[RunData]] = {}
    for r in runs:
        groups.setdefault(r.fps, []).append(r)
    return groups


def _uncertainty_extras(res: Dict, uncertainty: bool) -> Dict:
    if not uncertainty:
        return {}
    return {k: res[k] for k in ("marker_std", "cov_ridge_shrink", "cov_ridge_frac")}


def _save_ekf_results(ekf_results, dlc_thresh):
    for res in ekf_results:
        out_dir = os.path.join(res["data_dir"], "ekf")
        os.makedirs(out_dir, exist_ok=True)
        app.save_ekf(res["states"], out_dir, res["scene_fpath"], res["start_frame"], dlc_thresh,
                     positions=res["positions"])


def _placement(device, mesh) -> Dict:
    """The ``device`` and ``mesh`` a sweep hands its stages: only those
    the caller named, so that with neither the stages take their own
    default (a data mesh of every visible CUDA device). Raises at once
    where neither is named and no CUDA device is present."""
    if device is None and mesh is None:
        resolve_device(None)
    return {k: v for k, v in (("device", device), ("mesh", mesh)) if v is not None}


def sweep(
    root_dir: str,
    dlc_thresh: float = 0.8,
    num_iters: int = 60,
    save: bool = True,
    max_frames: Optional[int] = None,
    stages: Sequence[str] = ("fte",),
    warm_start="auto",
    relinearize_every: int = 1,
    rescue: bool = True,
    uncertainty: bool = False,
    device=None,
    mesh=None,
) -> List[Dict]:
    """Batched reconstruction of every run under ``root_dir`` (the
    reference's all_flick.sh) over ``mesh``, on ``device``, or over every
    visible CUDA device when neither is given (the batched stages'
    default), in float32 as the batched stages run. Runs are grouped by fps; each group is solved as one batch
    per requested stage ('fte' and/or 'ekf') and each run's pickles are
    written (``<run>/fte/fte.pickle``, ``<run>/ekf/ekf.pickle``).

    ``warm_start=True`` starts the FTE from the batched EKF's smoothed
    poses (the EKF then runs even when 'ekf' is not in ``stages``);
    'auto' is the cold start. ``rescue`` re-solves the runs whose
    stationarity test failed (``_rescue_unconverged``). Returns the FTE
    results (or, without 'fte', the EKF results) of every run."""
    place = _placement(device, mesh)
    run_dirs = discover_runs(root_dir)
    print(f"Found {len(run_dirs)} runs under {root_dir}")
    runs = [load_run(d, end_frame=(max_frames or -1)) for d in run_dirs]

    all_results = []
    for fps, group in _group_by_fps(runs).items():
        warm = resolve_warm_start(warm_start)
        ekf_results = None
        if "ekf" in stages or (warm and "fte" in stages):
            print(f"EKF: {len(group)} runs @ {fps} fps as one batch")
            ekf_results = solve_batch_ekf(group, dlc_thresh, **place)
            if save and "ekf" in stages:
                _save_ekf_results(ekf_results, dlc_thresh)
            if "fte" not in stages:
                all_results.extend(ekf_results)
        if "fte" not in stages:
            continue
        print(f"FTE: {len(group)} runs @ {fps} fps as one batch"
              + (" (EKF warm start)" if warm else ""))
        results = solve_batch(
            group, dlc_thresh, num_iters=num_iters, **place,
            X0_override=ekf_warm_starts(ekf_results) if warm else None,
            relinearize_every=relinearize_every,
            # the EKF init is already near the optimum and 3-sigma gated:
            # the redescending weights switch on almost at once
            plain_iters=(4 if warm else None),
            uncertainty=uncertainty,
        )
        if rescue:
            results = _rescue_unconverged(
                results, "", num_iters,
                lambda bad, X0s, budget: solve_batch(
                    [group[i] for i in bad], dlc_thresh, num_iters=budget, **place,
                    X0_override=X0s, relinearize_every=relinearize_every,
                    plain_iters=0,  # continuing a graduated solve
                    uncertainty=uncertainty,
                ),
            )
        all_results.extend(results)
        if save:
            for res in results:
                out_dir = os.path.join(res["data_dir"], "fte")
                os.makedirs(out_dir, exist_ok=True)
                app.save_optimised_cheetah(
                    res["positions"], os.path.join(out_dir, "fte.pickle"),
                    extra_data=dict(
                        x=res["x"], dx=res["dx"], ddx=res["ddx"],
                        start_frame=res["start_frame"],
                        cost=res["cost"], cost0=res["cost0"],
                        converged=res["converged"], grad_norm=res["grad_norm"],
                        **_uncertainty_extras(res, uncertainty),
                    ),
                )
    return all_results


def sweep_generic(
    root_dir: str,
    skeleton_fpath: str,
    dlc_thresh: float = 0.4,
    num_iters: int = 60,
    save: bool = True,
    max_frames: Optional[int] = None,
    warm_start="auto",
    rescue: bool = True,
    uncertainty: bool = False,
    init_marker: str = "forehead",
    stages: Sequence[str] = ("fte",),
    relinearize_every: int = 1,
    device=None,
    mesh=None,
) -> List[Dict]:
    """``sweep`` for any skeleton pickle (the src/build.py model family)
    over ``mesh``, on ``device``, or over every visible CUDA device when
    neither is given, in float32: 'fte' through
    ``solve_batch_generic`` writes ``<run>/fte/traj_results.pickle`` in
    build.py's result schema (src/build.py:344-378) with the solver
    status; 'ekf' through ``solve_batch_ekf_generic`` writes
    ``<run>/ekf/ekf.pickle``."""
    from ..models.skeleton import build_skeleton_model

    place = _placement(device, mesh)
    model = build_skeleton_model(data_io.load_skeleton(skeleton_fpath))
    run_dirs = discover_runs(root_dir)
    print(f"Found {len(run_dirs)} runs under {root_dir}")
    runs = [load_run(d, end_frame=(max_frames or -1), markers=model.markers) for d in run_dirs]

    all_results = []
    for fps, group in _group_by_fps(runs).items():
        # one EKF solve per group, shared by the ekf output and the FTE's
        # warm start
        warm = resolve_warm_start(warm_start)
        ekf_results = None
        if "ekf" in stages or (warm and "fte" in stages):
            print(f"generic EKF: {len(group)} runs @ {fps} fps as one batch")
            ekf_results = solve_batch_ekf_generic(model, group, dlc_thresh, **place,
                                                  init_marker=init_marker)
            if save and "ekf" in stages:
                _save_ekf_results(ekf_results, dlc_thresh)
            if "fte" not in stages:
                all_results.extend(ekf_results)
        if "fte" not in stages:
            continue
        print(f"generic FTE: {len(group)} runs @ {fps} fps as one batch"
              + (" (EKF warm start)" if warm else ""))
        results = solve_batch_generic(
            model, group, dlc_thresh, num_iters=num_iters, **place,
            warm_start=False,
            X0_override=(ekf_warm_starts(ekf_results) if warm else None),
            plain_iters=(4 if warm else None),
            rescue=rescue, uncertainty=uncertainty,
            init_marker=init_marker, relinearize_every=relinearize_every,
        )
        all_results.extend(results)
        if save:
            for res in results:
                data_io.save_pickle(
                    os.path.join(res["data_dir"], "fte", "traj_results.pickle"),
                    dict(
                        positions=res["positions"], x=res["x"], dx=res["dx"], ddx=res["ddx"],
                        markers=res["markers"], start_frame=res["start_frame"],
                        scene_fpath=res["scene_fpath"],
                        cost=res["cost"], cost0=res["cost0"],
                        converged=res["converged"], grad_norm=res["grad_norm"],
                        **_uncertainty_extras(res, uncertainty),
                    ),
                )
    return all_results
