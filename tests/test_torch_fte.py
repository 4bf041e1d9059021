"""The port's batched FTE solve and pipeline against the JAX package.

One batch of B=3 small synthetic runs (N=16 frames, C=2 cameras, the
size of __graft_entry__._tiny_problem), each with its own X0 and pixel
noise, the last padded to 12 valid frames, goes through the port's
natively batched ``fte_solve`` and, run by run, through the JAX
``fte_solve`` in float64 on the CPU.
"""
from dataclasses import asdict, replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.solvers import trajopt as jtraj
from acinoset_tpu.utils import synthetic as jsyn
from acinoset_tpu_torch import convert
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.pipeline import fte as tfte
from acinoset_tpu_torch.solvers import trajopt as ttraj
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
B, N, N_PAD = 3, 16, 12


@pytest.fixture(scope="module")
def batch():
    cams = jsyn.ring_cameras(n_cams=2)
    k, d, r, t, _res = cams
    X = jsyn.cheetah_gallop(N=N)
    px, lik, _ = jsyn.render_measurements(X, cams, noise_px=1.5, outlier_frac=0.02,
                                          bad_lik_frac=0.05, seed=3)
    X0 = jfte.initial_trajectory(px, lik, k, d, r, t, np.arange(N), 0.5)
    meas = px.transpose(1, 0, 2, 3)
    w = (lik.transpose(1, 0, 2) > 0.5) / 5.0
    rng = np.random.default_rng(5)
    X0b = np.stack([X0 + rng.normal(scale=1e-2, size=X0.shape) for _ in range(B)])
    measb = np.stack([meas + rng.normal(scale=0.5, size=meas.shape) for _ in range(B)])
    wb = np.stack([w] * B)
    wb[-1, N_PAD:] = 0.0  # padded frames carry no measurement
    nv = np.array([N] * (B - 1) + [N_PAD])
    return (k, d, r, t), X0b, measb, wb, nv


def _cfg(solver, **kw):
    return replace(jfte.default_config(90.0, num_iters=4), linear_solver=solver,
                   plain_iters=2, **kw)


def _jax_runs(batch, cfg):
    rig, X0b, measb, wb, nv = batch
    h, hjp = jekf.make_h_fn(*rig), jekf.make_hj_parts_fn(*rig)
    solve = jax.jit(lambda x, m, w, n: jtraj.fte_solve(h, x, m, w, cfg, hj_parts_fn=hjp, n_valid=n))
    return [solve(jnp.asarray(X0b[i]), jnp.asarray(measb[i]), jnp.asarray(wb[i]), nv[i])
            for i in range(B)]


def _port(batch, cfg):
    rig, X0b, measb, wb, nv = batch
    hjp = tekf.make_hj_parts_fn(*rig, torch.float64, "cpu")
    return ttraj.fte_solve(hjp, torch.tensor(X0b), measb, wb,
                           convert.fte_config_from_dict(asdict(cfg)), n_valid=nv, device="cpu")


@pytest.fixture(scope="module")
def jax_chol(batch):
    return _jax_runs(batch, _cfg("chol_unrolled"))


@pytest.mark.parametrize("solver", ["chol_unrolled", "pallas"])
def test_batched_fte_solve_matches_per_run_jax(batch, jax_chol, solver):
    """'chol_unrolled' and 'pallas' (its plain version on CPU tensors) are
    the same exact banded factorisation: held per iterate to the JAX
    'chol_unrolled' solve (the JAX Pallas kernel computes in float32
    whatever its input dtype, so it is no float64 reference)."""
    X, info = _port(batch, _cfg(solver))
    for i, (Xj, ij) in enumerate(jax_chol):
        np.testing.assert_allclose(X[i].numpy(), np.asarray(Xj), atol=1e-5)
        for key in ("cost", "cost0", "cost_history", "lam", "grad_norm"):
            np.testing.assert_allclose(info[key][i].numpy(), np.asarray(ij[key]), rtol=1e-6)
        assert bool(info["converged"][i]) == bool(ij["converged"])
    # padded frames have neither measurement nor model coupling: untouched
    X0b = batch[1]
    lo, hi = (np.asarray(v) for v in (_cfg(solver).lo, _cfg(solver).hi))
    np.testing.assert_allclose(X[-1, N_PAD:].numpy(), np.clip(X0b[-1, N_PAD:], lo, hi), atol=1e-12)


def test_batched_fte_solve_pcg_matches_jax_within_rounding_spread(batch):
    """PCG's cost, iteration by iteration, against JAX at rtol 1e-6: the
    two plain iterations of every run (at most 2.7e-13 apart here) and
    runs 0 and 2 throughout (at most 6.1e-11 apart). Run 1 from its first
    robust iteration on is rounding-chaotic in both packages: 16 CG
    iterations stall near a 1e-4 residual ratio on that IRLS-weighted
    system, and nudging X0 by 1e-15 or 1e-14 relative moves JAX's own
    final cost by up to 1.61e-3 relative and the port's by 1.23e-3 (the
    two packages read 6.7e-5 apart). There the bound is a fixed 5e-3. A
    wrong PCG reads outside these bounds: one CG iteration fewer moves
    the costs of runs 0 and 2 by up to 1.6e-3 and run 1's second plain
    iteration by 2.3e-5, and a preconditioner without the frame-local
    diagonal moves every cost by 2e-2 to 0.27."""
    cfg = _cfg("pcg")
    jax_out = _jax_runs(batch, cfg)
    _X, info = _port(batch, cfg)
    rtol = np.full((B, cfg.num_iters), 1e-6)
    rtol[1, cfg.plain_iters:] = 5e-3
    for i, (_Xj, ij) in enumerate(jax_out):
        hist, hist_j = info["cost_history"][i].numpy(), np.asarray(ij["cost_history"])
        assert np.all(np.abs(hist - hist_j) <= rtol[i] * np.abs(hist_j)), (i, hist, hist_j)
        cj = float(ij["cost"])
        assert abs(float(info["cost"][i]) - cj) <= rtol[i, -1] * abs(cj), (i, info["cost"][i], cj)
        np.testing.assert_allclose(info["cost0"][i].numpy(), np.asarray(ij["cost0"]), rtol=1e-12)


def test_fte_objective_matches_jax(batch):
    rig, X0b, measb, wb, _nv = batch
    cfg = _cfg("pcg")
    h_t = tekf.make_h_fn(*rig, device="cpu")
    obj = ttraj.fte_objective(torch.tensor(X0b), h_t, torch.tensor(measb), torch.tensor(wb),
                              convert.fte_config_from_dict(asdict(cfg)))
    h_j = jekf.make_h_fn(*rig)
    for i in range(B):
        oj = jtraj.fte_objective(jnp.asarray(X0b[i]), h_j, jnp.asarray(measb[i]), jnp.asarray(wb[i]), cfg)
        np.testing.assert_allclose(float(obj[i]), float(oj), rtol=1e-12)


def test_third_difference_adjoint_grams_and_derivatives_match_jax():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(20, 4))
    v = rng.normal(size=(17, 4))
    Ts = 0.01
    np.testing.assert_allclose(ttraj.third_difference(torch.tensor(X), Ts).numpy(),
                               np.asarray(jtraj.third_difference(jnp.asarray(X), Ts)), rtol=1e-12)
    np.testing.assert_allclose(ttraj._d3_correlate(torch.tensor(v), Ts).numpy(),
                               np.asarray(jtraj._d3_correlate(jnp.asarray(v), Ts)), rtol=1e-12)
    np.testing.assert_array_equal(ttraj._d3_gram_bands(20, Ts), jtraj._d3_gram_bands(20, Ts))
    for a, b in zip(ttraj.derivatives_from_trajectory(torch.tensor(X), Ts),
                    jtraj.derivatives_from_trajectory(jnp.asarray(X), Ts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("n_cams,N,seed", [(2, 16, 3), (6, 24, 0)])
def test_synthetic_data_equal_jax(n_cams, N, seed):
    cams_t, cams_j = tsyn.ring_cameras(n_cams), jsyn.ring_cameras(n_cams)
    for a, b in zip(cams_t, cams_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    X = tsyn.cheetah_gallop(N=N)
    np.testing.assert_array_equal(X, jsyn.cheetah_gallop(N=N))
    out_t = tsyn.render_measurements(X, cams_t, noise_px=1.5, outlier_frac=0.02, bad_lik_frac=0.05,
                                     seed=seed)
    out_j = jsyn.render_measurements(X, cams_j, noise_px=1.5, outlier_frac=0.02, bad_lik_frac=0.05,
                                     seed=seed)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-12, atol=1e-9)  # pixels
    np.testing.assert_array_equal(out_t[1], out_j[1])  # likelihood
    np.testing.assert_allclose(out_t[2], out_j[2], rtol=1e-12, atol=1e-12)  # pts3d


def test_initial_trajectory_batch_matches_jax():
    cams = jsyn.ring_cameras(n_cams=3)
    k, d, r, t, _res = cams
    runs = [jsyn.render_measurements(jsyn.cheetah_gallop(N=12), cams, seed=s)[:2] for s in (1, 2)]
    px = np.stack([p for p, _ in runs])
    lik = np.stack([lk for _, lk in runs])
    aux = [np.stack([a, a]) for a in (k, d.reshape(-1, 4), r, t.reshape(-1, 3))]
    frames = np.arange(12)
    got = tfte.initial_trajectory_batch(px, lik, aux, frames, 0.5, device="cpu")
    want = jfte.initial_trajectory_batch(px, lik, aux, frames, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)


def test_fte_run_reproduces_golden_fixture():
    """The port's fte_run (default config: pcg, float64) on the golden
    fixture's input, with tests/test_golden.py's tolerances."""
    import os

    cams = tsyn.ring_cameras(n_cams=4)
    k, d, r, t, _res = cams
    X = tsyn.cheetah_gallop(N=30, fps=90.0)
    pixels, likelihood, _ = tsyn.render_measurements(
        X, cams, noise_px=1.0, outlier_frac=0.01, bad_lik_frac=0.02, seed=11)
    out = tfte.fte_run(pixels, likelihood, k, d, r, t, fps=90.0, dlc_thresh=0.5, num_iters=40,
                       device="cpu")
    ref = np.load(os.path.join(os.path.dirname(__file__), "golden", "fte_synthetic_n30.npz"))
    np.testing.assert_allclose(out["positions"], ref["positions"], atol=5e-4)
    assert abs(out["cost"] - float(ref["cost"])) < 0.001 * float(ref["cost"]) + 1.0
    assert out["converged"]


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(assembly="mxu"), ValueError),
        (dict(linear_solver="lu"), ValueError),
    ],
)
def test_unported_options_raise(batch, change, error):
    """Option values that neither package has raise (every option of the
    JAX FteConfig is ported: tests/test_torch_fte_forms.py)."""
    rig, X0b, measb, wb, _nv = batch
    cfg = replace(convert.fte_config_from_dict(asdict(_cfg("pcg"))), **change)
    with pytest.raises(error):
        ttraj.fte_solve(tekf.make_hj_parts_fn(*rig, device="cpu"), X0b, measb, wb, cfg, device="cpu")

