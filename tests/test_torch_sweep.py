"""The port's sweep stage (acinoset_tpu_torch.pipeline.sweep) against the
JAX package's (acinoset_tpu.pipeline.sweep), in float64 on the CPU.

Five ragged synthetic runs (N 16..24 frames, 3 cameras, two rigs of
different radius) go through both packages: the run padding, the nose
track's line fit, the fused batched stage, ``solve_batch`` end to end,
its chunking and the rescue policy.
"""
from dataclasses import asdict, replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch import convert
from acinoset_tpu_torch.pipeline import sweep as tsweep
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
LENGTHS = (16, 20, 24, 18, 22)
THRESH = 0.5


def _runs(module, lengths=LENGTHS, n_cams=3, radii=(10.0, 13.0), seed0=0):
    out = []
    for i, n in enumerate(lengths):
        cams = tsyn.ring_cameras(n_cams=n_cams, radius=radii[i % len(radii)])
        k, d, r, t, _res = cams
        px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=n), cams, noise_px=1.5,
                                              outlier_frac=0.02, bad_lik_frac=0.05, seed=seed0 + i)
        out.append(module.RunData(
            data_dir=f"run_{i}", pixels=px, likelihood=lik,
            cams=(k, d.reshape(-1, 4), r, t.reshape(-1, 3)), fps=90.0, start_frame=0,
            scene_fpath="",
        ))
    return out


def _packed(runs, N, C):
    """The packed stage inputs of both packages, as solve_batch builds them."""
    packed, auxp, nv = [], [], []
    for run in runs:
        pix, lik, (K, D, R, T), n0 = tsweep._pad_run(run, N, C)
        packed.append(np.concatenate([pix, lik[..., None]], axis=-1))
        auxp.append(np.concatenate([K.reshape(C, 9), D.reshape(C, 4), R.reshape(C, 9),
                                    T.reshape(C, 3)], axis=1))
        nv.append(n0)
    return np.stack(packed), np.stack(auxp), np.asarray(nv)


@pytest.mark.parametrize("N,C", [(24, 3), (30, 4)])
def test_pad_run_matches_jax(N, C):
    for rt, rj in zip(_runs(tsweep), _runs(jsweep)):
        got, want = tsweep._pad_run(rt, N, C), jsweep._pad_run(rj, N, C)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]


def test_track_linreg_matches_jax():
    """Per run, padded frames masked out; run 1's nose is seen by both
    cameras of a pair in one frame only (the <2-point fallback to the
    track mean) and run 3's in none."""
    runs = _runs(tsweep)
    nose = tsweep.cheetah.get_markers().index("nose")
    runs[1].likelihood[:, 1:, nose] = 0.1
    runs[3].likelihood[:, :, nose] = 0.1
    packed, auxp, nv = _packed(runs, 24, 3)
    live = np.arange(24)[None] < nv[:, None]
    cams_t = tsweep._unpack_rig(torch.tensor(auxp))
    slope, intercept = tsweep._track_linreg(torch.tensor(packed[..., :2]),
                                            torch.tensor(packed[..., 2]), cams_t, nose, THRESH,
                                            torch.tensor(live))
    for i in range(len(runs)):
        a = jnp.asarray(auxp[i])
        cams_j = (a[:, :9].reshape(-1, 3, 3), a[:, 9:13], a[:, 13:22].reshape(-1, 3, 3),
                  a[:, 22:25])
        sj, ij = jsweep._jit_track_linreg(jnp.asarray(packed[i, ..., :2]),
                                          jnp.asarray(packed[i, ..., 2]), cams_j, nose, THRESH,
                                          jnp.asarray(live[i]))
        np.testing.assert_allclose(slope[i].numpy(), np.asarray(sj), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(intercept[i].numpy(), np.asarray(ij), rtol=1e-10, atol=1e-10)
    assert float(slope[3].abs().max()) == 0.0  # no point: the fallback


def _stage_cfg():
    return replace(jfte.default_config(90.0, num_iters=4), linear_solver="chol_unrolled",
                   plain_iters=2)


@pytest.mark.parametrize("with_init", [True, False])
def test_solve_stage_matches_jax_batch_solver(with_init):
    """The fused stage against the JAX package's jitted batch program
    (``_cached_batch_solver``), 'chol_unrolled' (exact banded Cholesky):
    X at 1e-5, cost at 1e-6 per run, as tests/test_torch_fte.py holds
    fte_solve."""
    N, C = 24, 3
    runs = _runs(tsweep)
    packed, auxp, nv = _packed(runs, N, C)
    cfg = _stage_cfg()
    rng = np.random.default_rng(7)
    X0 = np.stack([np.concatenate([tsyn.cheetah_gallop(N=n), np.repeat(
        tsyn.cheetah_gallop(N=n)[-1:], N - n, axis=0)]) for n in nv])
    X0 = X0 + rng.normal(scale=1e-2, size=X0.shape)
    solver = jsweep._cached_batch_solver(cfg, jnp.float64, with_init=with_init, dlc_thresh=THRESH)
    args = [jnp.asarray(packed), jnp.asarray(auxp), jnp.asarray(nv, jnp.int32)]
    if not with_init:
        args.insert(1, jnp.asarray(X0))
    flat = np.asarray(solver(*args))
    B, P, L = len(runs), 25, 20
    Xj = flat[:, :N * P].reshape(B, N, P)
    pos_j = flat[:, N * P:N * P + N * L * 3].reshape(B, N, L, 3)
    stat = flat[:, N * P + N * L * 3:]
    X, pos, info = tsweep.solve_stage(
        convert.fte_config_from_dict(asdict(cfg)), torch.tensor(packed), torch.tensor(auxp),
        torch.tensor(nv), THRESH, None if with_init else torch.tensor(X0))
    np.testing.assert_allclose(X.numpy(), Xj, atol=1e-5)
    np.testing.assert_allclose(pos.numpy(), pos_j, atol=1e-5)
    np.testing.assert_allclose(info["cost"].numpy(), stat[:, 0], rtol=1e-6)
    np.testing.assert_allclose(info["cost0"].numpy(), stat[:, 1], rtol=1e-10)
    np.testing.assert_array_equal(info["converged"].numpy(), stat[:, 2] > 0.5)


#: solve_batch end to end with the default 'pcg' (4 GN iterations, 2
#: plain): bounds on |cost_port - cost_jax| / cost_jax, per run, fixed
#: from the measured rounding spread. Runs 0 and 3 read 1.1e-14 and
#: 4.2e-10 apart, and pixel nudges of 1e-15..1e-14 relative move either
#: package's cost by at most 2.7e-10 there: 1e-8. Runs 1, 2 and 4 are
#: rounding-chaotic in both packages (16 CG iterations on IRLS-weighted
#: systems): the same nudges move JAX's own cost by up to 1.3e-3 and the
#: port's by up to 7.7e-4, and the two read up to 6.3e-4 apart: 5e-3, the
#: bound tests/test_torch_fte.py holds the chaotic run of fte_solve to.
PCG_COST_RTOL = (1e-8, 5e-3, 5e-3, 1e-8, 5e-3)
PCG_COST0_RTOL = 1e-10


@pytest.fixture(scope="module")
def pcg_pair():
    kw = dict(num_iters=4, plain_iters=2)
    got = tsweep.solve_batch(_runs(tsweep), THRESH, device="cpu", dtype=torch.float64, **kw)
    want = jsweep.solve_batch(_runs(jsweep), THRESH, dtype=jnp.float64, **kw)
    return got, want


def test_solve_batch_pcg_matches_jax(pcg_pair):
    got, want = pcg_pair
    assert len(got) == len(want) == len(LENGTHS)
    for rt, rj, rtol in zip(got, want, PCG_COST_RTOL):
        assert set(rt) == set(rj)
        assert rt["data_dir"] == rj["data_dir"] and rt["x"].shape == rj["x"].shape
        assert abs(rt["cost0"] - rj["cost0"]) <= PCG_COST0_RTOL * abs(rj["cost0"])
        assert abs(rt["cost"] - rj["cost"]) <= rtol * abs(rj["cost"]), (
            rt["data_dir"], rt["cost"], rj["cost"])
        assert rt["converged"] == rj["converged"]


def test_solve_batch_results_are_per_run_and_derived(pcg_pair):
    """Each result is cut to its run's length, its positions are the FK of
    its x, and dx/ddx are the JAX package's host-side differences."""
    got, want = pcg_pair
    for rt, rj, n in zip(got, want, LENGTHS):
        assert rt["positions"].shape == (n, 20, 3) and rt["x"].shape == (n, 25)
        fk = tsweep.cheetah.fk25(torch.tensor(rt["x"])).numpy()
        np.testing.assert_allclose(rt["positions"], fk, atol=1e-12)
        Ts = 1.0 / 90.0
        dx = np.diff(rt["x"], axis=0) / Ts
        np.testing.assert_allclose(rt["dx"], np.concatenate([dx[:1], dx]), rtol=1e-12)
        assert rt["ddx"].shape == rj["ddx"].shape


def _small_runs(n_runs, N=16):
    """Many small runs sharing one 2-camera rig, as the JAX package's
    chunking test builds them."""
    cams = tsyn.ring_cameras(n_cams=2)
    k, d, r, t, _res = cams
    rng = np.random.default_rng(0)
    runs = []
    for ri in range(n_runs):
        px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=N), cams, noise_px=1.0,
                                               outlier_frac=0.0, bad_lik_frac=0.0,
                                               seed=int(rng.integers(1 << 30)))
        runs.append(tsweep.RunData(f"chunk_run_{ri}", px, lik,
                                   (k, d.reshape(-1, 4), r, t.reshape(-1, 3)), 90.0, 0, ""))
    return runs


def test_solve_batch_chunked_matches_unchunked():
    """7 runs in chunks of 3 (3, 3, and 1 padded to 3): equal to solving
    each padded chunk by hand, bit for bit, with and without per-run
    X0_override; the same optima as the unchunked 7-run batch at cost
    level (2e-2, the JAX package's bound for the same comparison)."""
    runs = _small_runs(7)
    kw = dict(num_iters=3, plain_iters=1, device="cpu", dtype=torch.float64)
    chunked = tsweep.solve_batch(runs, THRESH, max_batch=3, **kw)
    assert len(chunked) == 7

    def manual(X0s=None):
        out = []
        for lo in range(0, 7, 3):
            chunk, Xc = runs[lo:lo + 3], (X0s[lo:lo + 3] if X0s is not None else None)
            if len(chunk) < 3:
                chunk = chunk + [chunk[-1]] * (3 - len(chunk))
                Xc = Xc + [Xc[-1]] * (3 - len(Xc)) if Xc is not None else None
            out.extend(tsweep.solve_batch(chunk, THRESH, max_batch=None, X0_override=Xc,
                                          **kw)[:len(runs[lo:lo + 3])])
        return out

    for rc, rm in zip(chunked, manual()):
        np.testing.assert_array_equal(rc["x"], rm["x"])
        assert rc["converged"] == rm["converged"]
    full = tsweep.solve_batch(runs, THRESH, max_batch=None, **kw)
    for rc, rf in zip(chunked, full):
        assert abs(rc["cost"] - rf["cost"]) <= 2e-2 * abs(rf["cost"])
    X0s = [r["x"] + 1e-3 * (i + 1) for i, r in enumerate(full)]
    warm = tsweep.solve_batch(runs, THRESH, max_batch=3, X0_override=X0s, **kw)
    for rw, rm in zip(warm, manual(X0s)):
        np.testing.assert_array_equal(rw["x"], rm["x"])


def _rescue_log(module, converged, num_iters=5):
    """Run a package's _rescue_unconverged with a recording stub resolve
    that converges only what it re-solves at 3x the budget, or at 1x
    for even run indices."""
    results = [dict(converged=c, x=np.full((3, 2), float(i)), tag="initial")
               for i, c in enumerate(converged)]
    log = []

    def resolve(bad, X0s, budget):
        log.append((list(bad), [float(x[0, 0]) for x in X0s], budget))
        return [dict(converged=(budget == 3 * num_iters or i % 2 == 0),
                     x=np.full((3, 2), float(i)), tag=f"rescued@{budget}") for i in bad]

    out = module._rescue_unconverged(results, "", num_iters, resolve)
    return log, [(r["converged"], r["tag"]) for r in out]


@pytest.mark.parametrize("converged", [
    [True, False, False, True, False, False, True],
    [True, True],
    [False],
])
def test_rescue_unconverged_matches_jax(converged):
    assert _rescue_log(tsweep, converged) == _rescue_log(jsweep, converged)


def test_warm_start_helpers_match_jax():
    ekf = [dict(states=dict(smoothed_x=np.arange(6.0).reshape(3, 2) * (i + 1))) for i in range(2)]
    for a, b in zip(tsweep.ekf_warm_starts(ekf), jsweep.ekf_warm_starts(ekf)):
        np.testing.assert_array_equal(a, b)
    for v in ("auto", True, False, 1, 0):
        assert tsweep.resolve_warm_start(v) is jsweep.resolve_warm_start(v)

