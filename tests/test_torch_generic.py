"""The port's generic-skeleton slice (acinoset_tpu_torch.pipeline.generic
and the generic stages of pipeline.sweep) against the JAX package's, in
float64 on the CPU, on skeletons built in tests/test_torch_skeleton.py
and measurements rendered there through the JAX FK (nothing is read
from disk).

Tolerances, each with its reason:
  * measurement functions and their Jacobians: 1e-12 absolute on pixels
    of order 1e3 (closed forms of the same arithmetic; they agree to
    ~1e-13);
  * one run (``fte_generic_run``, N=30, 4 cameras, 30 iterations): x at
    1e-8, cost at 1e-10 relative, ``converged`` equal: the 'chol_unrolled'
    GN solve is direct, not chaotic, and reads ~2e-12 apart;
  * the batch (``solve_batch_generic``, runs of 40/32/24 frames): per-run
    cost at 1e-8 relative and x at 1e-6 (the batch is padded, so its
    rounding differs from a run alone; measured ~1e-11 and ~2e-9),
    ``converged`` equal; ``marker_std`` at 1e-4 of its scale, the
    posterior's tolerance (tests/test_torch_uncertainty.py: the
    recurrence's own rounding on near-floppy pose directions);
  * the EKF (``solve_batch_ekf_generic``): 1e-9 of each key's scale with
    rtol 1e-8 (tests/test_torch_ekf.py's rule: the filter carries rounding
    from frame to frame), ``outliers`` equal.
"""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acinoset_tpu.models.skeleton import fk_and_jac_any as jax_fk_and_jac_any
from acinoset_tpu.pipeline import generic as jgen
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch import convert
from acinoset_tpu_torch.models import skeleton as tsk
from acinoset_tpu_torch.pipeline import generic as tgen
from acinoset_tpu_torch.pipeline import sweep as tsweep
from acinoset_tpu_torch.utils import synthetic as tsyn
from test_torch_skeleton import SKELETONS, build_pair, render_runs

torch.set_num_threads(2)
THRESH = 0.5
LENGTHS = (40, 32, 24)
#: tree and dag: one solve each; init marker per skeleton
INIT = {"tree": "root", "dag": "forehead", "reordered": "base", "cheetah": "nose"}


def _rig(n_cams=4):
    """A ring rig as (K (C, 3, 3), D (C, 4), R (C, 3, 3), T (C, 3))."""
    k, d, r, t, _res = tsyn.ring_cameras(n_cams=n_cams)
    return k, d.reshape(n_cams, 4), r, t.reshape(n_cams, 3)


def _pixels_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-12)


# ---- measurement pieces and the config ----

@pytest.mark.parametrize("name,compat", [("tree", "tpu"), ("dag", "tpu"), ("cheetah", "tpu"),
                                         ("reordered", "reference")])
def test_measurement_functions_match_jax(name, compat):
    """``make_h_fn_generic`` and ``make_hj_parts_fn_generic`` against JAX's
    on one pose, and their ``_aux_`` twins on poses (B, N) with per-run
    rigs (B, 1, C, ...), against JAX's on each pose."""
    mj, mt = build_pair(name, compat)
    rig = _rig()
    rng = np.random.default_rng(3)
    x = rng.normal(scale=0.3, size=(2, 3, mj.n_pose))
    x[..., 2] += 0.6
    h_j = jgen.make_h_fn_generic(mj, *rig)(jnp.asarray(x[0, 0]))
    _pixels_close(tgen.make_h_fn_generic(mt, *rig, device="cpu")(torch.tensor(x[0, 0])), h_j)
    for a, b in zip(tgen.make_hj_parts_fn_generic(mt, *rig, device="cpu")(torch.tensor(x[0, 0])),
                    jgen.make_hj_parts_fn_generic(mj, *rig)(jnp.asarray(x[0, 0]))):
        _pixels_close(a, b)

    rigs = [_rig(), tuple(a.copy() for a in _rig())]
    rigs[1][3][:, 0] += 0.5  # the second run's rig is moved
    aux_t = tuple(torch.tensor(np.stack([rg[i] for rg in rigs]))[:, None] for i in range(4))
    h_t = tsweep.make_h_fn_aux_generic(mt.fk)(torch.tensor(x), aux_t)
    hj_t = tsweep.make_hj_parts_aux_generic(tsk.fk_and_jac_any(mt))(torch.tensor(x), aux_t)
    h_aux_j = jsweep.make_h_fn_aux_generic(mj.fk)
    hj_aux_j = jsweep.make_hj_parts_aux_generic(jax_fk_and_jac_any(mj))
    for b in range(2):
        aux_j = tuple(jnp.asarray(a) for a in rigs[b])
        for n in range(3):
            xn = jnp.asarray(x[b, n])
            _pixels_close(h_t[b, n], h_aux_j(xn, aux_j))
            for a, w in zip(hj_t, hj_aux_j(xn, aux_j)):
                _pixels_close(a[b, n], w)


@pytest.mark.parametrize("kw", [{}, dict(num_iters=7, huber_delta=0.3, meas_std_px=2.0,
                                         model_err_weight=0.01)])
def test_generic_config_matches_jax(kw):
    """The port's config equals the JAX config carried across by
    ``convert.fte_config_from_dict``: weight 0.002 (q_var 500), +-inf at
    the root and +-pi/2 elsewhere, the 'l1' loss, the JAX default solver."""
    mj, mt = build_pair("dag")
    got = tgen.generic_config(mt, 90.0, **kw)
    assert got == convert.fte_config_from_dict(asdict(jgen.generic_config(mj, 90.0, **kw)))
    assert got.meas_loss == "l1" and got.linear_solver == "chol_unrolled"
    if not kw:
        assert set(got.q_var) == {500.0}


# ---- one run ----

@pytest.mark.parametrize("name,compat", [("tree", "tpu"), ("dag", "tpu"),
                                         ("reordered", "reference")])
def test_fte_generic_run_matches_jax(name, compat):
    """One run (N=30, 4 cameras, 30 iterations; the dag's 'neck' excluded
    by default): x at 1e-8, cost at 1e-10 relative, converged equal."""
    runs, _truth = render_runs(jsweep, name, (30,), compat=compat)
    run = runs[0]
    k, d, r, t = run.cams
    kw = dict(fps=90.0, dlc_thresh=THRESH, init_marker=INIT[name], num_iters=30, compat=compat)
    sd = SKELETONS[name][0]
    want = jgen.fte_generic_run(sd, run.pixels, run.likelihood, k, d, r, t, **kw)
    got = tgen.fte_generic_run(sd, run.pixels, run.likelihood, k, d, r, t, device="cpu", **kw)
    assert set(got) == set(want) and got["markers"] == want["markers"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["positions"], want["positions"], rtol=0, atol=1e-8)
    for key in ("dx", "ddx"):  # differences of x over Ts = 1/90 and its square
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-8 * 90.0 ** (1 + (key == "ddx")) * 4)
    for key in ("cost", "cost0"):
        assert abs(got[key] - want[key]) <= 1e-10 * abs(want[key]), (key, got[key], want[key])
    assert got["converged"] == want["converged"]
    assert got["cost"] < got["cost0"]


# ---- the batch ----

def _batch_kw(name, kw):
    return dict(dlc_thresh=THRESH, num_iters=kw.pop("num_iters", 30), init_marker=INIT[name],
                **kw)


def _port_batch(name, **kw):
    _mj, mt = build_pair(name)
    return tsweep.solve_batch_generic(mt, render_runs(tsweep, name, LENGTHS)[0], device="cpu",
                                      dtype=torch.float64, **_batch_kw(name, kw))


def _batch(name, **kw):
    """solve_batch_generic on three ragged runs in both packages."""
    mj, _mt = build_pair(name)
    want = jsweep.solve_batch_generic(mj, render_runs(jsweep, name, LENGTHS)[0],
                                      dtype=jnp.float64, **_batch_kw(name, dict(kw)))
    return _port_batch(name, **kw), want


def _assert_batch_close(got, want, x_tol=1e-6, cost_rtol=1e-8):
    assert len(got) == len(want)
    for rt, rj in zip(got, want):
        assert set(rt) == set(rj), set(rt) ^ set(rj)
        assert rt["data_dir"] == rj["data_dir"] and rt["markers"] == rj["markers"]
        assert rt["x"].shape == rj["x"].shape
        np.testing.assert_allclose(rt["x"], rj["x"], rtol=0, atol=x_tol)
        np.testing.assert_allclose(rt["positions"], rj["positions"], rtol=0, atol=x_tol)
        for key in ("cost", "cost0"):
            assert abs(rt[key] - rj[key]) <= cost_rtol * abs(rj[key]), (
                rt["data_dir"], key, rt[key], rj[key])
        assert rt["converged"] == rj["converged"], rt["data_dir"]


@pytest.fixture(scope="module")
def tree_batch():
    return _batch("tree", exclude_markers=(), uncertainty=True)


def test_solve_batch_generic_matches_jax(tree_batch):
    """The tree's three ragged runs with uncertainty=True: per-run cost,
    x, converged, and marker_std at 1e-4 of its scale."""
    got, want = tree_batch
    _assert_batch_close(got, want)
    for rt, rj, n in zip(got, want, LENGTHS):
        assert rt["positions"].shape == (n, 3, 3)
        scale = np.abs(rj["marker_std"]).max()
        np.testing.assert_allclose(rt["marker_std"], rj["marker_std"], rtol=0, atol=1e-4 * scale)
        for key in ("cov_ridge_shrink", "cov_ridge_frac"):
            assert rt[key] == rj[key] == 0.0  # float64: no ridge


def test_solve_batch_generic_dag_matches_jax():
    """The DAG skeleton (analytic DAG Jacobian), 'neck' excluded by the
    default exclude_markers."""
    got, want = _batch("dag")
    _assert_batch_close(got, want)


def test_solve_batch_generic_chunked_matches_jax():
    """max_batch=2: chunks of 2 (the last padded with its final run)."""
    got, want = _batch("tree", exclude_markers=(), max_batch=2)
    _assert_batch_close(got, want)


def test_solve_batch_generic_rescue_matches_jax(capsys):
    """A starved budget (3 iterations): the rescue re-solves the same runs
    at the same budgets (1x, then 3x) in both packages."""
    got, want = _batch("tree", exclude_markers=(), num_iters=3)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("rescue:")]
    assert lines and len(lines) % 2 == 0
    assert lines[: len(lines) // 2] == lines[len(lines) // 2:]
    _assert_batch_close(got, want)


def test_solve_batch_generic_x0_override_and_warm_start_match_jax():
    """X0_override (held at the last frame through padding), and the EKF
    warm start (warm_start=True, plain_iters=4)."""
    rng = np.random.default_rng(5)
    mj, _mt = build_pair("tree")
    X0s = [np.concatenate([np.tile([-1.0, 0.0, 0.6], (n, 1)),
                           rng.normal(scale=0.05, size=(n, mj.n_pose - 3))], axis=1)
           for n in LENGTHS]
    got, want = _batch("tree", exclude_markers=(), X0_override=X0s)
    _assert_batch_close(got, want)
    got, want = _batch("tree", exclude_markers=(), warm_start=True, num_iters=8, rescue=False)
    _assert_batch_close(got, want)


def test_solve_batch_generic_pallas_override_matches_jax(tree_batch):
    """_cfg_override={'linear_solver': 'pallas'} on CPU tensors (the kernel
    wrapper's plain version: the same exact banded factorisation) against
    JAX's 'chol_unrolled' (the JAX Pallas kernel computes in float32, so
    it is no float64 reference), as tests/test_torch_fte.py holds it."""
    got = _port_batch("tree", exclude_markers=(), uncertainty=True,
                      _cfg_override={"linear_solver": "pallas"})
    _assert_batch_close(got, tree_batch[1])


# ---- the EKF ----

@pytest.mark.parametrize("name", ["tree", "dag"])
def test_solve_batch_ekf_generic_matches_jax(name):
    mj, mt = build_pair(name)
    want = jsweep.solve_batch_ekf_generic(mj, render_runs(jsweep, name, LENGTHS)[0], THRESH,
                                          dtype=jnp.float64, init_marker=INIT[name])
    got = tsweep.solve_batch_ekf_generic(mt, render_runs(tsweep, name, LENGTHS)[0], THRESH,
                                         device="cpu", dtype=torch.float64,
                                         init_marker=INIT[name])
    assert len(got) == len(want)
    for rt, rj, n in zip(got, want, LENGTHS):
        assert set(rt) == set(rj) and set(rt["states"]) == set(rj["states"])
        assert rt["outliers"] == rj["outliers"] and rt["max_pixel_err"] == rj["max_pixel_err"]
        pairs = [(k, rt["states"][k], rj["states"][k]) for k in rj["states"]]
        pairs.append(("positions", rt["positions"], rj["positions"]))
        for key, g, w in pairs:
            assert g.shape == w.shape and g.shape[0] == n, key
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-9 * np.abs(w).max(), err_msg=key)


# ---- no fallback to the CPU ----

def _one_run():
    runs, _ = render_runs(tsweep, "tree", (8,), n_cams=2)
    return runs


ENTRY_POINTS = {
    "make_h_fn_generic": lambda m: tgen.make_h_fn_generic(m, *_rig(2)),
    "make_hj_parts_fn_generic": lambda m: tgen.make_hj_parts_fn_generic(m, *_rig(2)),
    "fte_generic_run": lambda m: tgen.fte_generic_run(
        SKELETONS["tree"][0], _one_run()[0].pixels, _one_run()[0].likelihood, *_rig(2),
        fps=90.0, init_marker="root", num_iters=1),
    "solve_batch_generic": lambda m: tsweep.solve_batch_generic(
        m, _one_run(), THRESH, num_iters=1, init_marker="root"),
    "solve_batch_ekf_generic": lambda m: tsweep.solve_batch_ekf_generic(
        m, _one_run(), THRESH, init_marker="root"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_generic_entry_point_without_device_and_cuda_raises(monkeypatch, name):
    _mj, mt = build_pair("tree")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](mt)
