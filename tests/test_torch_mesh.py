"""The port's device mesh (acinoset_tpu_torch.parallel.mesh) and the
sweep stages' ``mesh=`` against the JAX package's, in float64 on the CPU.

CPU shards are CPU devices the test names: eight of them stand in for
the JAX package's eight virtual CPU devices (tests/conftest.py). The
sharded solves follow tests/test_parallel.py: 4 cameras, N=24, eight
replicas of one run, the (8, 1), (4, 2) and (2, 4) layouts against the
single solve and the JAX package's sharded_fte_solver over the same
layout, and the camera-sharded 'pcg' at cost parity with both.
"""
import multiprocessing
import os
import subprocess
import sys
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acinoset_tpu.parallel import mesh as jmesh
from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch.parallel import mesh as tmesh
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.pipeline import fte as tfte
from acinoset_tpu_torch.pipeline import sweep as tsweep
from acinoset_tpu_torch.solvers import trajopt as ttraj
from acinoset_tpu_torch.utils import synthetic as tsyn

import mesh_cases

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: tests/test_parallel.py: every layout reproduces the single solve
LAYOUT_ATOL = 1e-8
#: tests/test_parallel.py: camera-sharded 'pcg' reaches the single
#: solve's cost within 2% after 40 iterations
PCG_COST_RTOL = 0.02
#: tests/test_torch_uncertainty.py's bound on the posterior, of its scale
COV_RTOL_OF_SCALE = 1e-4


def cpu_mesh(n, **kw):
    return tmesh.make_mesh(n, devices=[CPU] * n, **kw)


# ---- layouts, specs and padding ----

@pytest.mark.parametrize("n,kw", [(8, {}), (5, {}), (8, dict(model_size=4)),
                                  (8, dict(model_size=1)), (8, dict(model_axis=False)),
                                  (1, {})])
def test_make_mesh_layouts_match_jax(n, kw):
    got, want = cpu_mesh(n, **kw), jmesh.make_mesh(n, **kw)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == CPU for d in got.devices.flat)
    for shard in (True, False):
        assert tmesh.batch_spec(got, shard) == tuple(tuple(s) for s in jmesh.batch_spec(want,
                                                                                         shard))


def test_make_mesh_refuses_bad_layouts():
    with pytest.raises(ValueError):
        cpu_mesh(8, model_size=3)
    with pytest.raises(ValueError):
        cpu_mesh(8, model_axis=False, model_size=2)


def test_make_mesh_raises_without_enough_cuda_devices(monkeypatch):
    """The CUDA devices are the default and there is no fall back to the
    CPU: none raises, too few raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tmesh.make_mesh(2)
    one = tmesh.make_mesh()
    assert one.shape == {"data": 1} and one.devices[0] == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        tmesh.make_mesh(3, devices=[CPU] * 2)


def test_pad_batch_matches_jax():
    a = np.arange(10).reshape(5, 2)
    for multiple in (1, 2, 4, 5):
        (ap,), B = tmesh.pad_batch([a], multiple)
        (aj,), Bj = jmesh.pad_batch([a], multiple)
        assert B == Bj == 5
        np.testing.assert_array_equal(ap, aj)
        (at,), _ = tmesh.pad_batch([torch.tensor(a)], multiple)
        np.testing.assert_array_equal(at.numpy(), aj)


# ---- the sharded solver ----

@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's _fte_problem on the port."""
    cams = tsyn.ring_cameras(n_cams=4)
    k, d, r, t, _res = cams
    N = 24
    pixels, likelihood, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=N, fps=90.0), cams,
                                                     noise_px=1.0, seed=5)
    X0 = tfte.initial_trajectory(pixels, likelihood, k, d, r, t, np.arange(N), 0.5,
                                 device="cpu")
    cfg = tfte.default_config(90.0, num_iters=6)
    meas = pixels.transpose(1, 0, 2, 3)
    w = (likelihood.transpose(1, 0, 2) > 0.5) / cfg.meas_std_px
    B = 8
    batch = tuple(torch.tensor(np.stack([a] * B)) for a in (X0, meas, w))
    return (k, d, r, t), cfg, batch


def test_one_shard_mesh_is_fte_solve_bit_for_bit(problem):
    rig, cfg, batch = problem
    cfg = replace(cfg, linear_solver="pcg")
    hjp = tekf.make_hj_parts_fn(*rig, device="cpu")
    X, info = ttraj.fte_solve(hjp, *batch, cfg, device="cpu")
    threads, children = threading.active_count(), multiprocessing.active_children()
    solver = tmesh.sharded_fte_solver(cpu_mesh(1), None, cfg, hj_parts_fn=hjp, with_status=True)
    Xs, conv, gn = solver(*batch)
    assert threading.active_count() == threads  # no thread, no process started
    assert multiprocessing.active_children() == children
    assert torch.equal(Xs, X) and torch.equal(conv, info["converged"])
    assert torch.equal(gn, info["grad_norm"])


def _jax_sharded(rig, jcfg, batch, model_size, **kw):
    """The JAX package's sharded_fte_solver on its 8 virtual CPU devices
    (tests/conftest.py), on the same batch."""
    mesh = jmesh.make_mesh(8, model_size=model_size)
    solver = jmesh.sharded_fte_solver(mesh, jekf.make_h_fn(*rig), jcfg,
                                      hj_parts_fn=jekf.make_hj_parts_fn(*rig), **kw)
    with mesh:
        out = solver(*jmesh.shard_batch(mesh, *(jnp.asarray(a.numpy()) for a in batch)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_sharded_fte_matches_single_device(problem, model_size, tmp_path):
    """The (8, 1), (4, 2) and (2, 4) layouts reproduce the single solve
    ('chol_unrolled') at 1e-8, and its posterior's error bars at 1e-4 of
    their scale, and equal the JAX package's sharded_fte_solver over the
    same layout on the same batch (with_status, compute_cov) by the same
    bounds; every shard makes measurement calls (a worker process a data
    row, a thread a shard), and with model > 1 each receives its own
    4 / model cameras only (no silent replication of the camera work)."""
    rig, cfg, batch = problem
    cfg = replace(cfg, linear_solver="chol_unrolled")
    jcfg = replace(jfte.default_config(90.0, num_iters=6), linear_solver="chol_unrolled")
    X1, info1 = ttraj.fte_solve(tekf.make_hj_parts_fn(*rig, device="cpu"),
                                *(a[:1] for a in batch), cfg, compute_cov=True, device="cpu")
    log = tmp_path / "cameras.log"
    fn = tekf.RigFunction(mesh_cases.CameraLogAux(log),
                          tekf.make_hj_parts_fn(*rig, device="cpu").rig)
    mesh = cpu_mesh(8, model_size=model_size)
    solver = tmesh.sharded_fte_solver(mesh, None, cfg, hj_parts_fn=fn, with_status=True,
                                      compute_cov=True)
    X, conv, gn, std = solver(*batch)
    assert X.shape == (8, 24, 25) and std.shape == (8, 24, 20, 3)
    scale = float(info1["marker_std"].abs().max())
    for b in range(8):
        np.testing.assert_allclose(X[b].numpy(), X1[0].numpy(), rtol=0, atol=LAYOUT_ATOL)
        np.testing.assert_allclose(std[b].numpy(), info1["marker_std"][0].numpy(), rtol=0,
                                   atol=COV_RTOL_OF_SCALE * scale)
        assert bool(conv[b]) == bool(info1["converged"][0])
    np.testing.assert_allclose(gn.numpy(), info1["grad_norm"].expand(8).numpy(), rtol=1e-6)
    Xj, convj, gnj, stdj = _jax_sharded(rig, jcfg, batch, model_size, with_status=True,
                                        compute_cov=True)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=0, atol=LAYOUT_ATOL)
    np.testing.assert_allclose(std.numpy(), stdj, rtol=0,
                               atol=COV_RTOL_OF_SCALE * np.abs(stdj).max())
    np.testing.assert_array_equal(conv.numpy(), convj)
    np.testing.assert_allclose(gn.numpy(), gnj, rtol=1e-6)
    calls = mesh_cases.read_log(log)
    assert len({shard for shard, _c in calls}) == 8
    assert len({pid for (pid, _t), _c in calls}) == 8 // model_size
    assert {c for _s, c in calls} == {4 // model_size}


def test_sharded_pcg_cost_parity(problem):
    """The default 'pcg' under a camera-sharded (4, 2) mesh reaches the
    single solve's cost, on the reference objective, within 2% after 40
    iterations (the camera sums' rounding moves PCG's iterates, so the
    paths meet only at the plateau), and the cost of the JAX package's
    sharded_fte_solver over the same layout, run by run, by the same
    rule."""
    rig, _cfg, batch = problem
    cfg = tfte.default_config(90.0, num_iters=40)
    assert cfg.linear_solver == "pcg"
    hjp = tekf.make_hj_parts_fn(*rig, device="cpu")
    X1, _info1 = ttraj.fte_solve(hjp, *(a[:1] for a in batch), cfg, device="cpu")
    X = tmesh.sharded_fte_solver(cpu_mesh(8, model_size=2), None, cfg, hj_parts_fn=hjp)(*batch)
    h = tekf.make_h_fn(*rig, device="cpu")
    cost = ttraj.fte_objective(X, h, batch[1], batch[2], cfg)
    c1 = float(ttraj.fte_objective(X1, h, batch[1][:1], batch[2][:1], cfg)[0])
    assert np.all(np.abs(cost.numpy() - c1) < PCG_COST_RTOL * c1), (cost, c1)
    Xj = _jax_sharded(rig, jfte.default_config(90.0, num_iters=40), batch, 2)
    cost_j = ttraj.fte_objective(torch.tensor(Xj), h, batch[1], batch[2], cfg).numpy()
    assert np.all(np.abs(cost.numpy() - cost_j) < PCG_COST_RTOL * cost_j), (cost, cost_j)


def test_shard_batch_and_errors(problem):
    rig, cfg, batch = problem
    mesh = cpu_mesh(4, model_size=2)
    sb = tmesh.shard_batch(mesh, *batch)
    assert sb.batch == 8 and sb.cams == [slice(0, 2), slice(2, 4)]
    assert sb.parts[1][1][1].shape == (4, 24, 2, 20, 2)
    np.testing.assert_array_equal(sb.parts[1][1][1].numpy(), batch[1][4:8, :, 2:4].numpy())
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(cpu_mesh(3), *batch)
    with pytest.raises(ValueError, match="cameras do not divide"):
        tmesh.shard_batch(cpu_mesh(6, model_size=3), *(a[:2] for a in batch))
    # a bare closure can neither be cut to a shard's cameras nor pickle
    hjp = tekf.make_hj_parts_fn(*rig, device="cpu")
    solver = tmesh.sharded_fte_solver(cpu_mesh(1, model_size=1), None, cfg,
                                      hj_parts_fn=lambda x: hjp(x))
    solver(*(a[:2] for a in batch))  # one shard: the caller's closure as it is
    solver = tmesh.sharded_fte_solver(cpu_mesh(2, model_size=2), None, cfg,
                                      hj_parts_fn=lambda x: hjp(x))
    with pytest.raises(TypeError, match="on\\(device, cams\\)"):
        solver(*batch)
    solver = tmesh.sharded_fte_solver(cpu_mesh(2, model_axis=False), None, cfg,
                                      hj_parts_fn=lambda x: hjp(x))
    with pytest.raises(TypeError, match="does not pickle"):
        solver(*batch)


# ---- the sweep's four stages with mesh= ----

THRESH = 0.5
LENGTHS = (12, 16, 10)


def _runs(module):
    out = []
    for i, n in enumerate(LENGTHS):
        cams = tsyn.ring_cameras(n_cams=2, radius=(10.0, 13.0)[i % 2])
        k, d, r, t, _res = cams
        px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=n), cams, noise_px=1.5,
                                              outlier_frac=0.02, bad_lik_frac=0.05, seed=40 + i)
        out.append(module.RunData(f"run_{i}", px, lik, (k, d.reshape(-1, 4), r, t.reshape(-1, 3)),
                                  90.0, 0, ""))
    return out


def _generic_runs(module):
    from test_torch_skeleton import render_runs

    return render_runs(module, "tree", LENGTHS, n_cams=2)[0]


def _close_pcg(got, want):
    """tests/test_torch_sweep.py's rule for 'pcg' against the JAX package:
    per-run cost within 5e-3 (rounding-chaotic runs), cost0 within 1e-10,
    the same status and shapes."""
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert set(rg) == set(rw) and rg["x"].shape == rw["x"].shape
        assert abs(rg["cost0"] - rw["cost0"]) <= 1e-10 * abs(rw["cost0"])
        assert abs(rg["cost"] - rw["cost"]) <= 5e-3 * abs(rw["cost"]), (rg["cost"], rw["cost"])
        assert rg["converged"] == rw["converged"]


def _close(got, want, rtol):
    """Per run: every array at rtol of its scale, every number alike."""
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        flat_g = dict(rg, **{f"states.{k}": v for k, v in rg.get("states", {}).items()})
        flat_w = dict(rw, **{f"states.{k}": v for k, v in rw.get("states", {}).items()})
        for key, w in flat_w.items():
            g = flat_g[key]
            if isinstance(w, np.ndarray):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max(),
                                           err_msg=key)
            elif isinstance(w, float):
                assert abs(g - w) <= rtol * abs(w) + 1e-12, (key, g, w)
            elif not isinstance(w, dict):
                assert g == w, key


STAGES = {
    "solve_batch": (lambda m, runs, **kw: m.solve_batch(runs, THRESH, num_iters=4, plain_iters=2,
                                                        **kw), _runs),
    "solve_batch_ekf": (lambda m, runs, **kw: m.solve_batch_ekf(runs, THRESH, **kw), _runs),
    "solve_batch_generic": (lambda m, runs, model, **kw: m.solve_batch_generic(
        model, runs, THRESH, num_iters=6, init_marker="root", exclude_markers=(),
        _cfg_override={"linear_solver": "chol_unrolled"}, **kw), _generic_runs),
    "solve_batch_ekf_generic": (lambda m, runs, model, **kw: m.solve_batch_ekf_generic(
        model, runs, THRESH, init_marker="root", **kw), _generic_runs),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_with_two_shard_mesh_matches_one_shard_and_jax(name):
    """Three ragged runs over a mesh of 2 CPU shards (padded to 4 by
    repeating the first run): equal to the one-device call and to the JAX
    package's stage over its own 2-device mesh: 'pcg' (solve_batch) by
    tests/test_torch_sweep.py's rule, the exact stages at 1e-8."""
    call, make_runs = STAGES[name]
    extra_t, extra_j = {}, {}
    if "generic" in name:
        from test_torch_skeleton import build_pair

        mj, mt = build_pair("tree")
        extra_t, extra_j = dict(model=mt), dict(model=mj)
    one = call(tsweep, make_runs(tsweep), device="cpu", dtype=torch.float64, **extra_t)
    two = call(tsweep, make_runs(tsweep), mesh=cpu_mesh(2, model_axis=False),
               dtype=torch.float64, **extra_t)
    want = call(jsweep, make_runs(jsweep), mesh=jmesh.make_mesh(2, model_axis=False),
                dtype=jnp.float64, **extra_j)
    _close(two, one, 1e-10)
    if name == "solve_batch":
        _close_pcg(two, want)
    else:
        _close(two, want, 1e-8)


def test_stage_refuses_mesh_and_device_together():
    with pytest.raises(ValueError, match="not both"):
        tsweep.solve_batch(_runs(tsweep), THRESH, num_iters=1, device="cpu",
                           mesh=cpu_mesh(2, model_axis=False))


# ---- the entry twins ----

def test_entry_matches_graft_entry_on_the_cpu():
    """entry's problem is __graft_entry__._tiny_problem's, and its
    2-iteration float32 solve lands where the JAX package's does (both
    'pcg' in float32: 1e-4 of the cost, 1e-3 of the largest pose value)."""
    import jax

    import __graft_entry__ as graft
    from acinoset_tpu_torch import entry as tentry

    fn, args = tentry.entry("cpu")
    jfn, jargs = graft.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    X, cost = fn(*args)
    Xj, cj = jax.jit(jfn)(*jargs)
    assert abs(float(cost) - float(cj)) <= 1e-4 * abs(float(cj))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(Xj)).max()))

def test_dryrun_multichip_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", "from acinoset_tpu_torch import entry; entry.dryrun_multichip(8)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multichip OK: mesh={'data': 4, 'model': 2}" in proc.stdout, proc.stdout
