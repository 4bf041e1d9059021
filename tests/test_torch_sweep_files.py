"""The port's sweep over a dataset root (acinoset_tpu_torch.pipeline.sweep:
discover_runs, load_run, sweep) against the JAX package's, on the CPU.

Runs come from tests/file_pipeline_cases.py: four runs of 30-36 frames,
4 cameras, in two fps groups (90 and 120). Both sweeps run in float64
(each package's batched stages are called with dtype=float64 here; the
sweeps take no dtype) with the FTE and EKF stages and the rescue. Results are
held by tests/test_torch_sweep.py's and tests/test_torch_ekf.py's rules:
the FTE cost per run at 1e-8 relative, or at 5e-3 for a run that 'pcg'
makes rounding-chaotic in both packages, ``converged`` equal; the EKF's
states at 1e-8 of scale.
"""
import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import file_pipeline_cases as cases
from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch.parallel import mesh as tmesh
from acinoset_tpu_torch.pipeline import sweep as tsweep

torch.set_num_threads(2)
ITERS = 20
#: per run of cases.DATASET, |cost_port - cost_jax| / cost_jax. Runs a, b
#: and c read 6e-12 and closer apart; run d, 5.5e-5 (and 1.9e-5 at 8
#: iterations): its 16-iteration CG is rounding-chaotic in both packages,
#: so it takes tests/test_torch_sweep.py's bound for such runs.
COST_RTOL = {"a": 1e-8, "b": 1e-8, "c": 1e-8, "d": 5e-3}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep")
    return {w: (str(base / w), cases.make_dataset(base / w, w)) for w in cases.WRITERS}


def test_discover_runs_matches_jax(tmp_path, roots):
    """Nested runs, a dlc/ without .h5 files, a dlc/ holding another file
    kind, and a run below another run's directory: the same directories in
    the same order."""
    root, _runs = roots["port"]
    extra = tmp_path / "root"
    shutil.copytree(root, extra / "site")
    (extra / "empty" / "dlc").mkdir(parents=True)
    (extra / "csv" / "dlc").mkdir(parents=True)
    (extra / "csv" / "dlc" / "cam1.csv").write_text("x")
    nested = extra / "site" / "a" / "2019_03_09" / "synthetic" / "run" / "deeper"
    (nested / "dlc").mkdir(parents=True)
    (nested / "dlc" / "cam1DLC.h5").write_bytes(b"")
    got, want = tsweep.discover_runs(str(extra)), jsweep.discover_runs(str(extra))
    assert got == want
    assert len(got) == len(cases.DATASET) + 1 and str(nested) in got


@pytest.mark.parametrize("writer", sorted(cases.WRITERS))
@pytest.mark.parametrize("kw", [{}, dict(start_frame=3, end_frame=25),
                                dict(markers=["tail2", "nose", "no_such_marker"])])
def test_load_run_matches_jax(roots, writer, kw):
    for run in roots[writer][1]:
        got, want = tsweep.load_run(run, **kw), jsweep.load_run(run, **kw)
        for field in ("data_dir", "fps", "start_frame", "scene_fpath", "cam_res"):
            assert getattr(got, field) == getattr(want, field), field
        assert type(got.fps) is float and type(got.cam_res[0]) is int
        cases.assert_equal_arrays(got.pixels, want.pixels, "pixels")
        cases.assert_equal_arrays(got.likelihood, want.likelihood, "likelihood")
        for a, b in zip(got.cams, want.cams):
            cases.assert_equal_arrays(a, b, "cams")


def test_load_run_without_video_info_takes_120_fps(tmp_path, roots):
    run = shutil.copytree(roots["port"][1][0], tmp_path / "run")
    os.remove(run / "video_info.json")
    shutil.copytree(os.path.join(roots["port"][1][0], "..", "extrinsic_calib"),
                    tmp_path / "extrinsic_calib")
    assert tsweep.load_run(str(run)).fps == jsweep.load_run(str(run)).fps == 120.0


@pytest.fixture(scope="module")
def swept(tmp_path_factory, roots):
    """Both sweeps, each on its own copy of the JAX writer's root."""
    base = tmp_path_factory.mktemp("swept")
    out = {}
    for name, module, dtype, kw in (("jax", jsweep, jnp.float64, {}),
                                    ("port", tsweep, torch.float64, dict(device="cpu"))):
        root = str(base / name)
        shutil.copytree(roots["jax"][0], root)
        with pytest.MonkeyPatch.context() as mp:
            for fn in ("solve_batch", "solve_batch_ekf"):
                mp.setattr(module, fn, functools.partial(getattr(module, fn), dtype=dtype))
            res = module.sweep(root, dlc_thresh=cases.THRESH, num_iters=ITERS,
                               stages=("fte", "ekf"), **kw)
        out[name] = (root, res)
    return out


def _run_name(res, root):
    return os.path.relpath(res["data_dir"], root).split(os.sep)[0]


def _assert_sweeps_match(got, troot, want, jroot):
    assert [_run_name(r, troot) for r in got] == [_run_name(r, jroot) for r in want] == [
        "a", "c", "b", "d"]  # grouped by fps: 90 then 120
    for rt, rj in zip(got, want):
        name = _run_name(rt, troot)
        assert set(rt) == set(rj)
        assert rt["x"].shape == rj["x"].shape and rt["positions"].shape == rj["positions"].shape
        assert abs(rt["cost0"] - rj["cost0"]) <= 1e-10 * abs(rj["cost0"]), name
        assert abs(rt["cost"] - rj["cost"]) <= COST_RTOL[name] * abs(rj["cost"]), (
            name, rt["cost"], rj["cost"])
        assert rt["converged"] == rj["converged"], name
        assert rt["start_frame"] == rj["start_frame"] == 0


def test_sweep_matches_jax(swept):
    (jroot, want), (troot, got) = swept["jax"], swept["port"]
    _assert_sweeps_match(got, troot, want, jroot)


def test_sweep_over_a_mesh_matches_jax(tmp_path, roots, swept):
    """``sweep(mesh=)`` over a data mesh of 2 CPU shards (each stage's
    batch padded to 2 rows, each row solved in a worker process) against
    the JAX package's sweep over its own every-device mesh, by the same
    rules as the one-device sweep."""
    root = str(tmp_path / "mesh")
    shutil.copytree(roots["jax"][0], root)
    mesh = tmesh.make_mesh(2, model_axis=False, devices=[torch.device("cpu")] * 2)
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("solve_batch", "solve_batch_ekf"):
            mp.setattr(tsweep, fn, functools.partial(getattr(tsweep, fn), dtype=torch.float64))
        got = tsweep.sweep(root, dlc_thresh=cases.THRESH, num_iters=ITERS,
                           stages=("fte", "ekf"), mesh=mesh)
    jroot, want = swept["jax"]
    _assert_sweeps_match(got, root, want, jroot)


@pytest.mark.parametrize("given", ["neither", "device", "mesh"])
def test_sweep_hands_its_stages_only_the_placement_it_was_given(roots, monkeypatch, given):
    """With neither ``device`` nor ``mesh`` the stages get neither, so they
    take their default, a data mesh of every visible CUDA device (the JAX
    package's sweep passes neither); a named device or mesh goes through
    to every stage call, the rescue's too."""
    seen = []

    def record(runs, dlc_thresh, **kw):
        seen.append({k: kw[k] for k in ("device", "mesh") if k in kw})
        return [dict(data_dir=r.data_dir, x=np.zeros((2, 25)), converged=False,
                     states=dict(smoothed_x=np.zeros((2, 25)))) for r in runs]

    monkeypatch.setattr(tsweep, "solve_batch", record)
    monkeypatch.setattr(tsweep, "solve_batch_ekf", record)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mesh = tmesh.make_mesh(2, model_axis=False, devices=[torch.device("cpu")] * 2)
    kw = {"neither": {}, "device": dict(device="cpu"), "mesh": dict(mesh=mesh)}[given]
    tsweep.sweep(roots["port"][0], save=False, stages=("fte", "ekf"), max_frames=12, **kw)
    assert len(seen) == 8  # two fps groups: ekf, fte and the rescue's two rounds
    assert all(s == kw for s in seen)


@pytest.mark.parametrize("stage", ["fte", "ekf"])
def test_sweep_pickles_match_jax(swept, stage):
    """Every run's pickle exists in both trees with the same keys, shapes
    and dtypes, and no torch object; the EKF's values at
    tests/test_torch_ekf.py's 1e-8 of scale."""
    (jroot, _), (troot, _) = swept["jax"], swept["port"]
    runs = jsweep.discover_runs(jroot)
    assert len(runs) == len(cases.DATASET)
    for jrun in runs:
        rel = os.path.relpath(jrun, jroot)
        path = os.path.join(stage, f"{stage}.pickle")
        got = jdata.load_pickle(os.path.join(troot, rel, path))
        want = jdata.load_pickle(os.path.join(jrun, path))
        cases.assert_no_torch(got)
        cases.assert_same_layout(got, want)
        if stage == "ekf":
            for key, w in want.items():
                if isinstance(w, np.ndarray) and w.dtype.kind == "f":
                    np.testing.assert_allclose(got[key], w, rtol=1e-8,
                                               atol=1e-8 * np.abs(w).max(), err_msg=key)


def test_sweep_forwards_its_options_as_jax_does(tmp_path, roots, monkeypatch):
    """warm_start, relinearize_every, uncertainty, rescue and the stages
    reach the batched stages with the JAX package's values (stage calls
    recorded, not solved)."""
    calls = {}

    def recorder(package, name):
        def record(runs, dlc_thresh, **kw):
            kw = {k: v for k, v in kw.items() if k not in ("device", "dtype")}
            kw["X0_override"] = kw.get("X0_override") is not None
            calls.setdefault(package, []).append((name, len(runs), dlc_thresh, kw))
            res = [dict(data_dir=r.data_dir, x=np.zeros((2, 25)), converged=True,
                        states=dict(smoothed_x=np.zeros((2, 25)))) for r in runs]
            return res
        return record

    for package, module in (("jax", jsweep), ("port", tsweep)):
        monkeypatch.setattr(module, "solve_batch", recorder(package, "fte"))
        monkeypatch.setattr(module, "solve_batch_ekf", recorder(package, "ekf"))
        kw = dict(dlc_thresh=0.6, num_iters=7, save=False, stages=("fte",), warm_start=True,
                  relinearize_every=3, uncertainty=True, max_frames=12)
        if package == "port":
            kw["device"] = "cpu"
        module.sweep(roots["port"][0], **kw)
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == ["ekf", "fte", "ekf", "fte"]
