"""The port's file-level generic-skeleton paths (pipeline.sweep.sweep_generic
and pipeline.generic.build_and_solve) against the JAX package's, on the
CPU in float64, on a skeleton pickle built in code: the cheetah exported
by ``models.cheetah.to_skeleton_dict`` (n_pose 63).

That dict carries ``fk_equivalent=False`` (its generic FK factorises the
head differently from the cheetah's own), and both packages refuse to
build it from a file; the runs here save it without that flag. The runs
are tests/file_pipeline_cases.py's cheetah runs. Tolerances are
tests/test_torch_generic.py's: the batch at 1e-8 in cost and 1e-6 in x,
the single run ('chol_unrolled', direct) at 1e-8 in x and 1e-10 in cost,
the EKF at 1e-8 relative with 1e-9 of each key's scale.
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
from acinoset_tpu.pipeline import generic as jgen
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch.models import cheetah as tcheetah
from acinoset_tpu_torch.parallel import mesh as tmesh
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import generic as tgen
from acinoset_tpu_torch.pipeline import sweep as tsweep

torch.set_num_threads(2)
RUNS = (("a", 24, 90.0, 1), ("b", 20, 90.0, 2))
ITERS = 10


def _skeleton(rename=None):
    sk = tcheetah.to_skeleton_dict()
    sk.pop("fk_equivalent")
    if rename:
        old, new = rename
        sk["markers"] = [new if m == old else m for m in sk["markers"]]
        sk["positions"] = {(new if m == old else m): v for m, v in sk["positions"].items()}
        sk["dofs"] = {(new if m == old else m): v for m, v in sk["dofs"].items()}
        sk["links"] = [[new if m == old else m for m in link] for link in sk["links"]]
    return sk


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = tmp_path_factory.mktemp("generic")
    sk = str(base / "cheetah_skeleton.pickle")
    tdata.save_skeleton(sk, _skeleton())
    root = str(base / "root")
    cases.make_dataset(root, "port", RUNS)
    return sk, root


def test_both_refuse_the_dict_with_its_fk_flag(tmp_path, dataset):
    sk = str(tmp_path / "flagged.pickle")
    tdata.save_skeleton(sk, tcheetah.to_skeleton_dict())
    for module, kw in ((jsweep, {}), (tsweep, dict(device="cpu"))):
        with pytest.raises(ValueError, match="allow_fk_mismatch"):
            module.sweep_generic(dataset[1], sk, init_marker="nose", **kw)


@pytest.fixture(scope="module")
def swept(tmp_path_factory, dataset):
    sk, root = dataset
    base = tmp_path_factory.mktemp("generic_swept")
    out = {}
    kw = dict(dlc_thresh=cases.THRESH, num_iters=ITERS, init_marker="nose",
              stages=("fte", "ekf"), rescue=False)
    for name, module, dtype, dev in (("jax", jsweep, jnp.float64, {}),
                                     ("port", tsweep, torch.float64, dict(device="cpu"))):
        r = str(base / name)
        shutil.copytree(root, r)
        with pytest.MonkeyPatch.context() as mp:
            for fn in ("solve_batch_generic", "solve_batch_ekf_generic"):
                mp.setattr(module, fn, functools.partial(getattr(module, fn), dtype=dtype))
            res = module.sweep_generic(r, sk, **kw, **dev)
        out[name] = (r, res)
    return out


def test_sweep_generic_matches_jax(swept):
    (jroot, want), (troot, got) = swept["jax"], swept["port"]
    assert len(got) == len(want) == len(RUNS)
    for rt, rj in zip(got, want):
        assert set(rt) == set(rj), set(rt) ^ set(rj)
        assert os.path.relpath(rt["data_dir"], troot) == os.path.relpath(rj["data_dir"], jroot)
        assert rt["markers"] == rj["markers"] == tcheetah.get_markers()
        np.testing.assert_allclose(rt["x"], rj["x"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(rt["positions"], rj["positions"], rtol=0, atol=1e-6)
        for key in ("cost", "cost0"):
            assert abs(rt[key] - rj[key]) <= 1e-8 * abs(rj[key]), (key, rt[key], rj[key])
        assert rt["converged"] == rj["converged"]


@pytest.mark.parametrize("given", ["neither", "device", "mesh"])
def test_sweep_generic_hands_its_stages_only_the_placement_it_was_given(dataset, monkeypatch,
                                                                        given):
    """As tests/test_torch_sweep_files.py holds ``sweep``: with neither
    ``device`` nor ``mesh`` the stages get neither and take their default
    (every visible CUDA device); a named one reaches both stages."""
    seen = []

    def record(model, runs, dlc_thresh, **kw):
        seen.append({k: kw[k] for k in ("device", "mesh") if k in kw})
        return [dict(data_dir=r.data_dir, x=np.zeros((2, 63)),
                     states=dict(smoothed_x=np.zeros((2, 63)))) for r in runs]

    monkeypatch.setattr(tsweep, "solve_batch_generic", record)
    monkeypatch.setattr(tsweep, "solve_batch_ekf_generic", record)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mesh = tmesh.make_mesh(2, model_axis=False, devices=[torch.device("cpu")] * 2)
    kw = {"neither": {}, "device": dict(device="cpu"), "mesh": dict(mesh=mesh)}[given]
    tsweep.sweep_generic(dataset[1], dataset[0], save=False, init_marker="nose",
                         stages=("fte", "ekf"), max_frames=12, **kw)
    assert len(seen) == 2 and all(s == kw for s in seen)


@pytest.mark.parametrize("path", ["fte/traj_results.pickle", "ekf/ekf.pickle"])
def test_sweep_generic_pickles_match_jax(swept, path):
    (jroot, _), (troot, _) = swept["jax"], swept["port"]
    for jrun in jsweep.discover_runs(jroot):
        rel = os.path.relpath(jrun, jroot)
        got = jdata.load_pickle(os.path.join(troot, rel, path))
        want = jdata.load_pickle(os.path.join(jrun, path))
        cases.assert_no_torch(got)
        cases.assert_same_layout(got, want)
        if path.startswith("ekf"):
            for key, w in want.items():
                if isinstance(w, np.ndarray) and w.dtype.kind == "f":
                    np.testing.assert_allclose(got[key], w, rtol=1e-8,
                                               atol=1e-9 * np.abs(w).max(), err_msg=key)


def test_build_and_solve_matches_jax(tmp_path):
    """A project in src/build.py's layout (data/*.h5 and
    data/4_cam_scene_static_sba.json), the cheetah's nose renamed
    'forehead', build.py's init marker; frames 3..26."""
    rename = ("nose", "forehead")
    proj = tmp_path / "proj"
    run, _pts = cases.make_run(tmp_path / "src", "port", N=30)
    os.makedirs(proj / "data")
    markers = [rename[1] if m == rename[0] else m for m in tcheetah.get_markers()]
    for c in range(cases.N_CAMS):
        frames, _bp, vals = tdata._read_dlc_h5(os.path.join(run, "dlc", f"cam{c + 1}DLC.h5"))
        tdata.save_dlc_points_h5(str(proj / "data" / f"cam{c + 1}.h5"), vals[..., :2],
                                 vals[..., 2], markers)
    scene = tdata.find_scene_file(run, verbose=False)[-1]
    shutil.copy(scene, proj / "data" / "4_cam_scene_static_sba.json")
    sk = str(tmp_path / "sk.pickle")
    tdata.save_skeleton(sk, _skeleton(rename))
    kw = dict(start_frame=3, n_frames=24, fps=90.0, dlc_thresh=cases.THRESH, num_iters=ITERS)
    want = jgen.build_and_solve(sk, str(proj), out_fpath=str(tmp_path / "j.pickle"), **kw)
    got = tgen.build_and_solve(sk, str(proj), device="cpu", **kw)
    assert got["markers"] == want["markers"] == markers
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-8)
    for key in ("cost", "cost0"):
        assert abs(got[key] - want[key]) <= 1e-10 * abs(want[key]), key
    assert got["converged"] == want["converged"]
    saved = tdata.load_pickle(str(proj / "data" / "results" / "traj_results.pickle"))
    cases.assert_no_torch(saved)
    cases.assert_same_layout(saved, jdata.load_pickle(str(tmp_path / "j.pickle")))
    assert saved["start_frame"] == 3 and saved["scene_fpath"].endswith(
        "4_cam_scene_static_sba.json")
    cases.assert_equal_arrays(saved["x"], got["x"])
