"""The port's file-level stages (acinoset_tpu_torch.pipeline: tri, sba,
ekf, fte, app, points2d, viewer, and eval.metrics) against the JAX
package's on the same run directory, in float64 on the CPU.

The file level adds no arithmetic: each stage reads the DLC files, cuts
the window and hands its array core the arrays. So each stage is held in
two steps: the arrays handed to the core equal the JAX package's
exactly (a spy on both cores), and the stage's output agrees with the
JAX package's at the tolerance its core's own test uses (TRI 1e-9 m; SBA
as tests/test_torch_lm_sba.py; the EKF as tests/test_torch_ekf.py; the
FTE as tests/test_torch_fte.py and tests/test_torch_sweep.py hold it:
with the exact 'chol_unrolled' solver, states at 1e-5 and the cost at
1e-6; with the default 'pcg', which is rounding-chaotic in both packages,
the cost at a fixed 5e-3). Each comparison runs on two run directories, one
written by each package's writer (tests/file_pipeline_cases.py; their
pixels agree to rounding, not bit for bit), both packages on each.
"""
import glob
import json
import math
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import file_pipeline_cases as cases
from acinoset_tpu.eval import metrics as jmetrics
from acinoset_tpu.ops import camera as jcam
from acinoset_tpu.pipeline import app as japp
from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.pipeline import points2d as jp2d
from acinoset_tpu.pipeline import sba as jsba
from acinoset_tpu.pipeline import tri as jtri
from acinoset_tpu.pipeline import viewer as jviewer
from acinoset_tpu_torch.eval import metrics as tmetrics
from acinoset_tpu_torch.models import cheetah as tcheetah
from acinoset_tpu_torch.ops import camera as tcam
from acinoset_tpu_torch.pipeline import app as tapp
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.pipeline import fte as tfte
from acinoset_tpu_torch.pipeline import points2d as tp2d
from acinoset_tpu_torch.pipeline import sba as tsba
from acinoset_tpu_torch.pipeline import tri as ttri
from acinoset_tpu_torch.pipeline import viewer as tviewer

torch.set_num_threads(2)
N = 40
#: the window: 1-based start frame and end frame, as the CLI takes them
START, END = 4, 36
FTE_ITERS = 20
#: tests/test_torch_sweep.py's bound on the final cost of a run that
#: 'pcg' (16 CG iterations on IRLS-weighted systems) makes
#: rounding-chaotic in both packages. Here the costs of single
#: iterations part by up to 0.9% mid-solve and the positions by up to
#: 4 mm, so neither is held; the exact solver holds them below.
PCG_COST_RTOL = 5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    out = {w: cases.make_run(root / w, w, N=N) for w in cases.WRITERS}
    return {w: r for w, (r, _pts) in out.items()}, out["jax"][1]


def _stage(module, name, core, run, monkeypatch, **kw):
    """Run ``module.name`` on ``run`` with a spy on ``module.core``;
    returns (result, [(args, kwargs)] of the core's calls)."""
    spy = cases.Spy(getattr(module, core))
    monkeypatch.setattr(module, core, spy)
    out = getattr(module, name)(run, START, END, cases.THRESH, **kw)
    monkeypatch.undo()
    return out, spy.calls


def _assert_same_core_inputs(got, want, n_arrays):
    """The core calls' leading positional arrays are equal, exactly, and
    so are the other positional values (the port's device aside)."""
    assert len(got) == len(want) == 1
    (ga, gk), (wa, wk) = got[0], want[0]
    for i in range(n_arrays):
        cases.assert_equal_arrays(ga[i], wa[i], f"argument {i}")
    rest = [a for a in ga[n_arrays:] if not isinstance(a, torch.device)]
    assert rest == list(wa[n_arrays:])
    return gk, wk


@pytest.fixture(scope="module")
def jax_results(runs):
    """The JAX package's stages on both writers' runs, with spies; each
    run's outputs are moved aside for the port's."""
    mp = pytest.MonkeyPatch()
    out = {}
    for writer, run in runs[0].items():
        out[writer] = {
            "tri": _stage(jtri, "tri", "triangulate_run", run, mp),
            "sba": _stage(jsba, "sba", "sba_run", run, mp),
            "ekf": _stage(jekf, "ekf", "run_cheetah_ekf", run, mp),
            "fte": _stage(jfte, "fte", "fte_run", run, mp, num_iters=FTE_ITERS),
        }
        for stage in out[writer]:
            os.rename(os.path.join(run, stage), os.path.join(run, f"jax_{stage}"))
    mp.undo()
    return out


@pytest.fixture(scope="module")
def port_results(runs, jax_results):
    """The port's stages on both writers' runs, with spies."""
    mp = pytest.MonkeyPatch()
    out = {}
    for writer, run in runs[0].items():
        out[writer] = {
            "tri": _stage(ttri, "tri", "triangulate_run", run, mp, device="cpu"),
            "sba": _stage(tsba, "sba", "sba_run", run, mp, device="cpu"),
            "ekf": _stage(tekf, "ekf", "run_cheetah_ekf", run, mp, device="cpu"),
            "fte": _stage(tfte, "fte", "fte_run", run, mp, num_iters=FTE_ITERS, device="cpu"),
        }
    mp.undo()
    return out


def _pickle(run, stage, package="port"):
    name = stage if package == "port" else f"jax_{stage}"
    return jdata.load_pickle(os.path.join(run, name, f"{stage}.pickle"))


WRITERS = sorted(cases.WRITERS)


@pytest.mark.parametrize("writer", WRITERS)
def test_tri_matches_jax(runs, jax_results, port_results, writer):
    (want, wcalls), (got, gcalls) = jax_results[writer]["tri"], port_results[writer]["tri"]
    _assert_same_core_inputs(gcalls, wcalls, 6)
    assert got["start_frame"] == want["start_frame"] == START - 1
    assert got["positions"].shape == (END - START + 1, 20, 3)
    np.testing.assert_array_equal(np.isnan(got["positions"]), np.isnan(want["positions"]))
    np.testing.assert_allclose(got["positions"], want["positions"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("writer", WRITERS)
def test_sba_matches_jax(jax_results, port_results, writer):
    """Positions at tests/test_torch_lm_sba.py's 1e-6 m, the converged
    per-point Cauchy cost at 1e-8 (relative), residuals before at 1e-8."""
    (want, wcalls), (got, gcalls) = jax_results[writer]["sba"], port_results[writer]["sba"]
    _assert_same_core_inputs(gcalls, wcalls, 6)
    np.testing.assert_array_equal(np.isnan(got["positions"]), np.isnan(want["positions"]))
    np.testing.assert_allclose(got["positions"], want["positions"], atol=chip_smoke.LM_STATE_ATOL)
    before = want["residuals"]["before"]
    np.testing.assert_allclose(got["residuals"]["before"], before, rtol=1e-8,
                               atol=1e-8 * np.abs(before).max())
    n = got["positions"].shape[0] * got["positions"].shape[1]

    def point_costs(res):
        r = np.asarray(res).reshape(n, -1)
        return (50.0 ** 2 * np.log1p((r / 50.0) ** 2)).sum(1)

    np.testing.assert_allclose(point_costs(got["residuals"]["after"]),
                               point_costs(want["residuals"]["after"]),
                               rtol=chip_smoke.LM_COST_RTOL)


@pytest.mark.parametrize("writer", WRITERS)
def test_ekf_matches_jax(jax_results, port_results, writer):
    """The pixels, likelihoods and rig handed to the filter are the JAX
    package's exactly, its nose-track init (a line fit of the
    triangulation) at TRI's 1e-9; states, error bars and positions at
    tests/test_torch_ekf.py's 1e-8 of scale."""
    (want, wcalls), (got, gcalls) = jax_results[writer]["ekf"], port_results[writer]["ekf"]
    gk, wk = _assert_same_core_inputs(gcalls, wcalls, 6)  # and fps, cam_res, dlc_thresh
    np.testing.assert_allclose(gk["x0_pose"], wk["x0_pose"], rtol=0, atol=1e-9)
    assert got["outliers"] == want["outliers"]
    assert set(got["states"]) == set(want["states"])
    for key, w in list(want["states"].items()) + [("positions", want["positions"])]:
        g = got["positions"] if key == "positions" else got["states"][key]
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("writer", WRITERS)
def test_fte_matches_jax(runs, jax_results, port_results, writer):
    """The arrays handed to fte_run equal the JAX package's exactly; the
    default 'pcg' solve: cost0 at 1e-12 and the cost at 5e-3, both within
    tests/test_pipeline_e2e.py's 0.05 m of the truth."""
    (want, wcalls), (got, gcalls) = jax_results[writer]["fte"], port_results[writer]["fte"]
    gk, wk = _assert_same_core_inputs(gcalls, wcalls, 6)  # and fps, dlc_thresh
    cases.assert_equal_arrays(gk["frames"], wk["frames"], "frames")
    assert gk["frames"][0] == START - 1
    assert (gk["num_iters"], gk["uncertainty"]) == (wk["num_iters"], wk["uncertainty"])
    np.testing.assert_allclose(got["cost0"], want["cost0"], rtol=1e-12)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=PCG_COST_RTOL)
    assert got["converged"] == want["converged"]
    assert got["cost_history"].shape == want["cost_history"].shape == (FTE_ITERS,)
    truth = runs[1][START - 1:END]
    for res in (got, want):
        assert np.nanmean(np.linalg.norm(res["positions"] - truth, axis=-1)) < 0.05


def test_fte_with_the_exact_solver_matches_jax(tmp_path, runs, jax_results, port_results):
    """The fte stage with both packages' default_config switched to
    'chol_unrolled' (the exact banded Cholesky): x and positions at 1e-5,
    the cost at 1e-6 and its history per iterate, as
    tests/test_torch_sweep.py holds the stage."""
    from dataclasses import replace

    run = runs[0]["jax"]
    out = {}
    for name, module in (("jax", jfte), ("port", tfte)):
        default = module.default_config
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "default_config", lambda fps, num_iters=60, default=default:
                       replace(default(fps, num_iters), linear_solver="chol_unrolled"))
            kw = dict(device="cpu") if name == "port" else {}
            out[name] = module.fte(run, START, END, cases.THRESH, out_dir=str(tmp_path / name),
                                   num_iters=FTE_ITERS, **kw)
    got, want = out["port"], out["jax"]
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-5)
    np.testing.assert_allclose(got["positions"], want["positions"], atol=1e-5)
    np.testing.assert_allclose(got["cost_history"], want["cost_history"], rtol=1e-6)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-6)
    assert got["converged"] == want["converged"]


@pytest.mark.parametrize("stage", ["tri", "sba", "ekf", "fte"])
def test_pickles_have_the_jax_layout_and_no_torch(runs, jax_results, port_results, stage):
    """Same keys, shapes and dtypes as the JAX package's pickles, and no
    torch object anywhere in them."""
    run = runs[0]["port"]
    got, want = _pickle(run, stage), _pickle(run, stage, "jax")
    cases.assert_no_torch(got)
    cases.assert_same_layout(got, want)
    assert got["start_frame"] == want["start_frame"] == START - 1
    if stage == "fte":  # states in the reference's column order
        res = port_results["port"]["fte"][0]
        cases.assert_equal_arrays(got["x"], res["x"][:, tcheetah.FTE_SAVE_ORDER])
        for key in ("cost", "cost0", "converged", "grad_norm"):
            assert got[key] == res[key], key


def _jax_reprojection(path):
    """The JAX package's reprojection file: a pandas .h5 where PyTables is
    installed, else the DataFrame pickle it falls back to."""
    return pd.read_hdf(path) if path.endswith(".h5") else pd.read_pickle(path)


def test_reprojections_equal_jax_dataframes(tmp_path, runs):
    """save_3d_cheetah_as_2d on the same positions (a marker and a frame
    NaN): per camera, the port's .h5 read back (by the JAX package's
    reader and the port's) holds the JAX DataFrame's index, columns and
    values (pixels within 1e-9 px, likelihood exactly)."""
    run = runs[0]["jax"]
    scene = jdata.find_scene_file(run, verbose=False)[-1]
    pos = np.asarray(cases.make_run(tmp_path / "truth", N=12)[1])
    pos[3, 5] = np.nan
    pos[7] = np.nan
    markers = tcheetah.get_markers()
    start = 17
    os.makedirs(tmp_path / "j")
    jpaths = japp.save_3d_cheetah_as_2d(pos, str(tmp_path / "j"), scene, markers,
                                        jcam.project_points_fisheye, start)
    tpaths = tapp.save_3d_cheetah_as_2d(pos, str(tmp_path / "t"), scene, markers,
                                        tcam.project_points_fisheye, start, device="cpu")
    assert [os.path.basename(p) for p in tpaths] == [
        f"cheetah_reprojected_cam{c + 1}.h5" for c in range(cases.N_CAMS)]
    for jp, tp in zip(jpaths, tpaths):
        df = _jax_reprojection(jp)
        frames, bodyparts, vals = jdata._read_dlc_h5(tp)
        frames_t, bodyparts_t, vals_t = tdata._read_dlc_h5(tp)
        cases.assert_equal_arrays(frames_t, frames)
        assert bodyparts_t == bodyparts == markers
        cases.assert_equal_arrays(vals_t, vals)
        np.testing.assert_array_equal(frames, df.index.to_numpy())
        assert list(df.columns) == [("acinoset_tpu", m, c) for m in markers
                                    for c in ("x", "y", "likelihood")]
        want = df.to_numpy().reshape(len(frames), len(markers), 3)
        np.testing.assert_array_equal(vals[..., 2], want[..., 2])
        np.testing.assert_array_equal(np.isnan(vals), np.isnan(want))
        np.testing.assert_allclose(vals[..., :2], want[..., :2], rtol=0, atol=1e-9)


def test_fte_reprojections_are_its_positions_projected(runs, port_results):
    """The port's fte stage wrote, per camera, the projection of the
    positions in its fte.pickle."""
    run = runs[0]["port"]
    payload = _pickle(run, "fte")
    k, d, r, t, *_ = tdata.find_scene_file(run, verbose=False)
    for c in range(cases.N_CAMS):
        frames, _bp, vals = tdata._read_dlc_h5(
            os.path.join(run, "fte", f"cheetah_reprojected_cam{c + 1}.h5"))
        np.testing.assert_array_equal(frames, np.arange(START - 1, END))
        want = tmetrics.reproject_positions(payload["positions"], k[c], d[c], r[c], t[c],
                                            device="cpu")
        cases.assert_equal_arrays(vals[..., :2], want)


def test_eval_metrics_match_jax(runs, port_results):
    """reproject_positions, evaluate_reconstruction, reprojection_errors,
    positions_rmse_3d and bbox_diag on the fte result against the run's
    DLC labels, at 1e-9 relative."""
    run = runs[0]["jax"]
    payload = _pickle(run, "fte")
    k, d, r, t, *_ = jdata.find_scene_file(run, verbose=False)
    p2d = jdata.load_dlc_points(sorted(glob.glob(os.path.join(run, "dlc", "*.h5"))))
    gt = [p2d.pixels[c, START - 1:END] for c in range(cases.N_CAMS)]
    gt[1][2, 4] = np.nan
    pos = payload["positions"].copy()
    pos[0, 0] = np.nan
    cams = [2, 0, 3]
    want = jmetrics.evaluate_reconstruction(pos, [gt[c] for c in cams], k, d, r, t,
                                            cam_indices=cams)
    got = tmetrics.evaluate_reconstruction(pos, [gt[c] for c in cams], k, d, r, t,
                                           cam_indices=cams, device="cpu")
    assert set(got) == set(want) == {"cam3", "cam1", "cam4", "overall"}
    for cam in want:
        assert set(got[cam]) == set(want[cam])
        for key, w in want[cam].items():
            np.testing.assert_allclose(got[cam][key], w, rtol=1e-9, err_msg=(cam, key))
    np.testing.assert_allclose(
        tmetrics.reprojection_errors(pos, gt, k, d, r, t, device="cpu"),
        jmetrics.reprojection_errors(pos, gt, k, d, r, t), rtol=1e-9)
    for c in range(cases.N_CAMS):
        np.testing.assert_allclose(
            tmetrics.reproject_positions(pos, k[c], d[c], r[c], t[c], device="cpu"),
            jmetrics.reproject_positions(pos, k[c], d[c], r[c], t[c]), rtol=1e-9)
    np.testing.assert_allclose(tmetrics.bbox_diag(gt[1]), jmetrics.bbox_diag(gt[1]), rtol=1e-12)
    truth = runs[1][START - 1:END]
    assert tmetrics.positions_rmse_3d(pos, truth) == jmetrics.positions_rmse_3d(pos, truth)


@pytest.mark.parametrize("layout", ["dlc", "data"])
def test_bodyparts_and_part_path_match_jax(tmp_path, runs, layout):
    """get_bodyparts and estimate_part_path on a project with dlc/ and
    its scene found walking up, and with data/ holding both the DLC files
    and the named scene; the line fit at 1e-9 relative."""
    run = runs[0]["jax"]
    if layout == "data":
        proj = tmp_path / "proj"
        os.makedirs(proj / "data")
        for f in sorted(os.listdir(os.path.join(run, "dlc"))):
            os.symlink(os.path.join(run, "dlc", f), proj / "data" / f)
        scene = jdata.find_scene_file(run, verbose=False)[-1]
        os.symlink(scene, proj / "data" / "4_cam_scene_static_sba.json")
        run = str(proj)
    assert tp2d.get_bodyparts(run) == jp2d.get_bodyparts(run) == tcheetah.get_markers()
    for part in ("nose", "tail2"):
        got = tp2d.estimate_part_path(run, part, dlc_thresh=cases.THRESH, device="cpu")
        want = jp2d.estimate_part_path(run, part, dlc_thresh=cases.THRESH)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


def _same(a, b):
    """Parsed JSON values equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def _viewer_data(path):
    html = open(path).read()
    m = re.search(r"const DATA = (.*);\n", html)
    # NaN is a JavaScript literal in the page; json reads it back
    return json.loads(m.group(1)), html


@pytest.mark.parametrize("with_scene", [True, False])
def test_viewer_embeds_the_jax_packages_data(tmp_path, runs, port_results, with_scene):
    run = runs[0]["jax"]
    payload = _pickle(run, "fte")
    pos = payload["positions"].copy()
    pos[1, 2] = np.nan
    std = np.abs(pos) * 1e-3
    std[2, 3] = np.nan
    scene = jdata.load_scene(payload["scene_fpath"])[:4] if with_scene else None
    kw = dict(markers=tcheetah.get_markers(), scene=scene, fps=90.0, marker_std=std)
    got, ghtml = _viewer_data(tviewer.export_interactive_html(pos, str(tmp_path / "t.html"), **kw))
    want, whtml = _viewer_data(jviewer.export_interactive_html(pos, str(tmp_path / "j.html"),
                                                               **kw))
    assert set(got) == set(want) == {"positions", "links", "cameras", "trace_idx", "std"}
    for key in want:
        assert _same(got[key], want[key]), key
    assert (got["cameras"] is None) != with_scene
    assert ghtml == whtml


def test_triangulate_runs_batch_matches_jax(runs):
    """Two runs padded into one batch (the second's last frames and a
    camera's detections masked out), at TRI's 1e-9 m."""
    run = runs[0]["jax"]
    k, d, r, t, *_ = jdata.find_scene_file(run, verbose=False)
    p2d = jdata.load_dlc_points(sorted(glob.glob(os.path.join(run, "dlc", "*.h5"))))
    px = np.stack([np.nan_to_num(p2d.pixels), np.nan_to_num(p2d.pixels[:, ::-1])])
    valid = np.stack([p2d.valid(cases.THRESH), p2d.valid(cases.THRESH)[:, ::-1]])
    valid[1, :, 30:] = False
    valid[1, 2] = False
    aux = [np.stack([a, a]) for a in (k, d.reshape(-1, 4, 1), r, t)]
    got = ttri.triangulate_runs_batch(px, valid, aux, device="cpu")
    want = jtri.triangulate_runs_batch(px, valid, aux)
    assert got.shape == (2, N, 20, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_sba_points_fisheye_matches_jax(runs):
    """On a Points2D window and the run's scene file, at
    tests/test_torch_lm_sba.py's 1e-6 m."""
    run = runs[0]["jax"]
    scene = jdata.find_scene_file(run, verbose=False)[-1]
    fpaths = sorted(glob.glob(os.path.join(run, "dlc", "*.h5")))
    win_t = tdata.load_dlc_points(fpaths, markers=tcheetah.get_markers()).window(5, 25)
    win_j = jdata.load_dlc_points(fpaths, markers=tcheetah.get_markers()).window(5, 25)
    cases.assert_equal_arrays(win_t.pixels, win_j.pixels)
    cases.assert_equal_arrays(win_t.frames, win_j.frames)
    got, _ = tsba.sba_points_fisheye(scene, win_t, cases.THRESH, device="cpu")
    want, _ = jsba.sba_points_fisheye(scene, win_j, cases.THRESH)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=chip_smoke.LM_STATE_ATOL)


def test_logging_tee_writes_what_jax_writes(tmp_path, capsys):
    for name, module in (("jax", japp), ("port", tapp)):
        module.start_logging(str(tmp_path / name / "log.txt"))
        print("first line")
        module.start_logging(str(tmp_path / name / "second.txt"))  # closes the first
        print("second", 2)
        module.stop_logging()
        module.stop_logging()  # a second stop is a no-op
        print("not logged")
    for f in ("log.txt", "second.txt"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    assert (tmp_path / "port" / "second.txt").read_text() == "second 2\n"
    assert capsys.readouterr().out.count("not logged") == 2
