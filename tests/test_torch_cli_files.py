"""The port's command line (acinoset_tpu_torch.cli) against the JAX
package's (acinoset_tpu.cli) on the same run directory, with
``--device cpu``, in float64.

``all`` runs in both and its pickles are held at the stages' own
tolerances (tests/test_torch_pipeline_files.py). The single-stage
subcommands, ``sweep`` and ``build`` hand their stage the JAX CLI's
arguments (stage functions recorded in both packages, not solved), and
each single stage writes what ``all`` wrote, and ``all`` writes the
plots where the JAX CLI does. ``view`` and ``eval`` (with ``--hist``)
run in both. The ``dlc`` stage names each labelled video it does not
write and goes on; every subcommand refuses without a CUDA device unless
given ``--device cpu``.
"""
import ast
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
import file_pipeline_cases as cases
from acinoset_tpu import cli as jcli
from acinoset_tpu.eval import metrics as jmetrics
from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.pipeline import generic as jgen
from acinoset_tpu.pipeline import sba as jsba
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu.pipeline import tri as jtri
from acinoset_tpu_torch import cli as tcli
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.pipeline import fte as tfte
from acinoset_tpu_torch.pipeline import generic as tgen
from acinoset_tpu_torch.pipeline import sba as tsba
from acinoset_tpu_torch.pipeline import sweep as tsweep
from acinoset_tpu_torch.pipeline import tri as ttri
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import h26x, png
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
N = 40
STAGES = ("tri", "sba", "ekf", "fte")
STAGE_FNS = {"tri": (jtri, ttri), "sba": (jsba, tsba), "ekf": (jekf, tekf), "fte": (jfte, tfte)}
#: tests/test_torch_sweep.py's bound on the final 'pcg' cost of a run
#: that is rounding-chaotic in both packages
PCG_COST_RTOL = 5e-3


def _load(run, stage):
    return jdata.load_pickle(os.path.join(run, stage, f"{stage}.pickle"))


@pytest.fixture(scope="module")
def ran_all(tmp_path_factory):
    """``all`` in both CLIs, each on its own copy of one run."""
    base = tmp_path_factory.mktemp("cli")
    src, pts = cases.make_run(base / "src", "port", N=N)
    runs = {}
    for name in ("jax", "port"):
        runs[name] = str(shutil.copytree(src, base / name / "run"))
        shutil.copytree(os.path.join(src, "..", "extrinsic_calib"),
                        base / name / "extrinsic_calib")
    assert jcli.main(["all", "--data_dir", runs["jax"], "--dlc_thresh", "0.5"]) == 0
    assert tcli.main(["all", "--data_dir", runs["port"], "--dlc_thresh", "0.5",
                      "--device", "cpu"]) == 0
    return runs, pts


def test_all_matches_jax_cli(ran_all, capsys):
    runs, pts = ran_all
    got = {s: _load(runs["port"], s) for s in STAGES}
    want = {s: _load(runs["jax"], s) for s in STAGES}
    for s in STAGES:
        cases.assert_no_torch(got[s])
        cases.assert_same_layout(got[s], want[s])
    np.testing.assert_allclose(got["tri"]["positions"], want["tri"]["positions"], atol=1e-9)
    np.testing.assert_allclose(got["sba"]["positions"], want["sba"]["positions"],
                               atol=chip_smoke.LM_STATE_ATOL)
    for key, w in want["ekf"].items():
        if isinstance(w, np.ndarray) and w.dtype.kind == "f":
            np.testing.assert_allclose(got["ekf"][key], w, rtol=1e-8,
                                       atol=1e-8 * np.abs(w).max(), err_msg=key)
    np.testing.assert_allclose(got["fte"]["cost0"], want["fte"]["cost0"], rtol=1e-12)
    np.testing.assert_allclose(got["fte"]["cost"], want["fte"]["cost"], rtol=PCG_COST_RTOL)
    assert got["fte"]["converged"] == want["fte"]["converged"]
    for res in (got, want):
        assert np.nanmedian(np.linalg.norm(res["tri"]["positions"] - pts, axis=-1)) < 0.05
        assert np.nanmean(np.linalg.norm(res["fte"]["positions"] - pts, axis=-1)) < 0.05
    # the plots: each written where the JAX CLI writes it, and read back
    for rel in ("fte/fte.svg", "ekf/ekf.pdf", "reconstructions.png"):
        assert os.path.exists(os.path.join(runs["jax"], rel))
        assert os.path.exists(os.path.join(runs["port"], rel))
    assert sorted(os.listdir(os.path.join(runs["port"], "fte"))) == sorted(
        ["fte.pickle", "fte.svg"]
        + [f"cheetah_reprojected_cam{c + 1}.h5" for c in range(cases.N_CAMS)])
    failed = []
    chip_smoke.files_plots_check(runs["port"], failed)  # fte.svg, ekf.pdf, the png, x held
    assert not failed, failed
    img = png.read_png(os.path.join(runs["port"], "reconstructions.png"))
    jax_img = png.read_png(os.path.join(runs["jax"], "reconstructions.png"))
    assert img.shape[:2] == jax_img.shape[:2] == (600, 1400)
    assert png.read_png_text(os.path.join(runs["port"], "reconstructions.png"))[
        "axes 1 legend"] == "sba; ekf; fte"


def _recorders(monkeypatch, modules, name):
    """Replace ``name`` in each package's module by a recorder; returns the
    record {package: [(args, kwargs)]}, the port's device dropped."""
    calls = {}
    for package, module in zip(("jax", "port"), modules):
        def record(*args, _package=package, **kw):
            kw.pop("device", None)
            calls.setdefault(_package, []).append((args, kw))
            return {}
        monkeypatch.setattr(module, name, record)
    return calls


@pytest.mark.parametrize("stage", STAGES)
def test_single_stage_forwards_like_jax_and_writes_what_all_wrote(tmp_path, ran_all, stage,
                                                                  monkeypatch):
    runs, _pts = ran_all
    flags = ["--data_dir", runs["port"], "--start_frame", "3", "--end_frame", "30",
             "--dlc_thresh", "0.6", "--uncertainty"]
    with monkeypatch.context() as mp:
        calls = _recorders(mp, STAGE_FNS[stage], stage)
        jcli.main([stage] + flags)
        tcli.main([stage] + flags + ["--device", "cpu"])
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1
    # the stage alone writes what `all` wrote, on a copy of the run
    run = str(shutil.copytree(runs["port"], tmp_path / "run"))
    shutil.copytree(os.path.join(runs["port"], "..", "extrinsic_calib"),
                    tmp_path / "extrinsic_calib")
    shutil.rmtree(os.path.join(run, stage))
    assert tcli.main([stage, "--data_dir", run, "--dlc_thresh", "0.5", "--device", "cpu"]) == 0
    got, want = _load(run, stage), _load(runs["port"], stage)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            cases.assert_equal_arrays(got[key], w, key)
        elif key == "scene_fpath":  # the same scene, found from the copy
            assert os.path.relpath(got[key], run) == os.path.relpath(w, runs["port"])
        else:
            assert got[key] == w, key


def test_dlc_stage_without_videos_prints_the_jax_skip_line(ran_all, capsys):
    runs, _pts = ran_all
    for cli in (jcli, tcli):
        argv = ["dlc", "--data_dir", runs["port"]] + (["--device", "cpu"] if cli is tcli else [])
        assert cli.main(argv) == 0
        assert "No videos found; skipping dlc video labeling" in capsys.readouterr().out


def test_dlc_stage_with_videos_raises_before_any_work(tmp_path, capsys):
    """The name is the old one; the stage no longer raises. Beside the
    run's labels (named to end in cam{c}.h5, which create_labeled_videos
    looks for), cam1 is a box-only video that declares the run's size,
    fps and 12 frames (and there is no video_info.json), cam2 an mp4v
    file whose second sample is a B-VOP, cam3 real mp4v footage, cam4
    real H.264 (avc1, utils.h26x's random-syntax writer, CABAC with B
    frames). ``dlc`` writes a labelled video for each file it decodes (no
    frame for a box-only one, as the JAX package's cv2 writes; cam4's
    bytes equal mpeg4.Writer fed the port's draw_labels of cv2's frames),
    names the B-VOP one in a ``Not written:`` line and leaves no file at
    that path; ``all`` goes on and writes every stage's pickle, its frame
    count read from the videos."""
    from acinoset_tpu_torch.utils import mp4, mpeg4

    run, _pts = cases.make_run(tmp_path, "port", N=12)
    os.remove(os.path.join(run, "video_info.json"))
    for c in range(cases.N_CAMS):
        os.rename(os.path.join(run, "dlc", f"cam{c + 1}DLC.h5"),
                  os.path.join(run, "dlc", f"cam{c + 1}DLC_cam{c + 1}.h5"))
    tsyn.write_box_mp4(os.path.join(run, "cam1.mp4"), (2704, 1520), 90.0, 12)
    cam4 = h26x.write_mp4(os.path.join(run, "cam4.mp4"),
                          h26x.RandomH264((176, 144), 12, seed=4, cabac=True), 90.0)
    config = mpeg4.write_config((64, 48), 90)
    levels = np.zeros((72, 64), np.int16)
    levels[:, 0] = 100
    intra = mpeg4.encode_vop(mpeg4.parse_config(config), 0, 4,
                             np.full((12, 5), (mpeg4.MB_INTRA, 0, 0, 0, 0), np.int16), levels)
    with mp4.Mp4Writer(os.path.join(run, "cam2.mp4"), (64, 48), 90.0, config) as w:
        w.add_sample(intra, True)
        w.add_sample(b"\x00\x00\x01\xb6\x80" + bytes(8), False)  # vop_coding_type 2
    tsyn.write_scene_mp4(os.path.join(run, "cam3.mp4"), (64, 48), 90.0, 12, seed=3)
    labelled = [os.path.join(run, "dlc", f"cam{c + 1}_labeled.mp4") for c in range(4)]
    lines = [f"Not written: {labelled[1]} (B-VOPs: the port decodes MPEG-4 Simple Profile I-, "
             "P- and N-VOPs only)"]
    ref = str(tmp_path / "cam4_ref.mp4")
    cap = cv2.VideoCapture(cam4)
    frames_idx, markers, vals = tvideo._load_2d_labels(
        os.path.join(run, "dlc", "cam4DLC_cam4.h5"))
    markers = list(markers)
    links = [(markers.index(a), markers.index(b)) for a, b in tvideo.CHEETAH_LINKS
             if a in markers and b in markers]
    colours = np.array(tvideo.marker_colours(len(markers)), np.uint8).reshape(-1, 3)
    rows = {int(f): i for i, f in enumerate(frames_idx)}
    with mpeg4.Writer(ref, (176, 144), 90.0, "cpu") as w:
        for n in range(12):
            ok, f = cap.read()
            assert ok
            frame = torch.from_numpy(f)
            if n in rows:
                seg, dots, which = tvideo._frame_labels(vals[rows[n]], links, 0.5, True)
                tvideo.draw_labels(frame, seg, dots, colours[which])
            w.write(frame)
    for cmd in ("dlc", "all"):
        assert tcli.main([cmd, "--data_dir", run, "--dlc_thresh", "0.5", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert [ln for ln in out.splitlines() if ln.startswith("Not written")] == lines
        frames = []
        for c in (0, 2, 3):
            assert f"Saved {labelled[c]}" in out
            with mpeg4.Reader(labelled[c], device="cpu") as r:
                frames.append((r.n_frames, r.read(r.n_frames - 1) is not None))
        assert frames == [(0, False), (12, True), (12, True)]
        assert not os.path.exists(labelled[1])
        with open(labelled[3], "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
    for s in STAGES:
        assert _load(run, s)["positions"].shape == (12, 20, 3)
    for rel in ("fte/fte.svg", "ekf/ekf.pdf", "reconstructions.png"):
        assert os.path.exists(os.path.join(run, rel))


SWEEP_FLAGS = [
    ["--num_iters", "9", "--max_frames", "20", "--dlc_thresh", "0.6", "--stages", "fte,ekf",
     "--warm_start", "on", "--relinearize_every", "2", "--uncertainty", "--no_rescue"],
    ["--skeleton", "sk.pickle", "--init_marker", "nose", "--warm_start", "off"],
    [],
]


@pytest.mark.parametrize("flags", SWEEP_FLAGS, ids=["cheetah", "skeleton", "defaults"])
def test_sweep_forwards_like_jax(monkeypatch, flags):
    name = "sweep_generic" if "--skeleton" in flags else "sweep"
    calls = _recorders(monkeypatch, (jsweep, tsweep), name)
    jcli.main(["sweep", "--root_dir", "root"] + flags)
    tcli.main(["sweep", "--root_dir", "root"] + flags + ["--device", "cpu"])
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1


def test_sweep_cli_writes_every_runs_pickles(tmp_path, capsys):
    root = tmp_path / "root"
    runs = cases.make_dataset(root, "port", runs=(("a", 16, 90.0, 1), ("b", 14, 120.0, 2)))
    assert tcli.main(["sweep", "--root_dir", str(root), "--stages", "fte,ekf", "--num_iters",
                      "4", "--dlc_thresh", "0.5", "--device", "cpu"]) == 0
    for run in runs:
        for stage in ("fte", "ekf"):
            payload = _load(run, stage)
            cases.assert_no_torch(payload)
            assert payload["positions"].dtype == np.float64
    assert "Found 2 runs under" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--skeleton", "s.pickle", "--start_frame", "5",
                                        "--n_frames", "50", "--dlc_thresh", "0.3"]])
def test_build_forwards_like_jax(monkeypatch, flags):
    calls = _recorders(monkeypatch, (jgen, tgen), "build_and_solve")
    jcli.main(["build", "--top_dir", "proj"] + flags)
    tcli.main(["build", "--top_dir", "proj"] + flags + ["--device", "cpu"])
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1


@pytest.mark.parametrize("scene", [False, True])
def test_view_matches_jax_cli(tmp_path, ran_all, scene):
    runs, _pts = ran_all
    result = os.path.join(runs["port"], "fte", "fte.pickle")
    extra = ["--fps", "45"]
    if scene:
        extra += ["--scene", jdata.find_scene_file(runs["port"], verbose=False)[-1]]
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out[name] = str(tmp_path / f"{name}.html")
        argv = ["view", "--result", result, "--out", out[name]] + extra
        assert cli.main(argv + (["--device", "cpu"] if cli is tcli else [])) == 0
    assert open(out["port"]).read() == open(out["jax"]).read()


def _printed_metrics(text):
    rows = {}
    for line in text.splitlines():
        cam, sep, rest = line.partition(" ")
        if sep and rest.startswith("{"):
            rows[cam] = ast.literal_eval(rest)
    return rows


@pytest.mark.parametrize("options", [False, True])
def test_eval_matches_jax_cli(ran_all, capsys, options):
    """The printed metrics (rounded to 4 places by both) agree within the
    rounding step; by default and with --start_frame and --scene given."""
    runs, _pts = ran_all
    extra = (["--start_frame", "0", "--scene",
              jdata.find_scene_file(runs["port"], verbose=False)[-1]] if options else [])
    h5s = sorted(os.path.join(runs["port"], "dlc", f) for f in os.listdir(
        os.path.join(runs["port"], "dlc")))
    argv = ["eval", "--result", os.path.join(runs["port"], "fte", "fte.pickle"), "--gt_h5",
            *h5s[:3], "--cams", "0", "1", "2"] + extra
    capsys.readouterr()
    assert jcli.main(argv) == 0
    want = _printed_metrics(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = _printed_metrics(capsys.readouterr().out)
    assert set(got) == set(want) == {"cam1", "cam2", "cam3", "overall"}
    for cam in want:
        assert set(got[cam]) == set(want[cam])
        for key, w in want[cam].items():
            assert abs(got[cam][key] - w) <= 1e-4, (cam, key, got[cam][key], w)


def test_eval_hist_raises(ran_all, tmp_path, capsys, monkeypatch):
    """The name is the old one; ``--hist`` no longer raises. It writes the
    histogram, with the counts of np.histogram over the JAX package's
    reprojection errors on the same inputs, and prints the JAX CLI's line."""
    runs, _pts = ran_all
    h5s = [os.path.join(runs["port"], "dlc", f"cam{c}DLC.h5") for c in (1, 2)]
    argv = ["eval", "--result", os.path.join(runs["port"], "fte", "fte.pickle"), "--gt_h5",
            *h5s, "--cams", "0", "1", "--hist"]
    errors = []
    monkeypatch.setattr(jmetrics, "save_error_histogram",
                        lambda errs, path: errors.append(errs) or path)
    capsys.readouterr()
    assert jcli.main(argv + [str(tmp_path / "jax.png")]) == 0
    want = capsys.readouterr().out.splitlines()[-1]
    out = str(tmp_path / "h.png")
    assert tcli.main(argv + [out, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()[-1]
    assert got == want.replace(str(tmp_path / "jax.png"), out)
    assert got == f"saved histogram: {out} ({errors[0].size} points)"
    heights = png.read_png_text(out)["axes 1 bars 1 heights"].split()
    np.testing.assert_array_equal([float(v) for v in heights], np.histogram(errors[0], 20)[0])
    assert png.read_png(out).shape == (480, 720, 3)


@pytest.mark.parametrize("argv", [
    [cmd, "--data_dir", "run"] for cmd in STAGES + ("dlc", "all")] + [
    ["sweep", "--root_dir", "root"], ["build", "--top_dir", "proj"],
    ["view", "--result", "r.pickle"], ["eval", "--result", "r.pickle", "--gt_h5", "a.h5",
                                       "--cams", "0"]],
    ids=lambda argv: argv[0])
def test_every_subcommand_refuses_without_cuda(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
