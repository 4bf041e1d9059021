"""The port stands alone: importing it (and chip_smoke.py) pulls in
neither JAX, nor the JAX package, nor the JAX package's I/O stack; and
its entry points refuse to fall back to the CPU silently."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import acinoset_tpu_torch
from acinoset_tpu_torch import cli as tcli
from acinoset_tpu_torch import entry as tentry
from acinoset_tpu_torch.calib import app as tapp
from acinoset_tpu_torch.calib import corners as tcorners
from acinoset_tpu_torch.eval import metrics as tmetrics
from acinoset_tpu_torch.ops import camera as tcam
from acinoset_tpu_torch.parallel import mesh as tmesh
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.pipeline import app as tpapp
from acinoset_tpu_torch.pipeline import fte as tfte
from acinoset_tpu_torch.pipeline import generic as tgen
from acinoset_tpu_torch.pipeline import plots as tplots
from acinoset_tpu_torch.pipeline import points2d as tp2d
from acinoset_tpu_torch.pipeline import sba as tsba
from acinoset_tpu_torch.pipeline import sweep as tsweep
from acinoset_tpu_torch.pipeline import tri as ttri
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.probes import probe_mosaic as tpm
from acinoset_tpu_torch.probes import probe_mosaic2 as tpm2
from acinoset_tpu_torch.solvers import trajopt as ttraj
from acinoset_tpu_torch.utils import mpeg4 as tmpeg4
from acinoset_tpu_torch.utils import nvdec as tnvdec
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "acinoset_tpu", "h5py", "imageio", "pandas", "cv2", "matplotlib")


def test_port_and_chip_smoke_import_no_jax_nor_io_stack():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(acinoset_tpu_torch.__path__, "acinoset_tpu_torch.")
    )
    for m in ("kernels.banded_cuda", "kernels._nvcc", "kernels.probes_cuda", "probes.probe_mosaic",
              "probes.probe_mosaic2", "pipeline.sweep", "solvers.ekf", "solvers.cyclic",
              "models.skeleton", "pipeline.generic", "solvers.lm", "pipeline.sba", "pipeline.data",
              "calib.pnp", "calib.intrinsics", "calib.extrinsics", "calib.corners", "calib.native",
              "calib.app", "utils.png", "utils._gxx", "cli", "utils.hdf5", "utils.mp4",
              "pipeline.app", "pipeline.tri", "pipeline.points2d", "pipeline.viewer",
              "eval.metrics", "parallel.mesh", "entry", "utils.profiling",
              "utils.pan_compensation", "gui.label_session", "gui.skeleton_builder",
              "pipeline.plots", "pipeline.video", "utils.argus", "utils.figure",
              "utils.mpeg4", "utils.h26x", "utils.nvdec", "utils.h264", "utils.hevc"):
        assert f"acinoset_tpu_torch.{m}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['acinoset_tpu_torch', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _solve_args():
    k, d, r, t, _res = tsyn.ring_cameras(n_cams=2)
    cfg = tfte.default_config(90.0, num_iters=1)
    X0 = np.zeros((1, 8, 25))
    meas = np.zeros((1, 8, 2, 20, 2))
    w = np.ones((1, 8, 2, 20))
    return tekf.make_hj_parts_fn(k, d, r, t, device="cpu"), X0, meas, w, cfg


def _pixels():
    cams = tsyn.ring_cameras(n_cams=2)
    px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=8), cams, seed=0)
    return cams[:4], px, lik


def _sweep_runs():
    cams, px, lik = _pixels()
    k, d, r, t = cams
    return [tsweep.RunData("run", px, lik, (k, d.reshape(-1, 4), r, t.reshape(-1, 3)), 90.0, 0, "")]


ENTRY_POINTS = {
    "make_hj_parts_fn": lambda: tekf.make_hj_parts_fn(*_pixels()[0]),
    "make_h_fn": lambda: tekf.make_h_fn(*_pixels()[0]),
    "fte_solve": lambda: ttraj.fte_solve(*_solve_args()),
    "fte_run": lambda: tfte.fte_run(_pixels()[1], _pixels()[2], *_pixels()[0], fps=90.0,
                                    dlc_thresh=0.5, num_iters=1),
    "initial_trajectory_batch": lambda: tfte.initial_trajectory_batch(
        _pixels()[1][None], _pixels()[2][None], [a[None] for a in _pixels()[0]], np.arange(8), 0.5),
    "solve_batch": lambda: tsweep.solve_batch(_sweep_runs(), 0.5, num_iters=1),
    "solve_batch_ekf": lambda: tsweep.solve_batch_ekf(_sweep_runs(), 0.5),
    "make_hj_fn": lambda: tekf.make_hj_fn(*_pixels()[0]),
    "run_cheetah_ekf": lambda: tekf.run_cheetah_ekf(
        _pixels()[1].transpose(1, 0, 2, 3), _pixels()[2].transpose(1, 0, 2), *_pixels()[0],
        fps=90.0, cam_res=(2704, 1520), dlc_thresh=0.5),
    "marker_std_from_smoothed": lambda: tekf.marker_std_from_smoothed(
        np.zeros((2, 25)), np.tile(np.eye(25), (2, 1, 1))),
    "time_chain": lambda: tpm2.time_chain(1, K=1),
    "entry": lambda: tentry.entry(),
    "make_mesh": lambda: tmesh.make_mesh(),
    "find_corners_batch": lambda: tcorners.find_corners_batch([np.zeros((32, 32))], (9, 6)),
    "find_corners": lambda: tcorners.find_corners(np.zeros((32, 32)), (9, 6)),
    "find_corners_images": lambda: tcorners.find_corners_images([], (9, 6)),
    "extract_corners_from_images": lambda: tapp.extract_corners_from_images(
        os.path.join(ROOT, "no_such_dir"), os.path.join(ROOT, "no_such_dir", "p.json"), (9, 6),
        0.04),
    "adjust_extrinsics_manual_points": lambda: tapp.adjust_extrinsics_manual_points(
        "scene.json", "manual_points.json"),
    **{name: (lambda fn=getattr(tcam, name): fn(np.zeros((4, 6)), np.eye(3), np.zeros(4)))
       for name in ("undistort_image_fisheye", "undistort_image_pinhole")},
    **{name: (lambda fn=getattr(tcam, name): fn(np.eye(3), np.zeros(4), np.eye(3), (6, 4)))
       for name in ("undistort_rectify_map_fisheye", "undistort_rectify_map_pinhole")},
    "cli calib": lambda: tcli.main(["calib", "--scene_dir", "extrinsic_calib"]),
    **{f"{name} (file level)": (lambda fn=fn: fn("no_such_run", 1, -1, 0.5))
       for name, fn in (("tri", ttri.tri), ("sba", tsba.sba), ("ekf", tekf.ekf),
                        ("fte", tfte.fte))},
    "triangulate_runs_batch": lambda: ttri.triangulate_runs_batch(
        np.zeros((1, 2, 3, 20, 2)), np.ones((1, 2, 3, 20), bool),
        [a[None] for a in _pixels()[0]]),
    "sba_points_fisheye": lambda: tsba.sba_points_fisheye("no_scene.json", None),
    "save_3d_cheetah_as_2d": lambda: tpapp.save_3d_cheetah_as_2d(
        np.zeros((2, 20, 3)), "out", "no_scene.json", [], None, 0),
    "estimate_part_path": lambda: tp2d.estimate_part_path("no_such_project", "nose"),
    "get_pairwise_3d_points_from_df": lambda: ttri.get_pairwise_3d_points_from_df(
        {"frame": [0], "camera": [0], "marker": ["nose"], "x": [1.0], "y": [1.0]},
        *_pixels()[0]),
    "plot_points_fisheye_undistort": lambda: tplots.plot_points_fisheye_undistort(
        "points.json", "camera.json"),
    "sweep": lambda: tsweep.sweep("no_such_root"),
    "sweep_generic": lambda: tsweep.sweep_generic("no_such_root", "no_skeleton.pickle"),
    "build_and_solve": lambda: tgen.build_and_solve("no_skeleton.pickle", "no_such_project"),
    "reproject_positions": lambda: tmetrics.reproject_positions(
        np.zeros((2, 20, 3)), *[a[0] for a in _pixels()[0]]),
    "evaluate_reconstruction": lambda: tmetrics.evaluate_reconstruction(
        np.zeros((2, 20, 3)), [np.zeros((2, 20, 2))], *_pixels()[0]),
    "reprojection_errors": lambda: tmetrics.reprojection_errors(
        np.zeros((2, 20, 3)), [np.zeros((2, 20, 2))], *_pixels()[0]),
    **{f"cli {cmd}": (lambda argv=argv: tcli.main(argv)) for cmd, argv in (
        ("all", ["all", "--data_dir", "run"]), ("sweep", ["sweep", "--root_dir", "root"]),
        ("build", ["build", "--top_dir", "proj"]), ("view", ["view", "--result", "r.pickle"]),
        ("eval", ["eval", "--result", "r.pickle", "--gt_h5", "a.h5", "--cams", "0"]))},
    "get_frames": lambda: tvideo.get_frames("cam1.mp4", [0]),
    "extract_frame_range": lambda: tvideo.extract_frame_range("cam1.mp4", 0, 2, "frames"),
    "images_to_video": lambda: tvideo.images_to_video(["a.png"], "out.mp4"),
    "create_labeled_videos": lambda: tvideo.create_labeled_videos(["cam1.mp4"], "dlc"),
    "animate_reconstruction": lambda: tplots.animate_reconstruction("r.pickle", "a.mp4"),
    "mpeg4.Reader": lambda: tmpeg4.Reader("cam1.mp4"),
    "mpeg4.Writer": lambda: tmpeg4.Writer("out.mp4", (16, 16), 30.0),
    "open_video": lambda: tvideo.open_video("cam1.mp4"),
    "nvdec.Reader": lambda: tnvdec.Reader("cam1.mp4"),
    **{f"probe_mosaic.{name}": t for name, t in tpm.PROBES},
    **{f"probe_mosaic2.{name}": t for name, t in tpm2.PROBES},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_and_cuda_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
