"""The port's command line, the counterpart of acinoset_tpu.cli
(the reference's src/all_optimizations.py __main__):

    python -m acinoset_tpu_torch.cli all --data_dir <run> [--start_frame 1] \
        [--end_frame -1] [--dlc_thresh 0.8] [--uncertainty] [--device cuda]

Subcommands, with the JAX package's flags:
  dlc | tri | sba | ekf | fte | all — the reference's stages on one run
          directory (dlc/*.h5, a scene file at or above it, cam[1-9].mp4
          or video_info.json)
  calib — the points of <scene_dir>/points/points_cam*.json and the
          intrinsics of <scene_dir>/../intrinsic_calib/camera_*.json ->
          pairwise extrinsics -> {n}_cam_scene.json -> board SBA ->
          {n}_cam_scene_sba.json
  build — the generic-skeleton FTE on a project (src/build.py)
  sweep — every run under a dataset root, batched by fps
  view  — an interactive HTML viewer of a result pickle
  eval  — reprojection metrics of a result pickle against DLC labels

``--device`` (default ``cuda``) is where the work runs; ``sweep`` without
it runs over every visible CUDA device (a data mesh, as the batched stages
do by default). Without a CUDA device every subcommand raises unless given
``--device cpu``.

The ``dlc`` stage writes dlc/camN_labeled.mp4 for each cam[1-9].mp4, its
labels burnt in (``pipeline.video.create_labeled_videos``, the port's own
mp4v codec), reading mp4v, GoPro's H.264 (the port's software decoder)
or HEVC (the card's NVDEC); a video the port cannot read gets a
``Not written:`` line naming why, and ``all`` goes on to tri. ``all``
ends with ``reconstructions.png``, the sba, ekf and fte results
overlaid; the fte and ekf stages write their state plots.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser
from glob import glob

import numpy as np
import torch

RUN_STAGES = ("dlc", "tri", "sba", "ekf", "fte")


def _add_run_args(p):
    p.add_argument("--data_dir", type=str, required=True,
                   help="The data directory path to the flick/run to be optimized")
    p.add_argument("--start_frame", type=int, default=1,
                   help="The frame at which the optimized reconstruction will start at")
    p.add_argument("--end_frame", type=int, default=-1,
                   help="The frame at which the optimized reconstruction will end at")
    p.add_argument("--dlc_thresh", type=float, default=0.8,
                   help="Likelihood below which dlc points are excluded")
    p.add_argument("--plot", action="store_true", help="Show plots")
    p.add_argument("--uncertainty", action="store_true",
                   help="FTE stage: compute Laplace-posterior per-marker "
                   "1-sigma error bars (marker_std in fte.pickle)")


def _parser() -> ArgumentParser:
    parser = ArgumentParser(description="acinoset_tpu_torch — the PyTorch/CUDA port's pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)
    subs = [sub.add_parser(name) for name in RUN_STAGES + ("all",)]
    for p in subs:
        _add_run_args(p)

    pc = sub.add_parser("calib")
    pc.add_argument("--scene_dir", type=str, required=True,
                    help="extrinsic_calib dir with points/points_cam*.json")
    pc.add_argument("--camera_fpaths", type=str, nargs="*", default=None)
    pc.add_argument("--out", type=str, default=None)

    pb = sub.add_parser("build")
    pb.add_argument("--top_dir", type=str, required=True)
    pb.add_argument("--skeleton", type=str, default=None)
    pb.add_argument("--start_frame", type=int, default=60)
    pb.add_argument("--n_frames", type=int, default=100)
    pb.add_argument("--dlc_thresh", type=float, default=0.4)

    ps = sub.add_parser("sweep")
    ps.add_argument("--root_dir", type=str, required=True,
                    help="Dataset root; every dir containing dlc/*.h5 becomes a run")
    ps.add_argument("--dlc_thresh", type=float, default=0.8)
    ps.add_argument("--num_iters", type=int, default=60)
    ps.add_argument("--max_frames", type=int, default=None)
    ps.add_argument("--stages", type=str, default="fte", help="comma list: fte,ekf")
    ps.add_argument("--warm_start", choices=("auto", "on", "off"), default="auto",
                    help="EKF-smoothed FTE init: 'auto' (default) resolves to cold; "
                    "'on' forces the EKF init (e.g. panning rigs where a "
                    "straight-line fit is meaningless); 'off' forces cold")
    ps.add_argument("--relinearize_every", type=int, default=1,
                    help="lagged-Jacobian GN: refresh the measurement "
                    "Jacobian every k iterations (1 = every)")
    ps.add_argument("--uncertainty", action="store_true",
                    help="FTE stage: per-marker 1-sigma error bars in "
                    "each run's results (Laplace posterior)")
    ps.add_argument("--no_rescue", action="store_true",
                    help="disable the re-solve of runs whose stationarity "
                    "flag is unconverged")
    ps.add_argument("--skeleton", type=str, default=None,
                    help="skeleton pickle: sweep build.py-style subjects "
                    "(humans, new animals) instead of the cheetah")
    ps.add_argument("--init_marker", type=str, default="forehead",
                    help="generic sweeps: marker whose triangulated track "
                    "seeds the root-translation init")

    pv = sub.add_parser("view", help="export an interactive HTML 3D viewer "
                        "for a result pickle (drag-orbit, frame scrub/play)")
    pv.add_argument("--result", type=str, required=True,
                    help="fte/ekf/tri result pickle with a positions array")
    pv.add_argument("--out", type=str, default=None,
                    help="output .html (default: alongside the pickle)")
    pv.add_argument("--scene", type=str, default=None,
                    help="scene JSON to draw camera frusta (default: the "
                    "pickle's recorded scene_fpath)")
    pv.add_argument("--fps", type=float, default=30.0)

    pe = sub.add_parser("eval")
    pe.add_argument("--result", type=str, required=True)
    pe.add_argument("--gt_h5", type=str, nargs="+", required=True)
    pe.add_argument("--cams", type=int, nargs="+", required=True)
    pe.add_argument("--hist", type=str, default=None,
                    help="Save the reprojection-error histogram png here")
    pe.add_argument("--start_frame", type=int, default=None,
                    help="GT frame offset of the result window "
                    "(default: the result pickle's start_frame, else 0)")
    pe.add_argument("--scene", type=str, default=None,
                    help="Scene JSON (default: the result pickle's "
                    "scene_fpath, else walk up from the result)")

    for p in subs + [pc, pb, ps, pv, pe]:
        p.add_argument("--device", type=str, default=None,
                       help="torch device the work runs on (cuda or cpu; default cuda, "
                       "and for sweep every visible CUDA device)")
    return parser


def _label_videos(args, device):
    """The dlc stage: create_labeled_videos on the run's cam[1-9].mp4, a
    video at a time, so that one the port cannot read (HEVC on a device
    without NVDEC, a feature or codec it does not decode) is named in a
    ``Not written:`` line and the rest are labelled."""
    from .pipeline.video import create_labeled_video, labeled_video_fpath
    from .utils.mpeg4 import UnsupportedVideo

    vids = sorted(glob(os.path.join(args.data_dir, "cam[1-9].mp4")))
    if not vids:
        print("No videos found; skipping dlc video labeling")
        return
    out_dir = os.path.join(args.data_dir, "dlc")
    os.makedirs(out_dir, exist_ok=True)
    for ci, vid in enumerate(vids):
        try:
            create_labeled_video(vid, ci, out_dir, draw_skeleton=True, pcutoff=args.dlc_thresh,
                                 device=device)
        except UnsupportedVideo as err:
            print(f"Not written: {labeled_video_fpath(vid, out_dir)} ({err.reason})")


def _run_stages(args, device):
    stages = [args.cmd] if args.cmd != "all" else list(RUN_STAGES)
    for stage in stages:
        print(f"========== {stage.upper()} ==========\n")
        if stage == "dlc":
            _label_videos(args, device)
        elif stage == "tri":
            from .pipeline.tri import tri

            tri(args.data_dir, args.start_frame, args.end_frame, args.dlc_thresh, device=device)
        elif stage == "sba":
            from .pipeline.sba import sba

            sba(args.data_dir, args.start_frame, args.end_frame, args.dlc_thresh, device=device)
        elif stage == "ekf":
            from .pipeline.ekf import ekf

            ekf(args.data_dir, args.start_frame, args.end_frame, args.dlc_thresh, device=device)
        else:
            from .pipeline.fte import fte

            fte(args.data_dir, args.start_frame, args.end_frame, args.dlc_thresh,
                uncertainty=args.uncertainty, device=device)
    if args.cmd == "all":
        from .pipeline.plots import plot_multiple_cheetah_reconstructions

        fpaths = [os.path.join(args.data_dir, s, f"{s}.pickle") for s in ("sba", "ekf", "fte")]
        plot_multiple_cheetah_reconstructions(
            [f for f in fpaths if os.path.exists(f)], reprojections=False, dark_mode=True,
            out_fpath=os.path.join(args.data_dir, "reconstructions.png"))


def _calib(args, device):
    from .calib import app as calib_app

    points_fpaths = sorted(glob(os.path.join(args.scene_dir, "points", "points_cam*.json")))
    n = len(points_fpaths)
    camera_fpaths = args.camera_fpaths or sorted(
        glob(os.path.join(args.scene_dir, "..", "intrinsic_calib", "camera_*.json"))
    )
    out = args.out or os.path.join(args.scene_dir, f"{n}_cam_scene.json")
    calib_app.calibrate_fisheye_extrinsics_pairwise(camera_fpaths, points_fpaths, out,
                                                    device=device)
    calib_app.sba_board_points_fisheye(out, points_fpaths, device=device)


def _sweep(args, device):
    from .pipeline import sweep as sweep_mod

    warm = {"auto": "auto", "on": True, "off": False}[args.warm_start]
    kw = dict(dlc_thresh=args.dlc_thresh, num_iters=args.num_iters, max_frames=args.max_frames,
              stages=tuple(args.stages.split(",")), warm_start=warm,
              relinearize_every=args.relinearize_every, rescue=not args.no_rescue,
              uncertainty=args.uncertainty, device=device)
    if args.skeleton:
        sweep_mod.sweep_generic(args.root_dir, args.skeleton, init_marker=args.init_marker, **kw)
    else:
        sweep_mod.sweep(args.root_dir, **kw)


def _view(args):
    from .models import cheetah
    from .pipeline import data as data_io
    from .pipeline.viewer import export_interactive_html

    payload = data_io.load_pickle(args.result)
    scene_path = args.scene or payload.get("scene_fpath")
    scene = None
    if scene_path and os.path.exists(scene_path):
        k, d, r, t, _res = data_io.load_scene(scene_path)
        scene = (k, d, r, t)
    markers = payload.get("markers") or cheetah.get_markers()
    out = args.out or os.path.splitext(args.result)[0] + ".html"
    export_interactive_html(
        payload["positions"], out, markers=markers, scene=scene, fps=args.fps,
        marker_std=payload.get("marker_std"),
    )
    print(f"Saved {out} — open in any browser")


def _eval(args, device):
    from .eval.metrics import evaluate_reconstruction, reprojection_errors, save_error_histogram
    from .pipeline import data as data_io

    payload = data_io.load_pickle(args.result)
    scene = args.scene or payload.get("scene_fpath")
    if not (scene and os.path.exists(scene)):
        # walk up from the result file (older pickles lack the path)
        *_ignored, scene = data_io.find_scene_file(os.path.dirname(args.result), verbose=False)
    k, d, r, t, _res = data_io.load_scene(scene)
    N = payload["positions"].shape[0]
    start = args.start_frame
    if start is None:
        start = int(payload.get("start_frame", 0))
    res_markers = payload.get("markers")
    gt = []
    for fp in args.gt_h5:
        _frames, mk, vals = data_io._read_dlc_h5(fp)
        g = vals[start:start + N, :, :2]
        if res_markers is not None and list(mk) != list(res_markers):
            # align the labels to the result's marker order by name;
            # result markers absent from the labels become NaN (ignored)
            aligned = np.full((g.shape[0], len(res_markers), 2), np.nan)
            for i, m in enumerate(res_markers):
                if m in mk:
                    aligned[:, i] = g[:, list(mk).index(m)]
            g = aligned
        gt.append(g)
    res = evaluate_reconstruction(
        payload["positions"], gt, k, d.reshape(-1, 4), r, t, cam_indices=args.cams,
        device=device,
    )
    for cam, m in res.items():
        print(cam, {k2: round(v, 4) if isinstance(v, float) else v for k2, v in m.items()})
    if args.hist:
        errs = reprojection_errors(payload["positions"], gt, k, d.reshape(-1, 4), r, t,
                                   cam_indices=args.cams, device=device)
        save_error_histogram(errs, args.hist)
        print(f"saved histogram: {args.hist} ({errs.size} points)")


def main(argv=None):
    args = _parser().parse_args(argv)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")

    if args.cmd in RUN_STAGES + ("all",):
        _run_stages(args, device)
    elif args.cmd == "calib":
        _calib(args, device)
    elif args.cmd == "build":
        from .pipeline.generic import build_and_solve

        skel = args.skeleton or os.path.join(args.top_dir, "skeletons", "new_human.pickle")
        build_and_solve(skel, args.top_dir, start_frame=args.start_frame,
                        n_frames=args.n_frames, dlc_thresh=args.dlc_thresh, device=device)
    elif args.cmd == "sweep":
        _sweep(args, device if args.device else None)
    elif args.cmd == "view":
        _view(args)
    else:
        _eval(args, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
