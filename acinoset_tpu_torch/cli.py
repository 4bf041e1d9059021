"""Command-line driver of the port, the counterpart of acinoset_tpu.cli.
It has the calibration subcommand so far:

    python -m acinoset_tpu_torch.cli calib --scene_dir <run>/extrinsic_calib \
        [--camera_fpaths camera_1.json ...] [--out scene.json] [--device cuda]

  calib — the points of <scene_dir>/points/points_cam*.json and the
          intrinsics of <scene_dir>/../intrinsic_calib/camera_*.json ->
          pairwise extrinsics -> {n}_cam_scene.json -> board SBA ->
          {n}_cam_scene_sba.json

``--device`` (default ``cuda``) is where the solvers run; without a CUDA
device the command raises unless given ``--device cpu``.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser
from glob import glob

import torch


def main(argv=None):
    parser = ArgumentParser(description="acinoset_tpu_torch — the PyTorch/CUDA port's pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("calib")
    pc.add_argument("--scene_dir", type=str, required=True,
                    help="extrinsic_calib dir with points/points_cam*.json")
    pc.add_argument("--camera_fpaths", type=str, nargs="*", default=None)
    pc.add_argument("--out", type=str, default=None)
    pc.add_argument("--device", type=str, default="cuda",
                    help="torch device the calibration runs on (cuda or cpu)")

    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
