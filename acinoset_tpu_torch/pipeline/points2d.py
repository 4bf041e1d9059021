"""2D-point project helpers, the counterpart of
acinoset_tpu.pipeline.points2d (the reference's src/get_points.py): the
bodyparts of a project's DLC files, its tidy 2D table (a dict of
columns, ``pipeline.data.load_dlc_points_as_df``), and the straight-line
3D path of one part that the reference used to seed optimisations.
"""
from __future__ import annotations

import os
from glob import glob
from typing import List, Tuple

import numpy as np

from ..utils.device import resolve_device
from . import data as data_io
from .ekf import nose_track_linreg
from .tri import triangulate_run


def _dlc_files(project_dir: str) -> List[str]:
    fpaths = sorted(glob(os.path.join(project_dir, "data", "*.h5")))
    return fpaths or sorted(glob(os.path.join(project_dir, "dlc", "*.h5")))


def get_bodyparts(project_dir: str) -> List[str]:
    """The bodyparts of a project's first DLC file (data/*.h5, else
    dlc/*.h5), in the file's order."""
    fpaths = _dlc_files(project_dir)
    assert fpaths, f"no .h5 files under {project_dir}"
    _frames, bodyparts, _vals = data_io._read_dlc_h5(fpaths[0])
    return list(bodyparts)


def get_2d_points_df(project_dir: str):
    """The tidy [frame, camera, marker, x, y, likelihood] table of a
    project's DLC files (data/*.h5, else dlc/*.h5) as a dict of columns
    (src/get_points.py:8-20)."""
    return data_io.load_dlc_points_as_df(_dlc_files(project_dir))


def estimate_part_path(
    project_dir: str,
    part: str,
    scene_fname: str = "4_cam_scene_static_sba.json",
    dlc_thresh: float = 0.4,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Line fit of one bodypart's triangulated track over frame index, the
    triangulation on ``device`` (CUDA unless given). The scene is
    ``<project_dir>/data/<scene_fname>``, else the first scene file found
    walking up from ``project_dir``. Returns (slopes (3,), intercepts (3,))."""
    device = resolve_device(device)
    scene_path = os.path.join(project_dir, "data", scene_fname)
    if not os.path.exists(scene_path):
        k, d, r, t, *_rest, _scene = data_io.find_scene_file(project_dir, verbose=False)
    else:
        k, d, r, t, _res = data_io.load_scene(scene_path)
        d = d.reshape(-1, 4)
    p2d = data_io.load_dlc_points(_dlc_files(project_dir))
    assert part in p2d.markers, f"{part} not in {p2d.markers}"
    tri = triangulate_run(np.nan_to_num(p2d.pixels), p2d.valid(dlc_thresh), k, d, r, t, device)
    xs, xi, ys, yi, zs, zi = nose_track_linreg(tri, p2d.frames, p2d.markers.index(part))
    return np.array([xs, ys, zs]), np.array([xi, yi, zi])
