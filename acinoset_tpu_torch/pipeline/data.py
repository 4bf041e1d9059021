"""Data helpers of acinoset_tpu.pipeline.data that the port needs: the
scene, camera and corner-points JSON files (the schemas of the
reference's src/calib/utils.py:16-101; a file written by either package
loads in the other to equal arrays), and the checkerboard's object
points (src/calib/utils.py:10-13). The DLC .h5 and pickle readers are
not ported yet."""
from __future__ import annotations

import json
import os
import re
from datetime import datetime
from glob import glob
from typing import List, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Scene / camera / points JSON (schemas of src/calib/utils.py:16-101)
# --------------------------------------------------------------------------


def _timestamp() -> str:
    return str(datetime.now())


def _write_json(out_fpath, data):
    os.makedirs(os.path.dirname(out_fpath) or ".", exist_ok=True)
    with open(out_fpath, "w") as f:
        json.dump(data, f)


def save_points(out_fpath, img_points, img_fnames, board_shape, board_square_len,
                camera_resolution):
    """Write a corner-points JSON (newer schema keys, cf.
    data/thursday_kiara/extrinsic_calib/points/points_cam1.json)."""
    if isinstance(img_points, np.ndarray):
        img_points = img_points.tolist()
    _write_json(out_fpath, {
        "timestamp": _timestamp(),
        "board_shape": list(board_shape),
        "board_square_len": board_square_len,
        "camera_resolution": list(camera_resolution),
        "points": dict(zip(img_fnames, img_points)),
    })


def load_points(fpath) -> Tuple[np.ndarray, List[str], Tuple[int, int], float, Tuple[int, int]]:
    """Load a corner-points JSON, accepting both schema generations
    (board_edge_len/created_timestamp and board_square_len/timestamp).
    The points come back float32, as the JAX package loads them."""
    with open(fpath, "r") as f:
        data = json.load(f)
    fnames = list(data["points"].keys())
    points = np.array(list(data["points"].values()), dtype=np.float32)
    board_shape = tuple(data["board_shape"])
    edge_len = data.get("board_square_len", data.get("board_edge_len"))
    camera_resolution = tuple(data["camera_resolution"])
    return points, fnames, board_shape, edge_len, camera_resolution


def save_camera(out_fpath, camera_resolution, k, d):
    _write_json(out_fpath, {
        "timestamp": _timestamp(),
        "camera_resolution": list(camera_resolution),
        "k": np.asarray(k).tolist(),
        "d": np.asarray(d).tolist(),
    })


def load_camera(fpath) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    with open(fpath, "r") as f:
        data = json.load(f)
    return (
        np.array(data["k"], dtype=np.float64),
        np.array(data["d"], dtype=np.float64),
        tuple(data["camera_resolution"]),
    )


def save_scene(out_fpath, k_arr, d_arr, r_arr, t_arr, camera_resolution):
    cameras = [
        {
            "k": np.asarray(k).tolist(),
            "d": np.asarray(d).tolist(),
            "r": np.asarray(r).tolist(),
            "t": np.asarray(t).tolist(),
        }
        for k, d, r, t in zip(k_arr, d_arr, r_arr, t_arr)
    ]
    _write_json(out_fpath, {
        "timestamp": _timestamp(),
        "camera_resolution": list(camera_resolution),
        "cameras": cameras,
    })


def load_scene(fpath):
    """Load a scene JSON -> (k_arr, d_arr, r_arr, t_arr, camera_resolution).

    Shapes match the reference loader (src/calib/utils.py:84-101):
    k (C,3,3), d (C,4,1) as stored, r (C,3,3), t (C,3,1).
    """
    with open(fpath, "r") as f:
        data = json.load(f)
    cams = data["cameras"]
    k_arr = np.array([c["k"] for c in cams], dtype=np.float64)
    d_arr = np.array([c["d"] for c in cams], dtype=np.float64)
    r_arr = np.array([c["r"] for c in cams], dtype=np.float64)
    t_arr = np.array([c["t"] for c in cams], dtype=np.float64)
    return k_arr, d_arr, r_arr, t_arr, tuple(data["camera_resolution"])


def find_scene_file(data_dir, scene_fname=None, verbose: bool = True):
    """Walk up from ``data_dir`` to locate ``{n}_cam_scene_sba.json`` (or a
    given scene filename), looking in each directory's extrinsic_calib/
    and then in the directory itself.

    Returns (k_arr, d_arr(C,4), r_arr, t_arr, cam_res, n_cams, scene_fpath).
    """
    # primary pattern, then any scene variant (4_cam_scene_static_sba.json)
    patterns = (
        [scene_fname] if scene_fname
        else ["[1-9]_cam_scene_sba.json", "[1-9]_cam_scene*.json"]
    )
    current = os.path.abspath(data_dir)
    while True:
        for sub in ("extrinsic_calib", "."):
            hits = []
            for pattern in patterns:
                hits = sorted(glob(os.path.join(current, sub, pattern)))
                if hits:
                    break
            if hits:
                scene_fpath = hits[-1]
                k_arr, d_arr, r_arr, t_arr, cam_res = load_scene(scene_fpath)
                # trust the file's contents over its name
                n_cams = len(k_arr)
                m = re.match(r"(\d+)_cam_scene", os.path.basename(scene_fpath))
                if verbose:
                    print(f"Loaded scene file {scene_fpath}")
                    if m and int(m.group(1)) != n_cams:
                        print(
                            f"  note: filename claims {m.group(1)} cams, "
                            f"file holds {n_cams}"
                        )
                return k_arr, d_arr.reshape((-1, 4)), r_arr, t_arr, cam_res, n_cams, scene_fpath
        parent = os.path.dirname(current)
        if parent == current:
            raise FileNotFoundError(
                f"No scene file matching {patterns} found walking up from {data_dir}"
            )
        current = parent


# --------------------------------------------------------------------------
# Checkerboard object points (src/calib/utils.py:10-13)
# --------------------------------------------------------------------------


def create_board_object_pts(board_shape: Tuple[int, int], square_edge_length: float) -> np.ndarray:
    """(rows * cols, 3) float32 corners of a planar board at z = 0."""
    object_pts = np.zeros((board_shape[0] * board_shape[1], 3), np.float32)
    object_pts[:, :2] = (
        np.mgrid[0 : board_shape[0], 0 : board_shape[1]].T.reshape(-1, 2) * square_edge_length
    )
    return object_pts
