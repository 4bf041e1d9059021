"""Host-side data of acinoset_tpu.pipeline.data: the scene, camera and
corner-points JSON files (the schemas of the reference's
src/calib/utils.py:16-101), the checkerboard's object points
(src/calib/utils.py:10-13), DeepLabCut ``.h5`` keypoint files read and
written through ``utils.hdf5`` (no h5py, pandas or PyTables), the dense
``Points2D`` container, and the skeleton and result pickles. A file
written by either package loads in the other to equal arrays.

The JAX package's DataFrame shims have column-table twins here
(``load_dlc_points_as_df``, ``points2d_from_df``): a table is any
mapping from a column name to a 1-D array, read by ``t[name]``, so a
pandas DataFrame is one; the port returns a ``dict`` of numpy arrays in
the DataFrame's column order.
"""
from __future__ import annotations

import json
import os
import pickle
import re
from dataclasses import dataclass
from datetime import datetime
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import hdf5

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


# --------------------------------------------------------------------------
# DeepLabCut .h5 files (pandas "table" and "fixed" layouts)
# --------------------------------------------------------------------------


def _read_dlc_h5(fpath) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Read one DLC .h5 -> (frames (N,), bodyparts (L,), values (N, L, 3)).

    values[..., :] = (x, y, likelihood). The pandas "table" layout keeps
    the column names in the pickled ``non_index_axes`` group attribute
    (a string or opaque bytes) and the data in ``<group>/table`` with the
    fields 'index' and 'values_block_0'; the "fixed" layout keeps them in
    axis0_level*/axis0_label*, axis1 and block0_values. The first group
    in name order is read, as the JAX package reads h5py's first key."""
    root = hdf5.open_file(fpath)
    group = root[root.keys()[0]]
    if "table" in group:
        non_index_axes = pickle.loads(bytes(group.attrs["non_index_axes"]))
        columns = non_index_axes[0][1]  # [(axis, [(scorer, bodypart, coord), ...])]
        table = group["table"].read()
        frames = table["index"].astype(np.int64)
        vals = table["values_block_0"].astype(np.float64)
    else:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else str(x)

        levels = [group[f"axis0_level{i}"].read() for i in range(3)]
        labels = [group[f"axis0_label{i}"].read() for i in range(3)]
        columns = [
            tuple(_s(levels[lvl][lab[j]]) for lvl, lab in enumerate(labels))
            for j in range(len(labels[0]))
        ]
        frames = group["axis1"].read().astype(np.int64)
        vals = group["block0_values"].read().astype(np.float64)

    # column order: (scorer, bodypart, coord) triples; group by bodypart
    bodyparts: List[str] = []
    col_of: Dict[Tuple[str, str], int] = {}
    for j, col in enumerate(columns):
        _, bp, coord = col
        if bp not in bodyparts:
            bodyparts.append(bp)
        col_of[(bp, coord)] = j
    n, L = len(frames), len(bodyparts)
    out = np.full((n, L, 3), np.nan)
    for i, bp in enumerate(bodyparts):
        for k, coord in enumerate(("x", "y", "likelihood")):
            j = col_of.get((bp, coord))
            if j is not None:
                out[:, i, k] = vals[:, j]
    return frames, bodyparts, out


def save_dlc_points_h5(
    fpath: str,
    pixels: np.ndarray,  # (N, L, 2)
    likelihood: np.ndarray,  # (N, L)
    markers: List[str],
    scorer: str = "acinoset_tpu",
    frames: Optional[np.ndarray] = None,
    strings: str = "vlen",
):
    """Write a DLC-style .h5 keypoint file in the pandas "fixed" layout
    the JAX package writes through h5py (``_read_dlc_h5`` and
    DeepLabCut-compatible readers parse it). ``frames`` is the frame
    index (axis1, default 0..N-1); ``strings`` stores the three
    axis0_level* name lists as variable-length UTF-8 ('vlen', as h5py
    writes them) or fixed-length ('fixed', as PyTables writes them)."""
    N, L, _ = pixels.shape
    vals = np.concatenate([pixels, likelihood[..., None]], axis=-1).reshape(N, L * 3)
    if strings == "vlen":
        def names(x):
            return np.array(list(x), dtype=object)
    elif strings == "fixed":
        def names(x):
            return np.array([s.encode("utf-8") for s in x])
    else:
        raise ValueError(f"strings must be 'vlen' or 'fixed', not {strings!r}")
    axis1 = np.arange(N, dtype=np.int64) if frames is None else np.asarray(frames, np.int64)
    hdf5.write_file(fpath, {"df_with_missing": (
        {"pandas_type": b"frame", "CLASS": b"GROUP"},
        {
            "axis0_level0": names([scorer]),
            "axis0_level1": names(markers),
            "axis0_level2": names(["x", "y", "likelihood"]),
            "axis0_label0": np.zeros(L * 3, dtype=np.int64),
            "axis0_label1": np.repeat(np.arange(L, dtype=np.int64), 3),
            "axis0_label2": np.tile(np.arange(3, dtype=np.int64), L),
            "axis1": axis1,
            "block0_values": vals.astype(np.float64),
        },
    )})
    return fpath


@dataclass
class Points2D:
    """Dense multi-camera 2D keypoints.

    pixels:     (C, N, L, 2) float64
    likelihood: (C, N, L)    float64 (NaN where a frame/marker is absent)
    frames:     (N,) original frame indices (contiguous range)
    markers:    list of L marker names, in canonical order
    """

    pixels: np.ndarray
    likelihood: np.ndarray
    frames: np.ndarray
    markers: List[str]

    @property
    def n_cams(self) -> int:
        return self.pixels.shape[0]

    def window(self, start_frame: int, end_frame: int) -> "Points2D":
        """Slice to frame indices [start_frame, end_frame) (0-based)."""
        sel = (self.frames >= start_frame) & (self.frames < end_frame)
        return Points2D(
            self.pixels[:, sel], self.likelihood[:, sel], self.frames[sel], self.markers
        )

    def valid(self, thresh: float) -> np.ndarray:
        """(C, N, L) bool: likelihood strictly above thresh (the reference
        filters with '>', src/all_optimizations.py:263)."""
        return np.nan_to_num(self.likelihood, nan=-1.0) > thresh


def load_dlc_points(fpaths: Sequence[str], markers: Optional[List[str]] = None) -> Points2D:
    """Per-camera DLC .h5 files -> a dense Points2D. ``markers`` fixes the
    marker order (by default the first file's bodypart order); markers
    missing from a file get NaN pixels and likelihood."""
    per_cam = [_read_dlc_h5(p) for p in fpaths]
    n_frames = max(int(f[-1]) + 1 for f, _, _ in per_cam)
    if markers is None:
        markers = per_cam[0][1]
    L = len(markers)
    C = len(per_cam)
    pixels = np.full((C, n_frames, L, 2), np.nan)
    likelihood = np.full((C, n_frames, L), np.nan)
    for c, (frames, bodyparts, vals) in enumerate(per_cam):
        bp_idx = {bp: i for i, bp in enumerate(bodyparts)}
        for i, m in enumerate(markers):
            if m in bp_idx:
                pixels[c, frames, i] = vals[:, bp_idx[m], :2]
                likelihood[c, frames, i] = vals[:, bp_idx[m], 2]
    return Points2D(pixels, likelihood, np.arange(n_frames), list(markers))


#: the reference's tidy 2D table (src/calib/utils.py:105-120)
TABLE_COLUMNS = ("frame", "camera", "marker", "x", "y", "likelihood")


def load_dlc_points_as_df(fpaths: Sequence[str], verbose: bool = False) -> Dict[str, np.ndarray]:
    """Per-camera DLC .h5 files -> the reference's tidy table
    [frame, camera, marker, x, y, likelihood], a row a (camera, frame,
    marker) in file order, as columns: the JAX package's DataFrame as a
    dict of numpy arrays (markers an object array)."""
    parts = []
    for c, p in enumerate(fpaths):
        frames, bodyparts, vals = _read_dlc_h5(p)
        if verbose:
            print(f"Loaded {p}: {len(frames)} frames, {len(bodyparts)} markers")
        n, L = vals.shape[:2]
        parts.append((np.repeat(frames, L), np.full(n * L, c, np.int64),
                      np.tile(np.array(bodyparts, dtype=object), n), vals[:, :, 0].ravel(),
                      vals[:, :, 1].ravel(), vals[:, :, 2].ravel()))
    if not parts:
        raise ValueError("load_dlc_points_as_df: no files given")
    return {name: np.concatenate(cols) for name, cols in zip(TABLE_COLUMNS, zip(*parts))}


def points2d_from_df(df, markers: List[str]) -> Points2D:
    """A tidy table (any mapping of the columns frame, camera, marker, x,
    y, likelihood; a DataFrame is one) -> a dense Points2D over frames 0
    to the last, cameras in sorted order; rows of other markers are
    dropped."""
    camera, frame, marker = (np.asarray(df[k]) for k in ("camera", "frame", "marker"))
    cams = sorted(np.unique(camera))
    n_frames = int(frame.max()) + 1
    C, L = len(cams), len(markers)
    pixels = np.full((C, n_frames, L, 2), np.nan)
    likelihood = np.full((C, n_frames, L), np.nan)
    m_idx = {m: i for i, m in enumerate(markers)}
    x, y, lik = (np.asarray(df[k], dtype=np.float64) for k in ("x", "y", "likelihood"))
    for c_i, c in enumerate(cams):
        sel = camera == c
        li = np.array([m_idx.get(m, -1) for m in marker[sel]], dtype=np.int64)
        ok = li >= 0
        li, fi = li[ok], frame[sel].astype(int)[ok]
        pixels[c_i, fi, li, 0] = x[sel][ok]
        pixels[c_i, fi, li, 1] = y[sel][ok]
        likelihood[c_i, fi, li] = lik[sel][ok]
    return Points2D(pixels, likelihood, np.arange(n_frames), list(markers))


# --------------------------------------------------------------------------
# Skeleton & result pickles
# --------------------------------------------------------------------------


def load_skeleton(fpath) -> Dict:
    """A skeleton dict pickle {links, dofs, positions, markers} (the schema
    of the reference's skeletons/*.pickle)."""
    return load_pickle(fpath)


def save_skeleton(fpath, skel_dict: Dict):
    save_pickle(fpath, skel_dict)


def load_pickle(fpath) -> Dict:
    with open(fpath, "rb") as f:
        return pickle.load(f)


def save_pickle(fpath, data: Dict):
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    with open(fpath, "wb") as f:
        pickle.dump(data, f)
