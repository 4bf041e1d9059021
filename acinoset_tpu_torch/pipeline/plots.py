"""Plots, the counterpart of acinoset_tpu.pipeline.plots: the state grid,
3D skeleton strips, the overlay of several reconstructions, the
pan-compensated playback, and the calibration views (corners, fisheye
undistortion, the camera scene).

Each function plots the same series as its JAX twin, in the same order,
through ``utils.figure`` rather than matplotlib, and returns that
``Figure`` record (the JAX function returns a matplotlib figure). With
``out_fpath`` the figure is written by its extension: ``.svg``, ``.pdf``
or ``.png``. ``animate_reconstruction`` rasterises one figure a frame and
encodes them with the port's mp4v writer (``utils.mpeg4``).
"""
from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import cheetah as cheetah_model
from ..ops.camera import undistort_points_fisheye
from ..utils import mpeg4, pan_compensation
from ..utils.device import resolve_device
from ..utils.figure import Figure, subplots
from . import data as data_io

#: cheetah skeleton edges (marker-index pairs) for rendering
CHEETAH_LINKS = [
    ("nose", "l_eye"), ("nose", "r_eye"), ("l_eye", "r_eye"),
    ("nose", "neck_base"), ("neck_base", "spine"), ("spine", "tail_base"),
    ("tail_base", "tail1"), ("tail1", "tail2"),
    ("neck_base", "l_shoulder"), ("l_shoulder", "l_front_knee"),
    ("l_front_knee", "l_front_ankle"),
    ("neck_base", "r_shoulder"), ("r_shoulder", "r_front_knee"),
    ("r_front_knee", "r_front_ankle"),
    ("tail_base", "l_hip"), ("l_hip", "l_back_knee"), ("l_back_knee", "l_back_ankle"),
    ("tail_base", "r_hip"), ("r_hip", "r_back_knee"), ("r_back_knee", "r_back_ankle"),
]


def _marker_links(markers: Sequence[str]):
    idx = {m: i for i, m in enumerate(markers)}
    return [(idx[a], idx[b]) for a, b in CHEETAH_LINKS if a in idx and b in idx]


def _save(fig, out_fpath, announce=True):
    if out_fpath:
        fig.save(out_fpath)
        if announce:
            print(f"Saved {out_fpath}")


def plot_cheetah_states(
    x: np.ndarray,
    smoothed_x: Optional[np.ndarray] = None,
    out_fpath: Optional[str] = None,
    state_names: Optional[List[str]] = None,
):
    """A grid of five columns, one panel a state: x, and smoothed_x
    when given, against the frame index; the legend on the first panel."""
    x = np.asarray(x)
    n_states = x.shape[1]
    names = state_names or list(cheetah_model.get_pose_params().keys())[:n_states]
    ncols = 5
    nrows = int(np.ceil(n_states / ncols))
    fig, axes = subplots(nrows, ncols, figsize=(4 * ncols, 2.2 * nrows))
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        if i < n_states:
            ax.plot(x[:, i], label="x")
            if smoothed_x is not None:
                ax.plot(np.asarray(smoothed_x)[:, i], label="smoothed")
            ax.set_title(names[i] if i < len(names) else f"state {i}", fontsize=9)
        else:
            ax.axis("off")
    axes[0][0].legend(fontsize=8)
    _save(fig, out_fpath)
    return fig


def plot_cheetah_reconstruction(
    data_fpath: str,
    markers: Optional[Sequence[str]] = None,
    frame_step: int = 10,
    out_fpath: Optional[str] = None,
    centered: bool = False,
    dark_mode: bool = False,
):
    """A 3D strip of a result pickle's skeleton: every frame_step-th
    frame's markers, and its links where both ends are finite."""
    payload = data_io.load_pickle(data_fpath)
    positions = np.asarray(payload["positions"])
    markers = markers or cheetah_model.get_markers()
    links = _marker_links(markers) if len(markers) == positions.shape[1] else []

    fig = Figure(figsize=(14, 6), dark=dark_mode, projection="3d")
    ax = fig.axes[0][0]
    for n in range(0, len(positions), max(frame_step, 1)):
        pts = positions[n].copy()
        if centered:
            pts = pts - np.nanmean(pts, axis=0, keepdims=True)
        ax.scatter(*pts.T, s=6)
        for a, b in links:
            if np.isfinite(pts[[a, b]]).all():
                ax.plot(*np.stack([pts[a], pts[b]]).T, lw=0.8, alpha=0.7)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    ax.set_title(os.path.basename(data_fpath))
    _save(fig, out_fpath)
    return fig


def plot_multiple_cheetah_reconstructions(
    data_fpaths: Sequence[str],
    reprojections: bool = False,
    dark_mode: bool = False,
    frame_step: int = 20,
    out_fpath: Optional[str] = None,
):
    """Every frame_step-th frame of several result pickles on one 3D
    axes, each file's first frame labelled with its name."""
    fig = Figure(figsize=(14, 6), dark=dark_mode, projection="3d")
    ax = fig.axes[0][0]
    for fp in data_fpaths:
        payload = data_io.load_pickle(fp)
        positions = np.asarray(payload["positions"])
        label = os.path.basename(fp).replace(".pickle", "")
        for n in range(0, len(positions), max(frame_step, 1)):
            pts = positions[n]
            ax.scatter(*pts.T, s=4, label=label if n == 0 else None, alpha=0.6)
    ax.legend()
    _save(fig, out_fpath)
    return fig


def plot_results_with_pan(
    result_fpath: str,
    encoder_counts: Optional[np.ndarray] = None,
    frame_step: int = 10,
    out_fpath: Optional[str] = None,
):
    """A result pickle's positions de-rotated frame by frame by the
    rig's encoder angle (``utils.pan_compensation``, float64 on the
    host), plotted every frame_step-th frame. Returns the positions."""
    payload = data_io.load_pickle(result_fpath)
    positions = np.asarray(payload["positions"])
    if encoder_counts is not None:
        theta = pan_compensation.count_to_rad(np.asarray(encoder_counts))
        positions = pan_compensation.rotate_point(
            torch.as_tensor(positions), -theta[:, None]).numpy()
    fig = Figure(figsize=(12, 6), projection="3d")
    ax = fig.axes[0][0]
    for n in range(0, len(positions), max(frame_step, 1)):
        ax.scatter(*positions[n].T, s=5, alpha=0.7)
    ax.set_title(f"{os.path.basename(result_fpath)} (pan-compensated)")
    _save(fig, out_fpath, announce=False)
    return positions


#: threads animate_reconstruction rasterises its frames on
RASTER_THREADS = 4


def _reconstruction_frame(n, pts, pairs, lo, hi, elev, azim):
    """Frame n of animate_reconstruction: the points (L, 3) and bones."""
    fig = Figure(figsize=(8, 6), dpi=80, projection="3d")
    ax = fig.axes[0][0]
    ax.scatter(*pts.T, s=12, c="tab:red")
    for i, j in pairs:
        ax.plot(*np.stack([pts[i], pts[j]]).T, lw=1.5, c="tab:blue")
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(f"frame {n}")
    return fig


def animate_reconstruction(
    result_fpath: str,
    out_fpath: str,
    skel_links: Optional[Sequence[Sequence[str]]] = None,
    fps: float = 15.0,
    max_frames: int = 300,
    elev: float = 20.0,
    azim: float = -60.0,
    device=None,
):
    """A result pickle's 3D reconstruction as an mp4v video, one 8 x 6 in
    figure at 80 dpi (640 x 480) a frame, up to max_frames: the markers
    as a red scatter, the named skeleton links (resolved through the
    result's ``markers``) as blue bones, fixed limits padded by 10% of
    the span, ``view_init(elev, azim)`` and the title ``frame n``. Each
    frame is rasterised by ``Figure.to_png`` and encoded on the device
    (``utils.mpeg4.Writer``). Returns out_fpath."""
    device = resolve_device(device)
    payload = data_io.load_pickle(result_fpath)
    positions = np.asarray(payload["positions"])[:max_frames]
    markers = list(payload.get("markers") or [])
    pairs = [(markers.index(a), markers.index(b)) for a, b in (skel_links or [])
             if markers and a in markers and b in markers]
    lo = np.nanmin(positions.reshape(-1, 3), axis=0)
    hi = np.nanmax(positions.reshape(-1, 3), axis=0)
    pad = 0.1 * np.maximum(hi - lo, 1e-3)
    lo, hi = lo - pad, hi + pad
    def raster(n):
        return _reconstruction_frame(n, positions[n], pairs, lo, hi, elev, azim).to_png()[0]

    # the numpy rasteriser spends much of a frame outside the GIL: frames
    # are drawn on a few threads, in order, and encoded as they come
    with ThreadPoolExecutor(RASTER_THREADS) as pool:
        frames = pool.map(raster, range(len(positions)))
        first = next(frames)
        with mpeg4.Writer(out_fpath, (first.shape[1], first.shape[0]), fps, device) as writer:
            for rgb in itertools.chain([first], frames):
                writer.write(np.ascontiguousarray(rgb[..., ::-1]))
    print(f"Saved {out_fpath}")
    return out_fpath


def plot_corners(points_fpath: str, out_fpath: Optional[str] = None):
    """Every board's detected corners as a polyline over the image, y
    down."""
    points, _fnames, _board_shape, _edge, cam_res = data_io.load_points(points_fpath)
    fig, axes = subplots(figsize=(10, 6))
    ax = axes[0][0]
    for p in points:
        ax.plot(*p.reshape(-1, 2).T, ".-", ms=2, lw=0.4, alpha=0.7)
    ax.set_xlim(0, cam_res[0]); ax.set_ylim(cam_res[1], 0)
    ax.set_title(f"{len(points)} boards ({points_fpath})")
    _save(fig, out_fpath, announce=False)
    return fig


def plot_points_fisheye_undistort(points_fpath: str, camera_fpath: str, out_fpath=None,
                                  device=None):
    """Every board's corners before and after fisheye undistortion (a
    straightness check), the undistortion on ``device`` (CUDA unless
    given) in float64."""
    device = resolve_device(device)
    points, _fnames, _board_shape, _e, cam_res = data_io.load_points(points_fpath)
    k, d, _ = data_io.load_camera(camera_fpath)
    kt = torch.as_tensor(k, dtype=torch.float64, device=device)
    dt = torch.as_tensor(d.reshape(-1)[:4], dtype=torch.float64, device=device)
    fig, axes = subplots(1, 2, figsize=(16, 5))
    left, right = axes[0]
    for p in points:
        p2 = p.reshape(-1, 2)
        left.plot(*p2.T, ".-", ms=2, lw=0.4)
        u = undistort_points_fisheye(torch.as_tensor(p2, dtype=torch.float64, device=device),
                                     kt, dt, P=kt).cpu().numpy()
        right.plot(*u.T, ".-", ms=2, lw=0.4)
    left.set_title("distorted"); right.set_title("undistorted")
    for ax in (left, right):
        ax.set_xlim(0, cam_res[0]); ax.set_ylim(cam_res[1], 0)
    _save(fig, out_fpath, announce=False)
    return fig


def plot_scene(
    scene_fpath: str,
    points_3d: Optional[np.ndarray] = None,
    out_fpath: Optional[str] = None,
    dark_mode: bool = False,
    frustum_scale: float = 0.5,
):
    """The cameras of a scene file: each centre, its name, and four rays
    through its image's corners; and points_3d when given."""
    _k_arr, _d_arr, r_arr, t_arr, _res = data_io.load_scene(scene_fpath)
    fig = Figure(figsize=(10, 8), dark=dark_mode, projection="3d")
    ax = fig.axes[0][0]
    for i, (R, t) in enumerate(zip(r_arr, t_arr)):
        C = -R.T @ np.asarray(t).reshape(3)
        ax.scatter(*C, marker="s", s=40)
        ax.text(*C, f"cam{i + 1}")
        for sx, sy in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
            ray = R.T @ np.array([sx * 0.6, sy * 0.4, 1.0]) * frustum_scale
            ax.plot(*np.stack([C, C + ray]).T, "b-", lw=0.6)
    if points_3d is not None:
        p = np.asarray(points_3d).reshape(-1, 3)
        ax.scatter(*p.T, s=2, alpha=0.5)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    _save(fig, out_fpath)
    return fig
