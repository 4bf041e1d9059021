"""Orchestration-layer utilities of acinoset_tpu.pipeline.app: the
logging tee, video info, and the result savers (``{tri,sba,ekf,fte}
.pickle`` and the per-camera reprojections).

Every pickle holds numpy arrays and Python scalars only, never a torch
tensor, so the JAX package and the reference read them. Video info comes
from ``utils.mp4`` (the box tables, no decoding) where ``cam[1-9].mp4``
exist, else from the ``video_info.json`` sidecar. The reprojections are
written as DLC ``.h5`` files through ``utils.hdf5``; the JAX package
writes a pandas ``to_hdf`` file there (or a DataFrame pickle where
PyTables is missing).
"""
from __future__ import annotations

import json
import os
import sys
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import mp4
from ..utils.device import resolve_device
from . import data as data_io

# --------------------------------------------------------------------------
# Logging tee
# --------------------------------------------------------------------------


class _Tee:
    def __init__(self, stream, fpath):
        self.stream = stream
        self.file = open(fpath, "w")

    def write(self, msg):
        self.stream.write(msg)
        self.file.write(msg)

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()


_active_tee: Optional[_Tee] = None


def start_logging(fpath: str):
    """Tee stdout to a per-run log file."""
    global _active_tee
    stop_logging()
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    _active_tee = _Tee(sys.stdout, fpath)
    sys.stdout = _active_tee


def stop_logging():
    global _active_tee
    if _active_tee is not None:
        sys.stdout = _active_tee.stream
        _active_tee.close()
        _active_tee = None


# --------------------------------------------------------------------------
# Video info
# --------------------------------------------------------------------------


def get_vid_info(data_dir: str):
    """cam[1-9].mp4 -> (resolution, fps, tot_frames, fpaths), read from the
    first video's boxes. Without videos, the ``video_info.json`` sidecar
    ({"resolution": [w, h], "fps": f, "tot_frames": n}) answers."""
    fpaths = sorted(glob(os.path.join(data_dir, "cam[1-9].mp4")))
    if fpaths:
        res, fps, tot = mp4.video_info(fpaths[0])
        return res, fps, tot, fpaths
    sidecar = os.path.join(data_dir, "video_info.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            info = json.load(f)
        return tuple(info["resolution"]), info["fps"], info["tot_frames"], fpaths
    raise FileNotFoundError(f"No cam[1-9].mp4 or video_info.json in {data_dir}")


# --------------------------------------------------------------------------
# Result pickles ({tri,sba,ekf,fte}.pickle: positions + x/dx/ddx arrays)
# --------------------------------------------------------------------------


def _host(v):
    """A value for a pickle: numpy for arrays and tensors, else as is."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v) if hasattr(v, "shape") else v


def _save_result(out_fpath, positions, scene_fpath, start_frame, dlc_thresh, extra: Dict = None):
    payload = dict(
        positions=np.asarray(_host(positions)),
        scene_fpath=scene_fpath,
        start_frame=start_frame,
        dlc_thresh=dlc_thresh,
    )
    if extra:
        payload.update({k: _host(v) for k, v in extra.items()})
    data_io.save_pickle(out_fpath, payload)
    print(f"Saved {out_fpath}")
    return payload


def save_tri(positions, out_dir, scene_fpath, start_frame, dlc_thresh, extra: Dict = None):
    return _save_result(os.path.join(out_dir, "tri.pickle"), positions, scene_fpath,
                        start_frame, dlc_thresh, extra)


def save_sba(positions, out_dir, scene_fpath, start_frame, dlc_thresh, extra: Dict = None):
    return _save_result(os.path.join(out_dir, "sba.pickle"), positions, scene_fpath,
                        start_frame, dlc_thresh, extra)


def save_ekf(states: Dict, out_dir, scene_fpath, start_frame, dlc_thresh, positions=None):
    return _save_result(
        os.path.join(out_dir, "ekf.pickle"),
        positions if positions is not None else np.zeros((0,)),
        scene_fpath,
        start_frame,
        dlc_thresh,
        extra=states,
    )


def save_optimised_cheetah(positions, out_fpath, extra_data: Dict = None):
    """fte.pickle: {positions, x, dx, ddx, start_frame, ...}."""
    payload = dict(positions=np.asarray(_host(positions)))
    if extra_data:
        payload.update({k: _host(v) for k, v in extra_data.items()})
    data_io.save_pickle(out_fpath, payload)
    print(f"Saved {out_fpath}")
    return payload


def save_3d_cheetah_as_2d(
    positions, out_dir, scene_fpath, markers: Sequence[str], project_func, start_frame: int,
    out_fname: str = "cheetah_reprojected", device=None,
):
    """Reproject a 3D trajectory (N, L, 3) into every camera of the scene
    and write one ``<out_fname>_cam{c}.h5`` per camera in the DLC layout
    of ``data.save_dlc_points_h5``: scorer ``acinoset_tpu``, likelihood
    1.0 where the projection is finite and 0.0 elsewhere, frame index
    ``start_frame .. start_frame + N - 1``. ``project_func(pts (P, 3), K,
    D, R, t) -> (P, 2)`` runs on float64 tensors on ``device`` (CUDA
    unless given). Returns the paths written."""
    device = resolve_device(device)
    k_arr, d_arr, r_arr, t_arr, _res = data_io.load_scene(scene_fpath)
    d_arr = d_arr.reshape((-1, 4))
    positions = np.asarray(positions, dtype=np.float64)  # (N, L, 3)
    N, L, _ = positions.shape
    pts = positions.reshape(-1, 3)
    ok = np.isfinite(pts).all(axis=1)
    pts_t = torch.as_tensor(pts[ok], device=device)
    frames = np.arange(start_frame, start_frame + N)
    out_paths = []
    for c in range(len(k_arr)):
        pix = np.full((N * L, 2), np.nan)
        if ok.any():
            cam = [torch.as_tensor(a, dtype=torch.float64, device=device)
                   for a in (k_arr[c], d_arr[c], r_arr[c], t_arr[c])]
            pix[ok] = project_func(pts_t, *cam).cpu().numpy()
        pix = pix.reshape(N, L, 2)
        lik = np.where(np.isfinite(pix[..., 0]), 1.0, 0.0)
        fpath = os.path.join(out_dir, f"{out_fname}_cam{c + 1}.h5")
        data_io.save_dlc_points_h5(fpath, pix, lik, list(markers), frames=frames)
        out_paths.append(fpath)
        print(f"Saved {fpath}")
    return out_paths
