"""Multi-video synchronized manual point labelling, the counterpart of
acinoset_tpu.gui.label_session (the reference's OpenCV click GUI, AcinoSet
src/calib/extract.py:51-180, ``VideoLabelSession``).

The session holds a (n_points, n_cams, 2) array of clicked pixels (NaN =
unclicked) and writes the ``manual_points.json`` schema consumed by
``calib.app.adjust_extrinsics_manual_points``, byte for byte as the JAX
package writes it. The programmatic API (``record``, ``save``) is the
whole of it here: the click UI needs matplotlib, which the port does not
use, and ``run_interactive`` raises.
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np


class LabelSession:
    def __init__(self, n_cams: int, camera_resolution: Tuple[int, int]):
        self.n_cams = n_cams
        self.camera_resolution = tuple(camera_resolution)
        self.points: List[np.ndarray] = []  # each (n_cams, 2) with NaN

    def new_point(self) -> int:
        self.points.append(np.full((self.n_cams, 2), np.nan))
        return len(self.points) - 1

    def record(self, point_idx: int, cam_idx: int, xy: Sequence[float]):
        while point_idx >= len(self.points):
            self.new_point()
        self.points[point_idx][cam_idx] = np.asarray(xy, dtype=np.float64)

    def as_array(self) -> np.ndarray:
        return np.stack(self.points) if self.points else np.zeros((0, self.n_cams, 2))

    def save(self, out_fpath: str) -> str:
        pts = self.as_array()
        payload = {
            "camera_resolution": list(self.camera_resolution),
            "points": np.where(np.isfinite(pts), pts, None).tolist(),
        }
        os.makedirs(os.path.dirname(out_fpath) or ".", exist_ok=True)
        with open(out_fpath, "w") as f:
            json.dump(payload, f)
        print(f"Saved {out_fpath}")
        return out_fpath

    @classmethod
    def load(cls, fpath: str) -> "LabelSession":
        with open(fpath) as f:
            payload = json.load(f)
        pts = np.array(
            [[[np.nan if v is None else v for v in xy] for xy in cams] for cams in payload["points"]],
            dtype=np.float64,
        ) if payload["points"] else np.zeros((0, 1, 2))
        sess = cls(pts.shape[1] if pts.size else 1, tuple(payload["camera_resolution"]))
        sess.points = list(pts)
        return sess

    def run_interactive(self, images: Sequence[np.ndarray]):
        """The click UI of the JAX package, which draws with matplotlib:
        not in the port. Label with ``record`` and ``save``."""
        raise RuntimeError("run_interactive needs matplotlib, which the port does not use; "
                           "record points with LabelSession.record and save them")
