"""Argus Clicker -> manual_points.json converter, the counterpart of
acinoset_tpu.utils.argus (the reference's src/argus_converter.py).

Argus exports manually clicked multi-camera correspondences as a wide
CSV (columns like 'track_cam_1_x', 'track_cam_1_y', ...) and a YAML
config holding the camera resolution. AcinoSet's manual-point tools
expect ``manual_points.json`` with points shaped (n_points, n_cams, 2)
and the y axis flipped (Argus measures y up from the bottom;
src/argus_converter.py:67).

The CSV is read with ``csv`` (pandas' default missing-value words read
as NaN), and the YAML's top-level ``key: value`` lines by a reader of
those alone: the resolution keys are top-level scalars, and a line at
indent 0 that is not such a line raises, naming the file and the line.
"""
from __future__ import annotations

import csv
import json
import os
import re
from typing import Optional, Tuple

import numpy as np

#: the cells pandas.read_csv reads as NaN by default
NA_WORDS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
            "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
#: a top-level ``key: value`` (or ``key:``) line
_KEY_VALUE = re.compile(r"""^([^\s#'"-][^:#]*?|'[^']*'|"[^"]*")\s*:(?:\s+(.*))?$""")


def _scalar(text):
    """A YAML plain or quoted scalar: int, float, None or str."""
    text = re.sub(r"\s+#.*$", "", text.strip())
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_top_level_yaml(fpath) -> dict:
    """The top-level ``key: value`` pairs of a YAML file; nested blocks
    (indented lines) are skipped and their keys read as None."""
    out = {}
    with open(fpath) as f:
        for n, line in enumerate(f, 1):
            body = line.rstrip("\n")
            if not body.strip() or body.lstrip().startswith("#") or body[0] in " \t":
                continue
            if body.startswith(("---", "...")):
                continue
            m = _KEY_VALUE.match(body.rstrip())
            if m is None:
                raise ValueError(f"{fpath}:{n}: not a top-level 'key: value' line: {body!r}")
            out[_scalar(m.group(1))] = _scalar(m.group(2) or "")
    return out


def _read_csv(fpath):
    """(header, column reader) of a CSV with a header row: the reader
    gives a column as float64, short rows padded with NaN."""
    with open(fpath, newline="") as f:
        header, *body = list(csv.reader(f))

    def cell(v, name):
        if v.strip() in NA_WORDS:
            return np.nan
        try:
            return float(v)
        except ValueError:
            raise ValueError(f"{fpath}: column {name!r} holds {v!r}, not a number") from None

    def column(name):
        i = header.index(name)
        return np.array([cell(r[i], name) if i < len(r) else np.nan for r in body])

    return header, column, len(body)


def convert_argus_csv(
    csv_fpath: str,
    yaml_fpath: Optional[str] = None,
    out_fpath: Optional[str] = None,
    camera_resolution: Tuple[int, int] = (2704, 1520),
):
    """Convert an Argus clicker CSV (+YAML config) to manual_points.json,
    written as the JAX package writes it. Returns the points array
    (n_points, n_cams, 2) with NaN for unclicked views."""
    if yaml_fpath:
        cfg = read_top_level_yaml(yaml_fpath)
        # argus configs store image width/height (possibly per camera)
        w = cfg.get("image_width") or cfg.get("width") or camera_resolution[0]
        h = cfg.get("image_height") or cfg.get("height") or camera_resolution[1]
        camera_resolution = (int(w), int(h))

    columns, column, n_points = _read_csv(csv_fpath)
    cam_ids = sorted(
        {int(m.group(1)) for c in columns for m in [re.search(r"cam[_ ]?(\d+)[_ ]?x$", c.lower())]
         if m}
    )
    pts = np.full((n_points, len(cam_ids), 2), np.nan)
    for ci, cam in enumerate(cam_ids):
        xcol = next(c for c in columns if re.search(rf"cam[_ ]?{cam}[_ ]?x$", c.lower()))
        ycol = next((c for c in columns if re.search(rf"cam[_ ]?{cam}[_ ]?y$", c.lower())), None)
        if ycol is None:
            raise ValueError(f"{csv_fpath}: camera {cam} has an x column ({xcol}) and no y column")
        pts[:, ci, 0] = column(xcol)
        # Argus y runs bottom-up; AcinoSet expects top-down pixels
        pts[:, ci, 1] = camera_resolution[1] - column(ycol)
    out_fpath = out_fpath or os.path.join(os.path.dirname(csv_fpath), "manual_points.json")
    with open(out_fpath, "w") as f:
        json.dump(
            {
                "camera_resolution": list(camera_resolution),
                "points": np.where(np.isfinite(pts), pts, None).tolist(),
            },
            f,
        )
    print(f"Saved {out_fpath}")
    return pts
