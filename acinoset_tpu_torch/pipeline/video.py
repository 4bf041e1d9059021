"""Video helpers, the counterpart of acinoset_tpu.pipeline.video: the
natural sort and the vertical stack of images (src/make_anim.py), and a
run's 2D label files.

The port has no video decoder or encoder (the JAX package uses cv2's).
``utils.mp4`` reads a video's size, frame rate and frame count from its
boxes, which is all the pipeline's stages need. So the functions that
read or write frames (``get_frames``, ``extract_frame_range``,
``images_to_video``, ``create_labeled_videos``) raise
``NotImplementedError``, naming what is missing, before they open or
write a file; the CLI's ``dlc`` stage names each labelled video it does
not write.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

import numpy as np

from ..utils.png import read_png, write_png
from . import data as data_io


def _no_codec(what, needs):
    return NotImplementedError(
        f"{what}: {needs}, and the port has none (the JAX package uses cv2's); "
        "utils.mp4.video_info reads a video's size, frame rate and frame count")


def get_frames(video_fpath: str, frame_indices: Sequence[int], out_dir: Optional[str] = None):
    """Not ported: extracting frames needs a video decoder."""
    raise _no_codec(f"get_frames({video_fpath!r})", "extracting frames needs a video decoder")


def _load_2d_labels(fpath: str):
    """A DLC-style 2D label file (.h5) -> (frames, markers, (N, L, 3)).
    The ``.pickle`` labels the JAX package also reads are pandas
    DataFrames, which the port does not unpickle, so they raise."""
    if fpath.endswith(".pickle"):
        raise NotImplementedError(
            f"{fpath}: a .pickle label file holds a pandas DataFrame, and the port does not "
            "use pandas; write the labels as DLC .h5 (pipeline.data.save_dlc_points_h5)")
    return data_io._read_dlc_h5(fpath)


def labeled_video_fpath(video_fpath: str, out_dir: str) -> str:
    """Where ``create_labeled_videos`` writes the labelled copy of a video."""
    return os.path.join(out_dir, os.path.basename(video_fpath).replace(".mp4", "_labeled.mp4"))


def create_labeled_videos(
    video_fpaths: Sequence[str],
    out_dir: str,
    draw_skeleton: bool = True,
    pcutoff: float = 0.5,
    label_fpaths: Optional[Sequence[str]] = None,
    max_frames: Optional[int] = None,
):
    """Not ported: burning labels into videos needs a video decoder and
    encoder."""
    raise _no_codec(f"create_labeled_videos({list(video_fpaths)!r})",
                    "burning labels into videos needs a video decoder and encoder")


# ---- src/make_anim.py twins ----------------------------------------------


def natural_sort(items: Sequence[str]) -> List[str]:
    """Natural (numeric-aware) sort (src/make_anim.py:41-44)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(items, key=key)


def extract_frame_range(video_fpath: str, start: int, end: int, out_dir: str):
    """Not ported: extracting frames needs a video decoder."""
    raise _no_codec(f"extract_frame_range({video_fpath!r}, {start}, {end})",
                    "extracting frames needs a video decoder")


def images_to_video(image_fpaths: Sequence[str], out_fpath: str, fps: float = 30.0):
    """Not ported: writing a video needs a video encoder."""
    raise _no_codec(f"images_to_video(..., {out_fpath!r})", "writing a video needs a video encoder")


def _rgb(img):
    """An image as three channels, as cv2.imread's colour mode gives it:
    grey repeated, alpha dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def vstack_images(image_fpaths: Sequence[str], out_fpath: str):
    """PNG images stacked top to bottom, each cropped to the narrowest's
    width, as an RGB PNG (src/make_anim.py:76-90). Returns out_fpath."""
    if not out_fpath.lower().endswith(".png"):
        raise ValueError(f"{out_fpath}: vstack_images writes PNG files only")
    imgs = [_rgb(read_png(p)) for p in image_fpaths]
    w = min(i.shape[1] for i in imgs)
    write_png(out_fpath, np.concatenate([i[:, :w] for i in imgs], axis=0))
    return out_fpath
