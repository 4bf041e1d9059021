"""Video I/O, the counterpart of acinoset_tpu.pipeline.video: frames out
of a video (``get_frames``, ``extract_frame_range``), images into one
(``images_to_video``), labels burnt into a run's videos
(``create_labeled_videos``), the natural sort and the vertical stack of
images (src/make_anim.py).

The JAX package does this through cv2; the port reads through
``open_video``, which picks the reader by a fixed table of the track's
codec (``DECODERS``): its own codec ``utils.mpeg4`` for MPEG-4 Part 2
Simple Profile in MP4 (``mp4v``, the codec the JAX package writes), and
its software decoders ``utils.h264`` for GoPro's H.264 (``avc1``/``avc3``)
and ``utils.hevc`` for GoPro's HEVC (``hvc1``/``hev1``), frame for frame
as cv2 gives them (presentation order after the edit list); the card's
NVDEC (``utils.nvdec``) reads H.264 and HEVC where ``decoder='nvdec'``
asks for it. It writes mp4v, as the JAX package does. Each function runs
on the device it is given (``cuda`` unless ``device`` names another); what
cannot be read there (NVDEC on the CPU or where the card's machine
withholds it, a feature a decoder does not take, another codec) raises
``utils.mpeg4.UnsupportedVideo``, naming it, and nothing falls back to
another decoder.

The labels are drawn on the device, pixel for pixel as cv2 draws them:
skeleton lines as ``cv2.line(..., thickness=1)`` (8-connected, clipped to
the frame as ``cv::clipLine`` does), dots as ``cv2.circle(..., 3, colour,
-1)`` (a fixed mask about an integer centre). As cv2's writer does, a
video is written at its even size (odd widths and heights lose their
last column or row) and a frame of another size is dropped.
"""
from __future__ import annotations

import os
import re
from glob import glob
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import h264, hevc, mp4, mpeg4, nvdec
from ..utils.device import resolve_device
from ..utils.png import read_png, write_png
from . import data as data_io
from .plots import CHEETAH_LINKS


def _even(size):
    """The frame size cv2's writer makes of (width, height): each rounded
    down to even."""
    return (int(size[0]) & ~1, int(size[1]) & ~1)


def _write(writer, frame):
    """Write a BGR frame as cv2's writer takes it: cropped to the writer's
    even size, dropped if its own size rounds to another."""
    W, H = writer.size
    if _even((frame.shape[1], frame.shape[0])) == (W, H):
        writer.write(frame[:H, :W])


#: the reader of each sample entry when none is asked for; the rest go to
#: mpeg4.Reader (which refuses all but mp4v)
DECODERS = {"avc1": "software", "avc3": "software", "hvc1": "software", "hev1": "software"}


def open_video(video_fpath: str, device=None, decoder: Optional[str] = None):
    """A reader of the video's frames (``n_frames``, ``size``, ``fps``,
    ``read``, ``read_tensor``, ``close``; a context manager), picked by a
    fixed table from its track's codec (``DECODERS``): ``h264.Reader`` and
    ``hevc.Reader`` (the port's software decoders) for H.264 and HEVC,
    ``mpeg4.Reader`` for the rest. ``decoder='nvdec'`` (the card's NVDEC,
    ``nvdec.Reader``) or ``'software'`` asks for one of the two for H.264
    or HEVC. Nothing falls back: a refusal raises ``UnsupportedVideo``
    naming its reason."""
    device = resolve_device(device)
    codec = mp4.read_video_track(video_fpath).codec
    if decoder not in (None, "nvdec", "software"):
        raise ValueError(f"decoder must be None, 'nvdec' or 'software', not {decoder!r}")
    if codec not in DECODERS:
        if decoder is not None:
            raise mpeg4.UnsupportedVideo(video_fpath, f"{mpeg4.CODEC_NAMES.get(codec, repr(codec))}:"
                                                      f" decoder={decoder!r} reads H.264 and HEVC only")
        return mpeg4.Reader(video_fpath, device)
    choice = decoder or DECODERS[codec]
    if choice == "nvdec":
        return nvdec.Reader(video_fpath, device)
    if codec in hevc.CODECS:
        return hevc.Reader(video_fpath, device)
    return h264.Reader(video_fpath, device)


def get_frames(video_fpath: str, frame_indices: Sequence[int], out_dir: Optional[str] = None,
               device=None, decoder: Optional[str] = None):
    """Frames of a video by index, as [(index, BGR uint8 (H, W, 3))]
    (src/calib/extract.py:21-44); an index that cannot be read is
    skipped. With out_dir each is also written there as ``{index}.png``.
    ``decoder`` as in ``open_video``."""
    device = resolve_device(device)
    out = []
    with open_video(video_fpath, device, decoder) as reader:
        for idx in frame_indices:
            frame = reader.read(int(idx)) if int(idx) >= 0 else None
            if frame is None:
                continue
            out.append((idx, frame))
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"{idx}.png"), frame[..., ::-1])
    return out


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


#: the pixels cv2.circle(img, centre, 3, colour, -1) fills about its centre
DOT_OFFSETS = np.array([(dx, dy) for dy, half in ((-3, 0), (-2, 2), (-1, 2), (0, 3), (1, 2),
                                                  (2, 2), (3, 0))
                        for dx in range(-half, half + 1)], np.int64)
LINE_COLOUR = (200, 200, 200)


def marker_colours(n_markers):
    """The dots' BGR colours, marker by marker (the JAX package's)."""
    base = np.array([37, 99, 235])
    return [tuple(int(c) for c in base * (0.4 + 0.6 * i / max(n_markers - 1, 1)))
            for i in range(n_markers)]


def clip_lines(p1, p2, size):
    """cv::clipLine on segments (S, 2) int64 -> (p1, p2, kept): the
    endpoints moved onto the frame, and which segments touch it."""
    W, H = size
    right, bottom = W - 1, H - 1
    x1, y1, x2, y2 = (a.astype(np.int64).copy() for a in (p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]))

    def code(x, y):
        return (x < 0) * 1 + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def cut(num, span, den):  # int64((double)num * span / den)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = num.astype(np.float64) * span / den
        return np.where(np.isfinite(v), v, 0).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & ((c1 & 12) != 0)  # onto the top or bottom edge
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + cut(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) * 1 + (x1 > right) * 2, c1)
    m = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + cut(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) * 1 + (x2 > right) * 2, c2)
    todo &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & (c1 != 0)  # onto the left or right edge
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + cut(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = todo & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + cut(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return np.stack([x1, y1], 1), np.stack([x2, y2], 1), (c1 | c2) == 0


def line_pixels(p1, p2):
    """The pixels (x, y) of 8-connected lines between on-frame endpoints
    (S, 2) int64 tensors, as cv::LineIterator walks them from the left
    end: k steps along the major axis move (2 d k + D - 1) // (2 D)
    along the minor one (D, d the major and minor extents)."""
    swap = p2[:, 0] < p1[:, 0]
    a = torch.where(swap[:, None], p2, p1)
    b = torch.where(swap[:, None], p1, p2)
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    sy = torch.where(dy < 0, -1, 1)
    vert = dy.abs() > dx
    D = torch.where(vert, dy.abs(), dx)[:, None]
    d = torch.where(vert, dx, dy.abs())[:, None]
    k = torch.arange(int(D.max()) + 1 if len(D) else 0, device=p1.device)[None, :]
    m = (2 * d * k + D - 1).clamp(min=0).div(2 * D.clamp(min=1), rounding_mode="floor")
    vert = vert[:, None]
    x = a[:, :1] + torch.where(vert, m, k)
    y = a[:, 1:] + sy[:, None] * torch.where(vert, k, m)
    on = k <= D
    return x[on], y[on]


def draw_labels(frame, segments, dots, colours):
    """Draw on a BGR uint8 (H, W, 3) tensor, in place: lines between the
    segments' endpoints (S, 2, 2) in LINE_COLOUR, then dots (M, 2) in
    their colours (M, 3), a later dot over an earlier one, as cv2 draws
    them one after another. Coordinates are int64 numpy arrays."""
    H, W = frame.shape[:2]
    dev = frame.device
    xs, ys, order = [], [], []
    if len(segments):
        q1, q2, kept = clip_lines(segments[:, 0], segments[:, 1], (W, H))
        x, y = line_pixels(torch.from_numpy(q1[kept]).to(dev), torch.from_numpy(q2[kept]).to(dev))
        xs.append(x), ys.append(y), order.append(torch.zeros_like(x))
    if len(dots):
        c = torch.from_numpy(dots).to(dev)[:, None, :] + torch.from_numpy(DOT_OFFSETS).to(dev)
        xs.append(c[..., 0].reshape(-1)), ys.append(c[..., 1].reshape(-1))
        order.append(torch.arange(1, len(dots) + 1, device=dev).repeat_interleave(len(DOT_OFFSETS)))
    if not xs:
        return frame
    x, y, order = torch.cat(xs), torch.cat(ys), torch.cat(order)
    # off-frame pixels (dots at the edges) go to a spare slot past the end
    pix = torch.where((x >= 0) & (x < W) & (y >= 0) & (y < H), y * W + x, H * W)
    top = torch.full((H * W + 1,), -1, dtype=torch.int64, device=dev)
    top.scatter_reduce_(0, pix, order, reduce="amax")
    top = top[:H * W, None]
    table = torch.tensor([LINE_COLOUR] + [tuple(c) for c in colours], dtype=torch.uint8,
                         device=dev).view(-1, 3)
    flat = frame.view(H * W, 3)
    flat.copy_(torch.where(top >= 0, table[top.clamp(min=0).squeeze(1)], flat))
    return frame


def _frame_labels(pts, link_idx, pcutoff, draw_skeleton):
    """One frame's labels (L, 3) -> (segments (S, 2, 2), dots (M, 2),
    their marker indices): the points cv2 is given, int()-truncated, of
    finite points whose likelihood reaches pcutoff."""
    ok = np.isfinite(pts[:, :2]).all(1) & (pts[:, 2] >= pcutoff)
    xy = np.trunc(np.where(ok[:, None], pts[:, :2], 0)).astype(np.int64)
    segs = [(xy[a], xy[b]) for a, b in link_idx if draw_skeleton and ok[a] and ok[b]]
    segments = np.array(segs, np.int64).reshape(-1, 2, 2)
    which = np.flatnonzero(ok)
    return segments, xy[which], which


def _labels_for(out_dir, ci, label_fpaths):
    """The label file of the ci-th video: given, or the first
    ``*cam{ci + 1}.h5``/``.pickle`` in out_dir (None if there is none)."""
    if label_fpaths is not None:
        return label_fpaths[ci]
    cands = sorted(glob(os.path.join(out_dir, f"*cam{ci + 1}.h5"))
                   + glob(os.path.join(out_dir, f"*cam{ci + 1}.pickle")))
    return cands[0] if cands else None


def create_labeled_video(video_fpath: str, ci: int, out_dir: str, draw_skeleton: bool = True,
                         pcutoff: float = 0.5, label_fpaths=None, max_frames=None, device=None,
                         decoder: Optional[str] = None):
    """The ci-th video of ``create_labeled_videos``: its labelled copy's
    path, or None (and a printed line) when it has no labels."""
    device = resolve_device(device)
    lf = _labels_for(out_dir, ci, label_fpaths)
    if lf is None:
        print(f"No labels for cam{ci + 1}; skipping {video_fpath}")
        return None
    frames_idx, markers, vals = _load_2d_labels(lf)
    markers = list(markers)
    link_idx = [(markers.index(a), markers.index(b)) for a, b in CHEETAH_LINKS
                if a in markers and b in markers]
    colours = np.array(marker_colours(len(markers)), np.uint8).reshape(-1, 3)
    lookup = {int(f): i for i, f in enumerate(frames_idx)}
    out_fpath = labeled_video_fpath(video_fpath, out_dir)
    # a frame that cannot be decoded (a B-VOP, say) ends the copy with no file
    with open_video(video_fpath, device, decoder) as reader, \
            mpeg4.Writer(out_fpath, _even(reader.size), reader.fps or 30.0, device) as writer:
        n = 0
        while max_frames is None or n < max_frames:
            frame = reader.read_tensor(n)
            if frame is None:
                break
            row = lookup.get(n)
            if row is not None:
                segments, dots, which = _frame_labels(vals[row], link_idx, pcutoff,
                                                      draw_skeleton)
                draw_labels(frame, segments, dots, colours[which])
            _write(writer, frame)
            n += 1
    print(f"Saved {out_fpath}")
    return out_fpath


def create_labeled_videos(
    video_fpaths: Sequence[str],
    out_dir: str,
    draw_skeleton: bool = True,
    pcutoff: float = 0.5,
    label_fpaths: Optional[Sequence[str]] = None,
    max_frames: Optional[int] = None,
    device=None,
    decoder: Optional[str] = None,
):
    """Burn 2D keypoints (and the skeleton) into videos
    (lib.app.create_labeled_videos). The ci-th video's labels are
    label_fpaths[ci], else the first ``*cam{ci + 1}.h5`` (or ``.pickle``)
    in out_dir; a video without labels is skipped with a printed line.
    Frames are read from 0 up to max_frames; the labels of frame n are
    the label file's row whose frame index is n. The copy goes to
    ``labeled_video_fpath`` at the video's frame rate (30 where it has
    none); ``decoder`` as in ``open_video``. Returns the paths written."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    for ci, vid in enumerate(video_fpaths):
        out = create_labeled_video(vid, ci, out_dir, draw_skeleton, pcutoff, label_fpaths,
                                   max_frames, device, decoder)
        if out is not None:
            outputs.append(out)
    return outputs


# ---- src/make_anim.py twins ----------------------------------------------


def natural_sort(items: Sequence[str]) -> List[str]:
    """Natural (numeric-aware) sort (src/make_anim.py:41-44)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(items, key=key)


def extract_frame_range(video_fpath: str, start: int, end: int, out_dir: str, device=None,
                        decoder: Optional[str] = None):
    """Frames [start, end) of a video as PNGs in out_dir
    (src/make_anim.py:8-39); returns get_frames' list."""
    return get_frames(video_fpath, range(start, end), out_dir=out_dir, device=device,
                      decoder=decoder)


def images_to_video(image_fpaths: Sequence[str], out_fpath: str, fps: float = 30.0, device=None):
    """PNG images, in natural order, as an mp4v video of the first one's
    size (src/make_anim.py:46-74); read as cv2.imread reads them (grey
    repeated, alpha dropped). Returns out_fpath."""
    device = resolve_device(device)
    image_fpaths = natural_sort(list(image_fpaths))
    first = _rgb(read_png(image_fpaths[0]))
    H, W = first.shape[:2]
    with mpeg4.Writer(out_fpath, _even((W, H)), fps, device) as writer:
        for p in image_fpaths:
            _write(writer, np.ascontiguousarray(_rgb(read_png(p))[..., ::-1]))
    print(f"Saved {out_fpath}")
    return out_fpath


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
