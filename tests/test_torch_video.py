"""The port's video functions (acinoset_tpu_torch.pipeline.video, on its
own mp4v codec) against the JAX package's (cv2): the natural sort, the
vertical stack of PNG images (pixel for pixel against cv2's), the 2D
label files and the labelled videos' paths; frames out of a video by
index and by range (get_frames, extract_frame_range) and the PNGs they
write; and the labels drawn (cv2.line and cv2.circle's pixels, bit for
bit) and burnt into videos (create_labeled_videos: the same outputs,
paths and printed lines, and a PSNR against the drawn frames no lower
than the JAX package's file's less 1 dB)."""
import contextlib
import io
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.models import cheetah
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import mpeg4, png
from acinoset_tpu_torch.utils import synthetic as tsyn
from test_torch_mpeg4 import cv2_frames, footage, psnr, write_pngs

torch.set_num_threads(2)


def test_natural_sort_matches_jax():
    rng = np.random.default_rng(0)
    names = [f"{p}{n}.png" for p in ("f", "F", "frame_", "img-") for n in rng.integers(0, 200, 6)]
    names += ["10", "9", "a10b2", "a10b10", "a9b100", "", "x"]
    rng.shuffle(names)
    assert tvideo.natural_sort(names) == jvideo.natural_sort(names)
    assert tvideo.natural_sort(["f10.png", "f9.png", "f100.png"]) == [
        "f9.png", "f10.png", "f100.png"]


def test_vstack_images_matches_jax_pixel_for_pixel(tmp_path):
    """RGB, grey and RGBA inputs of different widths: cropped to the
    narrowest, grey repeated and alpha dropped, as cv2.imread reads them."""
    rng = np.random.default_rng(1)
    shapes = [(12, 31, 3), (7, 29), (9, 40, 4), (5, 33, 2)]
    paths = []
    for i, shape in enumerate(shapes):
        paths.append(str(tmp_path / f"{i}.png"))
        png.write_png(paths[-1], rng.integers(0, 256, shape, dtype=np.uint8))
    want = jvideo.vstack_images(paths, str(tmp_path / "jax.png"))
    got = tvideo.vstack_images(paths, str(tmp_path / "port.png"))
    assert got == str(tmp_path / "port.png")
    a, b = png.read_png(want), png.read_png(got)
    assert b.shape == (12 + 7 + 9 + 5, 29, 3)
    np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="PNG files only"):
        tvideo.vstack_images(paths, str(tmp_path / "out.jpg"))


def test_2d_labels_and_labelled_video_paths_match_jax(tmp_path):
    markers = cheetah.get_markers()
    rng = np.random.default_rng(2)
    pix = rng.uniform(5, 55, (12, len(markers), 2))
    lik = rng.uniform(0, 1, (12, len(markers)))
    h5 = tdata.save_dlc_points_h5(str(tmp_path / "labels_cam1.h5"), pix, lik, markers)
    got, want = tvideo._load_2d_labels(h5), jvideo._load_2d_labels(h5)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(NotImplementedError, match="pandas"):
        tvideo._load_2d_labels(str(tmp_path / "labels_cam1.pickle"))

    # the path the JAX package writes a labelled video to, on a cv2 video
    vid = str(tmp_path / "cam1.mp4")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    for _ in range(12):
        vw.write(np.zeros((48, 64, 3), np.uint8))
    vw.release()
    out_dir = str(tmp_path / "dlc")
    os.makedirs(out_dir)
    outs = jvideo.create_labeled_videos([vid], out_dir, label_fpaths=[h5])
    assert outs == [tvideo.labeled_video_fpath(vid, out_dir)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 30-frame, 96 x 64 mp4v file the JAX package wrote (cv2) from
    PNGs, and its frames as cv2 decodes them."""
    d = tmp_path_factory.mktemp("clip")
    paths = write_pngs(str(d / "png"), footage((96, 64), 30, seed=7))
    vid = jvideo.images_to_video(paths, str(d / "cam1.mp4"), fps=90.0)
    return vid, cv2_frames(vid)


def test_get_frames_matches_jax(clip, tmp_path):
    """Scattered indices, repeats and one past the end: the same
    (index, frame) list as the JAX function's cv2 seek, and the PNGs
    written read back as the frames (RGB, as cv2.imwrite writes BGR)."""
    vid, frames = clip
    idx = [17, 3, 29, 12, 12, 11, 0, 24, 30, 8]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jvideo.get_frames(vid, idx, out_dir=str(tmp_path / "jax"))
    got = tvideo.get_frames(vid, idx, out_dir=str(tmp_path / "port"), device="cpu")
    assert [i for i, _ in got] == [i for i, _ in want] == [i for i in idx if i < 30]
    for (i, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, frames[i])
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port" / f"{i}.png")),
                                      g[..., ::-1])
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / f"{i}.png")), w)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_extract_frame_range_matches_jax(clip, tmp_path):
    vid, _frames = clip
    want = jvideo.extract_frame_range(vid, 9, 14, str(tmp_path / "jax"))
    got = tvideo.extract_frame_range(vid, 9, 14, str(tmp_path / "port"), device="cpu")
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(9, 14))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(os.listdir(tmp_path / "port")) == {f"{i}.png" for i in range(9, 14)}


def _cv2_draw(frame, segments, dots, colours):
    out = frame.copy()
    for (a, b) in segments:
        cv2.line(out, tuple(map(int, a)), tuple(map(int, b)), tvideo.LINE_COLOUR, 1)
    for p, c in zip(dots, colours):
        cv2.circle(out, (int(p[0]), int(p[1])), 3, tuple(int(v) for v in c), -1)
    return out


def test_draw_labels_is_cv2s_drawing():
    """Lines (inside, crossing and wholly outside the frame, points and
    steep ones) and overlapping dots at and past the edges, each pixel as
    cv2.line and cv2.circle set it."""
    rng = np.random.default_rng(4)
    H, W = 48, 64
    for trial in range(40):
        frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        p = rng.integers(-30, 95, (12, 2, 2))
        p[:3, 1] = p[:3, 0] + rng.integers(-3, 4, (3, 2))  # short and single-pixel lines
        dots = rng.integers(-4, 70, (9, 2))
        dots[-1] = dots[0] + 1  # overlapping: the later dot wins
        colours = rng.integers(0, 256, (9, 3), dtype=np.uint8)
        got = tvideo.draw_labels(torch.from_numpy(frame.copy()), p, dots, colours).numpy()
        np.testing.assert_array_equal(got, _cv2_draw(frame, p, dots, colours), err_msg=str(trial))


@pytest.fixture(scope="module")
def labels(clip, tmp_path_factory):
    """Labels for clip's 30 frames: points on and off the frame, NaNs,
    likelihoods on both sides of pcutoff, frames without a row."""
    d = tmp_path_factory.mktemp("labels")
    markers = cheetah.get_markers()
    rng = np.random.default_rng(5)
    frames = np.arange(2, 30)  # frames 0 and 1 have no row
    pix = rng.uniform(-15, 110, (len(frames), len(markers), 2))
    pix[3, 4] = np.nan
    pix[5, :, 0] = np.nan
    lik = rng.uniform(0, 1, (len(frames), len(markers)))
    return tdata.save_dlc_points_h5(str(d / "labels_cam1.h5"), pix, lik, markers, frames=frames)


def test_create_labeled_videos_matches_jax(clip, labels, tmp_path, capsys):
    """The JAX function and the port's on the same video and labels: the
    same returned paths (each in its own out_dir) and printed lines; the
    port's frames, decoded, against cv2's drawing on cv2's decode of the
    source: a PSNR no lower than the JAX package's labelled file's less
    1 dB; and the same with max_frames, pcutoff and no skeleton."""
    vid, frames = clip
    for kw in (dict(), dict(max_frames=7, pcutoff=0.2, draw_skeleton=False)):
        outs = {}
        for name, mod, extra in (("jax", jvideo, {}), ("port", tvideo, {"device": "cpu"})):
            d = tmp_path / f"{name}{len(kw)}"
            d.mkdir()
            shutil.copy(labels, d / "labels_cam1.h5")
            got = mod.create_labeled_videos([vid, str(tmp_path / "cam2.mp4")], str(d), **kw,
                                            **extra)
            outs[name] = (got, capsys.readouterr().out.replace(str(d), "<out>"))
        assert outs["port"][1] == outs["jax"][1]
        assert [os.path.basename(p) for p in outs["port"][0]] == ["cam1_labeled.mp4"]
        assert [os.path.basename(p) for p in outs["jax"][0]] == ["cam1_labeled.mp4"]
        n = kw.get("max_frames", 30)
        jax_out, port_out = cv2_frames(outs["jax"][0][0]), cv2_frames(outs["port"][0][0])
        assert len(jax_out) == len(port_out) == n
        fr, markers, vals = tvideo._load_2d_labels(labels)
        links = [(markers.index(a), markers.index(b)) for a, b in tvideo.CHEETAH_LINKS]
        colours = np.array(tvideo.marker_colours(len(markers)), np.uint8)
        drawn = []
        for i in range(n):
            rows = np.flatnonzero(fr == i)
            frame = frames[i]
            if len(rows):
                segs, dots, which = tvideo._frame_labels(vals[rows[0]], links,
                                                         kw.get("pcutoff", 0.5),
                                                         kw.get("draw_skeleton", True))
                frame = _cv2_draw(frame, segs, dots, colours[which])
            drawn.append(frame)
        p_port = np.mean([psnr(a, b) for a, b in zip(port_out, drawn)])
        p_jax = np.mean([psnr(a, b) for a, b in zip(jax_out, drawn)])
        assert p_port >= p_jax - 1.0, (p_port, p_jax)
        with mpeg4.Reader(outs["port"][0][0], device="cpu") as r:
            assert (r.n_frames, r.size, r.fps) == (n, (96, 64), 90.0)


def test_create_labeled_videos_of_a_box_only_video(labels, tmp_path, capsys):
    """A video whose track holds no sample: a labelled file from which no
    frame can be read, as the JAX package writes one (cv2 cannot open the
    box-only file, and writes none)."""
    vid = tsyn.write_box_mp4(str(tmp_path / "cam1.mp4"), (64, 48), 90.0, 12)
    for name, mod, extra in (("jax", jvideo, {}), ("port", tvideo, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(labels, d / "labels_cam1.h5")
        out = mod.create_labeled_videos([vid], str(d), **extra)
        assert out == [str(d / "cam1_labeled.mp4")]
        assert f"Saved {out[0]}" in capsys.readouterr().out
        assert not cv2.VideoCapture(out[0]).read()[0]
    with mpeg4.Reader(str(tmp_path / "port" / "cam1_labeled.mp4"), device="cpu") as r:
        assert r.n_frames == 0 and r.read(0) is None


def test_labelled_videos_path_is_the_jax_formula():
    assert tvideo.labeled_video_fpath("/r/cam3.mp4", "/r/dlc") == "/r/dlc/cam3_labeled.mp4"
