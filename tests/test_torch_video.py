"""The port's video helpers (acinoset_tpu_torch.pipeline.video) against
the JAX package's: the natural sort, the vertical stack of PNG images
(pixel for pixel against cv2's), the 2D label files and the labelled
videos' paths; and the functions that need a video codec, which raise
before they open or write a file."""
import os

import cv2
import numpy as np
import pytest

from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.models import cheetah
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import png


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


CODEC_CALLS = {
    "get_frames": lambda d: tvideo.get_frames(os.path.join(d, "cam1.mp4"), [0, 1],
                                              out_dir=os.path.join(d, "file", "frames")),
    "extract_frame_range": lambda d: tvideo.extract_frame_range(
        os.path.join(d, "cam1.mp4"), 0, 4, os.path.join(d, "file", "frames")),
    "images_to_video": lambda d: tvideo.images_to_video([os.path.join(d, "a.png")],
                                                        os.path.join(d, "file", "out.mp4")),
    "create_labeled_videos": lambda d: tvideo.create_labeled_videos(
        [os.path.join(d, "cam1.mp4")], os.path.join(d, "file", "dlc")),
}


@pytest.mark.parametrize("name", sorted(CODEC_CALLS))
def test_codec_functions_raise_before_touching_a_file(tmp_path, name):
    """Every output path lies under a regular file, so any write would
    fail with another error; none is attempted."""
    (tmp_path / "file").write_text("")
    with pytest.raises(NotImplementedError, match="video (decoder|encoder)") as err:
        CODEC_CALLS[name](str(tmp_path))
    assert "utils.mp4" in str(err.value)
    assert sorted(os.listdir(tmp_path)) == ["file"]


def test_labelled_videos_path_is_the_jax_formula():
    assert tvideo.labeled_video_fpath("/r/cam3.mp4", "/r/dlc") == "/r/dlc/cam3_labeled.mp4"
