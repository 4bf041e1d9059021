"""The port's mp4v codec on a CUDA device against the CPU: the card's
encode of the same frames equals the CPU's byte for byte, and so do the
decodes, frame for frame (the block transforms are int32 torch ops).

Needs a CUDA device: the test skips without one. This file imports
nothing of JAX or cv2, so on a GPU machine without them it runs on its
own:

    python -m pytest --noconftest tests/test_torch_mpeg4_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from acinoset_tpu_torch.utils import mpeg4
from acinoset_tpu_torch.utils import synthetic as tsyn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(176, 144), (72, 40)])
def test_card_and_cpu_give_the_same_bytes_and_frames(cuda, tmp_path, size):
    """14 frames of footage with a moving patch (two GOPs)."""
    frames = list(tsyn.scene_frames(size, 14, seed=5))
    paths = {}
    for dev in ("cpu", "cuda"):
        paths[dev] = str(tmp_path / f"{dev}.mp4")
        with mpeg4.Writer(paths[dev], size, 30.0, device=dev) as w:
            for f in frames:
                w.write(f)
    assert open(paths["cpu"], "rb").read() == open(paths["cuda"], "rb").read()
    with mpeg4.Reader(paths["cpu"], device="cpu") as a, \
            mpeg4.Reader(paths["cpu"], device="cuda") as b:
        for i in (0, 13, 5, 12, 1):
            np.testing.assert_array_equal(a.read(i), b.read(i))
