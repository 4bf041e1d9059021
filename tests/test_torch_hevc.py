"""GoPro-shaped HEVC on the CPU (acinoset_tpu_torch.utils.h26x's HEVC
writer: CABAC over PCM and skipped CUs; utils.mp4's hvcC reading)
against cv2 (ffmpeg) and the JAX package: cv2 decodes the writer's
streams to the reconstruction bit for bit (hvc1 and hev1, a size that
the conformance window crops, BT.709 and BT.601 in both ranges); the
JAX package's get_frames equals it; hvcC gives back the writer's VPS,
SPS and PPS; and decoder='nvdec' on the CPU raises UnsupportedVideo naming
NVDEC.
The card's half is tests/test_torch_nvdec_cuda.py."""
import numpy as np
import pytest
import torch

from acinoset_tpu.pipeline import video as jvideo
from acinoset_tpu_torch.pipeline import video as tvideo
from acinoset_tpu_torch.utils import h26x, mp4, mpeg4
from test_torch_h264 import cv2_read, expected

torch.set_num_threads(2)


@pytest.mark.parametrize("size,matrix,full,entry", [
    ((176, 144), h26x.BT709, True, "hvc1"),
    ((168, 136), h26x.BT601, False, "hev1"),  # cropped from 176 x 144 coded
    ((320, 176), h26x.BT709, False, "hvc1"),
    ((320, 176), h26x.BT601, True, "hev1"),
])
def test_cv2_decodes_the_writer_stream_bit_for_bit(tmp_path, size, matrix, full, entry):
    """An IDR of PCM CUs, then P frames of skipped CUs around a moving
    PCM patch, two GOPs: every frame equal to the reconstruction."""
    stream = h26x.HevcStream(size, 16, gop=8, seed=size[0] + size[1], matrix=matrix,
                             full_range=full)
    assert "".join(stream.types) == "IPPPPPPPIPPPPPPP"
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 90.0, codec=entry)
    frames, cap = cv2_read(path)
    assert len(frames) == stream.n
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(f, expected(stream, k), err_msg=f"frame {k}")
    assert len({f.tobytes() for f in frames}) == stream.n
    track = mp4.read_video_track(path)
    assert track.codec == entry and list(track.param_sets) == stream.param_sets
    assert track.n_frames == stream.n and list(track.order) == list(range(stream.n))
    assert mp4.video_info(path) == (size, 90.0, stream.n)


def test_jax_get_frames_on_hevc(tmp_path):
    stream = h26x.HevcStream((176, 144), 20, gop=6, seed=11)
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 30.0)
    seeks = [13, 2, 19, 0, 6, 5, 20]
    got = jvideo.get_frames(path, seeks)
    assert [i for i, _f in got] == seeks[:-1]
    for i, f in got:
        np.testing.assert_array_equal(f, expected(stream, i))


def test_cabac_contexts_start_where_the_standard_puts_them():
    """HEVC 9.3.2.2 at QP 26, worked by hand: part_mode's I-slice
    context (184: m 10, n 48, preCtxState 64) starts at state 0 with MPS
    1; cu_skip_flag's three P-slice ones (197, 185, 201: preCtxState 48,
    72, 80) at (15, 0), (8, 1), (16, 1)."""
    assert h26x.cabac_context(184, 26) == [0, 1]
    assert [h26x.cabac_context(v, 26) for v in (197, 185, 201)] == [[15, 0], [8, 1], [16, 1]]
    assert all(0 <= h26x.cabac_context(v, q)[0] <= 62 for v in range(256) for q in (0, 26, 51))


def test_cpu_device_raises_naming_nvdec(tmp_path):
    """decoder='nvdec' asks for the card's decoder, which the CPU has not;
    the software decoder reads the file by default (its tests are
    tests/test_torch_hevc_decode.py)."""
    stream = h26x.HevcStream((64, 48), 2, seed=1)
    path = h26x.write_mp4(str(tmp_path / "cam1.mp4"), stream, 30.0, codec="hev1")
    with pytest.raises(mpeg4.UnsupportedVideo) as err:
        tvideo.get_frames(path, [0], device="cpu", decoder="nvdec")
    assert err.value.reason == ("HEVC: NVDEC decodes it on the card only, not on cpu "
                                "(decoder='software' reads it on the host)")
