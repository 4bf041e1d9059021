"""The port's NVDEC path on a CUDA device (acinoset_tpu_torch.utils.nvdec,
utils/csrc/nvdec.cu): the colour kernel against its plain version on
pitched NV12 surfaces in every (matrix, range) case; the 10-bit kernel
(yuv420p10_to_bgr) against its plain version on random 16-bit surfaces
in every matrix, range and chroma siting, and a 10-bit HEVC stream read
on the card equal to its read on the CPU, one launch a frame; NVDEC's parser
reading the writer's format; and every frame of an H.264 and an HEVC
stream of utils.h26x decoded equal to the reconstruction, one launch a
frame, and seeks equal to the sequential decode (that test skips only
where the environment visibly withholds the video engine,
``nvdec.withheld``; any other refusal fails it). Needs a CUDA device:
the tests skip without one. This file imports nothing of JAX or cv2, so
on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_nvdec_cuda.py -q -m cuda
"""
import pytest
import torch

from acinoset_tpu_torch.utils import h26x, hevc, mpeg4, nvdec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family,full", sorted(mpeg4.BGR_COEFS))
@pytest.mark.parametrize("size", [(2704, 1520), (1920, 1080), (174, 136)])
def test_kernel_equals_plain_version(cuda, family, full, size):
    """A random surface (odd widths take the kernel's byte path)."""
    W, H = size
    rows = (H + 15) // 16 * 16
    g = torch.Generator().manual_seed(W + H)
    surf = torch.randint(0, 256, (rows * 3 // 2, (W + 511) // 512 * 512), dtype=torch.uint8,
                         generator=g)
    coefs = mpeg4.BGR_COEFS[(family, full)]
    before = nvdec.nv12_to_bgr.launches
    got = nvdec.nv12_to_bgr(surf.to(cuda), rows, size, coefs)
    torch.cuda.synchronize()
    assert nvdec.nv12_to_bgr.launches == before + 1
    assert torch.equal(got.cpu(), nvdec.nv12_to_bgr_plain(surf, rows, size, coefs))


@pytest.mark.cuda
@pytest.mark.parametrize("matrix,full", [(6, False), (1, True), (9, False), (9, True)])
@pytest.mark.parametrize("size,origin", [((2704, 1520), (0, 0)), ((1920, 1080), (8, 4)),
                                         ((174, 136), (2, 2))])
def test_10bit_kernel_equals_plain_version(cuda, matrix, full, size, origin):
    """Random 10-bit samples on a pitched surface, the rectangle at an
    origin (widths not a multiple of 4 take the kernel's scalar path), in
    every chroma siting."""
    W, H = size
    rows = (H + origin[1] + 15) // 16 * 16
    g = torch.Generator().manual_seed(W + H + matrix)
    surf = torch.randint(0, 1024, (rows * 3 // 2, (W + origin[0] + 63) // 64 * 64),
                         dtype=torch.int16, generator=g)
    coefs = nvdec.colour_coefs10(matrix, full)
    for loc in range(6):
        siting = nvdec.chroma_siting(loc)
        before = nvdec.yuv420p10_to_bgr.launches
        got = nvdec.yuv420p10_to_bgr(surf.to(cuda), rows, size, coefs, origin, siting)
        torch.cuda.synchronize()
        assert nvdec.yuv420p10_to_bgr.launches == before + 1
        want = nvdec.yuv420p10_to_bgr_plain(surf, rows, size, coefs, origin, siting)
        assert torch.equal(got.cpu(), want), (loc, int((got.cpu().int() - want.int()).abs().max()))


@pytest.mark.cuda
def test_10bit_stream_reads_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A Main 10 stream (cropped, BT.2020, SAO, PCM, B pictures) through
    the software decoder: frames on the card equal the CPU's (the plain
    conversion), one yuv420p10_to_bgr launch a frame, seeks too."""
    stream = h26x.RandomHEVC((176, 136), 7, seed=5, bit_depth=10, matrix=9, full_range=False,
                             sao=True, pcm=True, b_frames=2, min_cb=16, qp=(-12, 30))
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0)
    with hevc.Reader(path, device="cpu") as r:
        want = [r.read_tensor(k) for k in range(r.n_frames)]
    nvdec.yuv420p10_to_bgr.launches = 0
    with hevc.Reader(path, device=cuda) as r:
        got = [r.read_tensor(k) for k in range(r.n_frames)]
        assert nvdec.yuv420p10_to_bgr.launches == len(want) == stream.n
        for k in (5, 1, 6, 0):
            assert torch.equal(r.read_tensor(k).cpu(), want[k])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("make,entry", [
    (lambda: h26x.H264Stream((320, 184), 26, seed=1, matrix=1, full_range=False), "avc1"),
    (lambda: h26x.HevcStream((176, 144), 14, gop=6, seed=2, matrix=6, full_range=True), "hev1"),
])
def test_parser_reads_the_writers_format(cuda, tmp_path, make, entry):
    stream = make()
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0, codec=entry)
    fmt = nvdec.stream_format(path, cuda)
    assert fmt["have"] and (fmt["coded_width"], fmt["coded_height"]) == stream.coded
    assert (fmt["right"] - fmt["left"], fmt["bottom"] - fmt["top"]) == stream.size
    assert (fmt["matrix"], fmt["full_range"]) == (stream.matrix, int(stream.full_range))
    assert nvdec.format_reason(fmt) is None


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    lambda: h26x.H264Stream((320, 184), 26, seed=3, matrix=1, full_range=True),
    lambda: h26x.HevcStream((176, 144), 14, gop=6, seed=4, matrix=1, full_range=False),
])
def test_decode_equals_reconstruction(cuda, tmp_path, make):
    stream = make()
    path = h26x.write_mp4(str(tmp_path / "a.mp4"), stream, 30.0)
    codec = "hvc1" if isinstance(stream, h26x.HevcStream) else "avc1"
    why = nvdec.refusal(cuda, codec, stream.size)
    if why and nvdec.withheld():
        pytest.skip(why)
    coefs = nvdec.colour_coefs(stream.matrix, stream.full_range)
    want = [nvdec.nv12_to_bgr_plain(stream.surface(k, cuda, 512), stream.coded[1], stream.size,
                                    coefs) for k in range(stream.n)]
    nvdec.nv12_to_bgr.launches = 0
    with nvdec.Reader(path, cuda) as r:
        got = [r.read_tensor(k) for k in range(r.n_frames)]
        assert r.read_tensor(stream.n) is None
        assert nvdec.nv12_to_bgr.launches == stream.n
        for k in (7, 1, stream.n - 1, 3, 0):
            assert torch.equal(r.read_tensor(k), want[k])
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
