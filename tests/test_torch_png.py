"""The port's PNG reader (acinoset_tpu_torch.utils.png.read_png) against
imageio, the JAX package's reader: on files imageio writes (its encoder
picks the filters) and on files utils.synthetic.write_png writes, whose
rows cycle through all five filter types; and its refusals."""
import zlib
from concurrent.futures import ThreadPoolExecutor

import imageio.v2 as imageio
import numpy as np
import pytest

from acinoset_tpu_torch.utils import png
from acinoset_tpu_torch.utils import synthetic as tsyn

SHAPES = {"grey": (41, 67), "grey_alpha": (41, 67, 2), "rgb": (41, 67, 3), "rgba": (41, 67, 4)}


def _image(shape, seed=0):
    """Smooth ramps plus noise, so that every filter type sees structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    base = (3 * xx + 5 * yy) % 256
    if len(shape) == 3:
        base = base[..., None] + 40 * np.arange(shape[2])
    return ((base + rng.integers(0, 12, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba"])
def test_read_png_equals_imageio_on_imageio_files(tmp_path, kind):
    img = _image(SHAPES[kind])
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, img)
    got = png.read_png(path)
    want = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_read_png_every_filter_type(tmp_path, kind):
    """write_png's rows use filter types 0-4 in turn; imageio and
    read_png decode them to the written array."""
    img = _image(SHAPES[kind], seed=1)
    path = str(tmp_path / f"{kind}.png")
    tsyn.write_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    stride = 1 + img[0].size
    assert sorted(set(rows[::stride].tolist())) == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_read_png_refuses_other_files(tmp_path):
    deep = str(tmp_path / "deep.png")
    imageio.imwrite(deep, (np.arange(64 * 32).reshape(32, 64) * 31).astype(np.uint16))
    palette = str(tmp_path / "palette.png")
    from PIL import Image

    Image.fromarray(_image((16, 16, 3))).convert("P").save(palette)
    jpeg = str(tmp_path / "frame.jpg")
    imageio.imwrite(jpeg, _image((16, 16, 3)))
    for path in (deep, palette):
        with pytest.raises(ValueError, match="unsupported PNG"):
            png.read_png(path)
    with pytest.raises(ValueError, match="not a PNG file"):
        png.read_png(jpeg)
    broken = str(tmp_path / "broken.png")
    tsyn.write_png(broken, _image((16, 16)))
    data = bytearray(open(broken, "rb").read())
    data[40] ^= 0xFF  # inside the IDAT payload: its CRC no longer holds
    open(broken, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="broken.png: corrupt PNG chunk"):
        png.read_png(broken)


def test_read_png_builds_its_helper_once_across_threads(tmp_path, monkeypatch):
    """The first reads of a process come from many threads at once (as
    calib.corners.find_corners_images reads): one builds the C helper,
    into a fresh location here, and every read decodes."""
    monkeypatch.setattr(png, "LIBRARY", tmp_path / "build" / "libpng_unfilter.so")
    monkeypatch.setattr(png, "_lib", None)
    img = _image(SHAPES["rgb"], seed=2)
    path = str(tmp_path / "rgb.png")
    tsyn.write_png(path, img)
    with ThreadPoolExecutor(16) as pool:
        decoded = list(pool.map(lambda _: png.read_png(path), range(32)))
    for got in decoded:
        np.testing.assert_array_equal(got, img)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libpng_unfilter.so"]
