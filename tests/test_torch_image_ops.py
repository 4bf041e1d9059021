"""The port's image undistortion ops (acinoset_tpu_torch.ops.camera:
the fisheye and pinhole remap grids, remap_bilinear and the two
undistort_image functions) against the JAX package's, on the same
seeded numpy inputs, in the dtypes the JAX package gives them (x64 on):
float32 cameras at 1e-6 (relative), float64 at 1e-12, and a float32 K
with a float64 D, where a float64 map must come out as in JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acinoset_tpu.ops import camera as jcam
from acinoset_tpu_torch.ops import camera as tcam

torch.set_num_threads(2)
SIZE = (96, 64)  # (width, height)
K = np.array([[61.0, 0, 47.5], [0, 60.0, 31.5], [0, 0, 1.0]])
NEW_K = np.array([[48.0, 0, 48.0], [0, 47.0, 32.0], [0, 0, 1.0]])
D_FISHEYE = np.array([0.04, 0.005, -0.006, 0.001])
D_PINHOLE = np.array([-0.3, 0.12, 1e-3, -2e-3, -0.02, -0.25, 0.08, -0.01])
TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["fisheye", "pinhole"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rectify_maps_match_jax(kind, dtype):
    D = D_FISHEYE if kind == "fisheye" else D_PINHOLE
    jfn = getattr(jcam, f"undistort_rectify_map_{kind}")
    tfn = getattr(tcam, f"undistort_rectify_map_{kind}")
    k, d, nk = (a.astype(dtype) for a in (K, D, NEW_K))
    want = jfn(jnp.asarray(k), jnp.asarray(d), jnp.asarray(nk), SIZE)
    got = tfn(torch.as_tensor(k), torch.as_tensor(d), torch.as_tensor(nk), SIZE)
    for g, w in zip(got, want):
        assert g.shape == (SIZE[1], SIZE[0])
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("kind", ["fisheye", "pinhole"])
def test_rectify_maps_mixed_dtypes_match_jax(kind):
    """A float32 K and new_K with a float64 D (numpy): the fisheye map is
    float64 in JAX, from float32 normalised coordinates; the pinhole map
    rounds D to float32 and stays float32."""
    D = D_FISHEYE if kind == "fisheye" else D_PINHOLE
    jfn = getattr(jcam, f"undistort_rectify_map_{kind}")
    tfn = getattr(tcam, f"undistort_rectify_map_{kind}")
    k32, nk32 = K.astype(np.float32), NEW_K.astype(np.float32)
    want = jfn(jnp.asarray(k32), D, jnp.asarray(nk32), SIZE)
    got = tfn(torch.as_tensor(k32), D, torch.as_tensor(nk32), SIZE)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_remap_bilinear_matches_jax(channels, dtype):
    """uint8 and float images, maps reaching past every edge (zero
    there)."""
    rng = np.random.default_rng(0)
    shape = (SIZE[1], SIZE[0]) + ((channels,) if channels else ())
    img_u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    img_f = rng.uniform(0, 1, shape).astype(dtype)
    mx = rng.uniform(-3, SIZE[0] + 2, (40, 50)).astype(dtype)
    my = rng.uniform(-3, SIZE[1] + 2, (40, 50)).astype(dtype)
    for img in (img_u8, img_f):
        want = jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
        got = tcam.remap_bilinear(torch.as_tensor(img), torch.as_tensor(mx), torch.as_tensor(my))
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("kind", ["fisheye", "pinhole"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_undistort_image_matches_jax(kind, dtype):
    """undistort_image_* of an RGB uint8 frame (new_K defaulting to K)
    and of a float grey frame with its own new_K; numpy inputs on the
    port's side with device='cpu'. Each output is the JAX package's
    remap_bilinear of the port's maps at the dtype's tolerance. Against
    the JAX package's own output, a float32 map may differ by the last
    bit (arctan's rounding differs between the two libraries): the maps
    agree to TOL relative (test_rectify_maps_match_jax), which moves a
    bilinear sample by at most TOL * max|map| times the image's steepest
    step between neighbouring pixels."""
    D = D_FISHEYE if kind == "fisheye" else D_PINHOLE
    jfn = getattr(jcam, f"undistort_image_{kind}")
    tfn = getattr(tcam, f"undistort_image_{kind}")
    tmap = getattr(tcam, f"undistort_rectify_map_{kind}")
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (SIZE[1], SIZE[0], 3), dtype=np.uint8)
    grey = rng.uniform(0, 1, (SIZE[1], SIZE[0])).astype(dtype)
    k, d, nk = (a.astype(dtype) for a in (K, D, NEW_K))
    tol = TOL[dtype]
    for img, new_k in ((rgb, k), (grey, nk)):
        got = tfn(img, k, d, None if img is rgb else nk, device="cpu")
        maps = [m.numpy() for m in tmap(k, d, new_k, SIZE, device="cpu")]
        _close(got, jcam.remap_bilinear(jnp.asarray(img), *map(jnp.asarray, maps)), tol)
        want = np.asarray(jfn(img, k, d, None if img is rgb else nk))
        step = max(np.abs(np.diff(img.astype(np.float64), axis=a)).max() for a in (0, 1))
        atol = tol * np.abs(want).max() + 2 * tol * max(np.abs(m).max() for m in maps) * step
        assert got.numpy().dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=atol)
