"""Calibration from files (acinoset_tpu_torch.calib.app and the JSON
half of pipeline.data) against the JAX package's, on the CPU: the corner
points of 3 cameras of a chained rig x 6 rendered PNG frames each
(tests/image_calib_cases.py), the intrinsics flows on
tests/sba_calib_cases.py's inputs through points files, and the
extrinsics' adjustment to clicked points. tests/test_torch_calib_cli.py
holds the `calib` subcommand.

The JAX app runs its JAX detector (its native engine is switched off in
the test only). Tolerances: corner points within 1e-3 px; the fisheye
camera's K and D at 1e-8 (relative, as tests/test_torch_calib.py); the
pinhole camera's and the clicked points' SBA as their tests say; the
JSON files cross between the packages to equal arrays."""
import json

import numpy as np
import pytest
import torch

import image_calib_cases as cases
import sba_calib_cases as sba_cases
from acinoset_tpu.calib import app as japp
from acinoset_tpu.calib import native as jnative
from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu_torch.calib import app as tapp
from acinoset_tpu_torch.ops import camera as tcam
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
quiet = cases.quiet


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    return root, cases.write_rig(root)


def _frames(root, c):
    return str(root / "extrinsic_calib" / "frames" / str(c))


@pytest.fixture(scope="module")
def points(root):
    """Each package's points JSON a camera: {package: [path, ...]}."""
    root, _ = root
    out = {"torch": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        for c in range(1, cases.N_CAMS + 1):
            out["torch"].append(str(root / "torch" / f"points_cam{c}.json"))
            out["jax"].append(str(root / "jax" / f"points_cam{c}.json"))
            quiet(tapp.extract_corners_from_images, _frames(root, c), out["torch"][-1],
                  cases.BOARD, cases.SQUARE, device="cpu")
            quiet(japp.extract_corners_from_images, _frames(root, c), out["jax"][-1],
                  cases.BOARD, cases.SQUARE)
    return out


def test_extract_corners_matches_jax_and_points_cross(root, points):
    """The port saves each frame's corners in the object points' order,
    (6, 9, 2), where the JAX package saves the detector's (9, 6) grid:
    the same corners, transposed; flattened, the port's follow the board's
    object points (the truth)."""
    _, truth = root
    n = cases.N_VIEWS
    for c, (tp, jp) in enumerate(zip(points["torch"], points["jax"])):
        got, want = tdata.load_points(tp), jdata.load_points(jp)
        assert got[0].dtype == np.float32 and got[0].shape == (n, 6, 9, 2)
        np.testing.assert_allclose(got[0], want[0].transpose(0, 2, 1, 3), atol=1e-3)
        assert np.abs(got[0].reshape(n, -1, 2) - truth[c]).max() < 0.5
        assert got[1:] == want[1:]  # names, board shape, square, resolution
        assert got[3] == cases.SQUARE and got[4] == cases.RES
        # each package reads the other's file to equal arrays
        for load_a, load_b, path in ((jdata.load_points, tdata.load_points, tp),
                                     (tdata.load_points, jdata.load_points, jp)):
            a, b = load_a(path), load_b(path)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]


def test_board_order_labels_the_board_from_its_front(root):
    """The detector's grid (9, 6) of a board seen from its front, turned
    180 degrees or mirrored along either axis (its canonical order can do
    either): saved in the object points' order, as the truth or the truth
    reversed, never mirrored."""
    _, truth = root
    for t in truth.reshape(-1, 54, 2):
        grid = t.reshape(6, 9, 2).transpose(1, 0, 2)
        for labels, want in ((grid, t), (grid[::-1, ::-1], t[::-1]), (grid[::-1], None),
                             (grid[:, ::-1], None)):
            got = tapp.board_order(labels).reshape(-1, 2)
            assert got.shape == (54, 2)
            if want is None:
                assert np.array_equal(got, t) or np.array_equal(got, t[::-1])
            else:
                np.testing.assert_array_equal(got, want)


def test_extract_corners_refuses_jpeg_and_auto(tmp_path, root):
    root, _ = root
    d = tmp_path / "frames"
    d.mkdir()
    tsyn.write_png(str(d / "0.png"), np.full((48, 64, 3), 128, np.uint8))
    (d / "1.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="1.jpg: JPEG frames cannot be read"):
        quiet(tapp.extract_corners_from_images, str(d), str(tmp_path / "p.json"), cases.BOARD,
              cases.SQUARE, device="cpu")
    with pytest.raises(ValueError, match="does not pick an engine"):
        quiet(tapp.extract_corners_from_images, _frames(root, 1), str(tmp_path / "p.json"),
              cases.BOARD, cases.SQUARE, engine="auto", device="cpu")


def _points_file(path, views, res):
    n = len(views)
    tdata.save_points(path, views.reshape(n, 9, 6, 2), [f"{i}.png" for i in range(n)], (9, 6),
                      0.04, res)
    return path


def test_calibrate_fisheye_intrinsics_matches_jax(tmp_path):
    """tests/sba_calib_cases.py's fisheye case (12 views, one corrupted
    and dropped) through a points JSON; and the camera JSON crossing both
    ways."""
    _obj, views, res = sba_cases.fisheye_intrinsics_case()
    pts = _points_file(str(tmp_path / "points.json"), views, res)
    k, d, res_t, cal = quiet(tapp.calibrate_fisheye_intrinsics, pts, str(tmp_path / "t.json"),
                             device="cpu")
    quiet(japp.calibrate_fisheye_intrinsics, pts, str(tmp_path / "j.json"))
    got, want = tdata.load_camera(str(tmp_path / "t.json")), jdata.load_camera(
        str(tmp_path / "j.json"))
    assert got[1].shape == (4, 1) and res_t == res and not cal.used[5]
    cases.same_camera(got, want)
    for path in (str(tmp_path / "t.json"), str(tmp_path / "j.json")):
        a, b = tdata.load_camera(path), jdata.load_camera(path)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_calibrate_intrinsics_matches_jax(tmp_path):
    """The pinhole flow on tests/test_pinhole_calib.py's views, through a
    points JSON. Read back as float32, the views make the rational
    model's LM stop 1.3e-8 apart in K (its last steps depend on rounding;
    chip_smoke.LM_STATE_ATOL holds converged LM states at 1e-6), so K is held at 1e-7; its
    8 coefficients trade off (k1 -21, k5 114 here) and stop 1e-4 apart,
    so D is held by what it does: the views' rays projected through both
    cameras within 1e-5 px."""
    _obj, views = tsyn.pinhole_views()
    pts = _points_file(str(tmp_path / "points.json"), views, tsyn.PINHOLE_RES)
    k, d, res = quiet(tapp.calibrate_intrinsics, pts, str(tmp_path / "t.json"), device="cpu")
    quiet(japp.calibrate_intrinsics, pts, str(tmp_path / "j.json"))
    got, want = tdata.load_camera(str(tmp_path / "t.json")), jdata.load_camera(
        str(tmp_path / "j.json"))
    assert got[1].shape == (8, 1) and res == tsyn.PINHOLE_RES
    np.testing.assert_allclose(got[0], want[0], rtol=1e-7)
    rays = tcam.undistort_points_pinhole(torch.as_tensor(views.reshape(-1, 2)), got[0],
                                         got[1].ravel())
    rays = torch.cat([rays, torch.ones_like(rays[:, :1])], dim=1)
    px_t, px_j = (tcam.project_points_pinhole(rays, k_, d_.ravel(), np.eye(3), np.zeros(3))
                  for k_, d_, _ in (got, want))
    np.testing.assert_allclose(px_t.numpy(), px_j.numpy(), atol=1e-5)


def test_adjust_extrinsics_manual_points_matches_jax(tmp_path):
    """Clicked points (some cameras missing, NaN) against a scene of the
    rig's truth perturbed; points and extrinsics at 1e-7."""
    n_cams = cases.N_CAMS
    cams = cases.rig(n_cams)
    rng = np.random.default_rng(4)
    R = [c[0] for c in cams]
    t = [c[1].reshape(3, 1) for c in cams]
    scene = str(tmp_path / "scene.json")
    tdata.save_scene(scene, [cases.K] * n_cams, [cases.D.reshape(4, 1)] * n_cams,
                     [tsyn._rot(rng.normal(scale=0.01, size=3)) @ r for r in R],
                     [x + rng.normal(scale=0.01, size=(3, 1)) for x in t], cases.RES)
    X = rng.uniform((-0.2, -0.15, 0.6), (0.2, 0.15, 0.9), (12, 3))
    clicks = np.stack([tcam.project_points_fisheye(torch.as_tensor(X), cases.K, cases.D, r, x)
                       .numpy() for r, x in zip(R, t)], axis=1)
    clicks += rng.normal(scale=0.5, size=clicks.shape)
    clicks[0, 2] = np.nan
    clicks[1, 0] = np.nan
    clicks[2, 1:] = np.nan  # seen once: left out
    manual = str(tmp_path / "manual_points.json")
    with open(manual, "w") as f:
        json.dump({"points": np.where(np.isnan(clicks), None, clicks).tolist()}, f)
    with open(manual) as f:
        assert np.isnan(np.array(json.load(f)["points"], dtype=float)).sum() == 8
    p_t, res_t = quiet(tapp.adjust_extrinsics_manual_points, scene, manual,
                       str(tmp_path / "t_sba.json"), num_iters=30, device="cpu")
    p_j, res_j = quiet(japp.adjust_extrinsics_manual_points, scene, manual,
                       str(tmp_path / "j_sba.json"), num_iters=30)
    assert p_t.shape == (11, 3)
    np.testing.assert_allclose(p_t, np.asarray(p_j), atol=1e-7)
    for key in ("before", "after"):
        np.testing.assert_allclose(res_t[key], np.asarray(res_j[key]), atol=1e-7)
    cases.same_scene(tdata.load_scene(str(tmp_path / "t_sba.json")),
                     jdata.load_scene(str(tmp_path / "j_sba.json")), 1e-7)
