"""The `calib` subcommand of acinoset_tpu_torch.cli against the JAX
package's `cli calib`, on the CPU: the port's corner points of 3 cameras
of a chained rig x 6 rendered PNG frames each (tests/image_calib_cases.py)
and the rig's true intrinsics, laid out as the reference's scenes are;
the pairwise flow with a camera missing; and the command's refusal to
fall back to the CPU.

Tolerances (tests/test_torch_extrinsics.py's): the pairwise scene's R and t at 1e-8; the board
SBA's poses relative to camera 1 (its gauge is free) at 1e-8 in R and
1e-6 in t; the scene files cross between the packages to equal arrays."""
import os

import numpy as np
import pytest
import torch

import image_calib_cases as cases
from acinoset_tpu import cli as jcli
from acinoset_tpu.calib import app as japp
from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu_torch import cli as tcli
from acinoset_tpu_torch.calib import app as tapp
from acinoset_tpu_torch.pipeline import data as tdata

torch.set_num_threads(2)
quiet = cases.quiet
N_CAMS = cases.N_CAMS


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """<root>/extrinsic_calib/points/points_cam<c>.json from the rendered
    frames (the port's detector) and <root>/intrinsic_calib/camera_<c>.json
    holding the rig's true intrinsics (6 views of a 640 x 480 frame do not
    pin a fisheye's K and D). Returns (root, points paths, camera paths)."""
    root = tmp_path_factory.mktemp("scene")
    cases.write_rig(root)
    points, cameras = [], []
    for c in range(1, N_CAMS + 1):
        points.append(str(root / "extrinsic_calib" / "points" / f"points_cam{c}.json"))
        quiet(tapp.extract_corners_from_images, str(root / "extrinsic_calib" / "frames" / str(c)),
              points[-1], cases.BOARD, cases.SQUARE, device="cpu")
        cameras.append(str(root / "intrinsic_calib" / f"camera_{c}.json"))
        tdata.save_camera(cameras[-1], cases.RES, cases.K, cases.D.reshape(4, 1))
    return root, points, cameras


def test_cli_calib_matches_jax(scene):
    """`cli calib` in both packages on the same points and camera files:
    {n}_cam_scene.json (pairwise extrinsics) and its _sba.json."""
    root, _, cameras = scene
    scene_dir = str(root / "extrinsic_calib")
    out_t = os.path.join(scene_dir, f"{N_CAMS}_cam_scene.json")
    out_j = str(root / "jax" / f"{N_CAMS}_cam_scene.json")
    assert quiet(tcli.main, ["calib", "--scene_dir", scene_dir, "--device", "cpu"]) == 0
    assert quiet(jcli.main, ["calib", "--scene_dir", scene_dir, "--out", out_j,
                             "--camera_fpaths", *cameras]) == 0
    got, want = tdata.load_scene(out_t), jdata.load_scene(out_j)
    assert got[0].shape == (N_CAMS, 3, 3) and got[1].shape == (N_CAMS, 4, 1)
    cases.same_scene(got, want, 1e-8)
    # the board SBA leaves the world frame and scale free (its board
    # points are free): its poses drift along that gauge by rounding
    # (1e-5 here), so the cameras' poses relative to camera 1 are held,
    # rotations at 1e-8 and translations at the converged-LM 1e-6 of
    # chip_smoke.LM_STATE_ATOL
    sba_t = tdata.load_scene(out_t.replace(".json", "_sba.json"))
    sba_j = jdata.load_scene(out_j.replace(".json", "_sba.json"))
    cases.same_camera(sba_t[:2] + sba_t[4:], sba_j[:2] + sba_j[4:])  # K, D, resolution
    (r, t), (rj, tj) = sba_t[2:4], sba_j[2:4]
    rel, rel_j = r @ r[0].T, rj @ rj[0].T
    np.testing.assert_allclose(rel, rel_j, atol=1e-8)
    np.testing.assert_allclose(t - rel @ t[0], tj - rel_j @ tj[0], atol=1e-6)
    # the chain against the rig's truth (camera 1 at the world frame's R1)
    for c, (R, tc) in enumerate(cases.rig(N_CAMS)):
        np.testing.assert_allclose(got[2][c], R @ got[2][0], atol=5e-3)
        np.testing.assert_allclose(got[3][c].ravel(), tc, atol=2e-2)
    # each package finds and reads the other's scene file
    for path in (out_t, out_j):
        a = tdata.find_scene_file(os.path.dirname(path), os.path.basename(path), verbose=False)
        b = jdata.find_scene_file(os.path.dirname(path), os.path.basename(path), verbose=False)
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
        assert a[4:] == b[4:]


def test_cli_calib_needs_cuda_or_cpu(monkeypatch, scene):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["calib", "--scene_dir", str(scene[0] / "extrinsic_calib")])


def test_pairwise_with_a_missing_camera_matches_jax(tmp_path, scene):
    """A camera without points takes its slot from the dummy scene."""
    _, points, cameras = scene
    dummy = str(tmp_path / "dummy_scene.json")
    tdata.save_scene(dummy, [cases.K] * N_CAMS, [cases.D.reshape(4, 1)] * N_CAMS,
                     [np.eye(3)] * N_CAMS, [np.full((3, 1), 0.5)] * N_CAMS, cases.RES)
    pts = points[:2] + [""]
    got = quiet(tapp.calibrate_fisheye_extrinsics_pairwise, cameras, pts,
                str(tmp_path / "t.json"), dummy, device="cpu")
    want = quiet(japp.calibrate_fisheye_extrinsics_pairwise, cameras, pts,
                 str(tmp_path / "j.json"), dummy)
    cases.same_scene(tdata.load_scene(str(tmp_path / "t.json")),
                     jdata.load_scene(str(tmp_path / "j.json")), 1e-8)
    np.testing.assert_array_equal(got[2][2], np.eye(3))
    np.testing.assert_allclose(np.array(got[2]), np.array(want[2]), atol=1e-8)
    with pytest.raises(ValueError, match="dummy_scene_fpath"):
        quiet(tapp.calibrate_fisheye_extrinsics_pairwise, cameras, pts,
              str(tmp_path / "t.json"), device="cpu")
