"""The column-table twins of the JAX package's DataFrame shims
(pipeline.data.load_dlc_points_as_df and points2d_from_df,
pipeline.tri.get_pairwise_3d_points_from_df, pipeline.points2d.
get_2d_points_df): each column equals the JAX DataFrame's
``df[c].to_numpy()``, in the same order, and each twin reads the JAX
DataFrame itself. Also the Argus converter (utils.argus) on the cases of
tests/test_gui_and_utils.py, byte for byte, and calib.native.available."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu.pipeline import points2d as jp2d
from acinoset_tpu.pipeline import tri as jtri
from acinoset_tpu.utils.argus import convert_argus_csv as jconvert
from acinoset_tpu_torch.calib import corners as tcorners
from acinoset_tpu_torch.calib import native as tnative
from acinoset_tpu_torch.models import cheetah
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import points2d as tp2d
from acinoset_tpu_torch.pipeline import tri as ttri
from acinoset_tpu_torch.utils import synthetic as tsyn
from acinoset_tpu_torch.utils.argus import convert_argus_csv as tconvert

torch.set_num_threads(2)


def _assert_table_equals_df(table, df, atol=0.0):
    assert isinstance(table, dict) and list(table) == list(df.columns)
    for c in df.columns:
        want, got = df[c].to_numpy(), table[c]
        assert got.shape == want.shape, c
        if atol and want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=c)
        else:
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=c)


@pytest.fixture()
def dlc_files(tmp_path):
    """Three cameras' DLC files of a seeded run: 30 frames, the third
    camera with 8 markers in another order and 20 frames."""
    cams = tsyn.ring_cameras(n_cams=3)
    px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=30), cams, seed=5)
    markers = cheetah.get_markers()
    d = tmp_path / "data"
    fpaths = []
    for c in range(3):
        fp = str(d / f"cam{c + 1}DLC.h5")
        if c < 2:
            tdata.save_dlc_points_h5(fp, px[c], lik[c], markers)
        else:
            pick = [7, 2, 0, 11, 5, 19, 3, 14]
            tdata.save_dlc_points_h5(fp, px[c, :20, pick].transpose(1, 0, 2),
                                     lik[c, :20, pick].T, [markers[i] for i in pick])
        fpaths.append(fp)
    return fpaths, cams


def test_load_dlc_points_as_df_matches_jax(dlc_files, capsys):
    fpaths, _cams = dlc_files
    df = jdata.load_dlc_points_as_df(fpaths, verbose=True)
    want_out = capsys.readouterr().out
    table = tdata.load_dlc_points_as_df(fpaths, verbose=True)
    assert capsys.readouterr().out == want_out
    _assert_table_equals_df(table, df)
    assert list(table) == list(tdata.TABLE_COLUMNS)
    with pytest.raises(ValueError):
        tdata.load_dlc_points_as_df([])


@pytest.mark.parametrize("source", ["port", "jax"])
def test_points2d_from_df_matches_jax(dlc_files, source):
    fpaths, _cams = dlc_files
    df = jdata.load_dlc_points_as_df(fpaths)
    table = df if source == "jax" else tdata.load_dlc_points_as_df(fpaths)
    markers = cheetah.get_markers()[::-1] + ["not_a_marker"]
    got, want = tdata.points2d_from_df(table, markers), jdata.points2d_from_df(df, markers)
    for name in ("pixels", "likelihood", "frames"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.markers == want.markers


@pytest.mark.parametrize("source", ["port", "jax"])
def test_get_pairwise_3d_points_from_df_matches_jax(dlc_files, source):
    fpaths, cams = dlc_files
    k, d, r, t, _res = cams
    df = jdata.load_dlc_points_as_df(fpaths)
    df = df[df["likelihood"] > 0.5].reset_index(drop=True)  # a detection table, rows dropped
    table = df if source == "jax" else {c: df[c].to_numpy() for c in df.columns}
    want = jtri.get_pairwise_3d_points_from_df(df[["frame", "camera", "marker", "x", "y"]],
                                               k, d, r, t)
    got = ttri.get_pairwise_3d_points_from_df(table, k, d, r, t, device="cpu")
    _assert_table_equals_df(got, want, atol=1e-9)
    assert len(want) > 0


def test_get_2d_points_df_matches_jax(dlc_files):
    fpaths, _cams = dlc_files
    project = os.path.dirname(os.path.dirname(fpaths[0]))
    _assert_table_equals_df(tp2d.get_2d_points_df(project), jp2d.get_2d_points_df(project))


ARGUS = pd.DataFrame({
    "track_cam_1_x": [10.0, 20.0, np.nan],
    "track_cam_1_y": [100.0, 200.0, np.nan],
    "track_cam_2_x": [11.0, np.nan, 31.0],
    "track_cam_2_y": [110.0, np.nan, 310.0],
})
YAMLS = {
    "none": None,
    "top level": "# an argus config\nimage_width: 1920\nimage_height: 1080  # px\n",
    "width/height": "---\nwidth: 2704\nheight: '1520'\ncameras:\n  - name: cam1\n"
                    "    image_width: 1\n",
    "no keys": "project: clicks\n",
}


@pytest.mark.parametrize("yaml_case", sorted(YAMLS))
def test_argus_converter_matches_jax_byte_for_byte(tmp_path, yaml_case):
    csv = str(tmp_path / "clicks.csv")
    ARGUS.to_csv(csv, index=False)
    yaml_fpath = None
    if YAMLS[yaml_case] is not None:
        yaml_fpath = str(tmp_path / "config.yaml")
        with open(yaml_fpath, "w") as f:
            f.write(YAMLS[yaml_case])
    out = {}
    for name, fn in (("jax", jconvert), ("port", tconvert)):
        out[name] = str(tmp_path / f"{name}.json")
        pts = fn(csv, yaml_fpath, out_fpath=out[name])
        if name == "jax":
            want = pts
    np.testing.assert_array_equal(pts, want)
    assert pts.shape == (3, 2, 2)
    assert open(out["port"], "rb").read() == open(out["jax"], "rb").read()
    # the default output, beside the CSV
    tconvert(csv, camera_resolution=(2704, 1520))
    np.testing.assert_allclose(pts[0, 0, 0], 10.0)
    assert os.path.exists(tmp_path / "manual_points.json")


@pytest.mark.parametrize("line", ["image_width 1920", "- 1920", "key:value", "'a' b: 1"])
def test_argus_yaml_line_it_cannot_read_raises(tmp_path, line):
    csv = str(tmp_path / "clicks.csv")
    ARGUS.to_csv(csv, index=False)
    yaml_fpath = str(tmp_path / "config.yaml")
    with open(yaml_fpath, "w") as f:
        f.write(f"image_height: 1080\n\n{line}\n")
    with pytest.raises(ValueError, match=f"{yaml_fpath}:3"):
        tconvert(csv, yaml_fpath)
    assert not os.path.exists(tmp_path / "manual_points.json")


def test_native_available_is_a_bool_and_auto_still_raises(monkeypatch, tmp_path):
    assert isinstance(tnative.available(), bool)
    with pytest.raises(ValueError, match="engine='auto'"):
        tcorners.find_corners_images([], (9, 6), engine="auto", device="cpu")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    assert tnative.available() is False
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "corners.cpp")
    (tmp_path / "corners.cpp").write_text("int broken(")
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "lib.so")
    assert tnative.available() is False
