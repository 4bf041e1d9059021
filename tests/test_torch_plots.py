"""The port's plots (acinoset_tpu_torch.pipeline.plots, on
utils.figure) against the JAX package's matplotlib figures on the same
inputs, made from a numpy seed: every series in the same order with the
same data (exactly on float64 data, 1e-12 after the fisheye
undistortion), the titles, labels and limits; the figure writers' files
read back (SVG by xml.etree, the PDF's xref table, the PNG by
utils.png); write_png's bytes; and save_error_histogram's counts."""
import hashlib
import os
import re
import struct
import xml.etree.ElementTree as ET
import zlib

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib.collections import Collection
from matplotlib.lines import Line2D
from matplotlib.text import Text
from mpl_toolkits.mplot3d.art3d import Line3D, Text3D

from acinoset_tpu.eval import metrics as jmetrics
from acinoset_tpu.pipeline import plots as jplots
from acinoset_tpu_torch.eval import metrics as tmetrics
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.pipeline import plots as tplots
from acinoset_tpu_torch.utils import figure, png
from acinoset_tpu_torch.utils import synthetic as tsyn

matplotlib.use("Agg")
torch.set_num_threads(2)
SVG = "{http://www.w3.org/2000/svg}"


@pytest.fixture(autouse=True)
def _matplotlib_style():
    """The JAX plots' dark mode sets a global style; restore it after each
    test."""
    with matplotlib.rc_context():
        yield


def _jax_series(ax):
    """(kind, data arrays) of a matplotlib axes' artists in the order
    they were added."""
    out = []
    for a in ax._children:
        if isinstance(a, Line3D):
            out.append(("line", [np.asarray(v, float) for v in a.get_data_3d()]))
        elif isinstance(a, Line2D):
            out.append(("line", list(a.get_xydata().T)))
        elif isinstance(a, Collection):
            out.append(("scatter", [np.asarray(np.ma.getdata(v), float) for v in a._offsets3d]))
        elif isinstance(a, Text3D):
            out.append(("text", [np.array([v], float) for v in a.get_position_3d()]))
        elif isinstance(a, Text):
            out.append(("text", [np.array([v], float) for v in a.get_position()]))
    return out


def _assert_same_series(port_ax, jax_ax, atol=0.0):
    want = _jax_series(jax_ax)
    got = [(s.kind, list(s.data)) for s in port_ax.series]
    assert [k for k, _ in got] == [k for k, _ in want]
    for i, ((_k, g), (_k2, w)) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for a, b in zip(g, w):
            if atol:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"series {i}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"series {i}")


def _assert_same_text(port_ax, jax_ax):
    assert port_ax.title == jax_ax.get_title()
    assert port_ax.xlabel == jax_ax.get_xlabel() and port_ax.ylabel == jax_ax.get_ylabel()
    if hasattr(jax_ax, "get_zlabel"):
        assert port_ax.zlabel == jax_ax.get_zlabel()
    assert [s.text for s in port_ax.texts] == [t.get_text() for t in jax_ax.texts]


def _assert_same_2d_limits(port_ax, jax_ax):
    assert port_ax.get_xlim() == pytest.approx(jax_ax.get_xlim(), rel=1e-12, abs=1e-12)
    assert port_ax.get_ylim() == pytest.approx(jax_ax.get_ylim(), rel=1e-12, abs=1e-12)


def _positions(rng, N=12, L=20):
    pos = rng.normal(scale=0.5, size=(N, L, 3)) + np.array([0.0, 0.0, 0.5])
    pos[3, 5] = np.nan  # a lost marker: its links go, its marker is dropped
    pos[0, 0, 2] = np.nan
    return pos


@pytest.fixture()
def result_pickles(tmp_path):
    rng = np.random.default_rng(0)
    out = []
    for name in ("sba", "fte"):
        fp = str(tmp_path / f"{name}.pickle")
        tdata.save_pickle(fp, dict(positions=_positions(rng)))
        out.append(fp)
    return out


@pytest.mark.parametrize("n_states,smoothed", [(25, True), (23, False)])
def test_plot_cheetah_states_matches_jax(tmp_path, n_states, smoothed):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, n_states))
    sx = x * 0.9 if smoothed else None
    jfig = jplots.plot_cheetah_states(x, sx)
    tfig = tplots.plot_cheetah_states(x, sx, out_fpath=str(tmp_path / "s.svg"))
    jaxes = jfig.axes
    assert len(tfig.flat) == len(jaxes) == 25
    for t_ax, j_ax in zip(tfig.flat, jaxes):
        assert t_ax.visible == j_ax.axison
        if not t_ax.visible:
            continue
        _assert_same_series(t_ax, j_ax)
        _assert_same_text(t_ax, j_ax)
        _assert_same_2d_limits(t_ax, j_ax)
    labels = [s.label for s in tfig.flat[0].series]
    assert labels == [t.get_text() for t in jaxes[0].get_legend().get_texts()]
    # the writer: one "series" polyline a line
    root = ET.parse(str(tmp_path / "s.svg")).getroot()
    series = [e for e in root.iter(f"{SVG}polyline") if e.get("class") == "series"]
    assert len(series) == n_states * (2 if smoothed else 1)


@pytest.mark.parametrize("centered,dark", [(False, False), (True, True)])
def test_plot_cheetah_reconstruction_matches_jax(result_pickles, tmp_path, centered, dark):
    fp = result_pickles[1]
    jfig = jplots.plot_cheetah_reconstruction(fp, frame_step=4, centered=centered,
                                              dark_mode=dark)
    tfig = tplots.plot_cheetah_reconstruction(fp, frame_step=4, centered=centered,
                                              dark_mode=dark, out_fpath=str(tmp_path / "r.png"))
    assert tfig.dark == dark
    _assert_same_series(tfig.axes[0][0], jfig.axes[0])
    _assert_same_text(tfig.axes[0][0], jfig.axes[0])
    img = png.read_png(str(tmp_path / "r.png"))
    assert img.shape == (600, 1400, 3)
    assert png.read_png_text(str(tmp_path / "r.png"))["axes 1 zlabel"] == "z [m]"


def test_plot_multiple_cheetah_reconstructions_matches_jax(result_pickles, tmp_path):
    jfig = jplots.plot_multiple_cheetah_reconstructions(result_pickles, dark_mode=True,
                                                        frame_step=5)
    tfig = tplots.plot_multiple_cheetah_reconstructions(result_pickles, dark_mode=True,
                                                        frame_step=5)
    t_ax, j_ax = tfig.axes[0][0], jfig.axes[0]
    _assert_same_series(t_ax, j_ax)
    assert [s.label for s in t_ax.series if s.label] == [
        t.get_text() for t in j_ax.get_legend().get_texts()] == ["sba", "fte"]


def test_plot_results_with_pan_matches_jax(result_pickles, tmp_path):
    enc = np.random.default_rng(2).integers(0, 102000, 12)
    want = jplots.plot_results_with_pan(result_pickles[0], enc, frame_step=3)
    got = tplots.plot_results_with_pan(result_pickles[0], enc, frame_step=3,
                                       out_fpath=str(tmp_path / "pan.svg"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    plain = tplots.plot_results_with_pan(result_pickles[0])
    np.testing.assert_array_equal(plain, tdata.load_pickle(result_pickles[0])["positions"])
    root = ET.parse(str(tmp_path / "pan.svg")).getroot()
    markers = [e for e in root.iter(f"{SVG}circle") if e.get("class") == "marker"]
    assert len(markers) == 4 * 20 - 2  # frames 0, 3, 6 and 9; 0 and 3 lose a marker each


def _calib_files(tmp_path, rng):
    k, d, r, t, res = tsyn.ring_cameras(n_cams=3)
    pts = rng.uniform([600.0, 300.0], [2100.0, 1200.0], size=(3, 54, 1, 2))
    points = str(tmp_path / "points.json")
    tdata.save_points(points, pts, ["1.png", "2.png", "3.png"], (9, 6), 0.04, res)
    camera = str(tmp_path / "camera.json")
    tdata.save_camera(camera, res, k[0], d[0].reshape(4, 1))
    scene = str(tmp_path / "scene.json")
    tdata.save_scene(scene, k, d.reshape(-1, 4, 1), r, t, res)
    return points, camera, scene


def test_calibration_plots_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    points, camera, scene = _calib_files(tmp_path, rng)
    jfig = jplots.plot_corners(points)
    tfig = tplots.plot_corners(points, out_fpath=str(tmp_path / "c.pdf"))
    _assert_same_series(tfig.axes[0][0], jfig.axes[0])
    _assert_same_text(tfig.axes[0][0], jfig.axes[0])
    _assert_same_2d_limits(tfig.axes[0][0], jfig.axes[0])
    assert tfig.axes[0][0].get_ylim() == (1520.0, 0.0)  # y down

    jfig = jplots.plot_points_fisheye_undistort(points, camera)
    tfig = tplots.plot_points_fisheye_undistort(points, camera, device="cpu")
    for t_ax, j_ax in zip(tfig.axes[0], jfig.axes):
        _assert_same_series(t_ax, j_ax, atol=1e-12 if t_ax.title == "undistorted" else 0.0)
        _assert_same_text(t_ax, j_ax)
        _assert_same_2d_limits(t_ax, j_ax)

    p3 = rng.normal(size=(10, 3))
    jfig = jplots.plot_scene(scene, points_3d=p3)
    tfig = tplots.plot_scene(scene, points_3d=p3, out_fpath=str(tmp_path / "scene.png"))
    _assert_same_series(tfig.axes[0][0], jfig.axes[0])
    _assert_same_text(tfig.axes[0][0], jfig.axes[0])
    text = png.read_png_text(str(tmp_path / "scene.png"))
    assert text["axes 1 text"] == "cam1; cam2; cam3"


def test_animate_reconstruction_matches_jax(tmp_path, capsys):
    """The JAX function (matplotlib frames, cv2's mp4v) and the port's
    (utils.figure frames, the port's mp4v) on one result: the same frame
    count, 640 x 480 and 15 fps, as cv2 reads both, the same printed
    line; the port's decoded frames against its own rasterisation of
    each frame: a PSNR no lower than cv2's mp4v encoding of those
    rasterised frames less 1 dB. Markers outside the links, a NaN point
    and max_frames cut the result."""
    import cv2

    from acinoset_tpu_torch.models import cheetah
    from test_torch_mpeg4 import cv2_frames, psnr

    rng = np.random.default_rng(6)
    markers = cheetah.get_markers()
    pos = tsyn.render_measurements(tsyn.cheetah_gallop(N=14), tsyn.ring_cameras(n_cams=2),
                                   seed=0)[2]
    pos[3, 5] = np.nan
    fp = str(tmp_path / "fte.pickle")
    tdata.save_pickle(fp, dict(positions=pos + rng.normal(scale=0.01, size=pos.shape),
                               markers=markers))
    links = tplots.CHEETAH_LINKS[:12] + [("nose", "no_such_marker")]
    outs = {}
    for name, mod, extra in (("jax", jplots, {}), ("port", tplots, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.mp4")
        assert mod.animate_reconstruction(fp, out, skel_links=links, max_frames=12, elev=25.0,
                                          azim=-50.0, **extra) == out
        assert capsys.readouterr().out == f"Saved {out}\n"
        cap = cv2.VideoCapture(out)
        outs[name] = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
                      cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FPS))
    assert outs["port"] == outs["jax"] == (12, 640, 480, 15.0)

    payload = tdata.load_pickle(fp)
    positions = payload["positions"][:12]
    pairs = [(markers.index(a), markers.index(b)) for a, b in links if b in markers]
    lo = np.nanmin(positions.reshape(-1, 3), axis=0)
    hi = np.nanmax(positions.reshape(-1, 3), axis=0)
    pad = 0.1 * np.maximum(hi - lo, 1e-3)
    raster = [tplots._reconstruction_frame(n, p, pairs, lo - pad, hi + pad, 25.0,
                                           -50.0).to_png()[0][..., ::-1]
              for n, p in enumerate(positions)]
    vw = cv2.VideoWriter(str(tmp_path / "cv2.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 15.0,
                         (640, 480))
    for f in raster:
        vw.write(np.ascontiguousarray(f))
    vw.release()
    p_port = np.mean([psnr(a, b) for a, b in zip(cv2_frames(str(tmp_path / "port.mp4")),
                                                 raster)])
    p_cv2 = np.mean([psnr(a, b) for a, b in zip(cv2_frames(str(tmp_path / "cv2.mp4")), raster)])
    assert p_port >= p_cv2 - 1.0, (p_port, p_cv2)


def _demo_figure():
    fig = figure.Figure(1, 2, figsize=(8, 3), dark=False)
    ax = fig.axes[0][0]
    ax.plot([0.0, 1.0, np.nan, 3.0, 4.0], [1.0, 2.0, 0.0, 1.0, 0.5], "o-", label="a & <b>")
    ax.plot([0.0, 4.0], [0.0, 2.0], "r-", label="(line)")
    ax.bar([0.5, 1.5], [1.0, 2.0], [1.0, 1.0])
    ax.text(2.0, 1.0, "note")
    ax.set_ylim(3.0, -1.0)
    ax.set_title("two runs"); ax.set_xlabel("x"); ax.set_ylabel("y"); ax.legend()
    ax3 = figure.Axes("3d")
    fig.axes[0][1] = ax3
    ax3.scatter([0.0, 1.0, np.nan], [0.0, 1.0, 2.0], [0.0, 1.0, 2.0], s=9, alpha=0.5)
    ax3.plot([0.0, 1.0], [0.0, 1.0], [0.0, 1.0])
    ax3.view_init(elev=10, azim=40)
    ax3.set_zlabel("z")
    return fig


def _pdf_objects_ok(data):
    """The xref table's offsets each land on 'n 0 obj', startxref on
    'xref', and every stream's /Length is its byte count."""
    start = int(re.search(rb"startxref\n(\d+)\n%%EOF\n$", data).group(1))
    assert data[start:start + 5] == b"xref\n"
    head, n = re.match(rb"xref\n0 (\d+)\n", data[start:]), None
    n = int(head.group(1))
    rows = data[start + head.end():].split(b"\n")[:n]
    assert rows[0] == b"0000000000 65535 f "
    for i, row in enumerate(rows[1:], 1):
        off = int(row[:10])
        assert row[10:] == b" 00000 n ", row
        assert data[off:].startswith(f"{i} 0 obj\n".encode()), (i, data[off:off + 12])
    for m in re.finditer(rb"/Length (\d+) >>\nstream\n", data):
        end = m.end() + int(m.group(1))
        assert data[end:end + 10] == b"\nendstream"
    return n - 1


def test_writers_round_trip(tmp_path):
    fig = _demo_figure()
    paths = {ext: str(tmp_path / "sub" / f"f{ext}") for ext in figure.WRITERS}
    for p in paths.values():
        assert fig.save(p) == p
    root = ET.parse(paths[".svg"]).getroot()
    assert root.get("viewBox") == "0 0 576 216"
    polylines = [e for e in root.iter(f"{SVG}polyline") if e.get("class") == "series"]
    assert len(polylines) == 2 + 1 + 1  # the NaN splits the first line; the second; the 3D one
    assert len([e for e in root.iter(f"{SVG}rect") if e.get("class") == "bar"]) == 2
    texts = [e.text for e in root.iter(f"{SVG}text")]
    assert {"two runs", "a & <b>", "(line)", "note", "z"} <= set(texts)

    data = open(paths[".pdf"], "rb").read()
    assert data.startswith(b"%PDF-1.4\n") and _pdf_objects_ok(data) == 5
    assert b"/BaseFont /Helvetica" in data and b"(\\(line\\)) Tj" in data
    assert b" re f" in data and b" S" in data and b" c " in data

    img = png.read_png(paths[".png"])
    assert img.shape == (300, 800, 3)
    assert (img != 255).any(axis=-1).sum() > 500
    text = png.read_png_text(paths[".png"])
    assert text["Title"] == "two runs" and text["axes 1 legend"] == "a & <b>; (line)"
    assert text["axes 1 bars 1 heights"] == "1.0 2.0" and text["axes 2 zlabel"] == "z"
    smooth, _ = fig.to_png(antialias=True)
    assert smooth.shape == img.shape and not np.array_equal(smooth, img)
    with pytest.raises(ValueError, match=r"\.jpg"):
        fig.save(str(tmp_path / "f.jpg"))


def test_3d_projection_is_matplotlibs_view():
    """The screen axes of elev/azim: at matplotlib's default view the
    x axis runs down to the right and z straight up."""
    right, up = figure._view_axes(30.0, -60.0)
    np.testing.assert_allclose(right, [np.sqrt(3) / 2, 0.5, 0.0], atol=1e-15)
    np.testing.assert_allclose(up[2], np.sqrt(3) / 2, atol=1e-15)
    assert np.dot(right, up) == pytest.approx(0.0, abs=1e-15)
    assert figure.Axes("3d").elev == 30.0 and figure.Axes("3d").azim == -60.0


#: sha256 of IHDR + the inflated image data of write_png's file for the
#: seeded images below, as the writer produced them before it took text
WRITE_PNG_CONTENT = {
    (37, 53): "f0c4b75baf3353f7c0c77893b3c256500aa308f6c91dab81290ceb1647a01d04",
    (37, 53, 2): "7af79753bd320baebd7915729f1abb30628ad4940c6ec0271c2d134e14900d48",
    (37, 53, 3): "1f38c50213461eeb212b6623338dd8436e024eb222732754a249f0227439a96a",
    (37, 53, 4): "1e09f87827566abda346d64edc132dbe7bb3bf0b57bbfab84063069b47e18295",
}


def test_write_png_bytes_unchanged_and_text_chunks(tmp_path):
    rng = np.random.default_rng(7)
    for shape, digest in WRITE_PNG_CONTENT.items():
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "a.png")
        tsyn.write_png(path, img)  # the calibration frames' writer, re-exported
        data = open(path, "rb").read()
        chunks = list(png._chunks(path, data))
        assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
        filtered = zlib.decompress(chunks[1][1])
        assert hashlib.sha256(chunks[0][1] + filtered).hexdigest() == digest
        assert data == (png.SIGNATURE + png._chunk(b"IHDR", chunks[0][1])
                        + png._chunk(b"IDAT", zlib.compress(filtered, 1))
                        + png._chunk(b"IEND", b""))
        np.testing.assert_array_equal(png.read_png(path), img)
        png.write_png(path, img, text={"Title": "café", "Comment": "✓ done"})
        assert png.read_png_text(path) == {"Title": "café", "Comment": "? done"}
        np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError, match="1-79"):
        png.write_png(str(tmp_path / "b.png"), img, text=[("x" * 80, "")])


def test_save_error_histogram_matches_jax(tmp_path, monkeypatch):
    errors = np.abs(np.random.default_rng(4).standard_cauchy(500))
    counts = []
    hist = matplotlib.axes.Axes.hist

    def spy(self, *a, **kw):
        out = hist(self, *a, **kw)
        counts.append(out[0])
        return out

    monkeypatch.setattr(matplotlib.axes.Axes, "hist", spy)
    jmetrics.save_error_histogram(errors, str(tmp_path / "jax.png"))
    out = str(tmp_path / "port.png")
    assert tmetrics.save_error_histogram(errors, out) == out
    text = png.read_png_text(out)
    heights = np.array([float(v) for v in text["axes 1 bars 1 heights"].split()])
    np.testing.assert_array_equal(heights, counts[0])
    np.testing.assert_array_equal(heights, np.histogram(errors, 20)[0])
    assert heights.sum() == errors.size
    assert text["axes 1 xlabel"] == "Reprojection Error (px)"
    assert text["axes 1 ylabel"] == "Frequency" and text["axes 1 title"] == "Reprojection error"
    assert png.read_png(out).shape == (480, 720, 3)
    assert struct.unpack(">II", open(out, "rb").read()[16:24]) == (720, 480)
