"""The port's small utilities against the JAX package's: pan
compensation, the stage timer and the build guard, and the headless
cores of the label session and the skeleton builder (their files and
dicts byte for byte).
"""
import numpy as np
import pytest
import torch

from acinoset_tpu.gui import label_session as jlabel
from acinoset_tpu.gui import skeleton_builder as jskel
from acinoset_tpu.utils import pan_compensation as jpan
from acinoset_tpu.utils import profiling as jprof
from acinoset_tpu_torch.gui import label_session as tlabel
from acinoset_tpu_torch.gui import skeleton_builder as tskel
from acinoset_tpu_torch.kernels import _nvcc
from acinoset_tpu_torch.models import skeleton as tsk
from acinoset_tpu_torch.utils import _gxx
from acinoset_tpu_torch.utils import pan_compensation as tpan
from acinoset_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


# ---- pan compensation ----

def test_pan_compensation_matches_jax():
    rng = np.random.default_rng(0)
    counts = rng.integers(-204000, 204000, size=7)
    np.testing.assert_allclose(tpan.count_to_rad(torch.tensor(counts, dtype=torch.float64)).numpy(),
                               np.asarray(jpan.count_to_rad(counts.astype(np.float64))),
                               rtol=1e-12, atol=1e-12)
    assert float(tpan.count_to_rad(102000.0)) == pytest.approx(2 * np.pi, rel=1e-12)
    pts = rng.normal(size=(7, 3))
    theta = rng.uniform(-np.pi, np.pi, size=7)
    got = tpan.rotate_point(torch.tensor(pts), torch.tensor(theta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpan.rotate_point(pts, theta)), rtol=1e-12,
                               atol=1e-12)
    one = tpan.rotate_point(torch.tensor(pts[0]), np.pi / 2).numpy()
    np.testing.assert_allclose(one, np.asarray(jpan.rotate_point(pts[0], np.pi / 2)), rtol=1e-12,
                               atol=1e-12)


# ---- profiling ----

def test_stage_timer_matches_jax(capsys):
    reports = []
    for mod in (tprof, jprof):
        timer = mod.StageTimer()
        for name in ("init", "solve", "init"):
            with timer.stage(name):
                pass
        with timer.stage("quiet", verbose=False):
            pass
        reports.append(timer.report())
        assert [r["stage"] for r in timer.records] == ["init", "solve", "init", "quiet"]
    assert reports[0].keys() == reports[1].keys() == {"init", "solve", "quiet"}
    out = capsys.readouterr().out
    assert out.count("init took") == 4 and "quiet took" not in out


def test_recompile_guard_counts_native_builds(monkeypatch):
    """compile_count sums the nvcc and g++ builds this process ran; a
    counted build inside the guard raises, none passes."""
    base = tprof.compile_count()
    with tprof.RecompileGuard():
        pass
    monkeypatch.setattr(_nvcc.build, "runs", _nvcc.build.runs + 1)
    assert tprof.compile_count() == base + 1
    with pytest.raises(AssertionError, match="1 native build"):
        with tprof.RecompileGuard():
            monkeypatch.setattr(_gxx.build, "runs", _gxx.build.runs + 1)
    with tprof.RecompileGuard(allowed=1):
        monkeypatch.setattr(_gxx.build, "runs", _gxx.build.runs + 1)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with tprof.profiler_trace(None):
        pass
    with tprof.profiler_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ---- the label session and the skeleton builder ----

def _label(mod, path):
    s = mod.LabelSession(n_cams=3, camera_resolution=(1920, 1080))
    i = s.new_point()
    s.record(i, 0, (100.5, 200.5))
    s.record(i, 2, (300.0, 400.0))
    s.record(2, 1, (7.0, 8.0))
    s.save(str(path))
    return s


def test_label_session_file_matches_jax(tmp_path):
    t, j = _label(tlabel, tmp_path / "t" / "manual_points.json"), _label(
        jlabel, tmp_path / "j" / "manual_points.json")
    assert (tmp_path / "t" / "manual_points.json").read_bytes() == (
        tmp_path / "j" / "manual_points.json").read_bytes()
    np.testing.assert_array_equal(t.as_array(), j.as_array())
    loaded = tlabel.LabelSession.load(str(tmp_path / "j" / "manual_points.json"))
    np.testing.assert_array_equal(loaded.as_array(), j.as_array())
    assert loaded.n_cams == 3 and loaded.camera_resolution == (1920, 1080)
    empty = tlabel.LabelSession(2, (640, 480))
    assert empty.as_array().shape == (0, 2, 2)
    with pytest.raises(RuntimeError, match="matplotlib"):
        t.run_interactive([np.zeros((4, 4))] * 3)


def _builder(mod):
    b = (mod.SkeletonBuilder()
         .add_part("nose", [0, 0, 0], dofs=(1, 1, 1))
         .add_part("neck", [-0.3, 0, 0], dofs=(0, 1, 0))
         .add_part("tail", [-0.8, 0, 0], dofs=(0, 1, 1))
         .add_part("hidden", [-0.5, 0.1, 0], marker=False))
    b.link("nose", "neck").link("neck", "tail").link("neck", "hidden")
    return b.set_dofs("hidden", (0, 0, 1))


def test_skeleton_builder_matches_jax(tmp_path):
    t, j = _builder(tskel), _builder(jskel)
    assert t.build() == j.build()
    assert t.validate() == j.validate() == []
    st = t.save(str(tmp_path / "t.pickle"))
    j.save(str(tmp_path / "j.pickle"))
    assert (tmp_path / "t.pickle").read_bytes() == (tmp_path / "j.pickle").read_bytes()
    model = tsk.build_skeleton_model(st)
    assert model.n_markers == 3
    p = model.fk(torch.zeros(model.n_pose, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(p[model.markers.index("tail")], [-0.8, 0, 0], atol=1e-12)
    for mod, name in ((tskel, "t"), (jskel, "j")):
        mod.patch_markers(str(tmp_path / f"{name}.pickle"), ["nose", "tail"])
    assert (tmp_path / "t.pickle").read_bytes() == (tmp_path / "j.pickle").read_bytes()
    loose = tskel.SkeletonBuilder().add_part("a", [0, 0, 0]).add_part("b", [1, 0, 0])
    jloose = jskel.SkeletonBuilder().add_part("a", [0, 0, 0]).add_part("b", [1, 0, 0])
    assert loose.validate() == jloose.validate() and len(loose.validate()) == 2
