"""Run directories for the port's file-level tests
(tests/test_torch_pipeline_files.py, tests/test_torch_sweep_files.py,
tests/test_torch_cli_files.py): synthetic cheetah runs in the
reference's layout (dlc/cam{c}DLC.h5, the scene JSON, video_info.json),
4 cameras and the 20 cheetah markers, seeded, written by either
package's ``make_synthetic_run_dir`` (the two write equal data); and the
checks the files' tests share."""
import os

import numpy as np
import torch

from acinoset_tpu.utils import synthetic as jsyn
from acinoset_tpu_torch.utils import synthetic as tsyn

N_CAMS = 4
THRESH = 0.5
WRITERS = {"jax": jsyn.make_synthetic_run_dir, "port": tsyn.make_synthetic_run_dir}


def make_run(root, writer="port", N=40, fps=90.0, seed=0, n_cams=N_CAMS):
    """A run directory under ``root`` by the named package's writer.
    Returns (run_dir, pts3d)."""
    run, _cams, _X, pts3d = WRITERS[writer](str(root), n_cams=n_cams, N=N, fps=fps, seed=seed)
    return run, pts3d


#: a dataset root of four runs in two fps groups: (name, N, fps, seed)
DATASET = (("a", 30, 90.0, 1), ("b", 36, 120.0, 2), ("c", 34, 90.0, 3), ("d", 30, 120.0, 4))


def make_dataset(root, writer="port", runs=DATASET):
    """Runs of ``runs`` under ``root``, each in its own subdirectory."""
    return [make_run(os.path.join(str(root), name), writer, N=n, fps=fps, seed=seed)[0]
            for name, n, fps, seed in runs]


def assert_no_torch(obj, path="payload"):
    """No torch object anywhere in a (nested) pickle payload."""
    assert not torch.is_tensor(obj), path
    assert type(obj).__module__.split(".")[0] != "torch", (path, type(obj))
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert_no_torch(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            assert_no_torch(v, f"{path}[{i}]")
    elif isinstance(obj, np.ndarray) and obj.dtype == object:
        for i, v in enumerate(obj.reshape(-1)):
            assert_no_torch(v, f"{path}.flat[{i}]")


def assert_same_layout(got, want):
    """Two pickle payloads with the same keys, and per key the same type,
    shape and dtype."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.shape == w.shape and g.dtype == w.dtype, (
                k, type(g), getattr(g, "shape", None), getattr(g, "dtype", None), w.shape,
                w.dtype)
        else:
            assert isinstance(g, type(w)) or isinstance(w, type(g)), (k, type(g), type(w))


def assert_equal_arrays(got, want, what=""):
    """Exactly equal, NaN where NaN, including dtype."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


class Spy:
    """Wraps a function and records the arguments of every call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)
