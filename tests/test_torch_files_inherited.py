"""chip_smoke.py's files phase holds every sweep run's EKF to
tests/test_pipeline_e2e.py's bound, except the runs in
``chip_smoke.FILES_EKF_JAX_LOST``: those the JAX package's own batched
float32 EKF loses on the same files (the inherited cold-init fault,
ROADMAP Queue 3). This holds that list to the JAX package, on the CPU,
on the phase's own dataset (8 runs of 6 cameras x 200 frames in two fps
groups, written by the port), and shows the port's float32 stage on the
CPU losing the same runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from acinoset_tpu.pipeline import sweep as jsweep
from acinoset_tpu_torch.pipeline import sweep as tsweep

torch.set_num_threads(2)
THRESH = 0.8  # the CLI's default, as the phase runs it


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("files_phase")
    runs = [chip_smoke.files_sweep_run(str(root), i) for i in range(chip_smoke.FILES_SWEEP_RUNS)]
    return {run: pts for run, _cams, _x, pts in runs}


def _lost(module, dataset, **kw):
    """Indices of the runs whose batched EKF ends over the bound."""
    errs = {}
    runs = [module.load_run(d) for d in dataset]
    for fps in chip_smoke.FILES_FPS:
        group = [r for r in runs if r.fps == fps]
        for res in module.solve_batch_ekf(group, THRESH, **kw):
            d = np.linalg.norm(res["positions"] - dataset[res["data_dir"]], axis=-1)
            errs[list(dataset).index(res["data_dir"])] = float(
                np.nanmean(d[chip_smoke.FILES_EKF_SKIP:]))
    return sorted(i for i, e in errs.items() if not e < chip_smoke.FILES_EKF_MEAN_M), errs


def test_ekf_runs_lost_by_the_jax_package_float32_stage(dataset):
    lost, errs = _lost(jsweep, dataset, dtype=jnp.float32)
    assert lost == list(chip_smoke.FILES_EKF_JAX_LOST), errs


def test_the_port_float32_stage_loses_the_same_runs(dataset):
    lost, errs = _lost(tsweep, dataset, device="cpu", dtype=torch.float32)
    assert lost == list(chip_smoke.FILES_EKF_JAX_LOST), errs
