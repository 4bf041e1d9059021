"""The port's EKF slice (acinoset_tpu_torch.solvers.ekf, the EKF part of
pipeline.ekf and sweep.solve_batch_ekf) against the JAX package's, in
float64 on the CPU, with the same seeded numpy inputs on both sides.

Fixtures: tests/test_ekf_oracle.py's (N=12, 3 cameras) and
tests/test_ekf.py's (N=50, 4 cameras), whose JAX outputs are also
committed as tests/golden/ekf_synthetic_n50.npz (written by
``write_ekf_golden``: ``python tests/test_torch_ekf.py``) so that
chip_smoke.py can hold the GPU to them without JAX.

Tolerances. States: rtol 1e-8, atol 1e-9 times the largest value of the
JAX array (positions and angles are of order 1, velocities ~40 and
accelerations ~700, and the filter carries rounding from frame to frame:
at N=50 a 1e-15 relative nudge of the pixels moves JAX's own
accelerations by more than 1e-9). Pose covariances: rtol 1e-6 on the
same atol. These are tests/test_ekf.py's sequential-vs-associative
tolerances.
"""
import os
import sys

import jax

if __name__ == "__main__":  # writing the golden file: JAX on the CPU in float64
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from acinoset_tpu.models import cheetah as jch  # noqa: E402
from acinoset_tpu.pipeline import ekf as jekf  # noqa: E402
from acinoset_tpu.pipeline import sweep as jsweep  # noqa: E402
from acinoset_tpu.solvers import banded as jbanded  # noqa: E402
from acinoset_tpu.solvers import ekf as jsolv  # noqa: E402
from acinoset_tpu.utils import synthetic as jsyn  # noqa: E402
from acinoset_tpu_torch.models import cheetah as tch  # noqa: E402
from acinoset_tpu_torch.pipeline import ekf as tekf  # noqa: E402
from acinoset_tpu_torch.pipeline import sweep as tsweep  # noqa: E402
from acinoset_tpu_torch.solvers import banded as tbanded  # noqa: E402
from acinoset_tpu_torch.solvers import ekf as tsolv  # noqa: E402
from acinoset_tpu_torch.utils import synthetic as tsyn  # noqa: E402

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "ekf_synthetic_n50.npz")
STATE_KEYS = ("x", "dx", "ddx", "smoothed_x", "smoothed_dx", "smoothed_ddx")
COV_KEYS = ("P", "smoothed_P")
N_POSE = 25


def assert_ekf_close(got, want, keys=STATE_KEYS + COV_KEYS):
    """The module's tolerance rule (see the docstring) on every key."""
    for key in keys:
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        rtol = 1e-6 if key in COV_KEYS else 1e-8
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-9 * np.abs(w).max(), err_msg=key)


# ---- fixtures ----

def _oracle_inputs():
    """tests/test_ekf_oracle.py's run: N=12, 3 cameras, 5% outliers."""
    cams = jsyn.ring_cameras(n_cams=3)
    k, d, r, t, res = cams
    X = jsyn.cheetah_gallop(N=12, fps=90.0)
    px, lik, _ = jsyn.render_measurements(X, cams, noise_px=1.0, outlier_frac=0.05,
                                          bad_lik_frac=0.05, seed=6)
    x0 = np.zeros(3 * N_POSE)
    x0[:3] = X[0, :3]
    x0[5] = X[0, 5]
    return dict(pixels=px.transpose(1, 0, 2, 3), likelihood=lik.transpose(1, 0, 2),
                cams=(k, d, r, t), x0=x0, P0=np.eye(3 * N_POSE) * 0.5, max_pixel_err=res[0])


def _n50_inputs():
    """tests/test_ekf.py's run: N=50, 4 cameras, x0 near the truth."""
    cams = jsyn.ring_cameras(n_cams=4)
    k, d, r, t, res = cams
    X = jsyn.cheetah_gallop(N=50, fps=90.0)
    px, lik, _ = jsyn.render_measurements(X, cams, noise_px=1.0, outlier_frac=0.01,
                                          bad_lik_frac=0.02, seed=1)
    pp = jch.get_pose_params()
    x0 = np.zeros(3 * N_POSE)
    for name in ("x_0", "y_0", "psi_0"):
        x0[pp[name]] = X[0, pp[name]]
    x0[N_POSE + pp["x_0"]] = 8.0  # approx forward speed
    return dict(pixels=px.transpose(1, 0, 2, 3), likelihood=lik.transpose(1, 0, 2),
                cams=(k, d, r, t), x0=x0, P0=tekf.ekf_P0(N_POSE), max_pixel_err=res[0],
                X_true=X)


FIXTURES = {"oracle_n12": _oracle_inputs, "n50": _n50_inputs}


def write_ekf_golden(path=GOLDEN):
    """The N=50 fixture's inputs and the JAX package's float64
    run_cheetah_ekf outputs (states, outliers, the pose covariances'
    diagonals and marker_std), for chip_smoke.py's parity check."""
    inp = _n50_inputs()
    k, d, r, t = inp["cams"]
    out = jekf.run_cheetah_ekf(inp["pixels"], inp["likelihood"], k, d, r, t, fps=90.0,
                               cam_res=(inp["max_pixel_err"], 0), dlc_thresh=0.5,
                               x0_pose=inp["x0"])
    np.savez_compressed(
        path, pixels=inp["pixels"], likelihood=inp["likelihood"], k=k, d=d, r=r, t=t,
        x0_pose=inp["x0"], fps=90.0, dlc_thresh=0.5, cam_width=inp["max_pixel_err"],
        outliers=out["outliers"],
        marker_std=jekf.marker_std_from_smoothed(out["smoothed_x"], out["smoothed_P"]),
        **{f"{key}_diag": np.diagonal(out[key], axis1=-2, axis2=-1) for key in COV_KEYS},
        **{key: out[key] for key in STATE_KEYS},
    )


def _jitted(run_ekf):
    """run_ekf compiled as one program (the eager associative scan
    compiles op by op: 3-4x slower here). Same arithmetic up to XLA's
    fusion of the rounding steps."""

    def run(h_fn, pixels, likelihood, x0, P0, qb_std, config, hj_fn=None, smoother="auto"):
        return jax.jit(lambda *a: run_ekf(h_fn, *a, qb_std, config, hj_fn=hj_fn,
                                          smoother=smoother))(pixels, likelihood, x0, P0)

    return run


def _jax_run_cheetah_ekf(inp):
    """The JAX package's run_cheetah_ekf on the N=50 fixture, its run_ekf
    compiled as one program."""
    k, d, r, t = inp["cams"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolv, "run_ekf", _jitted(jsolv.run_ekf))
        return jekf.run_cheetah_ekf(inp["pixels"], inp["likelihood"], k, d, r, t, fps=90.0,
                                    cam_res=(inp["max_pixel_err"], 0), dlc_thresh=0.5,
                                    x0_pose=inp["x0"])


@pytest.fixture(scope="module")
def jax_runs():
    """JAX run_ekf results, cached by (fixture, smoother). The N=50
    associative run is run_cheetah_ekf's ('auto' at N=50, with the
    reference's initial covariance, which the fixture's P0 copies)."""
    cache = {}

    def get(name, smoother):
        if (name, smoother) not in cache:
            inp = FIXTURES[name]()
            if (name, smoother) == ("n50", "associative"):
                out = _jax_run_cheetah_ekf(inp)
            else:
                k, d, r, t = inp["cams"]
                cfg = jsolv.EkfConfig(dt=1 / 90.0, dlc_thresh=0.5, meas_std_px=jch.MEAS_STD_PX,
                                      max_pixel_err=float(inp["max_pixel_err"]))
                out = _jitted(jsolv.run_ekf)(
                    jekf.make_h_fn(k, d, r, t), jnp.asarray(inp["pixels"]),
                    jnp.asarray(np.nan_to_num(inp["likelihood"], nan=-1.0)),
                    jnp.asarray(inp["x0"]), jnp.asarray(inp["P0"]), jch.EKF_QB, cfg,
                    hj_fn=jekf.make_hj_fn(k, d, r, t), smoother=smoother)
            cache[name, smoother] = {key: np.asarray(v) for key, v in out.items()}
        return cache[name, smoother]

    return get


def _port_run_ekf(inp, smoother, dtype=torch.float64):
    k, d, r, t = inp["cams"]

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    cfg = tsolv.EkfConfig(dt=1 / 90.0, dlc_thresh=0.5, meas_std_px=tch.MEAS_STD_PX,
                          max_pixel_err=float(inp["max_pixel_err"]))
    out = tsolv.run_ekf(tekf.make_hj_fn(k, d, r, t, dtype, "cpu"), T(inp["pixels"])[None],
                        T(np.nan_to_num(inp["likelihood"], nan=-1.0))[None], T(inp["x0"])[None],
                        T(inp["P0"]), tch.EKF_QB, cfg, smoother=smoother)
    return {key: v[0].numpy() for key, v in out.items()}


# ---- solver pieces ----

@pytest.mark.parametrize("n_pose,dt", [(3, 0.1), (N_POSE, 1 / 90.0)])
def test_constant_acc_model_matches_jax(n_pose, dt):
    np.testing.assert_array_equal(tsolv.constant_acc_F(n_pose, dt).numpy(),
                                  np.asarray(jsolv.constant_acc_F(n_pose, dt)))
    qb = np.linspace(1.0, 3.0, n_pose)
    np.testing.assert_array_equal(tsolv.constant_acc_Q(qb, dt), jsolv.constant_acc_Q(qb, dt))
    x = np.random.default_rng(0).normal(size=(4, 3 * n_pose))
    want = np.stack([np.asarray(jsolv.predict_next_state(jnp.asarray(xi), dt, n_pose))
                     for xi in x])
    np.testing.assert_array_equal(tsolv.predict_next_state(torch.tensor(x), dt, n_pose).numpy(),
                                  want)


def test_chol_inv_blocked3_matches_jax():
    """Four (75, 75) SPD matrices with the smoother's spread of scales."""
    rng = np.random.default_rng(3)
    G = rng.normal(size=(4, 75, 75))
    s = np.repeat([1e-2, 1.0, 30.0], 25)
    A = s[:, None] * (G @ G.mT / 75 + 0.5 * np.eye(75)) * s[None, :]
    L, Linv = tbanded._chol_inv_blocked3(torch.tensor(A), N_POSE)
    Lj, Linvj = jax.jit(lambda a: jbanded._chol_inv_blocked3(a, N_POSE))(jnp.asarray(A))
    for got, want in ((L, Lj), (Linv, Linvj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose((L @ L.mT).numpy(), A, rtol=1e-12, atol=1e-12 * np.abs(A).max())


# ---- run_ekf and the pipeline ----

@pytest.mark.parametrize("smoother", ["associative", "sequential"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_run_ekf_matches_jax(jax_runs, name, smoother):
    want = jax_runs(name, smoother)
    got = _port_run_ekf(FIXTURES[name](), smoother)
    assert_ekf_close(got, want)
    assert int(got["outliers"]) == int(want["outliers"]) > 0


def test_run_ekf_smoothers_agree_and_auto_picks_associative(jax_runs):
    """The two smoothers of the port agree at JAX's own tolerance, and
    'auto' is the associative scan at N <= 256 (the same numbers)."""
    inp = _n50_inputs()
    seq = _port_run_ekf(inp, "sequential")
    assoc = _port_run_ekf(inp, "associative")
    assert_ekf_close(seq, assoc, keys=("smoothed_x", "smoothed_dx", "smoothed_ddx", "smoothed_P"))
    auto = _port_run_ekf(inp, "auto")
    for key in assoc:
        np.testing.assert_array_equal(auto[key], assoc[key])
    with pytest.raises(ValueError, match="unknown smoother"):
        _port_run_ekf(inp, "parallel")


def test_make_hj_fn_matches_jax():
    k, d, r, t, _res = jsyn.ring_cameras(n_cams=3)
    poses = jsyn.cheetah_gallop(N=6) + np.random.default_rng(2).normal(scale=0.05, size=(6, 25))
    h, J = tekf.make_hj_fn(k, d, r, t, device="cpu")(torch.tensor(poses))
    hw, Jw = jax.jit(jax.vmap(jekf.make_hj_fn(k, d, r, t)))(jnp.asarray(poses))
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jw), rtol=1e-10, atol=1e-10)


def test_marker_std_matches_jax(jax_runs):
    """marker_std_from_smoothed on the N=50 run's smoothed states, and the
    batched make_marker_std_fn on a full-state covariance (its pose
    block is read)."""
    out = jax_runs("n50", "associative")
    want = jekf.marker_std_from_smoothed(out["smoothed_x"], out["smoothed_P"])
    got = tekf.marker_std_from_smoothed(out["smoothed_x"], out["smoothed_P"], device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    rng = np.random.default_rng(4)
    G = rng.normal(size=(3, 75, 75))
    Pf = G @ G.mT / 75
    x = out["smoothed_x"][:3]
    one_t = tekf.make_marker_std_fn(tch.fk25_and_jac, N_POSE)
    one_j = jekf.make_marker_std_fn(jch.fk25_and_jac, N_POSE)
    want = np.stack([np.asarray(one_j(jnp.asarray(x[i]), jnp.asarray(Pf[i]))) for i in range(3)])
    np.testing.assert_allclose(one_t(torch.tensor(x), torch.tensor(Pf)).numpy(), want,
                               rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _golden_run(g, dtype=torch.float64, pixels=None):
    return tekf.run_cheetah_ekf(
        g["pixels"] if pixels is None else pixels, g["likelihood"], g["k"], g["d"], g["r"],
        g["t"], fps=float(g["fps"]), cam_res=(float(g["cam_width"]), 0),
        dlc_thresh=float(g["dlc_thresh"]), x0_pose=g["x0_pose"], dtype=dtype, device="cpu")


def _golden_view(out):
    """run_cheetah_ekf's output in the golden file's keys."""
    view = {key: out[key] for key in STATE_KEYS}
    view.update({f"{key}_diag": np.diagonal(out[key], axis1=-2, axis2=-1) for key in COV_KEYS})
    return view


def test_run_cheetah_ekf_matches_golden(golden):
    out = _golden_run(golden)
    assert_ekf_close(_golden_view(out), golden,
                     keys=STATE_KEYS + tuple(f"{key}_diag" for key in COV_KEYS))
    assert int(out["outliers"]) == int(golden["outliers"])
    np.testing.assert_allclose(
        tekf.marker_std_from_smoothed(out["smoothed_x"], out["smoothed_P"], device="cpu"),
        golden["marker_std"], rtol=1e-8, atol=1e-12)


def test_jax_package_still_reproduces_golden(golden, jax_runs):
    """The fixture cannot drift from the reference: the inputs are those
    of tests/test_ekf.py, and the JAX package's run_cheetah_ekf on them
    (jax_runs' N=50 associative run) gives the committed outputs."""
    inp = _n50_inputs()
    for key in ("pixels", "likelihood", "x0_pose"):
        np.testing.assert_array_equal(golden[key], inp["x0" if key == "x0_pose" else key])
    for key, a in zip("kdrt", inp["cams"]):
        np.testing.assert_array_equal(golden[key], a)
    out = jax_runs("n50", "associative")
    assert_ekf_close(_golden_view(out), golden,
                     keys=STATE_KEYS + tuple(f"{key}_diag" for key in COV_KEYS))
    assert int(out["outliers"]) == int(golden["outliers"])


def test_float32_marker_error_within_5pct_of_float64(golden):
    """tests/test_ekf.py's float32 rule, on the mean over an ensemble of
    rounding: the golden run and five copies with the pixels nudged by
    1e-6 relative (1e-3 px, under the 1 px noise). Single runs of either
    package land a few percent either side of float64 (weakly observed
    head angles drift in float32), so one run's ratio says which way the
    rounding fell. The JAX rule's deterministic bounds hold per run."""
    X_true = jsyn.cheetah_gallop(N=50, fps=90.0)
    mk_true = tch.fk25(torch.tensor(X_true)).numpy()
    rng = np.random.default_rng(0)
    errs = {torch.float32: [], torch.float64: []}
    for i in range(6):
        px = golden["pixels"] * (1 + (1e-6 if i else 0.0) * rng.standard_normal(golden["pixels"].shape))
        runs = {dt: _golden_run(golden, dt, px) for dt in errs}
        for key in ("x", "smoothed_x"):
            diff = np.abs(runs[torch.float32][key].astype(np.float64) - runs[torch.float64][key])
            assert diff.max() < 0.3 and diff.mean() < 0.02, (i, key, diff.max(), diff.mean())
            mk = {dt: tch.fk25(torch.tensor(runs[dt][key], dtype=torch.float64)).numpy()
                  for dt in errs}
            assert np.linalg.norm(mk[torch.float32] - mk[torch.float64], axis=-1).mean() < 1e-2
        for dt in errs:
            mk = tch.fk25(torch.tensor(runs[dt]["smoothed_x"], dtype=torch.float64)).numpy()
            errs[dt].append(np.nanmean(np.linalg.norm(mk[20:] - mk_true[20:], axis=-1)))
    e32, e64 = np.mean(errs[torch.float32]), np.mean(errs[torch.float64])
    assert e32 < 1.05 * e64, (errs[torch.float32], errs[torch.float64])


# ---- the sweep's batched EKF stage ----

LENGTHS = (12, 16, 10, 14, 16, 11)


def _runs(module, lengths=LENGTHS):
    """Ragged runs on two rigs (3 cameras, and 2 cameras of another
    radius), the second half claiming a 1920-wide sensor: per-run frame
    counts, camera counts and untrusted-measurement sigmas."""
    out = []
    for i, n in enumerate(lengths):
        cams = tsyn.ring_cameras(n_cams=(3, 2)[i % 2], radius=(10.0, 13.0)[i % 2])
        k, d, r, t, res = cams
        px, lik, _ = tsyn.render_measurements(tsyn.cheetah_gallop(N=n), cams, noise_px=1.5,
                                              outlier_frac=0.03, bad_lik_frac=0.05, seed=20 + i)
        out.append(module.RunData(
            data_dir=f"run_{i}", pixels=px, likelihood=lik,
            cams=(k, d.reshape(-1, 4), r, t.reshape(-1, 3)), fps=90.0, start_frame=0,
            scene_fpath="", cam_res=res if i < len(lengths) // 2 else (1920, 1080)))
    return out


@pytest.fixture(scope="module")
def batch_pair():
    got = tsweep.solve_batch_ekf(_runs(tsweep), 0.5, device="cpu", dtype=torch.float64)
    want = jsweep.solve_batch_ekf(_runs(jsweep), 0.5, dtype=jnp.float64)
    return got, want


def test_solve_batch_ekf_matches_jax(batch_pair):
    got, want = batch_pair
    assert len(got) == len(want) == len(LENGTHS)
    for rt, rj, n in zip(got, want, LENGTHS):
        assert set(rt) == set(rj) and set(rt["states"]) == set(rj["states"])
        for key in ("data_dir", "start_frame", "scene_fpath", "max_pixel_err", "outliers"):
            assert rt[key] == rj[key], key
        assert rt["positions"].shape == (n, 20, 3)
        for key, w in list(rj["states"].items()) + [("positions", rj["positions"])]:
            g = rt["positions"] if key == "positions" else rt["states"][key]
            assert g.shape == w.shape, key
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8 * np.abs(w).max(), err_msg=key)
    assert {r["max_pixel_err"] for r in got} == {2704.0, 1920.0}


def test_ekf_warm_starts_take_port_results(batch_pair):
    """ekf_warm_starts reads the port's results unchanged, and they drive
    solve_batch's warm path (X0_override, plain_iters=4)."""
    got, want = batch_pair
    warm = tsweep.ekf_warm_starts(got)
    for a, b, n in zip(warm, jsweep.ekf_warm_starts(want), LENGTHS):
        assert a.shape == (n, N_POSE) and a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())
    res = tsweep.solve_batch(_runs(tsweep), 0.5, num_iters=2, device="cpu", dtype=torch.float64,
                             X0_override=warm, plain_iters=4)
    for r, n in zip(res, LENGTHS):
        assert r["x"].shape == (n, N_POSE) and np.isfinite(r["x"]).all()


def test_solve_batch_ekf_chunked_matches_unchunked():
    """7 runs in chunks of 3 (3, 3, and 1 padded to 3): bit for bit the
    padded chunks solved by hand, and the unchunked batch at
    tests/test_sweep.py's tolerance (rtol 1e-5, atol 1e-7) with equal
    outlier counts."""
    runs = _runs(tsweep, lengths=(12, 16, 10, 14, 16, 11, 13))
    kw = dict(device="cpu", dtype=torch.float64, pad_frames=16, pad_cams=3)
    chunked = tsweep.solve_batch_ekf(runs, 0.5, max_batch=3, **kw)
    manual = []
    for lo in range(0, 7, 3):
        chunk = runs[lo:lo + 3]
        manual += tsweep.solve_batch_ekf(chunk + [chunk[-1]] * (3 - len(chunk)), 0.5,
                                         max_batch=None, **kw)[:len(chunk)]
    full = tsweep.solve_batch_ekf(runs, 0.5, max_batch=None, **kw)
    assert len(chunked) == len(manual) == len(full) == 7
    for rc, rm, rf in zip(chunked, manual, full):
        for key, v in rc["states"].items():
            np.testing.assert_array_equal(v, rm["states"][key])
        np.testing.assert_allclose(rc["states"]["smoothed_x"], rf["states"]["smoothed_x"],
                                   rtol=1e-5, atol=1e-7)
        assert rc["outliers"] == rm["outliers"] == rf["outliers"]


def test_ekf_mem_cap_pins_h100_envelope():
    """The cap spends at most the budget, 82.5% of the H100's 80e9 bytes
    (the JAX package's 13e9 of a 15.75e9 v5e), at 9.5 full-state float32
    buffers a run; one more run would exceed it."""
    assert tsweep.EKF_HBM_BUDGET == pytest.approx(80e9 * 13e9 / 15.75e9, rel=1e-3)
    for N, n_pose in ((100, 25), (600, 25), (300, 48), (20000, 25)):
        per_run = 9.5 * N * (3 * n_pose) ** 2 * 4
        cap = tsweep._ekf_mem_cap(N, n_pose)
        assert cap * per_run <= tsweep.EKF_HBM_BUDGET < (cap + 1) * per_run or cap == 1
    assert tsweep._ekf_mem_cap(100, 25) == 3087  # 21.4 MB a run at N=100
    assert tsweep._ekf_mem_cap(600, 25) >= 96 * 5  # the JAX package's N=600 batch, 5x over
    assert tsweep._ekf_mem_cap(10 ** 6, 25) == 1


def test_chip_smoke_marker_bound_is_set_from_jax_float32():
    """chip_smoke.py's ekf phase bounds the median per-run smoothed marker
    error of the 128 sweep runs from the JAX package's float32 value on
    eight of them (the first of each rig). Both packages diverge on some
    runs from the cold line-fit init, so the median is the statistic."""
    runs, truth = chip_smoke.make_sweep_runs()
    sub = list(range(0, len(runs), 16))
    jr = jsweep.solve_batch_ekf([jsweep.RunData(**vars(runs[i])) for i in sub], 0.5,
                                dtype=jnp.float32)
    tr = tsweep.solve_batch_ekf([runs[i] for i in sub], 0.5, device="cpu", dtype=torch.float32)

    def median_err(res):
        return float(np.median([np.mean(np.linalg.norm(r["positions"] - truth[i], axis=-1))
                                for r, i in zip(res, sub)]))

    jax_med = median_err(jr)
    assert jax_med == pytest.approx(chip_smoke.EKF_JAX_F32_MEDIAN_ERR_M, rel=0.02)
    assert median_err(tr) <= chip_smoke.EKF_MARKER_ERR_BOUND_M


if __name__ == "__main__":
    write_ekf_golden()
    print(f"wrote {GOLDEN}")
