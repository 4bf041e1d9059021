"""The port's SBA slice (acinoset_tpu_torch.solvers.lm, pipeline.sba,
ops.rotations.rodrigues_inv and the pinhole/DLT camera ops) against the
JAX package's, in float64 on the CPU, with the same seeded numpy inputs
on both sides (tests/sba_calib_cases.py).

Tolerances. Closed forms: 1e-12 (relative), the eigh DLT 1e-10.
lm_dense on small problems: x at 1e-10, cost at 1e-12 (relative) and
lam equal. The SBA solvers run to convergence, where an LM step's
accept/reject is a cost comparison that rounding decides: such a flip
moves a converged point by up to ~sqrt(eps cost / H) (chip_smoke.py's
golden check reads ~1e-8 of scale) while its cost agrees to rounding.
So a converged LM result is held by
its final robust cost at 1e-8 (relative) in place of its states at
1e-8, with the states at 1e-6 beside it; the same solvers cut to the
iterations before the first flip are held at 1e-8 in their states.

The JAX package's float64 outputs on four of these inputs are committed
as tests/golden/sba_calib_synthetic.npz (``python
tests/test_torch_lm_sba.py`` rewrites it), so that chip_smoke.py can
hold the GPU to them without JAX.
"""
import os
import sys

import jax

if __name__ == "__main__":  # writing the golden file: JAX on the CPU in float64
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import sba_calib_cases as cases  # noqa: E402
from acinoset_tpu.calib import extrinsics as jext  # noqa: E402
from acinoset_tpu.calib import intrinsics as jint  # noqa: E402
from acinoset_tpu.ops import camera as jcam  # noqa: E402
from acinoset_tpu.ops import losses as jlosses  # noqa: E402
from acinoset_tpu.ops import rotations as jrot  # noqa: E402
from acinoset_tpu.pipeline import sba as jsba  # noqa: E402
from acinoset_tpu.solvers import lm as jlm  # noqa: E402
from acinoset_tpu_torch.convert import rig_to_torch  # noqa: E402
from acinoset_tpu_torch.ops import camera as tcam  # noqa: E402
from acinoset_tpu_torch.ops import losses as tlosses  # noqa: E402
from acinoset_tpu_torch.ops import rotations as trot  # noqa: E402
from acinoset_tpu_torch.pipeline import sba as tsba  # noqa: E402
from acinoset_tpu_torch.solvers import lm as tlm  # noqa: E402

torch.set_num_threads(2)
SPE_ITERS = 100  # tests/test_sba.py's case
FP_ITERS = 40  # tests/test_calib.py's pair


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


# ---- closed forms ----

def test_rodrigues_inv_matches_jax_batched_with_edge_angles():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-8, 1e-3, 0.7, 2.0, np.pi - 1e-3 + 1e-5, np.pi - 5e-4, np.pi - 1e-7])
    R = np.asarray(jrot.rodrigues(axes * angles[:, None])).reshape(2, 4, 3, 3)  # batched (2, 4)
    got = trot.rodrigues_inv(T(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrot.rodrigues_inv(R)), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[0, 0], 0.0)


def _pinhole_cams():
    K = np.array([[820.0, 1.5, 640.0], [0, 810.0, 360.0], [0, 0, 1]])
    D = np.array([0.08, -0.03, 0.0005, -0.001, 0.005, 0.01, -0.01, 0.002])
    R2 = np.asarray(jrot.rodrigues(np.array([0.05, -0.2, 0.03])))
    return K, D, np.eye(3), np.zeros((3, 1)), R2, np.array([[0.6], [0.0], [0.1]])


@pytest.mark.parametrize("n_coef", [8, 5, 14])
def test_pinhole_ops_match_jax(n_coef):
    """project_points_pinhole, undistort_points_pinhole and
    triangulate_points at 1e-12 (relative), with D of 5, 8 and 14
    coefficients (the ops take the first 8, zero-padded)."""
    rng = np.random.default_rng(1)
    K, D8, R1, t1, R2, t2 = _pinhole_cams()
    D = np.concatenate([D8, rng.normal(scale=1e-3, size=6)])[:n_coef]
    world = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.5, 0.5, 40),
                      rng.uniform(1.5, 4.0, 40)], axis=1)
    tol = dict(rtol=1e-12, atol=0)
    p1 = tcam.project_points_pinhole(T(world), T(K), T(D), T(R1), T(t1)).numpy()
    np.testing.assert_allclose(p1, np.asarray(jcam.project_points_pinhole(world, K, D, R1, t1)),
                               **tol)
    p2 = np.asarray(jcam.project_points_pinhole(world, K, D, R2, t2))
    ab = tcam.undistort_points_pinhole(T(p2), T(K), T(D)).numpy()
    np.testing.assert_allclose(ab, np.asarray(jcam.undistort_points_pinhole(p2, K, D)),
                               rtol=1e-12, atol=1e-12 * np.abs(ab).max())
    tri = tcam.triangulate_points(T(p1), T(p2), T(K), T(D), T(R1), T(t1), T(K), T(D), T(R2),
                                  T(t2)).numpy()
    np.testing.assert_allclose(tri, np.asarray(jcam.triangulate_points(p1, p2, K, D, R1, t1, K, D,
                                                                        R2, t2)), **tol)


def test_dlt_one_eigh_matches_jax():
    rng = np.random.default_rng(2)
    K, D, R1, t1, R2, t2 = _pinhole_cams()
    P1 = np.concatenate([R1, t1], 1)
    P2 = np.concatenate([R2, t2], 1)
    world = rng.uniform(-0.5, 0.5, (30, 3)) + [0, 0, 3.0]
    ab1 = (world @ R1.T + t1.T)[:, :2] / (world @ R1.T + t1.T)[:, 2:]
    ab2 = (world @ R2.T + t2.T)[:, :2] / (world @ R2.T + t2.T)[:, 2:]
    ab1 += rng.normal(scale=1e-3, size=ab1.shape)
    got = tcam._dlt_one_eigh(T(ab1), T(ab2), T(P1), T(P2)).numpy()
    want = np.stack([np.asarray(jcam._dlt_one_eigh(a, b, P1, P2)) for a, b in zip(ab1, ab2)])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


# ---- lm_dense ----

def _curve():
    """y = a exp(b t) + c with 1% noise and three gross outliers."""
    rng = np.random.default_rng(3)
    t = np.linspace(0.0, 2.0, 40)
    y = 1.5 * np.exp(-1.2 * t) + 0.3 + rng.normal(scale=0.01, size=t.shape)
    y[[5, 17, 30]] += [0.8, -0.6, 1.1]
    return t, y, np.array([1.0, -0.5, 0.0])


LM_CASES = {
    "plain": {},
    "irls": dict(weight=True),
    "robust": dict(weight=True, loss=True),
    "robust_clipped": dict(weight=True, loss=True, max_step=0.05),
}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_dense_matches_jax(case):
    """A small curve fit, plain, with IRLS weights alone, with the true
    robust cost for accept/reject, and with max_step: x at 1e-10, cost at
    1e-12 (relative), lam equal; plus the same problem batched three ways
    (the JAX package vmaps it) against a JAX vmap. 8 iterations: the fits
    are near their minima, and rounding decides no step yet."""
    kw = LM_CASES[case]
    t, y, x0 = _curve()

    def jres(x):
        return x[0] * jnp.exp(x[1] * t) + x[2] - y

    def tres(x, tt=T(t), yy=T(y)):
        return x[0] * torch.exp(x[1] * tt) + x[2] - yy

    jw = (lambda r: jlosses.cauchy_weight(r, 0.1)) if kw.get("weight") else None
    tw = (lambda r: tlosses.cauchy_weight(r, 0.1)) if kw.get("weight") else None
    jl = (lambda r: jlosses.cauchy_loss(r, 0.1)) if kw.get("loss") else None
    tl = (lambda r: tlosses.cauchy_loss(r, 0.1)) if kw.get("loss") else None
    ms = kw.get("max_step")
    want = jlm.lm_dense(jres, jnp.asarray(x0), num_iters=8, weight_fn=jw, loss_fn=jl, max_step=ms)
    got = tlm.lm_dense(tres, T(x0), num_iters=8, weight_fn=tw, loss_fn=tl, max_step=ms)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-10)
    for key in ("cost", "cost0"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   rtol=1e-12)
    assert float(got.lam) == float(want.lam)

    x0s = x0 + np.array([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1], [-0.2, 0.3, 0.1]])
    ys = y + np.array([[0.0], [0.05], [-0.05]])
    want = jax.vmap(lambda a, yy: jlm.lm_dense(lambda x: x[0] * jnp.exp(x[1] * t) + x[2] - yy, a,
                                               num_iters=8, weight_fn=jw, loss_fn=jl,
                                               max_step=ms))(jnp.asarray(x0s), jnp.asarray(ys))
    got = tlm.lm_dense(lambda x, yy: tres(x, yy=yy), T(x0s), num_iters=8, weight_fn=tw, loss_fn=tl,
                       max_step=ms, args=(T(ys),))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-12)
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(want.lam))


@pytest.mark.parametrize("num_iters", [1, 6])
def test_lm_dense_rejects_a_singular_step(num_iters):
    """With lam0 = 0 the first system, diag(0, 1) at x0 = (0, 0.5), is
    exactly singular: the step is non-finite and must be rejected, not
    raise (torch.linalg.solve would raise), as the JAX package's
    jnp.linalg.solve inf/nan is; after it the clipped damping (1e-12)
    makes the system solvable."""
    def jres(x):
        return jnp.stack([x[0] * x[0] - 1.0, x[1] - 2.0])

    def tres(x):
        return torch.stack([x[0] * x[0] - 1.0, x[1] - 2.0])

    x0 = np.array([0.0, 0.5])
    want = jlm.lm_dense(jres, jnp.asarray(x0), num_iters=num_iters, lam0=0.0)
    got = tlm.lm_dense(tres, T(x0), num_iters=num_iters, lam0=0.0)
    if num_iters == 1:
        np.testing.assert_array_equal(got.x.numpy(), x0)
        assert float(got.lam) == 1e-12
    else:
        assert abs(float(got.x[1]) - 2.0) < 1e-9
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-12)
    assert float(got.lam) == float(want.lam)


# ---- SBA ----

SCENES = {"4cam_n20": cases.sba_scene, "6cam_masked": cases.sba_scene_masked}


@pytest.fixture(scope="module")
def jax_sba():
    """The JAX package's sba_run (its defaults: 30 iterations, f_scale 50)
    on each scene, computed once."""
    out = {}
    for name, make in SCENES.items():
        px, valid, (k, d, r, t), _ = make()
        out[name] = jsba.sba_run(px, valid, k, d, r, t)
    return out


def _point_costs(residuals, n):
    return chip_smoke._point_costs(residuals, n, 50.0)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_robust_triangulation_init_matches_jax_pair_by_pair(scene):
    """The init, and so each point's chosen camera pair, equals the JAX
    package's: every point of the 4-camera scene is seen by an even
    number of cameras, where jnp.nanmedian averages the two middle
    errors. With torch.nanmedian (the lower one) the port would choose
    another pair for many points; the test shows that too."""
    px, valid, cams, _ = SCENES[scene]()
    pix = np.nan_to_num(px)
    want, seen_j = (np.asarray(a) for a in jsba._robust_triangulation_init(pix, valid, *cams))
    rig = rig_to_torch(*cams, "cpu")
    args = (T(pix), torch.tensor(valid), *rig)
    got, seen = tsba._robust_triangulation_init(*args)
    np.testing.assert_array_equal(seen.numpy(), seen_j)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    tris, scores, _ = tsba._pair_candidates(*args)
    pair_port = scores.argmin(0).numpy()
    pair_jax = np.abs(tris.numpy() - want.reshape(1, -1, 3)).max(-1).argmin(0)
    s = seen_j.reshape(-1)
    np.testing.assert_array_equal(pair_port[s], pair_jax[s])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsba, "_nanmedian", lambda x, dim=-1: torch.nanmedian(x, dim).values)
        _, lower, _ = tsba._pair_candidates(*args)
    n_other = int((lower.argmin(0).numpy()[s] != pair_jax[s]).sum())
    if scene == "4cam_n20":
        assert n_other > 0, "the even-count case does not tell the two medians apart"


def test_nanmedian_is_jnp_nanmedian():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 7))
    x[rng.random(x.shape) < 0.4] = np.nan
    x[0] = np.nan
    x[1, :] = [1, 2, 3, 4, np.nan, np.nan, np.nan]
    got = tsba._nanmedian(T(x), -1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(jnp.nanmedian(x, axis=1))))
    np.testing.assert_allclose(got, np.asarray(jnp.nanmedian(x, axis=1)), rtol=1e-15)
    assert got[1] == 2.5


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sba_run_matches_jax(scene, jax_sba):
    """NaN patterns equal, residuals before at 1e-8, the converged
    per-point Cauchy cost at 1e-8 (relative), positions at 1e-6 (see the
    module docstring: rounding decides accept/reject at convergence)."""
    px, valid, cams, _ = SCENES[scene]()
    pos, res = tsba.sba_run(px, valid, *cams, device="cpu")
    want_pos, want_res = jax_sba[scene]
    np.testing.assert_array_equal(np.isnan(pos), np.isnan(want_pos))
    scale = np.abs(want_res["before"]).max()
    np.testing.assert_allclose(res["before"], want_res["before"], rtol=1e-8, atol=1e-8 * scale)
    n = pos.shape[0] * pos.shape[1]
    np.testing.assert_allclose(_point_costs(res["after"], n), _point_costs(want_res["after"], n),
                               rtol=chip_smoke.LM_COST_RTOL)
    np.testing.assert_allclose(pos, want_pos, atol=chip_smoke.LM_STATE_ATOL)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sba_points_matches_jax_before_any_flip(scene):
    """sba_points at 2 iterations (before the first accept/reject flip):
    points and residuals at 1e-8."""
    px, valid, cams, _ = SCENES[scene]()
    pix = np.nan_to_num(px)
    C = pix.shape[0]
    x0, seen = (np.asarray(a) for a in jsba._robust_triangulation_init(pix, valid, *cams))
    obs = pix.transpose(1, 2, 0, 3).reshape(-1, C, 2)
    mask = valid.transpose(1, 2, 0).reshape(-1, C) & seen.reshape(-1)[:, None]
    x0 = x0.reshape(-1, 3)
    want, wres = jlm.sba_points(jnp.asarray(obs), jnp.asarray(mask), *cams, jnp.asarray(x0),
                                num_iters=2)
    got, res = tlm.sba_points(T(obs), torch.tensor(mask), *cams, T(x0), num_iters=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-8)
    for key in ("before", "after"):
        np.testing.assert_allclose(res[key].numpy(), np.asarray(wres[key]), rtol=1e-8, atol=1e-8)


@pytest.fixture(scope="module")
def jax_spe():
    """The JAX package's sba_points_extrinsics on tests/test_sba.py's
    case, at 20 iterations and at that test's 100."""
    obs, mask, k, d, r, t, x0 = cases.extrinsics_case()
    return {it: jlm.sba_points_extrinsics(jnp.asarray(obs), jnp.asarray(mask), k, d, r, t,
                                          jnp.asarray(x0), f_scale=1.0, num_iters=it)
            for it in (20, SPE_ITERS)}


@pytest.mark.parametrize("iters", [20, SPE_ITERS])
def test_sba_points_extrinsics_matches_jax(iters, jax_spe):
    """Points, R and t at 1e-8 after 20 iterations; after 100, where
    rounding flips accept/reject near the optimum, the final Cauchy cost
    at 1e-8 (relative) and points, R and t at 1e-6."""
    obs, mask, k, d, r, t, x0 = cases.extrinsics_case()
    pts, R, tt, res = tlm.sba_points_extrinsics(T(obs), torch.tensor(mask), k, d, r, t, T(x0),
                                                f_scale=1.0, num_iters=iters)
    wp, wR, wt, wres = (np.asarray(a) if not isinstance(a, dict) else a for a in jax_spe[iters])
    atol = 1e-8 if iters == 20 else chip_smoke.LM_STATE_ATOL
    for g, w in ((pts, wp), (R, wR), (tt, wt)):
        np.testing.assert_allclose(g.numpy(), w, atol=atol)
    np.testing.assert_allclose(res["before"].numpy(), np.asarray(wres["before"]), rtol=1e-10,
                               atol=1e-10)
    cost = chip_smoke._point_costs(res["after"].numpy(), 1, 1.0)
    np.testing.assert_allclose(cost, chip_smoke._point_costs(np.asarray(wres["after"]), 1, 1.0),
                               rtol=chip_smoke.LM_COST_RTOL)


# ---- the golden file ----

def golden_inputs():
    """The golden file's inputs: the 4-camera SBA scene, tests/test_sba.py's
    extrinsics case, the F = 12 fisheye intrinsics case with one bad view
    and the fisheye pair."""
    px, valid, (k, d, r, t), _ = cases.sba_scene()
    obs, mask, sk, sd, sr, st, x0 = cases.extrinsics_case()
    fi_obj, fi_img, fi_res = cases.fisheye_intrinsics_case()
    fp_obj, fp_p1, fp_p2, fp_K, fp_D = cases.fisheye_pair_case()
    return dict(
        sba_pixels=px, sba_valid=valid, sba_k=k, sba_d=d, sba_r=r, sba_t=t,
        spe_obs=obs, spe_mask=mask, spe_k=sk, spe_d=sd, spe_r=sr, spe_t=st, spe_x0=x0,
        spe_iters=SPE_ITERS, fi_obj=fi_obj, fi_img=fi_img, fi_res=np.asarray(fi_res),
        fp_obj=fp_obj, fp_p1=fp_p1, fp_p2=fp_p2, fp_K=fp_K, fp_D=fp_D, fp_iters=FP_ITERS,
    )


def jax_golden_sba(sba, spe):
    """The golden file's SBA keys from the JAX package's sba_run and
    sba_points_extrinsics outputs."""
    out = dict(sba_positions=sba[0], sba_before=sba[1]["before"], sba_after=sba[1]["after"],
               spe_pts=spe[0], spe_R=spe[1], spe_T=spe[2], spe_before=spe[3]["before"],
               spe_after=spe[3]["after"])
    return {key: np.asarray(v) for key, v in out.items()}


def jax_golden_calib(cal, pair):
    """The golden file's calibration keys from the JAX package's
    calibrate_fisheye_camera and calibrate_pair_extrinsics_fisheye
    outputs (tests/test_torch_calib.py holds the JAX package to them)."""
    out = {f"fi_{key}": getattr(cal, key) for key in CAL_KEYS}
    out.update(fp_rms=pair[0], fp_R=pair[1], fp_t=pair[2])
    return {key: np.asarray(v) for key, v in out.items()}


CAL_KEYS = ("k", "d", "rvecs", "tvecs", "rms", "frame_rms", "used")


def write_sba_calib_golden(path=chip_smoke.GOLDEN_SBA):
    g = golden_inputs()
    sba = jsba.sba_run(g["sba_pixels"], g["sba_valid"], g["sba_k"], g["sba_d"], g["sba_r"],
                       g["sba_t"])
    spe = jlm.sba_points_extrinsics(
        jnp.asarray(g["spe_obs"]), jnp.asarray(g["spe_mask"]), g["spe_k"], g["spe_d"], g["spe_r"],
        g["spe_t"], jnp.asarray(g["spe_x0"]), f_scale=1.0, num_iters=SPE_ITERS)
    cal = jint.calibrate_fisheye_camera(g["fi_obj"], g["fi_img"], tuple(g["fi_res"]))
    pair = jext.calibrate_pair_extrinsics_fisheye(
        g["fp_obj"], g["fp_p1"], g["fp_p2"], g["fp_K"], g["fp_D"], g["fp_K"], g["fp_D"],
        tuple(g["fi_res"]), num_iters=FP_ITERS)
    np.savez_compressed(path, **g, **jax_golden_sba(sba, spe), **jax_golden_calib(cal, pair))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.GOLDEN_SBA))


def test_port_matches_golden_on_cpu(golden):
    """chip_smoke.py's golden checks, run on the CPU: the same code and
    tolerances hold the card's results to the file."""
    cpu = torch.device("cpu")
    out = chip_smoke.golden_sba_run(cpu, golden)
    out.update(chip_smoke.golden_calib_run(cpu, golden))
    worst = chip_smoke.golden_sba_compare(out, golden)
    assert len(worst) == 16


def test_jax_package_still_reproduces_golden_sba(golden, jax_sba, jax_spe):
    """The file cannot drift from the reference: its inputs are those the
    builders make now (the same seeds), and the JAX package's SBA outputs
    on them (the fixtures' runs) agree with the committed ones at the
    port's tolerances (tests/test_torch_calib.py checks the calibration
    keys)."""
    g = golden_inputs()
    assert sorted(golden) == sorted(list(g) + list(jax_golden_sba(jax_sba["4cam_n20"],
                                                                  jax_spe[SPE_ITERS]))
                                    + [f"fi_{k}" for k in CAL_KEYS] + ["fp_rms", "fp_R", "fp_t"])
    for key, a in g.items():
        np.testing.assert_array_equal(golden[key], a, err_msg=key)
    worst = chip_smoke.golden_sba_compare(jax_golden_sba(jax_sba["4cam_n20"], jax_spe[SPE_ITERS]),
                                          golden)
    assert len(worst) == 7


if __name__ == "__main__":
    write_sba_calib_golden()
