"""The port's ops, model and measurement functions against the JAX
package on the same float64 inputs (numpy, from a seed), at 1e-10:
both evaluate the same closed forms, so they differ only by float64
rounding."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acinoset_tpu.models import cheetah as jcheetah
from acinoset_tpu.ops import camera as jcam
from acinoset_tpu.ops import losses as jlosses
from acinoset_tpu.ops import rotations as jrot
from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu_torch.models import cheetah as tcheetah
from acinoset_tpu_torch.ops import camera as tcam
from acinoset_tpu_torch.ops import losses as tlosses
from acinoset_tpu_torch.ops import rotations as trot
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-10)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def rig():
    k, d, r, t, _res = tsyn.ring_cameras(n_cams=3)
    return k, d, r, t


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(0)
    X = tsyn.cheetah_gallop(N=7)
    return X + rng.normal(scale=0.05, size=X.shape)


@pytest.mark.parametrize("name", ["mm3", "mvT3", "mv3"])
def test_rotation_products(name):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(5, 3, 3))
    B = rng.normal(size=(5, 3, 3)) if name == "mm3" else rng.normal(size=(5, 3))
    close(getattr(trot, name)(T(A), T(B)), getattr(jrot, name)(jnp.asarray(A), jnp.asarray(B)))


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z"])
def test_frame_rotations(name):
    a = np.random.default_rng(2).uniform(-3, 3, size=(6,))
    close(getattr(trot, name)(T(a)), jax.vmap(getattr(jrot, name))(jnp.asarray(a)))


def test_rodrigues_including_small_angles():
    rng = np.random.default_rng(3)
    rv = np.concatenate([rng.normal(size=(6, 3)), 1e-8 * rng.normal(size=(2, 3)), np.zeros((1, 3))])
    close(trot.rodrigues(T(rv)), jrot.rodrigues(jnp.asarray(rv)))


@pytest.mark.parametrize(
    "name,args",
    [
        ("redescending_loss", (3.0, 10.0, 20.0)),
        ("redescending_weight", (3.0, 10.0, 20.0)),
        ("huber_loss", (3.0,)),
        ("huber_weight", (3.0,)),
        ("cauchy_loss", (4.0,)),
        ("cauchy_weight", (4.0,)),
    ],
)
def test_losses(name, args):
    e = np.concatenate([np.linspace(-30, 30, 241), [0.0, 3.0, 10.0, 20.0]])
    close(getattr(tlosses, name)(T(e), *args), getattr(jlosses, name)(jnp.asarray(e), *args))


def _points(rng, n=40):
    return rng.uniform(-2, 2, size=(n, 3)) + np.array([0.0, 0.0, 0.5])


def test_distort_theta(rig):
    th = np.linspace(0.0, 1.4, 50)
    D = rig[1][0]
    close(tcam.distort_theta(T(th), T(D)), jcam.distort_theta(jnp.asarray(th), jnp.asarray(D)))


@pytest.mark.parametrize("cam", [0, 2])
def test_project_points_fisheye(rig, cam):
    k, d, r, t = (a[cam] for a in rig)
    pts = _points(np.random.default_rng(4))
    close(tcam.project_points_fisheye(T(pts), k, d, r, t),
          jcam.project_points_fisheye(jnp.asarray(pts), k, d, r, t))


def test_project_points_fisheye_and_jac_vs_jax_and_jacfwd(rig):
    k, d, r, t = (a[1] for a in rig)
    pts = _points(np.random.default_rng(5))
    uv, J = tcam.project_points_fisheye_and_jac(T(pts), k, d, r, t)
    juv, jJ = jcam.project_points_fisheye_and_jac(jnp.asarray(pts), k, d, r, t)
    close(uv, juv)
    close(J, jJ)
    # the closed-form Jacobian equals forward-mode autodiff of the projection
    jf = torch.func.vmap(torch.func.jacfwd(
        lambda p: tcam.project_points_fisheye(p, k, d, r, t)))(T(pts))
    close(J, jf.numpy())


def test_project_rig_and_jac(rig):
    k, d, r, t = rig
    pts = _points(np.random.default_rng(6), n=20)
    h, Jp = tcam.project_rig_and_jac(T(pts), T(k), T(d), T(r), T(t))
    jh, jJp = jcam.project_rig_and_jac(
        jnp.asarray(pts), jnp.asarray(k), jnp.asarray(d), jnp.asarray(r),
        jnp.asarray(t).reshape(-1, 3))
    close(h, jh)
    close(Jp, jJp)


def test_undistort_theta_and_points(rig):
    k, d = rig[0][0], rig[1][0]
    th_d = np.linspace(0.01, 1.3, 30)
    close(tcam.undistort_theta(T(th_d), T(d)), jcam.undistort_theta(jnp.asarray(th_d), jnp.asarray(d)))
    px = np.random.default_rng(7).uniform([100, 100], [2600, 1400], size=(25, 2))
    close(tcam.undistort_points_fisheye(T(px), k, d), jcam.undistort_points_fisheye(jnp.asarray(px), k, d))
    close(tcam.undistort_points_fisheye(T(px), k, d, P=k),
          jcam.undistort_points_fisheye(jnp.asarray(px), k, d, P=jnp.asarray(k)))


def test_dlt_and_triangulate_points(rig):
    k, d, r, t = rig
    pts = _points(np.random.default_rng(8), n=30)
    p1 = np.asarray(jcam.project_points_fisheye(jnp.asarray(pts), k[0], d[0], r[0], t[0]))
    p2 = np.asarray(jcam.project_points_fisheye(jnp.asarray(pts), k[1], d[1], r[1], t[1]))
    xyz = tcam.triangulate_points_fisheye(T(p1), T(p2), k[0], d[0], r[0], t[0], k[1], d[1], r[1], t[1])
    jxyz = jcam.triangulate_points_fisheye(p1, p2, k[0], d[0], r[0], t[0], k[1], d[1], r[1], t[1])
    close(xyz, jxyz, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(xyz.numpy(), pts, atol=1e-6)  # exact rays meet at the point
    ab = np.random.default_rng(9).normal(scale=0.3, size=(2, 2))
    P1 = np.concatenate([r[0], t[0].reshape(3, 1)], 1)
    P2 = np.concatenate([r[1], t[1].reshape(3, 1)], 1)
    close(tcam._dlt_one(T(ab[0]), T(ab[1]), T(P1), T(P2)), jcam._dlt_one(ab[0], ab[1], P1, P2))


def test_triangulate_pairwise_mean_with_masks(rig, poses):
    k, d, r, t = rig
    px, lik, _ = tsyn.render_measurements(poses, (*rig, (2704, 1520)), seed=4)
    valid = lik > 0.5
    valid[1, 2] = False  # a frame where the middle camera saw nothing
    p3, seen = tcam.triangulate_pairwise_mean(T(px), torch.as_tensor(valid), T(k), T(d), T(r), T(t))
    jp3, jseen = jcam.triangulate_pairwise_mean(jnp.asarray(px), jnp.asarray(valid), k, d, r, t)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    close(p3, jp3, rtol=1e-10, atol=1e-9)


def test_model_tables():
    for name in ["Q_VAR", "ACTIVE_IDX", "ACTIVE_IDX_ORDERED", "FTE_SAVE_ORDER", "_JAC_MSA"]:
        np.testing.assert_array_equal(getattr(tcheetah, name), getattr(jcheetah, name))
    assert tcheetah.get_markers() == jcheetah.get_markers()
    assert tcheetah.get_pose_params() == jcheetah.get_pose_params()
    assert tcheetah.MARKER_SPECS == jcheetah.MARKER_SPECS
    assert dict(tcheetah.JOINTS) == dict(jcheetah.JOINTS)
    assert (tcheetah.MEAS_STD_PX, tcheetah.REDESC_A, tcheetah.REDESC_B, tcheetah.REDESC_C) == (
        jcheetah.MEAS_STD_PX, jcheetah.REDESC_A, jcheetah.REDESC_B, jcheetah.REDESC_C)
    for t_, j_ in zip(tcheetah.pose_limits_25(), jcheetah.pose_limits_25()):
        np.testing.assert_array_equal(t_, j_)


def test_pose_order_helpers(poses):
    x = T(poses)
    close(tcheetah.expand_pose(x), jcheetah.expand_pose(jnp.asarray(poses)))
    close(tcheetah.compress_pose(tcheetah.expand_pose(x)), poses)
    close(tcheetah.to_fte_order(x), jcheetah.to_fte_order(poses))
    close(tcheetah.from_fte_order(tcheetah.to_fte_order(x)), poses)


def test_fk_and_fk25(poses):
    x45 = np.asarray(jcheetah.expand_pose(jnp.asarray(poses)))
    close(tcheetah.fk(T(x45)), jax.vmap(jcheetah.fk)(jnp.asarray(x45)))
    close(tcheetah.fk25(T(poses)), jax.vmap(jcheetah.fk25)(jnp.asarray(poses)))


def test_fk25_and_jac_vs_jax_and_jacfwd(poses):
    pts, J = tcheetah.fk25_and_jac(T(poses))
    jpts, jJ = jax.vmap(jcheetah.fk25_and_jac)(jnp.asarray(poses))
    close(pts, jpts)
    close(J, jJ)
    jf = torch.func.vmap(torch.func.jacfwd(tcheetah.fk25))(T(poses))
    close(J, jf.numpy())


def test_make_h_fn(rig, poses):
    h = tekf.make_h_fn(*rig, device="cpu")(T(poses))
    jh = jax.vmap(jekf.make_h_fn(*rig))(jnp.asarray(poses))
    close(h, jh)


def test_make_hj_parts_fn_and_aux(rig, poses):
    out = tekf.make_hj_parts_fn(*rig, device="cpu")(T(poses))
    jout = jax.vmap(jekf.make_hj_parts_fn(*rig))(jnp.asarray(poses))
    for a, b in zip(out, jout):
        close(a, b)
    aux = tuple(T(a) for a in rig)
    for a, b in zip(tekf.hj_parts_aux(T(poses), aux), jout):
        close(a, b)


def test_nose_track_linreg_is_the_same_function():
    rng = np.random.default_rng(10)
    pos = rng.normal(size=(12, 20, 3))
    pos[3] = np.nan
    frames = np.arange(12)
    assert tekf.nose_track_linreg(pos, frames, 2) == jekf.nose_track_linreg(pos, frames, 2)
