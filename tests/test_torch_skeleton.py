"""The port's generic skeleton model (acinoset_tpu_torch.models.skeleton
and models.cheetah.to_skeleton_dict) against the JAX package's, in
float64 on the CPU, for every skeleton built here (nothing is read from
disk) in both compat modes:

  * ``tree``: the 3-link tree of tests/test_sweep.py's generic harness;
  * ``cheetah``: ``cheetah.to_skeleton_dict()`` (20 markers, n_pose 63),
    compiled with ``allow_fk_mismatch=True``;
  * ``dag``: a part (``pelvis``) that is the child of two links, the
    shipped human's ``hip1`` case, so compat="tpu" takes the DAG path;
  * ``reordered``: a tree whose ``markers`` list is not in link-walk
    order, so the row order of the two modes differs.

Tolerance: 1e-12 absolute on poses of scale 0.5 with leading dimensions
(B, N) = (2, 3): FK and Jacobians are closed forms of the same
arithmetic in both packages, which agree to ~1e-15 here.

The helpers at the bottom (``render_runs``) render seeded measurements
through the JAX FK and projection for tests/test_torch_generic.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acinoset_tpu.models import cheetah as jch
from acinoset_tpu.models import skeleton as jsk
from acinoset_tpu.ops import camera as jcam
from acinoset_tpu_torch.models import cheetah as tch
from acinoset_tpu_torch.models import skeleton as tsk
from acinoset_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)
TOL = 1e-12

TREE = dict(
    links=[["root"], ["root", "mid"], ["mid", "tip"]],
    positions=dict(root=[0.0, 0.0, 0.0], mid=[0.4, 0.0, 0.0], tip=[0.8, 0.0, 0.0]),
    dofs=dict(root=[1, 1, 1], mid=[0, 1, 1], tip=[0, 1, 0]),
    markers=["root", "mid", "tip"],
)

#: pelvis hangs from both hips (last writer wins on its position; both
#: hips' rotations compose into its frame); 'neck' is a marker, so the
#: generic FTE's default exclude_markers=("neck",) drops it; 'knee' is
#: a part that no marker names and a link reaches; 'toe' no link reaches
DAG = dict(
    links=[["forehead"], ["forehead", "neck"], ["neck", "l_hip"], ["neck", "r_hip"],
           ["l_hip", "pelvis"], ["r_hip", "pelvis"], ["pelvis", "knee"], ["knee", "ankle"]],
    positions=dict(forehead=[0.0, 0.0, 0.8], neck=[0.0, 0.0, 0.6], l_hip=[0.0, 0.15, 0.2],
                   r_hip=[0.0, -0.15, 0.2], pelvis=[0.05, 0.0, 0.1], knee=[0.1, 0.0, -0.3],
                   ankle=[0.1, 0.0, -0.7], toe=[0.2, 0.0, -0.75]),
    dofs=dict(forehead=[1, 1, 1], neck=[1, 0, 1], l_hip=[0, 1, 1], r_hip=[1, 1, 0],
              pelvis=[0, 0, 1], knee=[0, 1, 0], ankle=[1, 1, 1], toe=[0, 1, 0]),
    markers=["forehead", "neck", "l_hip", "r_hip", "pelvis", "ankle", "toe"],
)

#: the walk order is base, a1, a2, b1, b2; the markers list is not
REORDERED = dict(
    links=[["base"], ["base", "a1"], ["a1", "a2"], ["base", "b1"], ["b1", "b2"]],
    positions=dict(base=[0.0, 0.0, 0.5], a1=[0.3, 0.1, 0.5], a2=[0.6, 0.1, 0.4],
                   b1=[-0.3, -0.1, 0.5], b2=[-0.5, -0.1, 0.3]),
    dofs=dict(base=[1, 1, 1], a1=[0, 1, 1], a2=[0, 1, 0], b1=[1, 0, 1], b2=[0, 0, 1]),
    markers=["b2", "a1", "base", "a2", "b1"],
)

SKELETONS = {
    "tree": (TREE, {}),
    "cheetah": (tch.to_skeleton_dict(), dict(allow_fk_mismatch=True)),
    "dag": (DAG, {}),
    "reordered": (REORDERED, {}),
}
CASES = [(name, compat) for name in SKELETONS for compat in ("tpu", "reference")]


def build_pair(name, compat="tpu"):
    """(JAX model, port model) of one skeleton."""
    sd, kw = SKELETONS[name]
    return (jsk.build_skeleton_model(sd, compat=compat, **kw),
            tsk.build_skeleton_model(sd, compat=compat, **kw))


def _poses(n_pose, seed=0):
    return np.random.default_rng(seed).normal(scale=0.5, size=(2, 3, n_pose))


def _jax_batched(f, x):
    return jax.jit(jax.vmap(jax.vmap(f)))(jnp.asarray(x))


def _path(model):
    return None if model.fk_and_jac is None else model.fk_and_jac.__name__


def test_to_skeleton_dict_matches_jax():
    got, want = tch.to_skeleton_dict(), jch.to_skeleton_dict()
    assert set(got) == set(want)
    for key in want:
        if key != "positions":
            assert got[key] == want[key], key
    assert list(got["positions"]) == list(want["positions"])
    for m, p in want["positions"].items():
        np.testing.assert_allclose(got["positions"][m], p, rtol=0, atol=TOL, err_msg=m)


@pytest.mark.parametrize("name,compat", CASES)
def test_model_metadata_matches_jax(name, compat):
    """Pose layout, names, dofs, active indices, limits and which
    Jacobian path the builder chose (tree, DAG or none)."""
    mj, mt = build_pair(name, compat)
    assert mt.n_pose == mj.n_pose and mt.n_markers == mj.n_markers
    assert mt.parts == mj.parts and mt.markers == mj.markers and mt.dofs == mj.dofs
    np.testing.assert_array_equal(mt.active_idx, mj.active_idx)
    for a, b in zip(tsk.generic_pose_limits(mt), jsk.generic_pose_limits(mj)):
        np.testing.assert_array_equal(a, b)
    assert _path(mt) == _path(mj)
    expected = {"tpu": "fk_and_jac_dag" if name == "dag" else "fk_and_jac",
                "reference": None}[compat]
    assert _path(mt) == expected


@pytest.mark.parametrize("name,compat", CASES)
def test_fk_matches_jax(name, compat):
    mj, mt = build_pair(name, compat)
    x = _poses(mj.n_pose)
    got = mt.fk(torch.tensor(x))
    assert got.shape == (2, 3, len(mj.fk(jnp.zeros(mj.n_pose))), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_batched(mj.fk, x)), rtol=0, atol=TOL)


@pytest.mark.parametrize("name,compat", CASES)
def test_fk_jacobians_match_jax_and_jacfwd(name, compat):
    """``fk_and_jac`` against the JAX analytic Jacobian, ``fk_and_jac_any``
    against ``jax.jacfwd(fk)``, and the port's analytic Jacobian against
    its own ``torch.func.jacfwd`` fallback (the model with
    ``fk_and_jac=None``)."""
    mj, mt = build_pair(name, compat)
    x = _poses(mj.n_pose, seed=1)
    xt = torch.tensor(x)
    pts_j = np.asarray(_jax_batched(mj.fk, x))
    jac_j = np.asarray(_jax_batched(jax.jacfwd(mj.fk), x))
    pts, J = tsk.fk_and_jac_any(mt)(xt)
    assert J.shape == (2, 3) + pts_j.shape[2:] + (mj.n_pose,)
    np.testing.assert_allclose(pts.numpy(), pts_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(J.numpy(), jac_j, rtol=0, atol=TOL)
    if mt.fk_and_jac is not None:
        pa_j, Ja_j = _jax_batched(mj.fk_and_jac, x)
        np.testing.assert_allclose(J.numpy(), np.asarray(Ja_j), rtol=0, atol=TOL)
        np.testing.assert_allclose(pts.numpy(), np.asarray(pa_j), rtol=0, atol=TOL)
        fallback = tsk.SkeletonModel(**{**vars(mt), "fk_and_jac": None})
        pf, Jf = tsk.fk_and_jac_any(fallback)(xt)
        np.testing.assert_allclose(Jf.numpy(), J.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(pf.numpy(), pts.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(SKELETONS))
def test_fk_makes_no_host_copy_after_the_first_call(name, monkeypatch):
    """The static tables reach a device once per (dtype, device): a second
    call of the FK and its Jacobian builds no tensor from host data (on
    the card each such copy synchronises the stream)."""
    _mj, mt = build_pair(name)
    x = torch.tensor(_poses(mt.n_pose))
    mt.fk_and_jac(x)

    def refuse(*_a, **_k):
        raise AssertionError("host-to-device copy in the FK")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    mt.fk(x)
    mt.fk_and_jac(x)


def test_refusals_match_jax():
    """An exported dict (fk_equivalent=False) and an unknown compat mode
    raise ValueError in both packages."""
    sd = tch.to_skeleton_dict()
    for build in (jsk.build_skeleton_model, tsk.build_skeleton_model):
        with pytest.raises(ValueError, match="interchange"):
            build(sd)
        with pytest.raises(ValueError, match="unknown compat"):
            build(TREE, compat="pose")


def test_chip_smoke_skeletons_match_jax():
    """The generic phase's skeletons at their stated widths and paths:
    the cheetah tree (20 markers, n_pose 63, tree Jacobian), the
    human-width DAG (15 markers, n_pose 48, DAG Jacobian) and the 3-link
    tree (n_pose 12, under the banded kernel's P <= 32), each with FK and
    Jacobian parity to the JAX package."""
    import chip_smoke

    for sd, kw, L, P, path in ((tch.to_skeleton_dict(), dict(allow_fk_mismatch=True), 20, 63,
                                "fk_and_jac"),
                               (chip_smoke.HUMAN_DAG, {}, 15, 48, "fk_and_jac_dag"),
                               (chip_smoke.TREE3, {}, 3, 12, "fk_and_jac")):
        mj, mt = jsk.build_skeleton_model(sd, **kw), tsk.build_skeleton_model(sd, **kw)
        assert (mt.n_markers, mt.n_pose, _path(mt), _path(mj)) == (L, P, path, path)
        x = _poses(P, seed=2)
        pts, J = mt.fk_and_jac(torch.tensor(x))
        pa_j, Ja_j = _jax_batched(mj.fk_and_jac, x)
        np.testing.assert_allclose(pts.numpy(), np.asarray(pa_j), rtol=0, atol=TOL)
        np.testing.assert_allclose(J.numpy(), np.asarray(Ja_j), rtol=0, atol=TOL)


# ---- measurements for tests/test_torch_generic.py ----

def render_runs(module, name, lengths, n_cams=4, fps=90.0, seed=0, noise_px=1.0,
                compat="tpu"):
    """Seeded runs of skeleton ``name``, one per length, as ``module``'s
    RunData (either package's sweep): a root line plus sinusoidal angles
    of amplitude 0.3 (tests/test_sweep.py's generic harness), rendered
    through the JAX FK and ``project_points_fisheye`` on a
    ``ring_cameras(n_cams)`` rig, with Gaussian pixel noise and all
    likelihoods 1. Returns (runs, ground-truth FK rows per run)."""
    sd, kw = SKELETONS[name]
    model = jsk.build_skeleton_model(sd, compat=compat, **kw)
    k, d, r, t, res = tsyn.ring_cameras(n_cams=n_cams)
    rng = np.random.default_rng(seed)
    runs, truth = [], []
    for ri, n in enumerate(lengths):
        tt = np.arange(n) / fps
        X = np.zeros((n, model.n_pose))
        X[:, 0] = -1.0 + 6.0 * tt
        X[:, 1] = 0.2 * np.sin(2 * np.pi * tt + ri)
        X[:, 2] = 0.6 + 0.05 * np.sin(2 * np.pi * 2 * tt)
        X[:, 3:] = 0.3 * np.sin(2 * np.pi * tt[:, None] * rng.uniform(0.5, 1.5, model.n_pose - 3)
                                + rng.uniform(0, 6, model.n_pose - 3))
        pts = jax.vmap(model.fk)(jnp.asarray(X))
        pix = np.stack([np.asarray(jcam.project_points_fisheye(
            pts, jnp.asarray(k[c]), jnp.asarray(d[c]), jnp.asarray(r[c]), jnp.asarray(t[c])))
            for c in range(n_cams)])  # (C, n, L, 2)
        pix = pix + rng.normal(scale=noise_px, size=pix.shape)
        lik = np.ones(pix.shape[:3])
        runs.append(module.RunData(
            data_dir=f"{name}_run_{ri}", pixels=pix, likelihood=lik,
            cams=(k, d.reshape(-1, 4), r, t.reshape(-1, 3)), fps=fps, start_frame=0,
            scene_fpath="", cam_res=res))
        truth.append(np.asarray(pts))
    return runs, truth
