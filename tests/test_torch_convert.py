"""State carried from the JAX package to the port through
acinoset_tpu_torch.convert gives the same measurements and objective."""
from dataclasses import asdict, fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acinoset_tpu.pipeline import ekf as jekf
from acinoset_tpu.pipeline import fte as jfte
from acinoset_tpu.solvers import trajopt as jtraj
from acinoset_tpu.utils import synthetic as jsyn
from acinoset_tpu_torch import convert
from acinoset_tpu_torch.pipeline import ekf as tekf
from acinoset_tpu_torch.solvers import trajopt as ttraj

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    cams = jsyn.ring_cameras(n_cams=3)
    X = jsyn.cheetah_gallop(N=10)
    px, lik, _ = jsyn.render_measurements(X, cams, seed=2)
    rng = np.random.default_rng(3)
    return cams[:4], X + rng.normal(scale=0.02, size=X.shape), px, lik


def test_rig_to_torch_shapes_and_values(run):
    rig = run[0]
    K, D, R, T = convert.rig_to_torch(*rig, device="cpu", dtype=torch.float64)
    assert (K.shape, D.shape, R.shape, T.shape) == ((3, 3, 3), (3, 4), (3, 3, 3), (3, 3))
    np.testing.assert_array_equal(D.numpy(), rig[1].reshape(3, -1)[:, :4])
    np.testing.assert_array_equal(T.numpy(), rig[3].reshape(3, 3))
    K32 = convert.rig_to_torch(*rig, device="cpu", dtype=torch.float32)[0]
    assert K32.dtype == torch.float32


def test_carried_rig_gives_the_same_h(run):
    rig, X, _px, _lik = run
    aux = convert.rig_to_torch(*rig, device="cpu")
    h, Jp, Jfk = tekf.hj_parts_aux(torch.tensor(X), aux)
    jh, jJp, jJfk = jax.vmap(jekf.make_hj_parts_fn(*rig))(jnp.asarray(X))
    for a, b in ((h, jh), (Jp, jJp), (Jfk, jJfk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)


def test_carried_config_gives_the_same_cost(run):
    rig, X, px, lik = run
    jcfg = jfte.default_config(90.0, num_iters=5)
    tcfg = convert.fte_config_from_dict(asdict(jcfg))
    assert [f.name for f in fields(tcfg)] == [f.name for f in fields(jcfg)]
    assert asdict(tcfg) == asdict(jcfg)
    meas = px.transpose(1, 0, 2, 3)
    w = (lik.transpose(1, 0, 2) > 0.5) / jcfg.meas_std_px
    cost = ttraj.fte_objective(torch.tensor(X), tekf.make_h_fn(*rig, device="cpu"), torch.tensor(meas),
                               torch.tensor(w), tcfg)
    jcost = jtraj.fte_objective(jnp.asarray(X), jekf.make_h_fn(*rig), jnp.asarray(meas),
                                jnp.asarray(w), jcfg)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


def test_config_defaults_carry_over():
    """The port's FteConfig has the JAX dataclass's fields and defaults."""
    jdef = {f.name: f.default for f in fields(jtraj.FteConfig)}
    tdef = {f.name: f.default for f in fields(ttraj.FteConfig)}
    assert jdef == tdef


def test_unknown_config_field_raises():
    fields_ = asdict(jfte.default_config(90.0))
    fields_["not_a_field"] = 1
    with pytest.raises(ValueError):
        convert.fte_config_from_dict(fields_)
