"""The port's fte_solve in its three measurement forms and with its last
two options, against the JAX package's, in float64 on the CPU.

tests/test_torch_fte.py's batch (B=3 runs of N=16 frames, 2 cameras, the
last padded to 12 valid frames) goes run by run through the JAX
``fte_solve`` with ``h_fn`` alone (its jacfwd), with ``hj_fn``, with
``assembly='vpu'`` and with ``pcg_meas_bf16=True``, and batched through
the port's counterpart of each.
"""
from dataclasses import asdict, replace

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
B, N, N_PAD = 3, 16, 12
#: per iterate, exact solves ('chol_unrolled'): the forms read 2e-14 apart
ITER_TOL = 1e-8
#: tests/test_torch_fte.py's fixed bound for rounding-chaotic pcg runs
PCG_COST_RTOL = 5e-3
#: tests/test_torch_uncertainty.py's bound on the posterior, of its scale
COV_RTOL_OF_SCALE = 1e-4


@pytest.fixture(scope="module")
def batch():
    cams = jsyn.ring_cameras(n_cams=2)
    k, d, r, t, _res = cams
    px, lik, _ = jsyn.render_measurements(jsyn.cheetah_gallop(N=N), cams, noise_px=1.5,
                                          outlier_frac=0.02, bad_lik_frac=0.05, seed=3)
    X0 = jfte.initial_trajectory(px, lik, k, d, r, t, np.arange(N), 0.5)
    rng = np.random.default_rng(5)
    X0b = np.stack([X0 + rng.normal(scale=1e-2, size=X0.shape) for _ in range(B)])
    meas = px.transpose(1, 0, 2, 3)
    measb = np.stack([meas + rng.normal(scale=0.5, size=meas.shape) for _ in range(B)])
    wb = np.stack([(lik.transpose(1, 0, 2) > 0.5) / 5.0] * B)
    wb[-1, N_PAD:] = 0.0
    nv = np.array([N] * (B - 1) + [N_PAD])
    return (k, d, r, t), X0b, measb, wb, nv


def _cfg(solver, **kw):
    return replace(jfte.default_config(90.0, num_iters=4), linear_solver=solver, plain_iters=2,
                   **kw)


def _forms(rig, form):
    """(JAX keywords, port keywords) of one measurement form."""
    if form == "h_fn":
        return {}, dict(h_fn=tekf.make_h_fn(*rig, torch.float64, "cpu"))
    if form == "hj_fn":
        return (dict(hj_fn=jekf.make_hj_fn(*rig)),
                dict(hj_fn=tekf.make_hj_fn(*rig, torch.float64, "cpu")))
    return (dict(hj_parts_fn=jekf.make_hj_parts_fn(*rig)),
            dict(hj_parts_fn=tekf.make_hj_parts_fn(*rig, torch.float64, "cpu")))


def _solve_both(batch, cfg, form, compute_cov=False):
    rig, X0b, measb, wb, nv = batch
    jkw, tkw = _forms(rig, form)
    h = jekf.make_h_fn(*rig)
    solve = jax.jit(lambda x, m, w, n: jtraj.fte_solve(h, x, m, w, cfg, n_valid=n,
                                                       compute_cov=compute_cov, **jkw))
    jax_out = [solve(jnp.asarray(X0b[i]), jnp.asarray(measb[i]), jnp.asarray(wb[i]), nv[i])
               for i in range(B)]
    hjp = tkw.pop("hj_parts_fn", None)
    port = ttraj.fte_solve(hjp, torch.tensor(X0b), measb, wb,
                           convert.fte_config_from_dict(asdict(cfg)), n_valid=nv,
                           compute_cov=compute_cov, device="cpu", **tkw)
    return port, jax_out


@pytest.mark.parametrize("form,cfg_kw,compute_cov", [
    ("h_fn", {}, True),
    ("hj_fn", {}, True),
    ("hj_parts_fn", dict(assembly="vpu"), False),
    ("hj_fn", dict(relinearize_every=3), False),
])
def test_form_matches_jax_per_iterate(batch, form, cfg_kw, compute_cov):
    """'chol_unrolled' (exact): every iterate's cost, the damping, the
    status and X held to the JAX package's same form at 1e-8. Without
    the parts the posterior is ``pose_cov`` (and the ridge shrink, 0 in
    float64), with no ``marker_cov`` or ``marker_std``, as in the JAX
    package. The lagged Jacobians run through the same dense path for
    ``h_fn`` and ``hj_fn``."""
    (X, info), jax_out = _solve_both(batch, _cfg("chol_unrolled", **cfg_kw), form, compute_cov)
    nv = batch[4]
    assert set(info) == set(jax_out[0][1])
    for i, (Xj, ij) in enumerate(jax_out):
        np.testing.assert_allclose(X[i].numpy(), np.asarray(Xj), rtol=0, atol=ITER_TOL)
        for key in ("cost", "cost0", "cost_history", "lam", "grad_norm"):
            np.testing.assert_allclose(info[key][i].numpy(), np.asarray(ij[key]), rtol=ITER_TOL,
                                       err_msg=key)
        assert bool(info["converged"][i]) == bool(ij["converged"])
        if compute_cov:
            assert "marker_std" not in info and "marker_cov" not in info
            got, want = info["pose_cov"][i, :nv[i]].numpy(), np.asarray(ij["pose_cov"])[:nv[i]]
            assert np.abs(got - want).max() <= COV_RTOL_OF_SCALE * np.abs(want).max()
            assert float(info["cov_ridge_shrink"][i]) == 0.0


def test_auto_assembly_is_einsum(batch):
    rig, X0b, measb, wb, nv = batch
    hjp = tekf.make_hj_parts_fn(*rig, torch.float64, "cpu")
    out = [ttraj.fte_solve(hjp, torch.tensor(X0b), measb, wb,
                           convert.fte_config_from_dict(asdict(_cfg("pcg", assembly=a))),
                           n_valid=nv, device="cpu") for a in ("auto", "einsum")]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["cost_history"], out[1][1]["cost_history"])


#: the bfloat16 operator's products are exact in float64, so the two
#: packages differ only in their float64 accumulation order
OPERATOR_RTOL_OF_SCALE = 1e-12


def test_pcg_meas_bf16_operator_matches_jax():
    """The rounded measurement operator itself, on the same H (Gauss-Newton
    blocks J^T J of a seeded J) and x: the port's ``pcg_meas_operator``
    against the JAX package's matvec written out (``dot_general`` of the
    bfloat16 operands with float64 accumulation, less the rounded H's
    diagonal times the unrounded x), at 1e-12 of its scale. The variants
    that round nothing, or cancel the unrounded diagonal, or round x in
    the diagonal term too, each land far outside that bound."""
    rng = np.random.default_rng(11)
    J = rng.normal(size=(2, 9, 40, 25)) * rng.uniform(1.0, 30.0, size=(1, 1, 1, 25))
    H = np.einsum("bnki,bnkj->bnij", J, J)
    x = rng.normal(size=(2, 9, 25)) * 1e-2

    def jax_meas(Hb, xb):
        H16 = jnp.asarray(Hb).astype(jnp.bfloat16)
        prod = jax.lax.dot_general(H16, jnp.asarray(xb).astype(jnp.bfloat16),
                                   (((2,), (1,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float64)
        return np.asarray(prod - jnp.diagonal(H16, axis1=-2, axis2=-1).astype(jnp.float64)
                          * jnp.asarray(xb))

    want = np.stack([jax_meas(H[b], x[b]) for b in range(2)])
    Ht, xt = torch.tensor(H), torch.tensor(x)
    got = ttraj.pcg_meas_operator(Ht, bf16=True)(xt).numpy()
    bound = OPERATOR_RTOL_OF_SCALE * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    H16 = Ht.to(torch.bfloat16).double()
    x16 = xt.to(torch.bfloat16).double()
    wrong = {
        "plain": ttraj.pcg_meas_operator(Ht)(xt),
        "unrounded diagonal": (H16 @ x16[..., None])[..., 0]
        - torch.diagonal(Ht, dim1=-2, dim2=-1) * xt,
        "rounded x in the diagonal": (H16 @ x16[..., None])[..., 0]
        - torch.diagonal(H16, dim1=-2, dim2=-1) * x16,
    }
    for name, w in wrong.items():
        assert np.abs(w.numpy() - want).max() > 1e3 * bound, name


def test_pcg_meas_bf16_matches_jax_at_cost_level(batch):
    """'pcg' with the bfloat16-rounded measurement matvec: every iterate's
    cost within the fixed 5e-3 of the JAX package's; the rounding is
    really there (the costs move off the unrounded solve's)."""
    cfg = _cfg("pcg", pcg_meas_bf16=True)
    (_X, info), jax_out = _solve_both(batch, cfg, "hj_parts_fn")
    for i, (_Xj, ij) in enumerate(jax_out):
        hist, hist_j = info["cost_history"][i].numpy(), np.asarray(ij["cost_history"])
        assert np.all(np.abs(hist - hist_j) <= PCG_COST_RTOL * np.abs(hist_j)), (i, hist, hist_j)
        np.testing.assert_allclose(info["cost0"][i].numpy(), np.asarray(ij["cost0"]), rtol=1e-12)
    rig, X0b, measb, wb, nv = batch
    _X, plain = ttraj.fte_solve(tekf.make_hj_parts_fn(*rig, torch.float64, "cpu"),
                                torch.tensor(X0b), measb, wb,
                                convert.fte_config_from_dict(asdict(_cfg("pcg"))), n_valid=nv,
                                device="cpu")
    assert not torch.equal(plain["cost_history"], info["cost_history"])


@pytest.mark.parametrize("given", [(), ("h_fn", "hj_fn"), ("hj_parts_fn", "h_fn")])
def test_exactly_one_form(batch, given):
    rig, X0b, measb, wb, _nv = batch
    fns = dict(hj_parts_fn=tekf.make_hj_parts_fn(*rig, torch.float64, "cpu"),
               hj_fn=tekf.make_hj_fn(*rig, torch.float64, "cpu"),
               h_fn=tekf.make_h_fn(*rig, torch.float64, "cpu"))
    kw = {k: fns[k] for k in given}
    hjp = kw.pop("hj_parts_fn", None)
    cfg = convert.fte_config_from_dict(asdict(_cfg("pcg")))
    with pytest.raises(ValueError, match="exactly one"):
        ttraj.fte_solve(hjp, X0b, measb, wb, cfg, device="cpu", **kw)
