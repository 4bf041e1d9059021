"""The port's banded solves against the JAX package and dense solves.

The four cases of tests/test_pallas_kernels.py hold the port's plain
banded solve (what ``kernels.banded_cuda.banded_solve`` runs for CPU
tensors) to np.linalg.solve, to the JAX ``block_banded_solve_unrolled``
and to the JAX Pallas kernel in interpret mode. The CUDA kernel itself
is held to the plain version by tests/test_torch_kernel_cuda.py, which
runs only where a CUDA device is present, and by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acinoset_tpu.kernels.banded_pallas import banded_solve_pallas
from acinoset_tpu.solvers import banded as jbanded
from acinoset_tpu_torch.kernels import banded_cuda
from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
from acinoset_tpu_torch.solvers import banded as tbanded
from chip_smoke import make_banded_batch
from test_banded import make_spd_banded

torch.set_num_threads(2)


def _batch_case(seed, B, N, P, tile=False):
    rng = np.random.default_rng(seed)
    systems = [make_spd_banded(rng, N, P) for _ in range(1 if tile else B)]
    if tile:
        systems = systems * B
    gs = rng.normal(size=(B, N, P))
    bands = [np.stack([s[1][k] for s in systems]) for k in range(4)]
    refs = np.stack([np.linalg.solve(s[0], g.reshape(-1)).reshape(N, P) for s, g in zip(systems, gs)])
    return bands, gs, refs


CASES = {  # name: (seed, B, N, P, tile) — the shapes of tests/test_pallas_kernels.py
    "dense_b3": (0, 3, 11, 5, False),
    "p25": (1, 2, 8, 25, True),
    "batch_padding": (2, 5, 7, 4, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_banded_solve_matches_dense_jax_and_pallas(case):
    seed, B, N, P, tile = CASES[case]
    bands, g, ref = _batch_case(seed, B, N, P, tile)
    x = banded_solve([torch.tensor(b) for b in bands], torch.tensor(g)).numpy()
    # float64 against the dense solve: only rounding separates them
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-10
    x_j = np.stack([
        np.asarray(jbanded.block_banded_solve_unrolled([jnp.asarray(b[i]) for b in bands],
                                                       jnp.asarray(g[i])))
        for i in range(B)
    ])
    np.testing.assert_allclose(x, x_j, rtol=1e-10, atol=1e-12)
    # the Pallas kernel computes in float32 whatever its input: hold the
    # port to it at the TPU kernel's own test tolerance
    x_p = np.asarray(banded_solve_pallas([jnp.asarray(b, jnp.float32) for b in bands],
                                         jnp.asarray(g, jnp.float32), interpret=True))
    assert np.abs(x - x_p).max() / np.abs(ref).max() < 1e-5


def test_plain_banded_solve_ill_conditioned_fte_like():
    """Residual parity with the JAX solves on the system the FTE solves:
    in float32 both are ~kappa eps accurate, so the port's plain version
    (float32, as the solver runs it) is held to the JAX Pallas kernel and
    the JAX unrolled solve by residual, and in float64 to the JAX unrolled
    solve at 1e-8 relative."""
    bands, g = make_banded_batch(np.random.default_rng(3), 1, 64, 25, "fte")
    bands, g = [b[0] for b in bands], g[0]
    b32 = [torch.tensor(b, dtype=torch.float32) for b in bands]
    g32 = torch.tensor(g, dtype=torch.float32)
    b64 = [torch.tensor(b) for b in bands]
    g64 = torch.tensor(g)

    def resid(x):
        return float(torch.linalg.vector_norm(tbanded.banded_matvec(b64, x.double()) - g64))

    x_t = banded_solve([b[None] for b in b32], g32[None])[0]
    jb = [jnp.asarray(b, jnp.float32) for b in bands]
    x_un = torch.tensor(np.asarray(jbanded.block_banded_solve_unrolled(jb, jnp.asarray(g, jnp.float32))))
    x_pl = torch.tensor(np.asarray(
        banded_solve_pallas([b[None] for b in jb], jnp.asarray(g, jnp.float32)[None], interpret=True)[0]))
    gn = float(np.linalg.norm(g))
    assert resid(x_t) < 2.0 * resid(x_un) + 1e-4 * gn
    assert resid(x_t) < 2.0 * resid(x_pl) + 1e-4 * gn
    x64 = banded_solve([b[None] for b in b64], g64[None])[0].numpy()
    x64_j = np.asarray(jbanded.block_banded_solve_unrolled([jnp.asarray(b) for b in bands], jnp.asarray(g)))
    assert np.abs(x64 - x64_j).max() / np.abs(x64_j).max() < 1e-8


def test_chol_inv_unrolled_matches_jax():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(3, 25, 25))
    A = M @ M.transpose(0, 2, 1) + 25 * np.eye(25)
    L, Li = tbanded._chol_inv_unrolled(torch.tensor(A))
    jL, jLi = jbanded._chol_inv_unrolled(jnp.asarray(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Li.numpy(), np.asarray(jLi), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("N", [9, 2])
def test_banded_matvec_matches_jax_and_dense(N):
    rng = np.random.default_rng(5)
    A, bands = make_spd_banded(rng, N, 4)
    x = rng.normal(size=(N, 4))
    y = tbanded.banded_matvec([torch.tensor(b) for b in bands], torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, (A @ x.reshape(-1)).reshape(N, 4), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(
        y, np.asarray(jbanded.banded_matvec([jnp.asarray(b) for b in bands], jnp.asarray(x))),
        rtol=1e-12, atol=1e-10)


def test_pcg_with_spectral_preconditioner_matches_jax():
    """Batched PCG (per-system scalars) against the JAX single-system
    PCG on each system, on an FTE-shaped operator (third-difference
    model term + SPD frame blocks) kept well-conditioned by Ts = 1, so
    that CG's iterates are insensitive to rounding: at the FTE's
    Ts = 1/90 the model term spans ~1e9 and float64 rounding alone moves
    the iterates ~1e-8 relative."""
    from acinoset_tpu_torch.solvers.trajopt import _d3_gram_dense

    rng = np.random.default_rng(6)
    B, N, P, Ts = 2, 12, 3, 1.0
    e, U = np.linalg.eigh(_d3_gram_dense(N, Ts))
    e = np.maximum(e, 0.0)
    wq = 1.0 / rng.uniform(1.0, 4.0, size=P) ** 2
    G = _d3_gram_dense(N, Ts)
    M = rng.normal(size=(B, N, P, P))
    Hb = M @ M.transpose(0, 1, 3, 2) + 5.0 * np.eye(P)
    b = rng.normal(size=(B, N, P))
    c = Hb.diagonal(axis1=-2, axis2=-1).mean(axis=1)  # (B, P)

    def op_t(x):
        return 2.0 * (torch.tensor(G) @ x) * torch.tensor(wq) + (torch.tensor(Hb) @ x[..., None])[..., 0]

    x = tbanded.pcg_solve(op_t, tbanded.spectral_minv(torch.tensor(U), torch.tensor(e),
                                                      torch.tensor(wq), torch.tensor(c)),
                          torch.tensor(b), num_iters=6).numpy()
    for i in range(B):
        A_j = lambda v, i=i: 2.0 * (jnp.asarray(G) @ v) * jnp.asarray(wq) + jnp.einsum(  # noqa: E731
            "nij,nj->ni", jnp.asarray(Hb[i]), v)
        xj = jbanded.pcg_solve(A_j, jbanded.spectral_minv(jnp.asarray(U), jnp.asarray(e),
                                                          jnp.asarray(wq), jnp.asarray(c[i])),
                               jnp.asarray(b[i]), num_iters=6)
        np.testing.assert_allclose(x[i], np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    bands, g, _ref = _batch_case(7, 2, 6, 3)
    tb = [torch.tensor(b) for b in bands]
    before = banded_solve.launches
    x = banded_solve(tb, torch.tensor(g))
    assert banded_solve.launches == before
    np.testing.assert_array_equal(x.numpy(), tbanded.block_banded_solve_unrolled(tb, torch.tensor(g)).numpy())


def test_wrapper_rejects_bad_shapes():
    bands, g, _ref = _batch_case(8, 2, 6, 3)
    tb = [torch.tensor(b) for b in bands]
    with pytest.raises(ValueError):
        banded_solve(tb[:3], torch.tensor(g))
    with pytest.raises(ValueError):
        banded_solve(tb, torch.tensor(g[:, :5]))
    with pytest.raises(ValueError):
        banded_solve(tb, torch.tensor(g[0]))


def test_kernel_build_command_targets_hopper_without_torch_headers():
    """The kernel is built by nvcc for sm_90a into a plain-C library that
    ctypes loads; its source includes no PyTorch or CUTLASS header."""
    flags = " ".join(banded_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    src = banded_cuda.SOURCE.read_text()
    assert 'extern "C" int banded_chol_solve' in src
    assert "torch/" not in src and "cutlass" not in src.lower()
    assert banded_cuda.LIBRARY.parent.name == "_build"


def test_phase_clocked_build_adds_its_flag_and_its_own_library(tmp_path, monkeypatch):
    """banded_cuda.build(clocked=True) compiles the kernel's source with
    -DBANDED_PHASE_CLOCK into a library of its own beside libbanded.so;
    the build helper puts the extra flags after NVCC_FLAGS and keeps the
    compiler's log beside the library."""
    import subprocess
    from pathlib import Path

    from acinoset_tpu_torch.kernels import _nvcc

    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info    : Used 128 registers",
                                           stderr="")

    assert banded_cuda.CLOCKED_LIBRARY.parent == banded_cuda.LIBRARY.parent
    monkeypatch.setattr(_nvcc.subprocess, "run", fake_run)
    monkeypatch.setattr(banded_cuda, "CLOCKED_LIBRARY",
                        tmp_path / "_build" / "libbanded_chol_clocked.so")
    lib = banded_cuda.build(clocked=True)
    assert lib == banded_cuda.CLOCKED_LIBRARY and lib.exists()
    (cmd,) = calls
    assert cmd[1:1 + len(_nvcc.NVCC_FLAGS)] == _nvcc.NVCC_FLAGS
    assert "-DBANDED_PHASE_CLOCK" in cmd and cmd[-1] == str(banded_cuda.SOURCE)
    assert _nvcc.log_path(lib).read_text() == "ptxas info    : Used 128 registers"
    assert banded_cuda.build(clocked=True) == lib and len(calls) == 1  # newer than its source


def _fmaf(a, b, c):
    """fmaf in float32: float64 holds the product of two float32 exactly,
    and the sum is rounded to float32 (after a float64 rounding: the same
    result except on rare double-rounding ties)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _kernel_order_p1(A, g):
    """One system at P = 1 in float32, in the CUDA kernel's order of
    operations (kernels/csrc/banded_chol.cu): L3, then A2, A1, S -= L3
    [L1_{n-2} | L2_{n-1} | L3], L2, A1, S -= L2 [L1_{n-1} | L2], L1, S -=
    L1 L1, each an fmaf; the pivot's reciprocal square root of max(S,
    1e-30), correctly rounded here (the kernel's rsqrt.approx is within a
    few ulp of it); the forward and backward substitutions' fmaf and
    left-to-right subtractions. A = [A0..A3] each (N,), g (N,)."""
    f32 = np.float32
    A0, A1, A2, A3 = (a.astype(f32) for a in A)
    N = len(g)
    zero, one = f32(0), f32(1)
    ring = {-3: (one, zero, zero), -2: (one, zero, zero), -1: (one, zero, zero)}  # Li, L1, L2
    fac, y = {}, {-3: zero, -2: zero, -1: zero}
    for n in range(N):
        li3 = ring[n - 3][0]
        li2, l1_2, _ = ring[n - 2]
        li1, l1_1, l2_1 = ring[n - 1]
        l3 = _fmaf(A3[n], li3, zero)
        a2, a1, s = _fmaf(-l3, l1_2, A2[n]), _fmaf(-l3, l2_1, A1[n]), _fmaf(-l3, l3, A0[n])
        l2 = _fmaf(a2, li2, zero)
        a1, s = _fmaf(-l2, l1_1, a1), _fmaf(-l2, l2, s)
        l1 = _fmaf(a1, li1, zero)
        s = _fmaf(-l1, l1, s)
        li = f32(1.0 / np.sqrt(np.float64(max(s, f32(1e-30)))))
        ring[n] = (li, l1, l2)
        fac[n] = (li, l1, l2, l3)
        t1, t2, t3 = (_fmaf(l, y[n - q], zero) for q, l in ((1, l1), (2, l2), (3, l3)))
        y[n] = _fmaf(li, f32(f32(f32(f32(g[n]) - t1) - t2) - t3), zero)
    x = {}
    for n in range(N - 1, -1, -1):
        t = [_fmaf(fac[n + q][q], x[n + q], zero) if n + q < N else zero for q in (1, 2, 3)]
        x[n] = _fmaf(fac[n][0], f32(f32(f32(y[n] - t[0]) - t[1]) - t[2]), zero)
    return np.array([x[n] for n in range(N)], np.float64)


def test_kernel_order_in_float32_meets_the_edge_shape_rule_at_p1_n4():
    """Why tests/test_torch_kernel_cuda.py holds the FTE-like edge shapes
    to normwise backward error and not to the flagship batch's residual
    rule. On the same three systems (P = 1, N = 4, kappa ~ 4e5) the
    kernel's order of operations, emulated in float32, leaves a residual
    above 2 |A x_plain32 - g| + 1e-4 |g| on at least one system, while
    its backward error |A x - g| / (|A| |x| + |g|) stays within twice the
    plain float32 version's plus 2^-22, and both are below float32's unit
    roundoff: correct rounding in another order, not a fault."""
    from chip_smoke import dense_from_bands

    bands, g = make_banded_batch(np.random.default_rng(100 * 1 + 4), 3, 4, 1, "fte")
    b64 = [torch.tensor(b) for b in bands]
    g64 = torch.tensor(g)
    x_emu = torch.tensor(np.stack([_kernel_order_p1([b[i, :, 0, 0] for b in bands], g[i, :, 0])
                                   for i in range(3)]))[..., None]
    x_p32 = tbanded.block_banded_solve_unrolled([b.float() for b in b64], g64.float()).double()
    gn = torch.linalg.vector_norm(g64, dim=(1, 2))
    a_norm = torch.linalg.matrix_norm(dense_from_bands(b64), ord=2)

    def res(x):
        return torch.linalg.vector_norm(tbanded.banded_matvec(b64, x) - g64, dim=(1, 2))

    def eta(x):
        return res(x) / (a_norm * torch.linalg.vector_norm(x, dim=(1, 2)) + gn)

    assert bool(torch.any(res(x_emu) > 2.0 * res(x_p32) + 1e-4 * gn))
    assert bool(torch.all(eta(x_emu) <= 2.0 * eta(x_p32) + 2.0**-22))
    assert bool(torch.all(torch.maximum(eta(x_emu), eta(x_p32)) < 2.0**-24))
