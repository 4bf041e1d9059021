"""The banded-Cholesky CUDA kernel against its plain PyTorch version.

Needs a CUDA device: the tests skip without one. This file imports
nothing of JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
from chip_smoke import dense_from_bands, make_banded_batch
from acinoset_tpu_torch.solvers.banded import banded_matvec, block_banded_solve_unrolled


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,P", [(4, 20, 25), (3, 7, 5), (2, 2, 32)])
def test_cuda_kernel_matches_plain_version(cuda, B, N, P):
    """float32 kernel vs the float64 plain version: within 1e-5 of the
    solution's scale on these well-conditioned (kappa ~ 3) systems."""
    bands, g = make_banded_batch(np.random.default_rng(B * N + P), B, N, P, "well")
    b32 = [torch.tensor(b, dtype=torch.float32, device=cuda) for b in bands]
    g32 = torch.tensor(g, dtype=torch.float32, device=cuda)
    before = banded_solve.launches
    x = banded_solve(b32, g32)
    torch.cuda.synchronize()
    assert banded_solve.launches == before + 1
    x_plain = block_banded_solve_unrolled([b.double() for b in b32], g32.double())
    assert float((x.double() - x_plain).abs().max()) <= 1e-5 * float(x_plain.abs().max())
    resid = banded_matvec([b.double() for b in b32], x.double()) - g32.double()
    assert float(resid.abs().max()) <= 1e-5 * float(g32.abs().max())


def _to_cuda(bands, g, device):
    b64 = [torch.tensor(b, device=device) for b in bands]
    g64 = torch.tensor(g, device=device)
    return b64, g64, [b.float().contiguous() for b in b64], g64.float().contiguous()


def _assert_residual_parity(b64, g64, b32, g32, x):
    """chip_smoke.phase_kernel's rule for the FTE-like systems (kappa ~
    1/damping): per system, |A x - g| <= 2 |A x_plain32 - g| + 1e-4 |g|,
    where x_plain32 is the plain version run in float32 on the same
    device. Both are ~kappa eps_f32 accurate, so the kernel is held to
    the plain version's own float32 residual."""
    x_p32 = block_banded_solve_unrolled(b32, g32)
    res_k = torch.linalg.vector_norm(banded_matvec(b64, x.double()) - g64, dim=(1, 2))
    res_p = torch.linalg.vector_norm(banded_matvec(b64, x_p32.double()) - g64, dim=(1, 2))
    gn = torch.linalg.vector_norm(g64, dim=(1, 2))
    assert bool(torch.all(res_k <= 2.0 * res_p + 1e-4 * gn)), (res_k / gn).max()


@pytest.mark.cuda
def test_cuda_kernel_fte_batch_at_the_flagship_shape(cuda):
    """The FTE-like batch (kappa ~ 1/damping) at the flagship solve's
    shape, B=96, N=100, P=25, under the residual rule."""
    bands, g = make_banded_batch(np.random.default_rng(0), 96, 100, 25, "fte")
    b64, g64, b32, g32 = _to_cuda(bands, g, cuda)
    x = banded_solve(b32, g32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    _assert_residual_parity(b64, g64, b32, g32, x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["well", "fte"])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("P", [1, 24, 25, 32])
def test_cuda_kernel_edge_shapes(cuda, P, N, kind):
    """Block edges at and around the kernel's tiling (P = 1, 24, 25, 32)
    and fewer frames than the bandwidth and its ring (N = 1..4, 7).
    'well' systems: within 1e-5 of the solution's scale of the float64
    plain version. 'fte' systems (kappa ~ 4e5 at these sizes): the
    normwise backward error eta = |A x - g| / (|A| |x| + |g|) within twice
    the plain float32 version's plus 2^-22 (4 units of float32 rounding),
    per system: on a system of 1-7 frames a handful of roundings set the
    residual, so the flagship rule's 1e-4 |g| slack is below the spread
    of two correctly rounded orders of the same operations (P = 1, N = 4:
    0.14% and 0.41% relative residual, both eta < 2.5e-8; the float32
    emulation of the kernel's order in tests/test_torch_banded.py shows
    the same on the CPU)."""
    bands, g = make_banded_batch(np.random.default_rng(100 * P + N), 3, N, P, kind)
    b64, g64, b32, g32 = _to_cuda(bands, g, cuda)
    x = banded_solve(b32, g32)
    torch.cuda.synchronize()
    if kind == "well":
        x_plain = block_banded_solve_unrolled(b64, g64)
        assert float((x.double() - x_plain).abs().max()) <= 1e-5 * float(x_plain.abs().max())
    else:
        a_norm = torch.linalg.matrix_norm(dense_from_bands(b64), ord=2)
        g_norm = torch.linalg.vector_norm(g64, dim=(1, 2))

        def eta(sol):
            res = torch.linalg.vector_norm(banded_matvec(b64, sol.double()) - g64, dim=(1, 2))
            return res / (a_norm * torch.linalg.vector_norm(sol.double(), dim=(1, 2)) + g_norm)

        eta_k, eta_p = eta(x), eta(block_banded_solve_unrolled(b32, g32))
        assert bool(torch.all(eta_k <= 2.0 * eta_p + 2.0**-22)), (eta_k, eta_p)


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same x, bit for bit: no
    atomics, no order that changes between runs."""
    bands, g = make_banded_batch(np.random.default_rng(1), 8, 30, 25, "fte")
    _b64, _g64, b32, g32 = _to_cuda(bands, g, cuda)
    x1 = banded_solve(b32, g32)
    x2 = banded_solve(b32, g32)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    bands, g = make_banded_batch(np.random.default_rng(0), 2, 6, 4, "well")
    b32 = [torch.tensor(b, dtype=torch.float32, device=cuda) for b in bands]
    g32 = torch.tensor(g, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        banded_solve([b.double() for b in b32], g32.double())
    with pytest.raises(ValueError):
        banded_solve([b.mT for b in b32], g32)  # not contiguous
    with pytest.raises(ValueError):
        banded_solve([b.cpu() for b in b32], g32)  # mixed devices
    big = [torch.zeros((1, 4, 33, 33), device=cuda) for _ in range(4)]
    with pytest.raises(ValueError):
        banded_solve(big, torch.zeros((1, 4, 33), device=cuda))
