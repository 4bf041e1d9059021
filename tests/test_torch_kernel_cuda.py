"""The banded-Cholesky CUDA kernel against its plain PyTorch version.

Needs a CUDA device: the tests skip without one. This file imports
nothing of JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from acinoset_tpu_torch.kernels.banded_cuda import banded_solve
from chip_smoke import make_banded_batch
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
