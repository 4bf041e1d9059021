"""The probe CUDA kernels against their plain PyTorch versions on the card,
with chip_smoke.py's inputs and tolerances (``chip_smoke.probe_cases``).

Needs a CUDA device: the tests skip without one. This file imports
nothing of JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_probes_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

import chip_smoke
from acinoset_tpu_torch.kernels import probes_cuda as pk

NAMES = sorted(pk.KERNELS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["random", "script"])
@pytest.mark.parametrize("name", NAMES)
def test_probe_kernel_matches_plain_version(cuda, name, inputs):
    cases = chip_smoke.probe_cases()
    wrapper = pk.KERNELS[name]
    before = wrapper.launches
    rng = np.random.default_rng(NAMES.index(name))
    chip_smoke.check_probe(cases[name], wrapper, inputs, cuda, rng)
    assert wrapper.launches == before + 1


@pytest.mark.cuda
def test_write_input_ref_kernel_leaves_its_input_unchanged(cuda):
    a = torch.randn((5, 4, 32, 32), device=cuda)
    before = a.clone()
    out = pk.write_input_ref(a)
    torch.cuda.synchronize()
    assert torch.equal(a, before)
    assert torch.equal(out[0], 2 * before[0])


@pytest.mark.cuda
def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((2, 32, 32), device=cuda)
    with pytest.raises(TypeError):
        pk.batched_dot(a.double(), a.double())
    with pytest.raises(ValueError):
        pk.batched_transpose(a.mT)  # not contiguous
    with pytest.raises(ValueError):
        pk.batched_dot(a, a.cpu())  # mixed devices
    with pytest.raises(ValueError):
        pk.dma_hbm_ring(torch.zeros((4, 3), device=cuda))  # rows not a multiple of 16 bytes
    with pytest.raises(RuntimeError):
        pk.dyn4d_scratch(torch.zeros((15, 4, 32, 32), device=cuda))  # 240 KB of shared memory
