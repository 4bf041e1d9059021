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
from acinoset_tpu_torch.probes import probe_mosaic as pm
from acinoset_tpu_torch.probes import probe_mosaic2 as pm2

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
    with pytest.raises(ValueError):
        pk.dma_out_any(torch.zeros((4, 6), device=cuda))
    with pytest.raises(RuntimeError):  # a CTA's slab of 114 x 128 float4: 228 KB of shared memory
        pk.dyn4d_scratch(torch.zeros((114, 4, 32, 32), device=cuda))


def _exact_on_the_card(cuda, wrapper, plain, shape, seed):
    a = torch.as_tensor(np.random.default_rng(seed).normal(size=shape), dtype=torch.float32,
                        device=cuda)
    before = wrapper.launches
    got = wrapper(a)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, plain(a))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 16, 32),  # N = 1
    (6, 1), (6, 3), (6, 5),  # rows of 1, 3, 5 floats: one float a thread
    (6, 1028),  # 257 float4 columns: three CTAs of 128, the last with one thread
    (6, 1030),  # one float a thread, nine CTAs, the last with six threads
    (19, 16, 32), (17, 5),  # more rows than the 8 whose loads are hoisted together
])
def test_ring_prefix_kernel_is_exact_on_edge_shapes(cuda, shape):
    _exact_on_the_card(cuda, pk.ring_dyn_index, pm.ring_dyn_index_plain, shape, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 4, 32, 32),  # N = 1
    (5, 1, 32, 32),  # two CTAs
    (25, 2, 32, 32),  # a 50 KB slab: over the 48 KB default, so the launcher raises the limit
    (113, 1, 32, 32),  # a 226 KB slab: the largest a CTA may have
    (15, 4, 32, 32),  # refused while the whole 240 KB scratch sat in one CTA
])
def test_dyn4d_kernel_is_exact_on_edge_shapes(cuda, shape):
    _exact_on_the_card(cuda, pk.dyn4d_scratch, pm2.dyn4d_scratch_plain, shape, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["dma_hbm_ring", "dma_out_any"])
@pytest.mark.parametrize("shape", [
    (1, 16, 32),  # N = 1
    (9, 16, 32), (17, 16, 32),  # just above row 6's round of 8 and row 4's ring of 16
    (100, 512),  # well above both: rings refilled, the two sets of slots used in turn
    (6, 4),  # a row of 4 floats: one 16-byte copy a row
    (5, 1028), (20, 1000),  # ragged last slices of 16 bytes and 1,952 bytes
    (4, 30000),  # 120 KB rows, over the 113 KB that a CTA holding whole rows took
    (100, 96, 4, 32, 32),  # the band-stream shape, 157 MB: 768 CTAs
])
def test_bulk_copy_kernels_are_exact_on_edge_shapes(cuda, row, shape):
    plain = {"dma_hbm_ring": pm.dma_hbm_ring_plain, "dma_out_any": pm.dma_out_any_plain}[row]
    _exact_on_the_card(cuda, pk.KERNELS[row], plain, shape, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 4, 32, 32),  # N = 1
    (6, 5), (17, 3),  # rows of 5 and 3 floats: one float a thread; 17 rows, past 2 x 8 hoisted
    (6, 1030),  # one float a thread, nine CTAs, the last with six threads
    (19, 16, 32), (9, 4),  # float4 columns: 19 rows; one column
    (5, 4, 32, 32),  # the probe's shape
    (100, 384, 32, 32),  # the flagship's, 157 MB: 768 CTAs
])
def test_recur_kernel_is_exact_on_edge_shapes(cuda, shape):
    _exact_on_the_card(cuda, pk.write_input_ref, pm2.write_input_ref_plain, shape, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [
    1, 7, 16,  # one tile, an odd count, the probe's
    133, 2113,  # one CTA a tile: one past the 132 SMs; an odd count over many waves
    38400,  # the flagship's 100 x 96 x 4 tiles
])
def test_batched_dot_kernel_matches_plain_on_edge_batches(cuda, B):
    cases = chip_smoke.probe_cases()
    gen = torch.Generator(device=cuda).manual_seed(B)
    a, b = (torch.randn((B, 32, 32), device=cuda, generator=gen) for _ in range(2))
    before = pk.batched_dot.launches
    got = pk.batched_dot(a, b)
    torch.cuda.synchronize()
    assert pk.batched_dot.launches == before + 1
    want = chip_smoke._plain_at(cases["batched_dot"], "batched_dot", [a, b])
    chip_smoke.probe_error(got, want, cases["batched_dot"]["tol"])
    assert torch.equal(got, pk.batched_dot(a, b))  # every sum in one order: deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("B", [
    1, 7, 8, 9,  # one tile; odd and even counts
    16, 133,  # the probe's; one CTA a tile: one past the 132 SMs
    38400,  # the flagship's 100 x 96 x 4 tiles
])
def test_matvec_kernels_match_plain_on_edge_batches(cuda, B):
    """Rows 2 and 7, one function through one device function: each within
    rtol 1e-5 of the largest output of its plain version, bit-identical on
    a second launch, and the two kernels bit-identical to each other."""
    cases = chip_smoke.probe_cases()
    gen = torch.Generator(device=cuda).manual_seed(B)
    a = torch.randn((B, 32, 32), device=cuda, generator=gen)
    v = torch.randn((B, 32), device=cuda, generator=gen)
    outs = []
    for name in ("bcast_mul_lane_reduce", "batched_matvec"):
        wrapper = pk.KERNELS[name]
        before = wrapper.launches
        got, again = wrapper(a, v), wrapper(a, v)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        want = chip_smoke._plain_at(cases[name], name, [a, v])
        chip_smoke.probe_error(got, want, cases[name]["tol"])
        assert torch.equal(got, again)
        outs.append(got)
    assert torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [
    1, 7, 8, 9,  # one tile; odd and even counts
    16, 133,  # the probe's; one CTA a tile: one past the 132 SMs
    38400,  # the flagship's 100 x 96 x 4 tiles
])
def test_transpose_kernel_is_exact_on_edge_batches(cuda, B):
    """Row 8, a copy: bit-identical to its plain version and on a second
    launch, and applied twice it gives its input back."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    a = torch.randn((B, 32, 32), device=cuda, generator=gen)
    before = pk.batched_transpose.launches
    got, again = pk.batched_transpose(a), pk.batched_transpose(a)
    back = pk.batched_transpose(got)
    torch.cuda.synchronize()
    assert pk.batched_transpose.launches == before + 3
    assert torch.equal(got, pm.batched_transpose_plain(a))
    assert torch.equal(got, again)
    assert torch.equal(back, a)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 17])  # odd and even: the ping-pong's parity
@pytest.mark.parametrize("tb", range(1, pk.MAX_CHAIN_TILES + 1))
def test_chain_kernels_on_every_tile_count(cuda, tb, K, prec):
    """One CTA per tile: each of TB tiles against the plain version, on
    seeded 0.9 Q (chip_smoke.probe_cases' Frobenius tolerance at this K)
    and exactly on the script's 0.999 I; two launches bit-identical."""
    wrapper = pk.chain_highest if prec == "highest" else pk.chain_tf32
    tol = ("frob", K * (32 * 2.0**-24 if prec == "highest" else 2.0**-10))
    q, _ = np.linalg.qr(np.random.default_rng(100 * tb + K).normal(size=(tb, 32, 32)))
    eye = (torch.eye(32, device=cuda)[None] * 0.999).repeat(tb, 1, 1)
    for a, t in ((torch.as_tensor(0.9 * q, dtype=torch.float32, device=cuda), tol), (eye, "exact")):
        before = wrapper.launches
        got = wrapper(a, K)
        again = wrapper(a, K)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert torch.equal(got, again)
        chip_smoke.probe_error(got, pm2.chain_plain(a, K, prec), t)
