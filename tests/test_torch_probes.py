"""The port's probe kernels (acinoset_tpu_torch.kernels.probes_cuda, on CPU
tensors their plain versions) against the Pallas kernel bodies of
scripts/probe_mosaic.py and scripts/probe_mosaic2.py, run by
``pl.pallas_call(..., interpret=True)`` with the scripts' specs.

Each row gets seeded random inputs and the script's own inputs.
Tolerances: the rows that move or scale data, and the recurrences (the
same float32 additions in the same order), are exact; the float32
products (rows 1, 2, 7, 11, 12) are held at rtol 1e-5 against the
largest value, as their sums run in another order.
"""
import importlib.util
import math
import os
import re
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from acinoset_tpu_torch.kernels import _nvcc
from acinoset_tpu_torch.kernels import probes_cuda as pk
from acinoset_tpu_torch.probes import probe_mosaic as tpm
from acinoset_tpu_torch.probes import probe_mosaic2 as tpm2

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """Import a probe script by path: its __main__ guard keeps it from
    running anything."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PM, PM2 = _load_script("probe_mosaic"), _load_script("probe_mosaic2")
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
ANY = pl.BlockSpec(memory_space=pl.ANY)


def _pallas(kernel, out_shape, in_specs, out_specs=VMEM, scratch=()):
    def call(*xs):
        out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
                             in_specs=in_specs, out_specs=out_specs,
                             scratch_shapes=list(scratch), interpret=True)(*xs)
        return np.asarray(out)
    return call


B, P, TB = 16, 32, 4
S3 = (B, P, P)


def _ones(*shape):
    return np.ones(shape, np.float32)


def _arange(*shape):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


#: row -> (port wrapper, Pallas call, random inputs, the script's inputs, exact?)
CASES = {
    "batched_dot": (
        pk.batched_dot, _pallas(PM.k1, S3, [VMEM] * 2),
        lambda r: (r.normal(size=S3), r.normal(size=S3)), lambda: (_ones(*S3), _ones(*S3)),
        False),
    "bcast_mul_lane_reduce": (
        pk.bcast_mul_lane_reduce, _pallas(PM.k2, (B, P), [VMEM] * 2),
        lambda r: (r.normal(size=S3), r.normal(size=(B, P))),
        lambda: (_ones(*S3), np.full((B, P), 2.0, np.float32)), False),
    "value_at_set_static": (
        pk.value_at_set_static, _pallas(PM.k3, S3, [VMEM]),
        lambda r: (r.normal(size=S3),), lambda: (_ones(*S3),), True),
    "dma_hbm_ring": (
        pk.dma_hbm_ring,
        _pallas(PM.k4, (4, B, P), [ANY],
                scratch=[pltpu.VMEM((2, B, P), jnp.float32), pltpu.SemaphoreType.DMA(())]),
        lambda r: (r.normal(size=(4, B, P)),), lambda: (_arange(4, B, P),), True),
    "ring_dyn_index": (
        pk.ring_dyn_index, _pallas(PM.k5, (6, B, P), [VMEM],
                                   scratch=[pltpu.VMEM((3, B, P), jnp.float32)]),
        lambda r: (r.normal(size=(6, B, P)),), lambda: (_ones(6, B, P),), True),
    "dma_out_any": (
        pk.dma_out_any,
        _pallas(PM.k6, (4, B, P), [VMEM], out_specs=ANY,
                scratch=[pltpu.VMEM((1, B, P), jnp.float32), pltpu.SemaphoreType.DMA(())]),
        lambda r: (r.normal(size=(4, B, P)),), lambda: (_ones(4, B, P),), True),
    "batched_matvec": (
        pk.batched_matvec, _pallas(PM.k7, (B, P), [VMEM] * 2),
        lambda r: (r.normal(size=S3), r.normal(size=(B, P))),
        lambda: (_ones(*S3), np.full((B, P), 2.0, np.float32)), False),
    "batched_transpose": (
        pk.batched_transpose, _pallas(PM.k8, S3, [VMEM]),
        lambda r: (r.normal(size=S3),), lambda: (_arange(*S3),), True),
    "dyn4d_scratch": (
        pk.dyn4d_scratch, _pallas(PM2.k1, (5, TB, P, P), [VMEM],
                                  scratch=[pltpu.VMEM((5, TB, P, P), jnp.float32)]),
        lambda r: (r.normal(size=(5, TB, P, P)),), lambda: (_ones(5, TB, P, P),), True),
    "write_input_ref": (
        pk.write_input_ref, _pallas(PM2.k2, (5, TB, P, P), [VMEM]),
        lambda r: (r.normal(size=(5, TB, P, P)),), lambda: (_ones(5, TB, P, P),), True),
    "matvec_transposed_contract": (
        pk.matvec_transposed_contract, _pallas(PM2.k3, (TB, P), [VMEM] * 2),
        lambda r: (r.normal(size=(TB, P, P)), r.normal(size=(TB, P))),
        lambda: (_arange(TB, P, P) / np.float32(100.0), _ones(TB, P)), False),
}


def _compare(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("inputs", ["random", "script"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_matches_pallas_body(name, inputs):
    wrapper, pallas_call, rand, script, exact = CASES[name]
    xs = rand(np.random.default_rng(sorted(CASES).index(name))) if inputs == "random" else script()
    xs = [np.asarray(x, np.float32) for x in xs]
    got = wrapper(*(torch.tensor(x) for x in xs)).numpy()
    _compare(got, pallas_call(*xs), exact)


def test_write_input_ref_leaves_its_input_unchanged():
    a = torch.tensor(np.random.default_rng(3).normal(size=(5, TB, P, P)), dtype=torch.float32)
    before = a.clone()
    out = pk.write_input_ref(a)
    assert torch.equal(a, before)
    assert not torch.equal(out, a)


#: the tile rows' Pallas bodies: row 1's takes two tiles, rows 2 and 7 a
#: tile and a vector, row 8 a tile
TILE_ROWS = {"batched_dot": PM.k1, "bcast_mul_lane_reduce": PM.k2, "batched_matvec": PM.k7,
             "batched_transpose": PM.k8}
#: edge shapes the wrappers take, each against its Pallas body: rows 1, 2,
#: 7 and 8 at one tile and at odd counts of tiles; row 10 at one row (the
#: body runs its fixed 5 steps; the recurrence is causal, so the first n
#: rows of its result are the n-row result) and at rows of 9 floats, not a
#: multiple of 4 (the body run with its module's TB and P set to 1 and 3)
EDGE_CASES = [("batched_dot", (1, P, P)), ("batched_dot", (7, P, P)),
              *[(name, (b, P, P)) for name in ("bcast_mul_lane_reduce", "batched_matvec",
                                               "batched_transpose")
                for b in (1, 7, 9)],
              ("write_input_ref", (1, TB, P, P)), ("write_input_ref", (5, 1, 3, 3)),
              ("write_input_ref", (1, 1, 3, 3))]


@pytest.mark.parametrize("name, shape", EDGE_CASES)
def test_probe_matches_pallas_body_on_edge_shapes(name, shape, monkeypatch):
    r = np.random.default_rng(sum(shape))
    if name in TILE_ROWS:
        others = {"batched_dot": [shape], "batched_transpose": []}.get(name, [shape[:2]])
        xs = [r.normal(size=s).astype(np.float32) for s in (shape, *others)]
        got = pk.KERNELS[name](*(torch.tensor(x) for x in xs)).numpy()
        want = _pallas(TILE_ROWS[name], got.shape, [VMEM] * len(xs))(*xs)
        _compare(got, want, exact=name == "batched_transpose")
        return
    n, tb, p, _ = shape
    monkeypatch.setattr(PM2, "TB", tb)
    monkeypatch.setattr(PM2, "P", p)
    a = r.normal(size=(5, tb, p, p)).astype(np.float32)
    got = pk.write_input_ref(torch.tensor(a[:n])).numpy()
    _compare(got, _pallas(PM2.k2, a.shape, [VMEM])(a)[:n], exact=True)


def test_write_input_ref_is_twice_cumsum_within_summation_order():
    """2 * torch.cumsum(a, 0), row 10's library call, computes the plain
    loop's function: 2 a[n] is exact, and two float32 sums of the same n
    terms in different orders differ by at most 2 n 2^-24 of the sum of
    the terms' magnitudes. On the CPU cumsum does not add in the loop's
    order, so the two are close, not equal."""
    a = torch.tensor(np.random.default_rng(6).normal(size=(5, TB, P, P)), dtype=torch.float32)
    want = tpm2.write_input_ref_plain(a)
    got = 2 * torch.cumsum(a, 0)
    n = torch.arange(1, 6, dtype=torch.float32).reshape(5, 1, 1, 1)
    bound = 2 * n * 2.0**-24 * torch.cumsum(2 * a.abs(), 0)
    assert torch.all((got - want).abs() <= bound)


def _chain_pallas(a, K, prec):
    return _pallas(partial(PM2.chain_kernel, K=K, prec=prec), a.shape, [VMEM])(a)


def _scaled_orthogonal(tb, seed, scale=0.9):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(tb, P, P)))
    return (scale * q).astype(np.float32)


@pytest.mark.parametrize("tb", [1, 4])
def test_chain_highest_matches_pallas_body(tb):
    K = 5
    eye = (np.eye(P, dtype=np.float32)[None] * 0.999).repeat(tb, 0)
    for a in (_scaled_orthogonal(tb, tb), eye):
        got = pk.chain_highest(torch.tensor(a), K).numpy()
        _compare(got, _chain_pallas(a, K, jax.lax.Precision.HIGHEST), exact=False)


def test_chain_tf32_matches_pallas_body_within_tf32_rounding():
    """The TF32 chain rounds a and every x to TF32 (10 mantissa bits), so
    each step's product moves by at most 2 * 2^-11 of its norm for
    a = 0.9 Q, Q orthogonal (norms shrink by 0.9 a step and nothing is
    amplified): after K steps the result is within K * 2^-10 of the
    float32 chain in the Frobenius norm. The Pallas body at DEFAULT
    precision runs in float32 on the CPU."""
    K = 5
    a = _scaled_orthogonal(2, 11)
    got = pk.chain_tf32(torch.tensor(a), K).numpy()
    want = _chain_pallas(a, K, jax.lax.Precision.DEFAULT)
    err = np.linalg.norm(got - want, axis=(-2, -1))
    assert np.all(err <= K * 2.0**-10 * np.linalg.norm(want, axis=(-2, -1))), err
    assert np.any(got != want)  # the rounding took place


def _tf32_reference(x):
    """Round to 11 significant bits, ties away from zero (cvt.rna), via
    frexp: independent of the bit trick the port uses."""
    m, e = np.frexp(np.float64(x))
    return np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) / 2.0**11 * 2.0**e


def test_chain_tf32_on_the_script_input_is_the_scalar_tf32_recurrence():
    """On 0.999 I every product has one nonzero term, so the chain is the
    scalar recurrence x <- f32(tf32(c) tf32(x)) exactly."""
    K = 40
    a = np.eye(P, dtype=np.float32)[None] * np.float32(0.999)
    got = pk.chain_tf32(torch.tensor(a), K).numpy()
    c = np.float32(a[0, 0, 0])
    x = c
    for _ in range(K):
        x = np.float32(_tf32_reference(c) * _tf32_reference(x))
    np.testing.assert_array_equal(np.diagonal(got[0]), np.full(P, x))
    assert got[0][~np.eye(P, dtype=bool)].max() == 0.0


def test_round_tf32_matches_an_independent_rounding():
    x = np.random.default_rng(5).normal(size=4096).astype(np.float32) * np.float32(1e3)
    x[:4] = [0.999, -0.999, 1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-11)]  # two ties, away from zero
    got = tpm2.round_tf32(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_reference(x).astype(np.float32))


def test_probe_entry_points_give_the_scripts_values_on_the_cpu():
    want = {"batched_dot": 32.0, "bcast_mul_lane_reduce": 64.0, "value_at_set_static": 2.0,
            "dma_out_any": 3.0, "batched_matvec": 64.0}
    for name, t in tpm.PROBES:
        out = t(device="cpu")
        if name in want:
            assert float(out.reshape(-1)[0]) == want[name]
    np.testing.assert_array_equal(tpm.t4(device="cpu").numpy(), _arange(4, B, P) + 1)
    np.testing.assert_array_equal(tpm.t5(device="cpu")[:, 0, 0].numpy(), np.arange(1.0, 7.0))
    np.testing.assert_array_equal(tpm.t8(device="cpu").numpy(), _arange(*S3).transpose(0, 2, 1))
    np.testing.assert_array_equal(tpm2.t2(device="cpu")[:, 0, 0, 0].numpy(), [2, 4, 6, 8, 10])
    np.testing.assert_array_equal(tpm2.t1(device="cpu")[:, 0, 0, 0].numpy(), [1, 2, 3, 4, 5])
    tpm2.t3(device="cpu")


def test_probe_mains_report_and_exit_non_zero_on_a_failure(monkeypatch, capsys):
    monkeypatch.setattr(tpm, "PROBES", [("batched_dot", lambda: tpm.t1("cpu"))])
    assert tpm.main() == 0
    assert capsys.readouterr().out == "OK   batched_dot: [32. 32.]\n"

    def broken():
        raise RuntimeError("probe_batched_dot failed to launch: CUDA error 1")

    monkeypatch.setattr(tpm, "PROBES", [("batched_dot", broken)])
    assert tpm.main() == 1
    assert capsys.readouterr().out.startswith("FAIL batched_dot: RuntimeError")


def test_time_chain_on_the_cpu_prints_the_scripts_line(capsys):
    ns = tpm2.time_chain(2, K=3, prec="default", device="cpu")
    assert ns > 0
    assert re.fullmatch(r"TIME batched_matmul_chain TB=2 prec=default: \d+ ns/op\n",
                        capsys.readouterr().out)
    with pytest.raises(ValueError):
        tpm2.time_chain(2, K=3, prec="bf16", device="cpu")


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        pk.batched_dot(torch.zeros(2, 32, 16), torch.zeros(2, 32, 16))
    with pytest.raises(ValueError):
        pk.bcast_mul_lane_reduce(torch.zeros(2, 32, 32), torch.zeros(3, 32))
    with pytest.raises(ValueError):
        pk.chain_highest(torch.zeros(9, 32, 32), 1)
    with pytest.raises(ValueError):
        pk.dyn4d_scratch(torch.zeros(5, 32, 32))
    with pytest.raises(ValueError, match="leading row axis"):
        pk.ring_dyn_index(torch.zeros(5))
    with pytest.raises(ValueError, match="K must be"):
        pk.chain_highest(torch.zeros(1, 32, 32), -1)
    # a tensor that is not on the CPU goes to the kernel or raises: no fallback. A
    # meta tensor is on no device, so every check before the device's shows on it
    meta = torch.empty(2, 32, 32, device="meta")
    for wrapper, args in [(pk.batched_dot, (meta, meta)), (pk.value_at_set_static, (meta,)),
                          (pk.dma_hbm_ring, (meta,)), (pk.chain_tf32, (meta, 2)),
                          (pk.ring_dyn_index, (meta,)), (pk.batched_dot, (meta, torch.empty(2, 32, 32))),
                          (pk.dyn4d_scratch, (meta[None],))]:
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(*args)
    misaligned = torch.empty(2 * 32 * 32 + 1, device="meta")[1:].view(2, 32, 32)
    for wrapper in (pk.ring_dyn_index, pk.dyn4d_scratch, pk.batched_transpose,
                    pk.bcast_mul_lane_reduce):
        a = meta[None] if wrapper is pk.dyn4d_scratch else meta
        args = (a, torch.empty(2, 32, device="meta")) if wrapper is pk.bcast_mul_lane_reduce else (a,)
        with pytest.raises(TypeError, match="float32"):
            wrapper(*(t.double() for t in args))
        with pytest.raises(ValueError, match="not contiguous"):
            wrapper(a.transpose(-1, -2), *args[1:])
        with pytest.raises(ValueError, match="16-byte aligned"):
            wrapper(misaligned[None] if wrapper is pk.dyn4d_scratch else misaligned, *args[1:])
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        pk.dma_out_any(torch.empty(4, 3, device="meta"))


def test_probe_source_holds_one_hand_written_kernel_per_row():
    """13 kernels (rows 1-11, and row 12 at FP32 and TF32), each behind an
    extern "C" launcher the wrapper binds; row 4 loads with cp.async.bulk
    completing on per-slot mbarriers, row 6 stores with bulk async copies
    after a proxy fence and waits for their reads, both over a grid that
    grows with the row (one CTA per 2 KB column slice), not one CTA; row 9
    copies into its slab with 16-byte cp.async; row 1 runs register tiles
    and row 10 one pass; no library or PyTorch header; the chains run one
    CTA a tile, TF32 by raw mma.sync; rows 2 and 7 run one warp a tile, a
    grid in tiles, with float4 loads of the tile, through one device
    function; row 8 runs a grid in tiles, a CTA of a few warps a tile (no
    longer 32 x 32 threads), with float4 accesses; beside them, one empty
    kernel, a measuring aid."""
    src = pk.SOURCE.read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src)
    kernels.remove("empty_kernel")  # the floor under the probes' device times, not a port
    assert len(kernels) == 13 == len(set(kernels)) == len(pk.KERNELS)
    for name in pk._SIGNATURES:
        assert f'extern "C" int {name}(' in src
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert "mbarrier.try_wait.parity" in src
    assert "cp.async.bulk.global.shared::cta.bulk_group" in src
    assert "fence.proxy.async.shared::cta" in src
    assert "cp.async.bulk.wait_group.read 0" in src
    assert "uint64_t bar[RING_DEPTH]" in src  # one mbarrier per ring slot
    for launcher, kernel in (("probe_dma_ring", "dma_ring_kernel"), ("probe_dma_out", "dma_out_kernel")):
        body = src[src.index(f'extern "C" int {launcher}('):]
        body = body[:body.index("\n}\n")]
        grid = re.search(kernel + r"<<<([^,]+),", body).group(1)
        assert grid == "(row4 + BULK_THREADS - 1) / BULK_THREADS"
    assert re.search(r"constexpr int BULK_THREADS = 128;", src)
    assert "cp.async.cg.shared.global" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    for launcher, kernel in (("probe_chain_fp32", "chain_fp32_kernel"),
                             ("probe_chain_tf32", "chain_tf32_kernel")):
        body = src[src.index(f'extern "C" int {launcher}('):]
        assert re.search(kernel + r"<<<TB, ", body[:body.index("\n}\n")])  # one CTA a tile
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    # row 1: one CTA of 128 threads a tile, each a 2 x 4 block of registers; row 10:
    # row 5's grid of float4 columns, o[n-1] carried in registers, never read back
    assert "batched_dot_kernel<<<B, DOT_THREADS, " in src and "float acc[2][4]" in src
    assert re.search(r"recur_kernel<<<\(cols \+ RING_THREADS - 1\) / RING_THREADS, RING_THREADS", src)
    recur = src[src.index("void recur("):src.index("__global__ void recur_kernel")]
    assert "o[" in recur and "= o[" not in recur and "+ o[" not in recur
    callees = set()
    for launcher, kernel in (("probe_lane_reduce", "lane_reduce_kernel"),
                             ("probe_matvec", "matvec_kernel")):
        body = src[src.index(f'extern "C" int {launcher}('):]
        body = body[:body.index("\n}\n")]
        assert re.search(kernel + r"<<<B, 32, ", body)  # a grid of tiles, one warp each
        body = src[src.index(f"{kernel}(const float*"):]
        callees.update(re.findall(r"(\w+)\(", body[body.index("{"):body.index("\n}\n")]))
    (device_fn,) = callees  # both kernels are one call of the same device function
    mv = src[src.index(f"void {device_fn}("):]
    assert re.search(r"__device__\s+(?:__forceinline__\s+)?$", src[:src.index(f"void {device_fn}(")])
    assert "float4" in mv[:mv.index("\n}\n")]
    body = src[src.index('extern "C" int probe_transpose('):]
    body = body[:body.index("\n}\n")]
    grid, block = re.search(r"transpose_kernel<<<\s*([^,]+),\s*([^,]+),", body).groups()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    threads = math.prod(int(consts.get(f.strip(), f)) for f in block.split("*"))
    assert grid.strip() == "B" and threads % 32 == 0 and threads <= 256  # a CTA of warps a tile
    assert not re.search(r"dim3\s*\(\s*T\s*,\s*T\s*\)", src)
    tr = src[src.index("transpose_kernel(const"):]
    assert "float4" in tr[:tr.index("\n}\n")]
    for banned in ("cublas", "cudnn", "torch/", "cutlass"):
        assert banned not in src.lower()
    assert pk.LIBRARY.parent.name == "_build" and pk.LIBRARY.name == "libprobes.so"
    assert "arch=compute_90a,code=sm_90a" in " ".join(_nvcc.NVCC_FLAGS)
