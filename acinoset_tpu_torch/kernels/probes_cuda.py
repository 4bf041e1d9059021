"""The Mosaic probe kernels as hand-written CUDA kernels for Hopper
(``csrc/probes.cu``), the port of the TPU kernels of
``scripts/probe_mosaic.py`` (k1..k8) and ``scripts/probe_mosaic2.py``
(k1..k3, ``chain_kernel``).

The kernels are compiled at first use by ``nvcc`` into
``acinoset_tpu_torch/_build/libprobes.so`` (``_nvcc.build``) and loaded
with ``ctypes``. Each wrapper launches its kernel for CUDA tensors
(float32, contiguous, 16-byte aligned, on one device) and raises on
anything else; for CPU tensors it runs the plain PyTorch version from
``probes.probe_mosaic`` / ``probes.probe_mosaic2``. Each wrapper counts
its kernel launches in ``<wrapper>.launches``. The wrappers carry the
probes' report names.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..probes import probe_mosaic as _pm
from ..probes import probe_mosaic2 as _pm2
from . import _nvcc

T = 32  # tile edge of every probe
TILE = (T, T)
MAX_CHAIN_TILES = 8
SOURCE = Path(__file__).resolve().parent / "csrc" / "probes.cu"
LIBRARY = Path(__file__).resolve().parents[1] / "_build" / "libprobes.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: launcher name -> (pointer arguments, int arguments); each ends with the stream
_SIGNATURES = {
    "probe_batched_dot": (3, 1),
    "probe_lane_reduce": (3, 1),
    "probe_matvec": (3, 1),
    "probe_scale_cols": (2, 1),
    "probe_dma_ring": (2, 2),
    "probe_ring_prefix": (2, 2),
    "probe_dma_out": (2, 2),
    "probe_transpose": (2, 1),
    "probe_dyn4d": (2, 2),
    "probe_recur": (2, 2),
    "probe_matvec_t": (3, 1),
    "probe_chain_fp32": (2, 2),
    "probe_chain_tf32": (2, 2),
    "probe_empty": (0, 0),
}

_F32 = torch.float32
# bound when the library loads: launcher name -> its ctypes function, and
# torch's getters of the current CUDA device and its current raw stream
_lib = _fns = _current_device = _raw_stream = None


def build() -> Path:
    """Compile ``csrc/probes.cu`` into ``LIBRARY`` (``_nvcc.build``)."""
    return _nvcc.build(SOURCE, LIBRARY)


def _library():
    global _lib, _fns, _current_device, _raw_stream
    if _lib is None:
        # PyDLL keeps the GIL through the call: a launcher enqueues one
        # kernel and calls no Python, so it has no use for releasing and
        # retaking the lock on every launch
        lib = ctypes.PyDLL(str(build()))
        fns = {}
        for name, (n_ptr, n_int) in _SIGNATURES.items():
            fn = fns[name] = getattr(lib, name)
            fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
            fn.restype = ctypes.c_int
        _current_device = torch._C._cuda_getDevice
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _lib, _fns = lib, fns
    return _lib


def _shape(name, t, ndim, tail):
    """Raise unless ``t`` has ``ndim`` axes, the last of them ``tail``."""
    dims = t.shape
    if len(dims) != ndim or dims[ndim - len(tail):] != tail:
        raise ValueError(f"{name} has shape {tuple(dims)}, expected {ndim} axes ending in {tail}")


def _on_cpu(*ts) -> bool:
    for t in ts:
        if not t.is_cpu:
            return False
    return True


def _check_cuda(*ts) -> int:
    """Raise unless every operand is a contiguous, 16-byte aligned float32
    tensor on one CUDA device; return that device's index. The device is
    checked last, so that every other refusal shows on a tensor that is
    on no device (``device="meta"``) as well."""
    dev = ts[0].get_device()
    for t in ts:
        if t.dtype is not _F32:
            raise TypeError(f"operand is {t.dtype}; the CUDA kernels take float32")
        if not t.is_contiguous():
            raise ValueError("operand is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError("operand is not 16-byte aligned")
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"operand on {t.device}; all operands must be on one CUDA device")
    return dev


def _launch(name, dev, *args):
    """Call launcher ``name`` with ``args`` (pointers as integers, then the
    sizes) and the raw handle of CUDA device ``dev``'s current stream. The
    device guard is entered only when ``dev`` is not the current device."""
    if _fns is None:
        _library()
    fn = _fns[name]
    if dev == _current_device():
        err = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _raw_stream(dev))
    if err:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def batched_dot(a, b):
    """Row 1: (B, 32, 32) @ (B, 32, 32) in FP32 (HIGHEST)."""
    _shape("a", a, 3, TILE)
    _shape("b", b, 3, tuple(a.shape))
    if _on_cpu(a, b):
        return _pm.batched_dot_plain(a, b)
    dev = _check_cuda(a, b)
    o = torch.empty_like(a)
    if a.shape[0]:
        _launch("probe_batched_dot", dev, a.data_ptr(), b.data_ptr(), o.data_ptr(), a.shape[0])
        batched_dot.launches += 1
    return o


def _tile_vec(launcher, plain, wrapper, a, v):
    """Rows 2, 7 and 11: a (B, 32, 32) and v (B, 32) in, y (B, 32) out."""
    _shape("a", a, 3, TILE)
    _shape("v", v, 2, (a.shape[0], T))
    if _on_cpu(a, v):
        return plain(a, v)
    dev = _check_cuda(a, v)
    y = torch.empty_like(v)
    if a.shape[0]:
        _launch(launcher, dev, a.data_ptr(), v.data_ptr(), y.data_ptr(), a.shape[0])
        wrapper.launches += 1
    return y


def _tile_map(launcher, plain, wrapper, a):
    """Rows 3 and 8: a (B, 32, 32) in, o of its shape out."""
    _shape("a", a, 3, TILE)
    if a.is_cpu:
        return plain(a)
    dev = _check_cuda(a)
    o = torch.empty_like(a)
    if a.shape[0]:
        _launch(launcher, dev, a.data_ptr(), o.data_ptr(), a.shape[0])
        wrapper.launches += 1
    return o


def bcast_mul_lane_reduce(a, v):
    """Row 2: sum(a * v[:, None, :], -1), a (B, 32, 32), v (B, 32)."""
    return _tile_vec("probe_lane_reduce", _pm.bcast_mul_lane_reduce_plain,
                     bcast_mul_lane_reduce, a, v)


def value_at_set_static(a):
    """Row 3: columns 0..3 of every (32, 32) tile of a (B, 32, 32) times 2."""
    return _tile_map("probe_scale_cols", _pm.value_at_set_static_plain, value_at_set_static, a)


def _row_kernel(launcher, plain, wrapper, x, bulk=False):
    """The ring and recurrence rows: x (N, ...) taken as N rows of
    ``row`` floats, o of its shape out."""
    if x.dim() < 2:
        raise ValueError(f"x must have a leading row axis, got shape {tuple(x.shape)}")
    if x.is_cpu:
        return plain(x)
    N = x.shape[0]
    row = x.numel() // N if N else 0
    if bulk and row % 4:
        raise ValueError(f"a row of {row} floats is not a multiple of 16 bytes")
    dev = _check_cuda(x)
    o = torch.empty_like(x)
    if row:
        _launch(launcher, dev, x.data_ptr(), o.data_ptr(), N, row)
        wrapper.launches += 1
    return o


def dma_hbm_ring(x):
    """Row 4: o[n] = x[n] + 1, rows brought in by bulk async copies
    through a ring of shared slots, each CTA one 2 KB column slice of
    every row. x (N, ...) with rows of a multiple of 16 bytes, any size."""
    return _row_kernel("probe_dma_ring", _pm.dma_hbm_ring_plain, dma_hbm_ring, x, bulk=True)


def ring_dyn_index(a):
    """Row 5: o[n] = a[n] + o[n-1] through a 3-slot shared ring, a (N, ...)."""
    return _row_kernel("probe_ring_prefix", _pm.ring_dyn_index_plain, ring_dyn_index, a)


def dma_out_any(x):
    """Row 6: o[n] = 3 x[n], rows written out by bulk async stores from
    shared scratch slots, each CTA one 2 KB column slice of every row.
    x (N, ...) with rows of a multiple of 16 bytes, any size."""
    return _row_kernel("probe_dma_out", _pm.dma_out_any_plain, dma_out_any, x, bulk=True)


def batched_matvec(a, v):
    """Row 7: (B, 32, 32) @ (B, 32) in FP32 (HIGHEST)."""
    return _tile_vec("probe_matvec", _pm.batched_matvec_plain, batched_matvec, a, v)


def batched_transpose(a):
    """Row 8: the last two axes of a (B, 32, 32) swapped."""
    return _tile_map("probe_transpose", _pm.batched_transpose_plain, batched_transpose, a)


def dyn4d_scratch(a):
    """Row 9: prefix sum over n of a (N, TB, 32, 32) through a scratch of
    the whole input in shared memory (at most 227 KB)."""
    _shape("a", a, 4, TILE)
    return _row_kernel("probe_dyn4d", _pm2.dyn4d_scratch_plain, dyn4d_scratch, a)


def write_input_ref(a):
    """Row 10: the recurrence a[n] = 2 a[n] + a[n-1] over a (N, ...) taken
    as N rows of any size (the probe's is (N, TB, 32, 32)), run in a copy:
    the input is left as it was."""
    return _row_kernel("probe_recur", _pm2.write_input_ref_plain, write_input_ref, a)


def matvec_transposed_contract(a, v):
    """Row 11: y[b, j] = sum_i a[b, i, j] v[b, i], a (B, 32, 32), v (B, 32)."""
    return _tile_vec("probe_matvec_t", _pm2.matvec_transposed_contract_plain,
                     matvec_transposed_contract, a, v)


def _chain(launcher, wrapper, prec, a, K):
    _shape("a", a, 3, TILE)
    if not 1 <= a.shape[0] <= MAX_CHAIN_TILES:
        raise ValueError(f"the chain takes 1..{MAX_CHAIN_TILES} tiles, got {a.shape[0]}")
    if K < 0:
        raise ValueError(f"K must be >= 0, got {K}")
    if a.is_cpu:
        return _pm2.chain_plain(a, K, prec)
    dev = _check_cuda(a)
    o = torch.empty_like(a)
    _launch(launcher, dev, a.data_ptr(), o.data_ptr(), a.shape[0], int(K))
    wrapper.launches += 1
    return o


def chain_highest(a, K):
    """Row 12, HIGHEST: K dependent steps x <- a @ x from x = a, in FP32
    FMA, on TB <= 8 tiles a (TB, 32, 32), one CTA a tile; returns a^(K+1)."""
    return _chain("probe_chain_fp32", chain_highest, "highest", a, K)


def chain_tf32(a, K):
    """Row 12, DEFAULT: the chain on the TF32 tensor cores (a and each x
    rounded to TF32, FP32 accumulation)."""
    return _chain("probe_chain_tf32", chain_tf32, "default", a, K)


def empty(device):
    """Launch the empty kernel once on CUDA device ``device``'s current
    stream, through the probes' launch path: a measuring aid (the floor
    under the probes' device times), not a ported kernel, so neither in
    ``KERNELS`` nor counted."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on a CUDA device, not {device}")
    _launch("probe_empty", torch.cuda.current_device() if device.index is None else device.index)


#: every wrapper, by the name chip_smoke.py and PERF.md give its kernel
KERNELS = {f.__name__: f for f in (
    batched_dot, bcast_mul_lane_reduce, value_at_set_static, dma_hbm_ring, ring_dyn_index,
    dma_out_any, batched_matvec, batched_transpose, dyn4d_scratch, write_input_ref,
    matvec_transposed_contract, chain_highest, chain_tf32,
)}
for _f in KERNELS.values():
    _f.launches = 0
