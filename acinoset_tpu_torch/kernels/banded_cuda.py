"""Batched block-banded Cholesky factor + solve: a hand-written CUDA
kernel for Hopper (``csrc/banded_chol.cu``), the port of the TPU kernel
``acinoset_tpu/kernels/banded_pallas.py`` (``banded_solve_pallas``).

The kernel is compiled at first use by ``nvcc`` into a shared library
with a plain C interface, ``acinoset_tpu_torch/_build/libbanded.so``,
and loaded with ``ctypes``; the build is skipped while the library is
newer than its source. ``banded_solve`` launches the kernel for CUDA
tensors and runs the plain PyTorch version,
``solvers.banded.block_banded_solve_unrolled``, for CPU tensors. It is
what ``FteConfig(linear_solver='pallas')`` selects.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import torch

from ..solvers.banded import block_banded_solve_unrolled
from . import _nvcc
from ._nvcc import NVCC_FLAGS  # noqa: F401  (the flags build() compiles with)

PP = 32  # the kernel's padded block edge: P may be at most this
SOURCE = Path(__file__).resolve().parent / "csrc" / "banded_chol.cu"
LIBRARY = Path(__file__).resolve().parents[1] / "_build" / "libbanded.so"
#: the same source built with -DBANDED_PHASE_CLOCK, which also exports
#: banded_chol_solve_clocked (clock64() stamps at the kernel's phase
#: borders; measurement only)
CLOCKED_LIBRARY = LIBRARY.with_name("libbanded_chol_clocked.so")

_lib = None
#: guards the library's first load and the launch count: the shards of a
#: device mesh (parallel.mesh) launch from threads of their own
_lock = threading.Lock()


def build(clocked: bool = False) -> Path:
    """Compile the kernel's source into ``LIBRARY`` (``_nvcc.build``), or
    with ``clocked`` into ``CLOCKED_LIBRARY``."""
    if clocked:
        return _nvcc.build(SOURCE, CLOCKED_LIBRARY, ("-DBANDED_PHASE_CLOCK",))
    return _nvcc.build(SOURCE, LIBRARY)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.banded_chol_solve.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p
            ]
            lib.banded_chol_solve.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_shapes(bands, g):
    if len(bands) != 4:
        raise ValueError(f"expected 4 bands (bandwidth 3), got {len(bands)}")
    if g.dim() != 3:
        raise ValueError(f"g must be (B, N, P), got shape {tuple(g.shape)}")
    B, N, P = g.shape
    for k, a in enumerate(bands):
        if tuple(a.shape) != (B, N, P, P):
            raise ValueError(f"bands[{k}] has shape {tuple(a.shape)}, expected {(B, N, P, P)}")


def _check_cuda(bands, g):
    for name, t in [(f"bands[{k}]", a) for k, a in enumerate(bands)] + [("g", g)]:
        if t.device != g.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all operands must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the CUDA kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if g.shape[-1] > PP:
        raise ValueError(f"P={g.shape[-1]} exceeds the kernel's block edge {PP}")


def banded_solve(bands: Sequence[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """Solve A x = g for a batch of SPD block-banded systems: bands
    [A0..A3] each (B, N, P, P) with bands[k][b, n] = block (n, n-k), g
    (B, N, P). The caller supplies Jacobi-scaled (unit-diagonal) systems,
    as ``solvers.trajopt`` does.

    CPU tensors go to the plain version; CUDA tensors (float32,
    contiguous, P <= 32) launch the kernel, and anything else raises.
    ``banded_solve.launches`` counts kernel launches."""
    bands = list(bands)
    _check_shapes(bands, g)
    if g.device.type == "cpu" and all(a.device.type == "cpu" for a in bands):
        return block_banded_solve_unrolled(bands, g)
    _check_cuda(bands, g)
    B, N, P = g.shape
    x = torch.empty_like(g)
    if B == 0 or N == 0 or P == 0:
        return x
    lib = _library()
    fac = torch.empty((B, N, 4, PP, PP), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.banded_chol_solve(
            *(ctypes.c_void_p(t.data_ptr()) for t in (*bands, g, x, fac)),
            B, N, P, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"banded_chol_solve failed to launch: CUDA error {err}")
    with _lock:
        banded_solve.launches += 1
    return x


banded_solve.launches = 0
