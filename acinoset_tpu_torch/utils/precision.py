"""Matmul-precision pin, the counterpart of acinoset_tpu.utils.precision.

On Hopper the analogue of the TPU's default bf16 matmul passes is TF32:
a float32 matmul may run on the tensor cores with a 10-bit mantissa,
and cuDNN does so by default. The Gauss-Newton normal equations and the
banded Cholesky span ~1e7 of dynamic range (the JAX package pins
Precision.HIGHEST for the banded solve and the polish tail), so the
port runs every float32 product in full float32.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmuls():
    """Run the body with TF32 disabled for matmuls and cuDNN and the
    float32 matmul precision at "highest"; restore the previous settings
    on exit. Usable as a decorator (``@f32_matmuls()``)."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
