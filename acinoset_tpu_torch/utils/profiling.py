"""Stage timing and build observability, the counterpart of
acinoset_tpu.utils.profiling.

``StageTimer`` keeps the reference's wall-clock prints around its stages
and accumulates a report. The port has no jit: its compilations are the
native builds, ``nvcc`` of the CUDA kernels (``kernels._nvcc.build``) and
``g++`` of the host helpers (``utils._gxx.build``), counted by
``compile_count``; ``RecompileGuard`` asserts a region runs none.
``profiler_trace`` wraps ``torch.profiler`` for deep dives.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StageTimer:
    records: List[Dict] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = True):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.records.append(dict(stage=name, seconds=dt))
        if verbose:
            print(f"{name} took {dt:.2f} seconds")

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out


def compile_count() -> int:
    """Native builds (nvcc and g++) this process has run so far."""
    from ..kernels import _nvcc
    from . import _gxx

    return _nvcc.build.runs + _gxx.build.runs


class RecompileGuard:
    """Assert a code region runs no fresh native build.

    Usage:
        with RecompileGuard():
            step(batch)   # every kernel already built
    """

    def __init__(self, allowed: int = 0):
        self.allowed = allowed

    def __enter__(self):
        self.before = compile_count()
        return self

    def __exit__(self, *exc):
        after = compile_count()
        if after - self.before > self.allowed:
            raise AssertionError(f"{after - self.before} native build(s) inside RecompileGuard")
        return False


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the body, CPU and CUDA activities,
    written under ``log_dir`` as a Chrome trace (``trace.json``); a no-op
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
