"""Build a CUDA source of the port into a shared library with a plain C
interface: ``nvcc`` for Hopper (``sm_90a``), no PyTorch headers, so a
build takes seconds. The library goes under ``acinoset_tpu_torch/_build/``
and is loaded by the kernel's wrapper with ``ctypes``."""
from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
TIMEOUT_S = 180
_count_lock = threading.Lock()


def log_path(library: Path) -> Path:
    """Where ``build`` keeps the compiler's output (ptxas registers and
    spills per kernel) beside the library."""
    return library.with_suffix(".log")


def build(source: Path, library: Path, extra_flags: tuple = ()) -> Path:
    """Compile ``source`` into ``library`` (``NVCC_FLAGS`` plus
    ``extra_flags``) unless the library is newer than the source. Raises
    if ``nvcc`` fails or takes over 180 s."""
    if library.exists() and library.stat().st_mtime > source.stat().st_mtime:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = library.with_name(f"{library.stem}.{os.getpid()}.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(source)], timeout=TIMEOUT_S,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log_path(library).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, library)  # atomic: a concurrent loader sees the old or the new library
    with _count_lock:
        build.runs += 1
    return library


#: builds this process has run (a library newer than its source is not
#: rebuilt and not counted); read by utils.profiling.compile_count
build.runs = 0
