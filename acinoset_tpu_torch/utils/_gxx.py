"""Build a C++ source with a plain C interface into a shared library
for the host with ``g++`` (the flags of ``native/Makefile``, less its
warnings). The library goes under ``acinoset_tpu_torch/_build/`` and is
loaded with ``ctypes`` by the module that needs it."""
from __future__ import annotations

import os
import shutil
import subprocess
import threading
import tempfile
from pathlib import Path

GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared"]
TIMEOUT_S = 180
_count_lock = threading.Lock()
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def build(source: Path, library: Path) -> Path:
    """Compile ``source`` into ``library`` unless the library is newer
    than the source. Raises if ``g++`` is missing, fails or takes over
    180 s."""
    if library.exists() and library.stat().st_mtime > source.stat().st_mtime:
        return library
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ is not on PATH; it is needed to build {source.name}")
    library.parent.mkdir(parents=True, exist_ok=True)
    # a name of its own for each build, so that concurrent builds (other
    # processes, other threads) never share a temporary file
    fd, tmp = tempfile.mkstemp(prefix=f"{library.stem}.", suffix=".so", dir=library.parent)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(source)], timeout=TIMEOUT_S,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, library)  # atomic: a concurrent loader sees the old or the new library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with _count_lock:
        build.runs += 1
    return library


#: builds this process has run (a library newer than its source is not
#: rebuilt and not counted); read by utils.profiling.compile_count
build.runs = 0
