"""ctypes binding to the repository's C++ corner engine,
``native/corners.cpp`` (its C interface: ``acinoset_detect_corners`` and
``acinoset_detect_corners_batch``), the counterpart of
acinoset_tpu.calib.native: a multithreaded host detector of the same
method as calib.corners.

The library is built from the checkout's ``native/corners.cpp`` at
first use, with ``native/Makefile``'s flags (``utils._gxx``), into
``acinoset_tpu_torch/_build/libacinoset_native.so``. A failed build
raises; no prebuilt library is looked for. ``available()`` says whether
the library builds and loads here.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..utils import _gxx

SOURCE = Path(__file__).resolve().parents[2] / "native" / "corners.cpp"
LIBRARY = _gxx.BUILD_DIR / "libacinoset_native.so"

_lib = None
_lib_lock = threading.Lock()


def _library():
    """The loaded library, built at the first call; the first calls may
    come from several threads at once, and one builds it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load():
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing: the native engine is built from the "
                           f"repository's native/corners.cpp")
    lib = ctypes.CDLL(str(_gxx.build(SOURCE, LIBRARY)))
    lib.acinoset_detect_corners.restype = ctypes.c_int
    lib.acinoset_detect_corners.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.acinoset_detect_corners_batch.restype = ctypes.c_int
    lib.acinoset_detect_corners_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    return lib


def available() -> bool:
    """Whether the engine builds (or is built) and loads: False where
    ``native/corners.cpp`` or ``g++`` is missing or the build fails.
    It selects nothing: ``find_corners_images(engine='auto')`` raises
    either way."""
    try:
        _library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _to_gray_f32(image: np.ndarray) -> np.ndarray:
    """The engine's input, made as the JAX package's binding makes it:
    the BGR weights on RGB channels, the float32 cast, then 1/255 where
    the maximum exceeds 2 (after the cast, unlike calib.corners)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img @ np.array([0.114, 0.587, 0.299])
    img = img.astype(np.float32)
    if img.max() > 2:
        img = img / 255.0
    return np.ascontiguousarray(img)


def find_corners(image: np.ndarray, board_shape: Tuple[int, int]):
    """Native twin of calib.corners.find_corners. Returns (grid, found)."""
    lib = _library()
    gray = _to_gray_f32(image)
    H, W = gray.shape
    bh, bw = board_shape
    out = np.zeros((bh * bw * 2,), np.float64)
    ok = lib.acinoset_detect_corners(
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W, bh, bw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if not ok:
        return None, False
    return out.reshape(bh, bw, 2), True


def find_corners_batch(
    images: List[np.ndarray], board_shape: Tuple[int, int], n_threads: int = 0
):
    """Detect boards in a stack of same-size images with the engine's
    thread pool (n_threads 0: one a hardware thread). Returns (grids
    (F, h, w, 2) with NaN where not found, found mask)."""
    lib = _library()
    grays = np.ascontiguousarray(np.stack([_to_gray_f32(im) for im in images]))
    F, H, W = grays.shape
    bh, bw = board_shape
    out = np.zeros((F, bh * bw * 2), np.float64)
    found = np.zeros(F, np.int32)
    lib.acinoset_detect_corners_batch(
        grays.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        F, H, W, bh, bw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        found.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    grids = out.reshape(F, bh, bw, 2)
    grids[found == 0] = np.nan
    return grids, found.astype(bool)
