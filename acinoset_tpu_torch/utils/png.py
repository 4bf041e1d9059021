"""A PNG reader for calibration frames, the port's stand-in for
``imageio.imread``: 8-bit, non-interlaced grey, grey+alpha, RGB and
RGBA images (PNG specification, sections 5-9). Any other file raises,
naming it. Also the writer of the same images, with optional ``tEXt``
chunks (section 11.3.4.3), and a reader of those chunks.

The stream is inflated with ``zlib``. Scanline filters 0-2 (None, Sub,
Up) are undone in numpy; filters 3 and 4 (Average, Paeth) depend on the
byte just decoded to the left, so a small C function
(``csrc/png_unfilter.cpp``, built with ``g++`` at its first use into
``acinoset_tpu_torch/_build/``) undoes them a row at a time.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from . import _gxx

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples a pixel of each colour type read: grey, RGB, grey+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
SOURCE = Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
LIBRARY = _gxx.BUILD_DIR / "libpng_unfilter.so"

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
    lib = ctypes.CDLL(str(_gxx.build(SOURCE, LIBRARY)))
    lib.png_unfilter_row.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int]
    lib.png_unfilter_row.restype = ctypes.c_int
    return lib


def _chunks(path, data):
    """(type, payload) of every chunk, each CRC checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _unfilter(path, rows, bpp):
    """Undo each scanline's filter in place; rows (H, 1 + stride) uint8,
    column 0 the filter type. Returns the (H, stride) raw bytes."""
    kinds = rows[:, 0].copy()
    out = rows[:, 1:]
    zero = np.zeros(out.shape[1], np.uint8)
    for i, kind in enumerate(kinds):
        row = out[i]
        prev = out[i - 1] if i else zero
        if kind == 1:
            row[:] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row += prev
        elif kind in (3, 4):
            _library().png_unfilter_row(int(kind), row.ctypes.data, prev.ctypes.data,
                                        row.shape[0], bpp)
        elif kind != 0:
            raise ValueError(f"{path}: unknown PNG filter type {kind} in row {i}")
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG file into a uint8 array (H, W) for grey, else
    (H, W, C) with C = 2 (grey+alpha), 3 (RGB) or 4 (RGBA), as
    ``imageio.imread`` returns it. Raises ValueError for a file that is
    not an 8-bit, non-interlaced PNG of one of those colour types."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    W, H, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS or compression or filtering or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}); 8-bit non-interlaced grey, grey+alpha, RGB "
                         f"or RGBA only")
    C = CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (1 + W * C):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, expected "
                         f"{H * (1 + W * C)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + W * C).copy()
    img = np.ascontiguousarray(_unfilter(path, rows, C))
    return img.reshape(H, W) if C == 1 else img.reshape(H, W, C)


def read_png_text(path) -> dict:
    """The keyword -> text pairs of a PNG file's ``tEXt`` chunks, in file
    order (Latin-1, as the specification has them)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    out = {}
    for kind, payload in _chunks(path, data):
        if kind == b"tEXt":
            key, _nul, text = payload.partition(b"\x00")
            out[key.decode("latin-1")] = text.decode("latin-1")
    return out


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _text_chunk(key, text):
    """A ``tEXt`` chunk: a keyword of 1-79 Latin-1 characters, no
    leading, trailing or doubled spaces; characters outside Latin-1
    become '?'."""
    k = " ".join(str(key).split()).encode("latin-1", "replace")
    if not 1 <= len(k) <= 79:
        raise ValueError(f"PNG tEXt keyword {key!r}: 1-79 characters")
    return _chunk(b"tEXt", k + b"\x00" + str(text).encode("latin-1", "replace"))


def write_png(path, img, level=1, text=None):
    """Write a uint8 image (H, W) or (H, W, C), C = 2 (grey+alpha), 3
    (RGB) or 4 (RGBA), as an 8-bit PNG whose row i has filter type
    i % 5, so that a reader meets all five (PNG specification, section
    9). ``text``, a mapping or (keyword, text) pairs, adds a ``tEXt``
    chunk each, between the header and the image data."""
    a = np.ascontiguousarray(img, np.uint8)
    H, W = a.shape[:2]
    C = 1 if a.ndim == 2 else a.shape[2]
    raw = a.reshape(H, W * C).astype(np.int16)
    prev = np.zeros_like(raw)
    prev[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, C:] = raw[:, :-C]
    upleft = np.zeros_like(raw)
    upleft[:, C:] = prev[:, :-C]
    out = np.empty((H, 1 + W * C), np.uint8)
    for kind in range(5):
        x, lf, up, ul = (m[kind::5] for m in (raw, left, prev, upleft))
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = lf
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (lf + up) >> 1
        else:
            p = lf + up - ul
            pa, pb, pc = np.abs(p - lf), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), lf, np.where(pb <= pc, up, ul))
        out[kind::5, 0] = kind
        out[kind::5, 1:] = (x - pred) & 0xFF

    pairs = text.items() if isinstance(text, dict) else (text or ())
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
                + b"".join(_text_chunk(k, v) for k, v in pairs)
                + _chunk(b"IDAT", zlib.compress(out.tobytes(), level))
                + _chunk(b"IEND", b""))
