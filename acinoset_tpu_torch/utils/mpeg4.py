"""The port's MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video codec,
in an MP4 file with the ``mp4v`` sample entry: the codec the JAX package
writes through ``cv2.VideoWriter_fourcc(*"mp4v")``.

The codec has two halves:

- the bitstream (headers, macroblock layer, VLC codes, DC and AC
  prediction) is serial work and runs on the host, in C++
  (``csrc/mpeg4_vlc.cpp``, built with ``g++`` at its first use into
  ``acinoset_tpu_torch/_build/`` and loaded with ``ctypes``);
- the block transforms run on the device as int32 torch ops, so the CPU
  and the card give the same coefficients, frames and bytes: colour
  conversion (BT.601 limited range, 4:2:0), the forward DCT (the
  integer "islow" DCT of libjpeg) and H.263 quantisation, dequantisation
  and the IDCT (the fixed-point row/column IDCT of ffmpeg's "simple"
  IDCT, which meets IEEE Std 1180-1990), half-pel motion compensation
  (``vop_rounding_type`` honoured, references clamped to the coded
  frame's edge) and the clipped add.

Decoding: frame n's sample is parsed on the host into per-macroblock
types and vectors and the coded blocks' levels with their index; these
go to the device, which rebuilds the frame on the reference kept there.
``Reader`` seeks from the nearest preceding sync sample, and parses the
next sample on a worker thread while the device takes the current one.

Encoding (``Writer``): every ``GOP``-th frame is an I-VOP, the others
P-VOPs whose macroblocks are coded with the zero vector, at the fixed
quantiser ``QP``; a macroblock whose quantised residual is all zero is
sent as not coded. The writer keeps its reconstruction on the device,
bit for bit what the decoder rebuilds, and writes each frame's
bitstream on a worker thread while the device takes the next frame.

Anything else than mp4v raises ``UnsupportedVideo`` (H.264 and HEVC go
to ``utils.nvdec``), and so does an mp4v stream that uses a tool outside what is
decoded here (4MV, B-VOPs, resync markers, data partitioning, quarter-pel,
interlace, sprites, MPEG quantisation, not-8-bit, shape), naming it.
"""
from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _gxx, mp4
from .device import resolve_device

SOURCE = Path(__file__).resolve().parent / "csrc" / "mpeg4_vlc.cpp"
LIBRARY = _gxx.BUILD_DIR / "libmpeg4_vlc.so"

#: the writer's quantiser and I-VOP period
QP = 3
GOP = 12
#: frames whose bitstream the writer may still be coding
WRITER_AHEAD = 4

#: the int32 VOL record shared with the C++ side: found, width, height,
#: time resolution, time increment bits, verid
VOL_N = 6
#: sample entry types the port names when it refuses them
CODEC_NAMES = {"avc1": "H.264", "avc3": "H.264", "hvc1": "HEVC", "hev1": "HEVC",
               "av01": "AV1", "vp09": "VP9", "mjpa": "Motion JPEG", "jpeg": "Motion JPEG"}


#: the codec's work in this process: seconds in the C++ bitstream calls,
#: and bytes copied to and from a device other than the CPU (a frame that
#: stays on the device, as the labelled videos' do, moves none)
COUNTERS = {"host_s": 0.0, "to_device_bytes": 0, "to_host_bytes": 0}
_COUNTERS_LOCK = threading.Lock()


def _count(key, value):
    with _COUNTERS_LOCK:  # the bitstream calls run on worker threads
        COUNTERS[key] += value


def _moved(device, key, *arrays):
    if device.type != "cpu":
        _count(key, sum(int(a.nbytes) for a in arrays))


class UnsupportedVideo(NotImplementedError):
    """A video the port cannot decode; ``reason`` names the codec or the
    tool, without the file."""

    def __init__(self, fpath, reason):
        super().__init__(f"{fpath}: {reason}")
        self.reason = reason


# ---- the C++ library ----

_lib = None
_lib_lock = threading.Lock()
_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)


def _library():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(_gxx.build(SOURCE, LIBRARY)))
                lib.m4v_parse_config.argtypes = [_P, ctypes.c_int64, _P, ctypes.c_char_p,
                                                 ctypes.c_int]
                lib.m4v_decode_vop.argtypes = [_P, ctypes.c_int64, _P, _P, _P, _P, _P, _P,
                                               ctypes.c_int64, _I64P, ctypes.c_char_p,
                                               ctypes.c_int]
                lib.m4v_write_config.argtypes = [ctypes.c_int32] * 3 + [_P, ctypes.c_int]
                lib.m4v_encode_vop.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int64, _I64P,
                                               ctypes.c_char_p, ctypes.c_int]
                for f in (lib.m4v_parse_config, lib.m4v_decode_vop, lib.m4v_write_config,
                          lib.m4v_encode_vop):
                    f.restype = ctypes.c_int
                _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc, err, fpath):
    if rc == -2:
        raise UnsupportedVideo(fpath, f"{err.value.decode()}: the port decodes MPEG-4 Simple "
                                      "Profile I-, P- and N-VOPs only")
    if rc:
        raise ValueError(f"{fpath}: malformed MPEG-4 video ({err.value.decode()})")


def parse_config(config: bytes, fpath: str = "<config>") -> np.ndarray:
    """The VOL record of a decoder configuration (VOS/VO/VOL headers);
    its [0] is 0 where the bytes hold no VOL."""
    vol = np.zeros(VOL_N, np.int32)
    buf = np.frombuffer(config, np.uint8)
    err = ctypes.create_string_buffer(256)
    _check(_library().m4v_parse_config(_ptr(buf), len(buf), _ptr(vol), err, 256), err, fpath)
    return vol


def write_config(size: Tuple[int, int], time_res: int) -> bytes:
    """The VOS, VO and VOL headers of a Simple Profile stream of ``size``
    (width, height) whose VOP times count 1/time_res seconds."""
    out = np.zeros(64, np.uint8)
    k = _library().m4v_write_config(int(size[0]), int(size[1]), int(time_res), _ptr(out),
                                    len(out))
    return out[:k].tobytes()


#: macroblock modes of ``encode_vop``
MB_SKIP, MB_INTER, MB_INTER_Q, MB_INTRA, MB_INTRA_Q = range(5)


def encode_vop(vol: np.ndarray, vop_type: int, qp: int, mbs: np.ndarray, levels: np.ndarray,
               coded: bool = True, rounding: int = 0, fcode: int = 1, modulo: int = 0,
               time_inc: int = 0, gov_seconds: int = -1) -> bytes:
    """One VOP's bytes (a GOV header first where gov_seconds >= 0).
    vop_type 0 (I) or 1 (P); mbs (n_mb, 5) int16: each macroblock's mode
    (MB_*), dquant, ac_pred flag and absolute vector (half pels); levels
    (k, 64) int16: the 6 blocks of every macroblock not MB_SKIP, in order,
    quantised and in raster order as the decoder returns them (an intra
    block's [0] is its DC level)."""
    mbs = np.ascontiguousarray(mbs, np.int16)
    levels = np.ascontiguousarray(levels, np.int16)
    hdr = np.array([vop_type, int(coded), qp, rounding, fcode, modulo, time_inc, gov_seconds],
                   np.int32)
    out = np.zeros(levels.size * 4 + 4096, np.uint8)
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    t0 = time.perf_counter()
    rc = _library().m4v_encode_vop(_ptr(vol), _ptr(hdr), _ptr(mbs), _ptr(levels), _ptr(out),
                                   len(out), ctypes.byref(n), err, 256)
    _count("host_s", time.perf_counter() - t0)
    if rc:
        raise ValueError(f"encoding a VOP: {err.value.decode()}")
    return out[:n.value].tobytes()


# ---- integer transforms (int32 tensors on any device) ----

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def _wrap16(v):
    """An int32 value as the int16 it is stored in."""
    return ((v + 32768) & 0xFFFF) - 32768


def _idct_butterfly(x0, x1, x2, x3, x4, x5, x6, x7):
    """The simple IDCT's 1-D butterfly, before rounding: 8 linear forms."""
    a0 = a1 = a2 = a3 = W4 * x0
    a0, a1 = a0 + W2 * x2 + W4 * x4 + W6 * x6, a1 + W6 * x2 - W4 * x4 - W2 * x6
    a2, a3 = a2 - W6 * x2 - W4 * x4 + W2 * x6, a3 - W2 * x2 + W4 * x4 - W6 * x6
    b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7
    b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7
    b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7
    b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7
    return [a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0]


# libjpeg's jfdctint (13 fraction bits; PASS1_BITS = 2)
C0298, C0390, C0541, C0765, C0899, C1175 = 2446, 3196, 4433, 6270, 7373, 9633
C1501, C1847, C1961, C2053, C2562, C3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _fdct_butterfly(d0, d1, d2, d3, d4, d5, d6, d7):
    """jfdctint's 1-D butterfly, before its descaling: 8 linear forms."""
    t0, t7, t1, t6 = d0 + d7, d0 - d7, d1 + d6, d1 - d6
    t2, t5, t3, t4 = d2 + d5, d2 - d5, d3 + d4, d3 - d4
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    z1 = (t12 + t13) * C0541
    z5 = (t4 + t6 + t5 + t7) * C1175
    z1b, z2 = (t4 + t7) * -C0899, (t5 + t6) * -C2562
    z3, z4 = (t4 + t6) * -C1961 + z5, (t5 + t7) * -C0390 + z5
    return [t10 + t11, t7 * C1501 + z1b + z4, z1 + t13 * C0765, t6 * C3072 + z2 + z3,
            t10 - t11, t5 * C2053 + z2 + z4, z1 - t12 * C1847, t4 * C0298 + z1b + z3]


def _matrix(butterfly, scale_cols=()):
    """A linear butterfly as its int32 8 x 8 matrix (out = x @ M), the
    named columns scaled by 1 << 13."""
    eye = [[int(i == k) for i in range(8)] for k in range(8)]
    m = torch.tensor([butterfly(*row) for row in eye], dtype=torch.int32)
    for c in scale_cols:
        m[:, c] <<= 13
    return m


_IDCT = _matrix(_idct_butterfly)
#: jfdctint descales outputs 1-3 and 5-7 by 11 bits after pass 1 and 15
#: after pass 2, and shifts outputs 0 and 4 left by 2, then right by 2:
#: with those two columns scaled by 1 << 13, one rounding serves all eight
_FDCT = _matrix(_fdct_butterfly, scale_cols=(0, 4))


def _apply(x, m):
    """x (..., 8) @ m (8, 8) in int32, wrapping as the C code's 32-bit
    arithmetic does (any order of the sum gives the same bits): one
    broadcast product and one sum over its last axis, two kernels."""
    return (x[..., None, :] * m.T.to(x.device)).sum(-1, dtype=torch.int32)


def idct(coef: torch.Tensor) -> torch.Tensor:
    """The 8x8 inverse DCT of int32 coefficients (..., 8, 8), unclipped:
    ffmpeg's simple IDCT (rows with 11 fraction bits kept as int16, a row
    with only a DC term taken as DC << 3, then columns with 20; the
    column pass's rounding is 32 W4, (1 << 19) // W4 folded into the DC
    term as the C code folds it)."""
    x = coef.to(torch.int32)
    rows = _wrap16((_apply(x, _IDCT) + (1 << 10)) >> 11)
    dc_only = (x[..., 1:] == 0).all(-1, keepdim=True)
    rows = torch.where(dc_only, _wrap16(x[..., :1] * 8), rows)
    cols = _apply(rows.transpose(-1, -2), _IDCT) + 32 * W4
    return (cols >> 20).transpose(-1, -2)


def fdct8(pix: torch.Tensor) -> torch.Tensor:
    """8 x the 8x8 forward DCT of int32 samples (..., 8, 8): libjpeg's
    integer "islow" DCT, rows then columns, each output of a pass one
    linear form of its inputs, descaled once."""
    rows = (_apply(pix.to(torch.int32), _FDCT) + (1 << 10)) >> 11
    cols = (_apply(rows.transpose(-1, -2), _FDCT) + (1 << 14)) >> 15
    return cols.transpose(-1, -2).contiguous()


def _dc_scaler_table(luma):
    """Table 7-1 of ISO/IEC 14496-2: dc_scaler by QP (index 0 unused)."""
    out = [8]
    for q in range(1, 32):
        if q <= 4:
            out.append(8)
        elif luma:
            out.append(2 * q if q <= 8 else q + 8 if q <= 24 else 2 * q - 16)
        else:
            out.append((q + 13) // 2 if q <= 24 else q - 6)
    return out


_DC_SCALER = torch.tensor([_dc_scaler_table(False), _dc_scaler_table(True)], dtype=torch.int32)


def dequantise(levels, qp, intra, luma):
    """H.263 inverse quantisation (7.4.4.1): |F| = QP (2 |QF| + 1), less
    one for an even QP; an intra block's DC is QF x dc_scaler; clipped to
    [-2048, 2047]. levels (n, 64) int32; qp, intra, luma (n,)."""
    q = qp.to(torch.int32)[:, None]
    mag = q * (2 * levels.abs() + 1) - (1 - (q & 1))
    out = torch.where(levels == 0, 0, torch.where(levels < 0, -mag, mag))
    scale = _DC_SCALER.to(levels.device)[luma.long(), qp.long()]
    out[:, 0] = torch.where(intra, levels[:, 0] * scale, out[:, 0])
    return out.clamp(-2048, 2047)


def quantise_intra(coef8, qp, luma):
    """coef8 = 8 x DCT (n, 64): the DC rounded over dc_scaler, the AC
    |F| // (2 QP) (the H.263 intra quantiser)."""
    scale = _DC_SCALER.to(coef8.device)[luma.long(), qp]
    out = torch.sign(coef8) * (coef8.abs() // (16 * qp))
    out[:, 0] = (coef8[:, 0] + 4 * scale) // (8 * scale)
    return out.clamp(-2047, 2047)


def quantise_inter(coef8, qp):
    """(|F| - QP // 2) // (2 QP), signed (the H.263 inter quantiser)."""
    mag = ((coef8.abs() - 8 * (qp // 2)) // (16 * qp)).clamp(0, 2047)
    return torch.sign(coef8) * mag


# ---- colour (BT.601, limited range, 4:2:0) ----


#: BT.601 limited range, 8-bit weights of B, G, R: Y = (w . bgr + 128) >> 8
#: + 16; U and V from the 2 x 2 sums, (w . sum + 512) >> 10 + 128
_TO_YUV = torch.tensor([[25, 129, 66], [112, -74, -38], [-18, -94, 112]], dtype=torch.int32)


def bgr_to_yuv420(bgr: torch.Tensor, coded: Tuple[int, int]):
    """uint8 BGR (H, W, 3) -> int32 planes Y (H16, W16), U and V (H16/2,
    W16/2) of the coded size (W16, H16), the frame's edge repeated into
    the padding; chroma from each 2x2 block's sum."""
    H, W = bgr.shape[:2]
    W16, H16 = coded
    dev = bgr.device
    p = bgr
    if (H16, W16) != (H, W):
        p = p[torch.arange(H16, device=dev).clamp(max=H - 1)]
        p = p[:, torch.arange(W16, device=dev).clamp(max=W - 1)]
    p = p.to(torch.int32)
    w = _TO_YUV.to(dev)
    y = (((p * w[0]).sum(-1, dtype=torch.int32) + 128) >> 8) + 16
    s = p.view(H16 // 2, 2, W16 // 2, 2, 3).sum(dim=(1, 3), dtype=torch.int32)
    uv = (((s[..., None, :] * w[1:]).sum(-1, dtype=torch.int32) + 512) >> 10) + 128
    return y, uv[..., 0].contiguous(), uv[..., 1].contiguous()


#: the integer constants of the YUV -> BGR arithmetic below, by (VUI
#: matrix_coefficients family, full range): (ycoef, yoff, Cb->B, Cb->G,
#: Cr->G, Cr->R), what cv2's swscale uses for each (BT.601 covers streams
#: that signal no matrix, and matrices 5 and 6; BT.2020 is matrix 9). Each
#: was held to cv2 over every (Y, U, V) triple (tests/test_torch_h264.py);
#: full-range BT.2020 takes swscale's plain constants (ycoef 8192, yoff 0),
#: where full-range BT.601 and BT.709 take others
BGR_COEFS = {
    ("BT.601", False): (9539, 128, 16525, -3209, -6660, 13075),
    ("BT.709", False): (9539, 128, 17305, -1747, -4366, 14686),
    ("BT.2020", False): (9539, 128, 17545, -1535, -5328, 13752),
    ("BT.601", True): (8189, -1, 14516, -2819, -5850, 11485),
    ("BT.709", True): (8189, -1, 15201, -1535, -3835, 12901),
    ("BT.2020", True): (8192, 0, 15412, -1348, -4680, 12080),
}


def yuv420_to_bgr(y, u, v, size: Tuple[int, int], coefs=BGR_COEFS[("BT.601", False)]):
    """Planes -> uint8 BGR (H, W, 3) of the display size (W, H), each
    chroma sample over its 2x2 block, in the arithmetic of swscale's SIMD
    yuv420p -> bgr24 converter (what cv2 reads through): samples << 3 less
    their offsets, each term (x * c) >> 16 with 13-bit coefficients, the
    sums saturated to 0..255. ``coefs`` is a BGR_COEFS entry (the mp4v
    codec's own: BT.601, limited range)."""
    W, H = size
    ycoef, yoff, cb_b, cb_g, cr_g, cr_r = coefs
    y, u, v = (p.to(torch.int32) for p in (y, u, v))
    yv = (((y[:H, :W] << 3) - yoff) * ycoef) >> 16
    d, e = (u << 3) - 1024, (v << 3) - 1024
    c = torch.stack([(d * cb_b) >> 16, ((d * cb_g) >> 16) + ((e * cr_g) >> 16),
                     (e * cr_r) >> 16], -1)
    h, w = c.shape[:2]
    c = c[:, None, :, None].expand(h, 2, w, 2, 3).reshape(2 * h, 2 * w, 3)[:H, :W]
    return (yv[..., None] + c).clamp(0, 255).to(torch.uint8)


# ---- motion compensation ----


def _mc_plane(ref, mvx, mvy, block, rounding):
    """Half-pel prediction of a plane: every block x block macroblock area
    moved by its vector (half-pel units of this plane), references outside
    the frame clamped to its edge (unrestricted vectors)."""
    H, W = ref.shape
    dev = ref.device
    vx = mvx.repeat_interleave(block, 0).repeat_interleave(block, 1)
    vy = mvy.repeat_interleave(block, 0).repeat_interleave(block, 1)
    x = torch.arange(W, device=dev)[None, :] + (vx >> 1)
    y = torch.arange(H, device=dev)[:, None] + (vy >> 1)
    fx, fy = vx & 1, vy & 1
    x0, x1 = x.clamp(0, W - 1), (x + 1).clamp(0, W - 1)
    y0, y1 = y.clamp(0, H - 1), (y + 1).clamp(0, H - 1)
    flat = ref.reshape(-1)
    a, b = flat[y0 * W + x0], flat[y0 * W + x1]
    c, d = flat[y1 * W + x0], flat[y1 * W + x1]
    both = (a + b + c + d + 2 - rounding) >> 2
    horiz = (a + b + 1 - rounding) >> 1
    vert = (a + c + 1 - rounding) >> 1
    return torch.where((fx & fy) == 1, both, torch.where(fx == 1, horiz,
                                                         torch.where(fy == 1, vert, a)))


def predict(planes, mv, rounding):
    """The P-VOP prediction of (Y, U, V) for per-macroblock luma vectors
    mv (mbh, mbw, 2) in half pels; chroma vectors are (v >> 1) | (v & 1)."""
    y, u, v = planes
    mvx, mvy = mv[..., 0], mv[..., 1]
    cx, cy = (mvx >> 1) | (mvx & 1), (mvy >> 1) | (mvy & 1)
    return (_mc_plane(y, mvx, mvy, 16, rounding), _mc_plane(u, cx, cy, 8, rounding),
            _mc_plane(v, cx, cy, 8, rounding))


# ---- the frame store and its blocks ----


class _Blocks:
    """A frame's planes as one flat int32 store (Y, then U, then V, each
    row-major at the coded size), and the flat indices of its blocks (6 a
    macroblock: Y0-Y3, U, V), so that any set of blocks is read or written
    in one gather or one scatter."""

    def __init__(self, mbw, mbh, device):
        self.mbw, self.mbh = mbw, mbh
        self.W, self.H = 16 * mbw, 16 * mbh
        self.n_y, self.n_c = self.W * self.H, self.W * self.H // 4
        r = torch.arange(8, device=device)
        self._offsets = torch.stack([(r[:, None] * self.W + r).reshape(64),
                                     (r[:, None] * (self.W // 2) + r).reshape(64)])
        #: every block's indices, macroblocks in raster order
        self.all = self.index(torch.arange(6 * mbw * mbh, device=device))

    def index(self, idx):
        """(n, 64) store indices of blocks idx (6 m + b), raster order."""
        m, b = idx // 6, idx % 6
        mby, mbx = m // self.mbw, m % self.mbw
        luma = b < 4
        base = torch.where(luma, (16 * mby + 8 * (b >> 1)) * self.W + 16 * mbx + 8 * (b & 1),
                           self.n_y + (b - 4) * self.n_c + 8 * mby * (self.W // 2) + 8 * mbx)
        return base[:, None] + self._offsets[(~luma).long()]

    def planes(self, store):
        """(Y, U, V) views of a store."""
        c = self.n_y + self.n_c
        return (store[:self.n_y].view(self.H, self.W),
                store[self.n_y:c].view(self.H // 2, self.W // 2),
                store[c:].view(self.H // 2, self.W // 2))

    def store(self, planes):
        return torch.cat([p.reshape(-1) for p in planes])

    def blank(self, device):
        return torch.zeros(self.n_y + 2 * self.n_c, dtype=torch.int32, device=device)


def _reconstruct(store, pix, coef_levels, qp, intra, luma, predicted):
    """store[pix] = clip(prediction + IDCT(dequantised levels)), in place;
    intra blocks have no prediction. pix (n, 64) from _Blocks.index."""
    if len(pix) == 0:
        return
    res = idct(dequantise(coef_levels, qp, intra, luma).view(-1, 8, 8)).reshape(-1, 64)
    if predicted:
        res = torch.where(intra[:, None], res, store[pix] + res)
    store[pix] = res.clamp(0, 255)


# ---- decoding ----


class Parsed(NamedTuple):
    """One sample's bitstream, parsed on the host: hdr [type, coded,
    rounding, qp, f_code, has a VOP]; mb (n_mb, 3): each macroblock's
    kind (0 not coded, 1 inter, 2 intra) and vector; the coded blocks'
    indices (6 m + b), QPs and quantised levels (k, 64), raster order."""

    hdr: np.ndarray
    mb: np.ndarray
    idx: np.ndarray
    qp: np.ndarray
    levels: np.ndarray


class Decoder:
    """Rebuilds the frames of one mp4v stream on the device: ``parse``
    each sample on the host (it may run on another thread, one sample at
    a time), ``apply`` the parses in order on the device; ``frame`` is the
    last one as BGR."""

    def __init__(self, vol: np.ndarray, device, fpath: str = "<stream>"):
        self.vol = vol.copy()
        self.device = torch.device(device)
        self.fpath = fpath
        W, H = int(self.vol[1]), int(self.vol[2])
        self.size = (W, H)
        self.mbw, self.mbh = (W + 15) // 16, (H + 15) // 16
        self.blocks = _Blocks(self.mbw, self.mbh, self.device)
        self.store = None  # the reference frame
        self.last = None  # the last parse applied

    def parse(self, sample: bytes) -> Parsed:
        """The host half of one sample (a VOP, maybe after VOS/VOL/GOV
        headers; a VOL in it updates the stream's)."""
        buf = np.frombuffer(sample, np.uint8)
        n_mb = self.mbw * self.mbh
        hdr = np.zeros(6, np.int32)
        mb = np.zeros((n_mb, 3), np.int16)
        idx = np.empty(n_mb * 6, np.int32)
        qp = np.empty(n_mb * 6, np.uint8)
        levels = np.empty((n_mb * 6, 64), np.int16)
        n = ctypes.c_int64(0)
        err = ctypes.create_string_buffer(256)
        t0 = time.perf_counter()
        rc = _library().m4v_decode_vop(_ptr(buf), len(buf), _ptr(self.vol), _ptr(hdr), _ptr(mb),
                                       _ptr(idx), _ptr(qp), _ptr(levels), n_mb, ctypes.byref(n),
                                       err, 256)
        _count("host_s", time.perf_counter() - t0)
        _check(rc, err, self.fpath)
        k = n.value
        return Parsed(hdr, mb, idx[:k], qp[:k], levels[:k])

    def apply(self, parsed: Parsed):
        """The device half: rebuild the frame on the reference."""
        hdr, mb, idx_np, qp_np, levels_np = parsed
        vop_type, coded, rounding = (int(v) for v in hdr[:3])
        if not hdr[5] or not coded:  # no VOP, or an N-VOP: the previous frame
            if self.store is None:
                raise ValueError(f"{self.fpath}: a not-coded VOP before any frame")
            self.last = parsed
            return
        if vop_type == 1 and self.store is None:
            raise ValueError(f"{self.fpath}: a P-VOP before any I-VOP")
        dev = self.device
        idx = torch.from_numpy(idx_np).to(dev).long()
        qp = torch.from_numpy(qp_np).to(dev)
        levels = torch.from_numpy(levels_np).to(dev).to(torch.int32)
        intra = torch.from_numpy(mb[idx_np // 6, 0] == 2).to(dev)
        _moved(dev, "to_device_bytes", idx_np, qp_np, levels_np)
        if vop_type == 0:
            store = self.blocks.blank(dev)
        elif np.any(mb[:, 1:]):
            mv = torch.from_numpy(mb[:, 1:].astype(np.int32)).to(dev)
            _moved(dev, "to_device_bytes", mb)
            store = self.blocks.store(predict(self.blocks.planes(self.store),
                                              mv.view(self.mbh, self.mbw, 2), rounding))
        else:
            store = self.store.clone()
        _reconstruct(store, self.blocks.index(idx), levels, qp, intra, (idx % 6) < 4,
                     vop_type == 1)
        self.store = store
        self.last = parsed

    @property
    def planes(self):
        return self.blocks.planes(self.store)

    def frame(self) -> torch.Tensor:
        """The last decoded frame, uint8 BGR (H, W, 3) on the device."""
        return yuv420_to_bgr(*self.planes, self.size)


def _codec_reason(codec: str) -> str:
    return f"{CODEC_NAMES.get(codec, repr(codec))}: the port decodes mp4v, H.264 and HEVC only"


def vop_coded(sample: bytes, time_bits: int) -> bool:
    """Whether a sample holds a coded VOP: False for an I- or P-VOP with
    vop_coded 0 (an N-VOP) or a sample without a VOP, which give no frame
    in cv2. B- and S-VOPs count as coded, so that decoding names them."""
    p = sample.find(b"\x00\x00\x01\xb6")
    if p < 0:
        return False
    bits = np.unpackbits(np.frombuffer(sample[p + 4:p + 12], np.uint8))
    if len(bits) < 2 or bits[0]:  # vop_coding_type 2 (B) or 3 (S)
        return True
    q = 2
    while q < len(bits) and bits[q]:  # modulo_time_base
        q += 1
    q += 2 + time_bits  # its 0, the marker, vop_time_increment
    q += 1  # marker
    return q >= len(bits) or bool(bits[q])


class Reader:
    """Frames of an mp4v file by index, as BGR uint8, decoded on the
    device (``cuda`` unless ``device`` names another). ``size`` (width,
    height) and ``fps`` are the track's. As in cv2, a not-coded VOP
    (N-VOP) gives no frame: frame k is the k-th coded VOP, and
    ``n_frames`` counts them. A sample that no chunk holds, or an index
    past the end, reads as None."""

    def __init__(self, fpath: str, device=None):
        self.fpath = fpath
        self.device = resolve_device(device)
        self.track = mp4.read_video_track(fpath)
        if self.track.codec != "mp4v":
            raise UnsupportedVideo(fpath, _codec_reason(self.track.codec))
        self.n_frames = self.track.n_frames
        self._order = self.track.order
        self.size, self.fps = self.track.size, self.track.fps
        self._pos = -1
        self._dec = None
        self._ahead = None  # (index, future) of the sample parsed ahead
        vol = parse_config(self.track.config, fpath)
        self._file = open(fpath, "rb")
        try:
            if not vol[0]:  # headers in band: the first sample that holds a VOL
                data = next((d for d in map(self._sample, range(self.track.n_samples)) if d),
                            b"")
                vol = parse_config(data, fpath)
            if vol[0]:
                coded = [not self._held(int(i)) or vop_coded(self._head(int(i)), int(vol[4]))
                         for i in self._order]
                self._order = self._order[np.asarray(coded, bool)]
                self.n_frames = len(self._order)
        except BaseException:
            self._file.close()
            raise
        self._pool = ThreadPoolExecutor(1)
        if vol[0]:
            self.size = (int(vol[1]), int(vol[2]))
            self._dec = Decoder(vol, self.device, fpath)

    def _held(self, i) -> bool:
        return int(self.track.offsets[i]) >= 0 and int(self.track.sizes[i]) > 0

    def _head(self, i, n=64) -> bytes:
        """Sample i's first bytes, up to its VOP header (all of it where
        headers before the VOP run past n bytes)."""
        self._file.seek(int(self.track.offsets[i]))
        head = self._file.read(min(n, int(self.track.sizes[i])))
        return head if b"\x00\x00\x01\xb6" in head[:-8] else self._sample(i)

    def _sample(self, i) -> bytes:
        off, n = int(self.track.offsets[i]), int(self.track.sizes[i])
        if off < 0 or n == 0:
            return b""
        self._file.seek(off)
        return self._file.read(n)

    def _parse_soon(self, i):
        """Parse sample i on the worker thread: a future, or None for a
        sample that no chunk holds."""
        data = self._sample(i)
        return self._pool.submit(self._dec.parse, data) if data else None

    def read_tensor(self, idx: int) -> Optional[torch.Tensor]:
        """Frame idx on the device, or None. Samples are parsed a frame
        ahead on a worker thread while the device rebuilds the frame
        before, and the one after idx's sample is parsed in case it is
        read next."""
        idx = int(idx)
        if self._dec is None or not 0 <= idx < self.n_frames:
            return None
        target = int(self._order[idx])
        sync = np.flatnonzero(self.track.sync[:target + 1])
        start = int(sync[-1]) if len(sync) else 0
        if self._pos < start or self._pos > target:  # else carry on from the last frame
            self._pos = start - 1
        n = self.track.n_samples
        for i in range(self._pos + 1, target + 1):
            ahead, self._ahead = self._ahead, None
            fut = ahead[1] if ahead and ahead[0] == i else self._parse_soon(i)
            if fut is None:
                self._pos = -1
                return None
            if i + 1 < n:
                self._ahead = (i + 1, self._parse_soon(i + 1))
            self._dec.apply(fut.result())
            self._pos = i
        return self._dec.frame()

    def read(self, idx: int) -> Optional[np.ndarray]:
        """Frame idx as a numpy (H, W, 3) uint8 BGR array, or None."""
        f = self.read_tensor(idx)
        if f is None:
            return None
        out = f.cpu().numpy()
        _moved(self.device, "to_host_bytes", out)
        return out

    def close(self):
        self._pool.shutdown()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- encoding ----


class Writer:
    """An mp4v file written frame by frame (``write``, then ``close``):
    I-VOPs every GOP frames, else P-VOPs of zero-vector or not-coded
    macroblocks, all at quantiser QP. Frames are BGR uint8 (H, W, 3),
    numpy or torch (on any device), of ``size`` (width, height)."""

    def __init__(self, fpath: str, size: Tuple[int, int], fps: float, device=None):
        self.device = resolve_device(device)
        self.size = (int(size[0]), int(size[1]))
        W, H = self.size
        if not (0 < W < 8192 and 0 < H < 8192):
            raise ValueError(f"{fpath}: frame size {W} x {H} is outside 1..8191")
        self.fpath = fpath
        num, den = mp4.frame_rate(fps)
        self._res = num if num < 65536 else 60000  # vop_time_increment_resolution
        self._num, self._den = num, den
        config = write_config(self.size, self._res)
        self.vol = parse_config(config, fpath)
        self.mbw, self.mbh = (W + 15) // 16, (H + 15) // 16
        self.blocks = _Blocks(self.mbw, self.mbh, self.device)
        self.store = None  # the reconstruction, what the decoder will rebuild
        self.n = 0
        self._sec = 0
        self._mp4 = mp4.Mp4Writer(fpath, self.size, fps, config)
        self._pool = ThreadPoolExecutor(1)
        self._pending = deque()  # (intra, future of the sample's bytes), in frame order
        luma = np.tile(np.array([1, 1, 1, 1, 0, 0], bool), self.mbw * self.mbh)
        self._luma = torch.from_numpy(luma).to(self.device)

    @property
    def planes(self):
        """(Y, U, V) of the last frame's reconstruction."""
        return self.blocks.planes(self.store)

    def write(self, frame):
        """Encode one frame."""
        t = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) \
            else frame
        W, H = self.size
        if t.dtype != torch.uint8 or tuple(t.shape) != (H, W, 3):
            raise ValueError(f"{self.fpath}: a frame must be uint8 ({H}, {W}, 3), not "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device.type != self.device.type:
            _moved(self.device, "to_device_bytes", t)
        blocks = self.blocks
        cur = blocks.store(bgr_to_yuv420(t.to(self.device), (blocks.W, blocks.H)))[blocks.all]
        intra = self.n % GOP == 0
        qp = QP
        # the levels go to the host first, so that the bitstream is written
        # there while the device rebuilds the frame
        if intra:
            levels = quantise_intra(fdct8(cur.view(-1, 8, 8)).view(-1, 64), qp, self._luma)
            coded_mb = np.ones(self.mbw * self.mbh, np.uint8)
            host = levels.to(torch.int16).cpu().numpy()
            self.store = blocks.blank(self.device)
            qps = torch.full((len(levels),), qp, device=self.device)
            _reconstruct(self.store, blocks.all, levels, qps, torch.ones_like(self._luma),
                         self._luma, False)
        else:
            res = cur - self.store[blocks.all]
            levels = quantise_inter(fdct8(res.view(-1, 8, 8)).view(-1, 64), qp)
            mb_any = (levels != 0).view(-1, 6 * 64).any(1)
            idx = torch.nonzero(mb_any.repeat_interleave(6)).flatten()
            levels = levels[idx]
            coded_mb = mb_any.cpu().numpy().astype(np.uint8)
            host = levels.to(torch.int16).cpu().numpy()
            _reconstruct(self.store, blocks.index(idx), levels, torch.full_like(idx, qp),
                         torch.zeros_like(idx, dtype=torch.bool), (idx % 6) < 4, True)
        _moved(self.device, "to_host_bytes", host, coded_mb)
        self._emit(intra, coded_mb, host)
        self.n += 1

    def _emit(self, intra, coded_mb, levels):
        """Code the frame's bitstream on the worker thread, while the
        device takes the next frame; samples go to the file in order."""
        ticks = self.n * self._den * self._res // self._num
        sec, inc = divmod(ticks, self._res)
        mbs = np.zeros((len(coded_mb), 5), np.int16)
        mbs[:, 0] = MB_INTRA if intra else np.where(coded_mb, MB_INTER, MB_SKIP)
        self._pending.append((intra, self._pool.submit(
            encode_vop, self.vol, 0 if intra else 1, QP, mbs, levels,
            modulo=0 if intra else sec - self._sec, time_inc=inc,
            gov_seconds=sec if intra else -1)))
        self._sec = sec
        self._flush(keep=WRITER_AHEAD)

    def _flush(self, keep=0):
        while len(self._pending) > keep or (self._pending and self._pending[0][1].done()):
            intra, fut = self._pending.popleft()
            self._mp4.add_sample(fut.result(), intra)

    def close(self):
        try:
            self._flush()
        except BaseException:
            self.abort()
            raise
        self._pool.shutdown()
        self._mp4.close()

    def abort(self):
        """Stop, and remove the unfinished file: a write that fails leaves
        no file rather than one that cannot be played."""
        self._pool.shutdown(cancel_futures=True)
        self._mp4.abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()
