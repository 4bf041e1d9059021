"""H.264 and HEVC in MP4 (``avc1``/``avc3``, ``hvc1``/``hev1``: what
GoPro cameras write) decoded on the card's NVDEC, the H100's
fixed-function decoder, through the driver's ``libnvcuvid`` (no package
of finished kernels: the library comes with the driver).

``csrc/nvdec.cu`` holds the binding and the two kernels: it is built with
``nvcc`` at first use into ``acinoset_tpu_torch/_build/libnvdec.so`` and
loaded with ``ctypes``. The samples come from ``utils.mp4`` in decode
order, each in start-code form (``utils.h26x.annexb``) with the
parameter sets in front at each decode start, and each with its frame's
presentation index as its timestamp; frame k is the k-th by composition
time after the edit list, as cv2 counts them. The decoder's NV12 surface
is converted in place by ``nv12_to_bgr``, a hand-written CUDA kernel in
cv2's colour arithmetic (the constants of ``mpeg4.BGR_COEFS``, picked by
the stream's VUI matrix and range), one launch a frame.

What this path does not take raises ``mpeg4.UnsupportedVideo`` naming it,
and nothing falls back to another path: a CPU device, a CUDA device
whose driver has no ``libnvcuvid`` or whose ``cuvidGetDecoderCaps`` fails
(the reason gives the driver's error; ``withheld`` says whether the
environment visibly keeps the video engine from this process), 10-bit
(P016), 4:2:2, 4:4:4 or interlaced streams, and colour matrices other
than BT.601, BT.709 and BT.2020. (10-bit HEVC reads through the software
decoder, ``utils.hevc``, and this module's second kernel,
``yuv420p10_to_bgr``.)

The decoder half (``Reader``, and ``csrc/nvdec.cu``'s decoder creation,
decode, map and unmap) is untested: it has run only on an H100 in a
container without the NVIDIA driver capability ``video``, where NVDEC
is refused. The parser half, the format record and the kernel ran and
were checked there.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import _nvcc
from . import h26x, mp4
from .device import resolve_device
from .mpeg4 import BGR_COEFS, CODEC_NAMES, UnsupportedVideo, yuv420_to_bgr

SOURCE = Path(__file__).resolve().parent / "csrc" / "nvdec.cu"
LIBRARY = Path(__file__).resolve().parents[1] / "_build" / "libnvdec.so"
#: sample entry -> cudaVideoCodec (cuviddec.h: H264 4, HEVC 8)
CODECS = {"avc1": 4, "avc3": 4, "hvc1": 8, "hev1": 8}
#: VUI matrix_coefficients -> the colour family of BGR_COEFS: 1 BT.709;
#: 2 (unspecified), 5 (BT.470BG) and 6 (SMPTE 170M) BT.601, as swscale
#: treats them; 9 BT.2020 (non-constant luminance). NVDEC reports 2 for a
#: stream without colour description.
MATRICES = {1: "BT.709", 2: "BT.601", 5: "BT.601", 6: "BT.601", 9: "BT.2020"}
#: the matrices refused, by name
OTHER_MATRICES = {10: "BT.2020 (constant luminance)", 0: "identity (RGB)", 4: "FCC",
                  7: "SMPTE 240M"}
#: cuvidParseVideoData's packet flags
PKT_ENDOFSTREAM, PKT_TIMESTAMP, PKT_DISCONTINUITY, PKT_ENDOFPICTURE = 1, 2, 4, 8
#: frames one packet may show (the parser's DPB is at most 16)
SHOWN_CAP = 64
#: fields of nvdec_format's record
FORMAT_FIELDS = ("have", "refused", "codec", "coded_width", "coded_height", "left", "top",
                 "right", "bottom", "chroma_format", "luma_minus8", "chroma_minus8",
                 "progressive", "full_range", "matrix", "primaries", "transfer", "surfaces",
                 "rate_num", "rate_den")

#: the reader's work in this process: seconds on the host reading the
#: samples, putting them in start-code form and in the parser (which
#: submits each picture to NVDEC), and seconds waiting in
#: cuvidMapVideoFrame64 for NVDEC
COUNTERS = {"host_s": 0.0, "map_s": 0.0}

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_ERR = 512


def build() -> Path:
    """Compile csrc/nvdec.cu into LIBRARY (``_nvcc.build``, linked with
    -ldl for dlopen)."""
    return _nvcc.build(SOURCE, LIBRARY, ("-ldl",))


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.nvdec_available.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.nvdec_caps.argtypes = [ctypes.c_int, ctypes.c_int, _P, ctypes.c_char_p,
                                       ctypes.c_int]
            lib.nvdec_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(_P), ctypes.c_char_p, ctypes.c_int]
            lib.nvdec_parse.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P,
                                        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_char_p, ctypes.c_int]
            lib.nvdec_format.argtypes = [_P, _P]
            lib.nvdec_format.restype = None
            lib.nvdec_map.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
                                      ctypes.c_int]
            lib.nvdec_unmap.argtypes = [_P, ctypes.c_uint64, _P, ctypes.c_char_p, ctypes.c_int]
            lib.nvdec_reset.argtypes = [_P, ctypes.c_char_p, ctypes.c_int]
            lib.nvdec_destroy.argtypes = [_P]
            lib.nvdec_destroy.restype = None
            lib.nv12_to_bgr.argtypes = [_P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P,
                                        _P]
            lib.yuv420p10_to_bgr.argtypes = [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                                             ctypes.c_int, _P, _P]
            _lib = lib
    return _lib


def sdk_headers() -> bool:
    """Whether the build found the Video Codec SDK's headers (and so held
    the structs typed into csrc/nvdec.cu to theirs)."""
    return bool(_library().nvdec_sdk_headers())


def available() -> Optional[str]:
    """None when the driver's libcuda and libnvcuvid open, else why not."""
    err = ctypes.create_string_buffer(_ERR)
    return None if _library().nvdec_available(err, _ERR) == 0 else err.value.decode()


#: fields of nvdec_caps' record
CAPS_FIELDS = ("supported", "engines", "output_formats", "max_width", "max_height", "max_mbs",
               "min_width", "min_height")


def caps(device, codec: str) -> Tuple[Optional[Dict[str, int]], Optional[str]]:
    """(NVDEC's capabilities for codec (a sample entry) at 4:2:0 8-bit on
    a CUDA device, None) or (None, why they cannot be read)."""
    why = available()
    if why:
        return None, why
    rec = np.zeros(len(CAPS_FIELDS), np.int32)
    err = ctypes.create_string_buffer(_ERR)
    index = _index(device)
    if _library().nvdec_caps(index, CODECS[codec], _P(rec.ctypes.data), err, _ERR):
        return None, err.value.decode()
    return dict(zip(CAPS_FIELDS, (int(v) for v in rec))), None


def _index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def withheld() -> Optional[str]:
    """Why the environment visibly keeps the video engine from this
    process, or None: a container's NVIDIA_DRIVER_CAPABILITIES set and
    naming neither ``video`` nor ``all``."""
    given = os.environ.get("NVIDIA_DRIVER_CAPABILITIES")
    if given is None or {c.strip() for c in given.split(",")} & {"video", "all"}:
        return None
    return f"NVIDIA_DRIVER_CAPABILITIES={given} does not grant the NVIDIA driver capability 'video'"


def refusal(device, codec: str, size: Tuple[int, int]) -> Optional[str]:
    """Why NVDEC on a CUDA device cannot decode codec (a sample entry) at
    size (width, height), or None: the driver's libraries, the decoder's
    capabilities (cuvidGetDecoderCaps' own error, with ``withheld``'s
    reason where there is one), the codec, the size."""
    name = CODEC_NAMES[codec]
    cap, why = caps(device, codec)
    if why:
        env = withheld()
        return f"{name}: NVDEC cannot be used on {device} ({why}{'; ' + env if env else ''})"
    W, H = size
    mbs = ((W + 15) // 16) * ((H + 15) // 16)
    if not cap["supported"]:
        return f"{name}: this card's NVDEC does not decode {name} 4:2:0 8-bit"
    if W > cap["max_width"] or H > cap["max_height"] or mbs > cap["max_mbs"]:
        return (f"{name}: {W} x {H} is beyond this card's NVDEC ({cap['max_width']} x "
                f"{cap['max_height']}, {cap['max_mbs']} macroblocks)")
    return None


def stream_format(fpath: str, device=None) -> Dict[str, int]:
    """The format NVDEC's parser reads from an H.264 or HEVC file's
    parameter sets and first sync sample (nvdec_format's record), without
    a decoder."""
    track = mp4.read_video_track(fpath)
    device = resolve_device(device)
    lib = _library()
    h = _P()
    err = ctypes.create_string_buffer(_ERR)
    if lib.nvdec_create(_index(device), CODECS[track.codec], 1, ctypes.byref(h), err, _ERR):
        raise RuntimeError(f"{fpath}: {err.value.decode()}")
    try:
        first = int(np.flatnonzero(track.sync)[0]) if track.sync.any() else 0
        with open(fpath, "rb") as f:
            f.seek(int(track.offsets[first]))
            data = f.read(int(track.sizes[first]))
        data = h26x.annexb(list(track.param_sets) + h26x.nal_units(data, track.length_size))
        shown = np.zeros((SHOWN_CAP, 4), np.int64)
        n = ctypes.c_int(0)
        for payload, flags in ((data, PKT_TIMESTAMP | PKT_ENDOFPICTURE), (b"", PKT_ENDOFSTREAM)):
            lib.nvdec_parse(h, payload, len(payload), 0, flags, _P(shown.ctypes.data), SHOWN_CAP,
                            ctypes.byref(n), err, _ERR)
        rec = np.zeros(len(FORMAT_FIELDS), np.int32)
        lib.nvdec_format(h, _P(rec.ctypes.data))
        return dict(zip(FORMAT_FIELDS, (int(v) for v in rec)))
    finally:
        lib.nvdec_destroy(h)


# ---- the colour conversion ----


def colour_coefs(matrix: int, full_range: bool) -> Tuple[int, ...]:
    """The BGR_COEFS entry for a VUI matrix and range; KeyError for a
    matrix outside MATRICES."""
    return BGR_COEFS[(MATRICES[int(matrix)], bool(full_range))]


def nv12_offsets(pitch: int, surface_height: int, left: int, top: int) -> Tuple[int, int]:
    """Where an NV12 surface's display rectangle starts: the offsets in
    bytes of its first luma sample and of its first interleaved chroma
    pair, for rows of pitch bytes whose chroma rows (one for every two
    luma rows) start at row surface_height, and the rectangle at (left,
    top). The one account of the layout, which the kernel's launches and
    the plain version share."""
    return top * pitch + left, (surface_height + top // 2) * pitch + left


def nv12_to_bgr_plain(surface: torch.Tensor, surface_height: int, size: Tuple[int, int],
                      coefs, origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The plain version of the kernel: ``mpeg4.yuv420_to_bgr`` with the
    constants given, on an NV12 surface (rows, pitch) uint8 (luma rows 0..
    surface_height, then the interleaved chroma rows); size (W, H) and
    origin (left, top) the display rectangle."""
    W, H = size
    surface = surface.contiguous()
    pitch = surface.shape[1]
    luma, chroma = nv12_offsets(pitch, surface_height, *origin)
    base = surface.storage_offset()
    y = torch.as_strided(surface, (H, W), (pitch, 1), base + luma)
    uv = torch.as_strided(surface, ((H + 1) // 2, W), (pitch, 1), base + chroma)
    return yuv420_to_bgr(y, uv[:, 0::2], uv[:, 1::2], size, coefs)


def _launch(ptr: int, pitch: int, surface_height: int, origin: Tuple[int, int],
            out: torch.Tensor, coefs, stream: int):
    """One launch of the kernel into out (H, W, 3) uint8 on the card, from
    the NV12 surface at device address ptr (``nv12_offsets``' layout)."""
    H, W = out.shape[:2]
    luma, chroma = nv12_offsets(pitch, surface_height, *origin)
    k = (ctypes.c_int32 * 6)(*coefs)
    err = _library().nv12_to_bgr(_P(ptr + luma), _P(ptr + chroma), int(pitch), _P(out.data_ptr()),
                                 W, H, k, _P(stream))
    if err != 0:
        raise RuntimeError(f"nv12_to_bgr failed to launch: CUDA error {err}")
    with _lock:
        nv12_to_bgr.launches += 1


def nv12_to_bgr(surface: torch.Tensor, surface_height: int, size: Tuple[int, int], coefs,
                origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """An NV12 surface (rows, pitch) uint8 -> BGR (H, W, 3) uint8 of the
    display rectangle (size (W, H) at origin (left, top)); chroma rows
    start at row surface_height. A CPU tensor goes to the plain version; a
    CUDA tensor (contiguous) launches the kernel; anything else raises.
    ``nv12_to_bgr.launches`` counts launches."""
    if surface.dtype != torch.uint8 or surface.dim() != 2:
        raise ValueError(f"the surface must be uint8 (rows, pitch), not {surface.dtype} "
                         f"{tuple(surface.shape)}")
    W, H = size
    left, top = origin
    rows, pitch = surface.shape
    if left % 2 or top % 2 or left + W > pitch or surface_height + (top + H + 1) // 2 > rows \
            or top + H > surface_height:
        raise ValueError(f"a {W} x {H} rectangle at {origin} does not fit an NV12 surface of "
                         f"{rows} rows of {pitch} with chroma from row {surface_height}")
    if surface.device.type == "cpu":
        return nv12_to_bgr_plain(surface, surface_height, size, coefs, origin)
    if surface.device.type != "cuda" or not surface.is_contiguous():
        raise ValueError(f"the surface must be a contiguous CPU or CUDA tensor, not on "
                         f"{surface.device}")
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=surface.device)
    with torch.cuda.device(surface.device):
        stream = torch.cuda.current_stream(surface.device).cuda_stream
        _launch(surface.data_ptr(), pitch, surface_height, origin, out, coefs, stream)
    return out


nv12_to_bgr.launches = 0


# ---- the 10-bit conversion ----
#
# cv2 converts a 10-bit 4:2:0 frame (yuv420p10) to bgr24 through swscale's
# scaler, not through the table converter of 8-bit frames, in this
# arithmetic (found on cv2 5.0.0, swscale 9.5, x86-64; held to cv2 bit for
# bit by tests/test_torch_hevc10.py):
# - the horizontal pass is the identity: each sample s becomes s << 5
#   (15 bits), and each chroma sample serves its two columns;
# - chroma is scaled vertically from ceil(H / 2) rows to H by swscale's
#   default bicubic (B 0, C 0.6) at its chroma siting, four taps a row of
#   12-bit coefficients, the rows past the top and bottom folded into the
#   edge taps (``chroma_taps``);
# - every row but the last two goes through the x86 vertical scaler and
#   YUV -> RGB of swscale_template.c: each tap's (s * c) >> 16 summed on a
#   rounder of 4 (luma: 2 Y + 4), less the offsets, times the 13-bit
#   constants of the 8-bit SIMD converter (each product >> 16), summed and
#   saturated to 0..255;
# - the last two rows go through the C output (yuv2rgb_X_c_template),
#   where the MMX tables would be overrun: Y, U and V are rounded to 8 bits
#   ((s * c summed + 2^18) >> 19; U and V clipped to 0..255 by the tables,
#   Y not) and looked up in ff_yuv2rgb_c_init_tables' tables: the output is
#   clip((ybase + (Y + off) * cy) >> 16) with off the chroma's
#   ((U * c) >> 16) - (c >> 9) terms.

#: swscale's inverse tables (ff_yuv2rgb_coeffs: Cr->R, Cb->B, Cb->G, Cr->G,
#: the last two as magnitudes), by family
SWS_INV_TABLE = {"BT.601": (104597, 132201, 25675, 53279),
                 "BT.709": (117489, 138438, 13975, 34925),
                 "BT.2020": (110013, 140363, 12277, 42626)}


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def colour_coefs10(matrix: int, full_range: bool) -> Tuple[int, ...]:
    """The 10-bit conversion's constants for a VUI matrix (in MATRICES)
    and range, as swscale derives them (sws_setColorspaceDetails and
    ff_yuv2rgb_c_init_tables with contrast and saturation 1 << 16,
    brightness 0): the six of the vertical scaler's rows (ycoef, yoff,
    Cb->B, Cb->G, Cr->G, Cr->R, as BGR_COEFS) and the six of the last two
    rows' tables (cy, ybase, Cb->B, Cb->G, Cr->G, Cr->R)."""
    crv, cbu, cgu, cgv = SWS_INV_TABLE[MATRICES[int(matrix)]]
    cgu, cgv = -cgu, -cgv
    if full_range:
        cy, oy = 1 << 16, 0
        crv, cbu, cgu, cgv = (_trunc_div(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = _trunc_div((1 << 16) * 255, 219), 16 << 16

    def r16(f):  # roundToInt16
        return (f + (1 << 15)) >> 16

    mmx = (r16(cy << 13), r16(oy << 3), r16(cbu << 13), r16(cgu << 13), r16(cgv << 13),
           r16(crv << 13))
    # the tables' constants, scaled by cy; the luma table's origin
    crv, cbu, cgu, cgv = (_trunc_div((c << 16) + 0x8000, cy) for c in (crv, cbu, cgu, cgv))
    ybase = (384 if full_range else 326) * cy - (384 << 16) - oy + 0x8000
    return mmx + (cy, ybase, cbu, cgu, cgv, crv)


#: the chroma siting, (x, y) of a 2x2 block's chroma sample in swscale's
#: 1/256 units, by the VUI's chroma_sample_loc_type (AVChromaLocation less
#: 1); ffmpeg's HEVC decoder reports type 0 (left) where the VUI has none
CHROMA_SITING = {0: (0, 128), 1: (128, 128), 2: (0, 0), 3: (128, 0), 4: (0, 256), 5: (128, 256)}


def chroma_siting(loc: int) -> Tuple[int, int]:
    """CHROMA_SITING of a VUI chroma_sample_loc_type (-1: none, left)."""
    return CHROMA_SITING[max(int(loc), 0)]


@lru_cache(maxsize=None)
def scale_taps(n_src: int, n_dst: int, src_pos: int, one: int,
               align: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """swscale's filter from n_src samples to n_dst >= n_src (initFilter
    at SWS_BICUBIC, B 0 and C 0.6; the source sample's position src_pos
    and the destination's 128, in 1/256 of a sample from its edge; the
    identity where they are equal and so are the counts), with the x86
    build's alignment (align taps) and reductions: each output sample's
    first input and its four coefficients, which sum to one. ValueError
    where the filter has other than four taps."""
    if n_dst < n_src:
        raise ValueError("swscale's downscaling filters are not taken")
    inc = ((n_src << 16) + (n_dst >> 1)) // n_dst
    fone = 1 << 54  # initFilter's 1 << (54 - log2(n_src / n_dst)), upscaling
    pos, rows = [], []
    if abs(inc - 0x10000) < 10 and src_pos == 128:
        size = 1
        pos, rows = list(range(n_dst)), [[fone] for _ in range(n_dst)]
    else:
        size = max(min(5, n_src - 2), 1)  # 1 + the bicubic's size factor 4
        B, C = 0, int(0.6 * (1 << 24))
        x_in_src = ((128 * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        for _ in range(n_dst):
            xx = _trunc_div(x_in_src - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _j in range(size):
                d = abs(xx * (1 << 17) - x_in_src) << 13
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = ((12 * (1 << 24) - 9 * B - 6 * C) * ddd
                                 + (-18 * (1 << 24) + 12 * B + 6 * C) * dd
                                 + (6 * (1 << 24) - 2 * B) * (1 << 30))
                    else:
                        coeff = ((-B - 6 * C) * ddd + (6 * B + 30 * C) * dd
                                 + (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (1 << 30))
                row.append(_trunc_div(coeff, (1 << 54) // fone))
                xx += 1
            rows.append(row)
            x_in_src += 2 * inc
    # shift out near-zero taps on the left, count those on the right
    cutoff = 0.002 * fone
    min_size = 0
    for i in range(n_dst - 1, -1, -1):
        acc = 0
        for _j in range(size):
            acc += abs(rows[i][0])
            if acc > cutoff or (i < n_dst - 1 and pos[i] >= pos[i + 1]):
                break
            rows[i] = rows[i][1:] + [0]
            pos[i] += 1
        keep, acc = size, 0
        for j in range(size - 1, 0, -1):
            acc += abs(rows[i][j])
            if acc > cutoff:
                break
            keep -= 1
        min_size = max(min_size, keep)
    if min_size == 1 and align == 2:  # the x86 build's unscaled vertical case
        align = 1
    taps = (min_size + align - 1) & ~(align - 1)
    if taps != 4:
        raise ValueError(f"a filter of {taps} taps")
    rows = [(r + [0] * taps)[:taps] for r in rows]
    for i in range(n_dst):  # the samples past the edges folded into the edge taps
        if pos[i] < 0:
            for j in range(1, taps):
                left = max(j + pos[i], 0)
                rows[i][left] += rows[i][j]
                rows[i][j] = 0
            pos[i] = 0
        if pos[i] + taps > n_src:
            shift = pos[i] + min(taps - n_src, 0)
            acc = 0
            for j in range(taps - 1, -1, -1):
                if pos[i] + j >= n_src:
                    acc += rows[i][j]
                    rows[i][j] = 0
            rows[i] = [0] * shift + rows[i][:taps - shift]
            pos[i] -= shift
            rows[i][n_src - 1 - pos[i]] += acc
    out = []
    for r in rows:  # normalised to one, the rounding error carried along the row
        total = _trunc_div(sum(r) + one // 2, one) or 1
        err, q = 0, []
        for c in r:
            v = c + err
            iv = _trunc_div(v + (total >> 1) if v >= 0 else v - (total >> 1), total)
            q.append(iv)
            err = v - iv * total
        out.append(tuple(q))
    return tuple(pos), tuple(out)


def chroma_taps(size: Tuple[int, int], siting: Tuple[int, int] = (0, 128)):
    """The two chroma filters of a 4:2:0 frame of size (W, H) converted to
    RGB, as ``scale_taps`` (pos, coefficients): horizontal, from
    ceil(W / 2) columns to as many (the destination keeps 4:2:2's pairs),
    14-bit, four taps aligned (x86's hScale); vertical, from ceil(H / 2)
    rows to H, 12-bit, two aligned. siting (x, y) is the source's chroma
    position (CHROMA_SITING). ValueError below 10 rows or 2 columns,
    where swscale takes other filters and other output code."""
    W, H = size
    cw, ch = -((-W) >> 1), -((-H) >> 1)
    if ch < 5 or cw < 1:
        raise ValueError(f"a 10-bit frame of {W} x {H}: cv2 converts frames of fewer than 10 "
                         "rows otherwise")
    x, y = siting
    try:
        return (scale_taps(cw, cw, (x + 128) >> 1, 1 << 14, 4),
                scale_taps(ch, H, (y + 128) >> 1, 1 << 12, 2))
    except ValueError as e:
        raise ValueError(f"a 10-bit frame of {W} x {H}: {e}") from None


def yuv420p10_to_bgr_plain(surface: torch.Tensor, surface_height: int, size: Tuple[int, int],
                           coefs, origin: Tuple[int, int] = (0, 0),
                           siting: Tuple[int, int] = (0, 128)) -> torch.Tensor:
    """The plain version of the 10-bit kernel: a 16-bit surface (rows,
    pitch) int16 laid out as NV12 (``nv12_offsets``, in samples: luma rows
    0..surface_height, then the interleaved Cb Cr rows) holding 10-bit
    samples -> BGR (H, W, 3) uint8 of the display rectangle (size (W, H) at
    origin (left, top)), in the arithmetic of the notes above; coefs a
    ``colour_coefs10`` tuple, siting the chroma's (CHROMA_SITING)."""
    W, H = size
    ycoef, yoff, cb_b, cb_g, cr_g, cr_r, cy, ybase, t_cb_b, t_cb_g, t_cr_g, t_cr_r = coefs
    surface = surface.contiguous()
    dev = surface.device
    pitch = surface.shape[1]
    luma, chroma = nv12_offsets(pitch, surface_height, *origin)
    base = surface.storage_offset()
    y = torch.as_strided(surface, (H, W), (pitch, 1), base + luma).to(torch.int64)
    uv = torch.as_strided(surface, ((H + 1) // 2, W), (pitch, 1), base + chroma).to(torch.int64)
    (hpos, htaps), (vpos, vtaps) = chroma_taps(size, siting)
    four = torch.arange(4, device=dev)
    # the horizontal pass: 15-bit chroma, (s * c summed) >> 9, at most 32767
    cols = torch.tensor(hpos, device=dev)[:, None] + four
    hk = torch.tensor(htaps, dtype=torch.int64, device=dev)
    c15 = [torch.clamp_max(((p[:, cols] * hk).sum(-1)) >> 9, 32767)
           for p in (uv[:, 0::2], uv[:, 1::2])]
    c15 = torch.stack(c15, -1).reshape(uv.shape[0], -1)  # Cb Cr interleaved again
    rows = torch.tensor(vpos, device=dev)[:, None] + four
    k = torch.tensor(vtaps, dtype=torch.int64, device=dev)[:, :, None]
    win = c15[rows]  # (H, 4, 2 ceil(W / 2)): each row's four chroma rows
    # the vertical scaler's rows: each tap (s * c) >> 16 on a rounder of 4
    mmx = ((win * k) >> 16).sum(1) + 4
    d = mmx - 1024
    yv = (((2 * y + 4) - yoff) * ycoef) >> 16
    du = d[:, 0::2].repeat_interleave(2, 1)[:, :W]
    dv = d[:, 1::2].repeat_interleave(2, 1)[:, :W]
    out = torch.stack([yv + ((du * cb_b) >> 16),
                       yv + ((du * cb_g) >> 16) + ((dv * cr_g) >> 16),
                       yv + ((dv * cr_r) >> 16)], -1)
    # the last two rows: 8-bit Y, U, V looked up in the tables
    c8 = (((win[-2:] * k[-2:]).sum(1) + (1 << 18)) >> 19).clamp(0, 255)
    u8 = c8[:, 0::2].repeat_interleave(2, 1)[:, :W]
    v8 = c8[:, 1::2].repeat_interleave(2, 1)[:, :W]
    y8 = ((y[-2:] << 17) + (1 << 18)) >> 19
    offs = (((u8 * t_cb_b) >> 16) - (t_cb_b >> 9),
            ((u8 * t_cb_g) >> 16) - (t_cb_g >> 9) + ((v8 * t_cr_g) >> 16) - (t_cr_g >> 9),
            ((v8 * t_cr_r) >> 16) - (t_cr_r >> 9))
    out[-2:] = torch.stack([(ybase + (y8 + o) * cy) >> 16 for o in offs], -1)
    return out.clamp(0, 255).to(torch.uint8)


#: chroma_taps as the kernel reads them: int32 (W / 2 + H, 5), each
#: output chroma column's then each output row's first input and four
#: coefficients, by (size, siting, device): one copy to a device a format
_TAPS: Dict[tuple, torch.Tensor] = {}


def _taps_on(size: Tuple[int, int], siting: Tuple[int, int], device: torch.device) -> torch.Tensor:
    key = (tuple(size), tuple(siting), str(device))
    with _lock:
        t = _TAPS.get(key)
    if t is None:
        rows = [(p,) + c for pos, taps in chroma_taps(size, siting) for p, c in zip(pos, taps)]
        t = torch.tensor(rows, dtype=torch.int32).to(device)
        with _lock:
            _TAPS[key] = t
    return t


def yuv420p10_to_bgr(surface: torch.Tensor, surface_height: int, size: Tuple[int, int], coefs,
                     origin: Tuple[int, int] = (0, 0),
                     siting: Tuple[int, int] = (0, 128)) -> torch.Tensor:
    """A 10-bit surface (rows, pitch) int16 in NV12's layout -> BGR (H,
    W, 3) uint8 of the display rectangle (size (W, H) at origin (left,
    top)), as cv2 converts yuv420p10 (``yuv420p10_to_bgr_plain``); coefs a
    ``colour_coefs10`` tuple, siting the chroma's (CHROMA_SITING; left by
    default, as ffmpeg reports HEVC's). A CPU tensor goes to the plain version; a
    CUDA tensor (contiguous) launches the kernel, one launch; anything else
    raises. ``yuv420p10_to_bgr.launches`` counts launches."""
    if surface.dtype != torch.int16 or surface.dim() != 2:
        raise ValueError(f"the surface must be int16 (rows, pitch), not {surface.dtype} "
                         f"{tuple(surface.shape)}")
    W, H = size
    left, top = origin
    rows, pitch = surface.shape
    if left % 2 or top % 2 or W % 2 or pitch % 2 or left + W > pitch \
            or top + H > surface_height or surface_height + (top + H + 1) // 2 > rows:
        raise ValueError(f"a {W} x {H} rectangle at {origin} does not fit a 16-bit surface of "
                         f"{rows} rows of {pitch} with chroma from row {surface_height}")
    if surface.device.type == "cpu":
        return yuv420p10_to_bgr_plain(surface, surface_height, size, coefs, origin, siting)
    if surface.device.type != "cuda" or not surface.is_contiguous() or surface.data_ptr() % 4:
        raise ValueError(f"the surface must be a contiguous CPU or CUDA tensor at a 4-byte "
                         f"boundary, not on {surface.device} at {surface.data_ptr()}")
    taps = _taps_on(size, siting, surface.device)
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=surface.device)
    luma, chroma = nv12_offsets(pitch, surface_height, left, top)
    k = (ctypes.c_int32 * 12)(*coefs)
    ptr = surface.data_ptr()
    with torch.cuda.device(surface.device):
        stream = torch.cuda.current_stream(surface.device).cuda_stream
        err = _library().yuv420p10_to_bgr(_P(ptr + 2 * luma), _P(ptr + 2 * chroma), int(pitch),
                                          _P(taps.data_ptr()), _P(out.data_ptr()), W, H, k,
                                          _P(stream))
    if err != 0:
        raise RuntimeError(f"yuv420p10_to_bgr failed to launch: CUDA error {err}")
    with _lock:
        yuv420p10_to_bgr.launches += 1
    return out


yuv420p10_to_bgr.launches = 0


def format_reason(fmt: Dict[str, int]) -> Optional[str]:
    """Why the port's NVDEC path does not take a stream of this format
    (nvdec_format's record), or None."""
    if fmt["chroma_format"] != 1:
        kind = {0: "monochrome", 2: "4:2:2", 3: "4:4:4"}.get(fmt["chroma_format"],
                                                             f"chroma format {fmt['chroma_format']}")
        return f"{kind} video: the port's NVDEC path decodes 4:2:0 (NV12) only"
    if fmt["luma_minus8"] or fmt["chroma_minus8"]:
        return (f"{8 + max(fmt['luma_minus8'], fmt['chroma_minus8'])}-bit video (P016): the "
                "port's NVDEC path decodes 8-bit only")
    if not fmt["progressive"]:
        return "interlaced video: the port's NVDEC path decodes progressive frames only"
    if fmt["matrix"] not in MATRICES:
        return matrix_reason(fmt["matrix"])
    return None


def matrix_reason(matrix: int) -> str:
    """Why a VUI matrix outside MATRICES is refused, naming it."""
    return (f"colour matrix {matrix} {OTHER_MATRICES.get(matrix, '')}".rstrip()
            + ": the port converts BT.601, BT.709 and BT.2020 only")


def codec_reason(codec: str, device) -> str:
    """Why an H.264 or HEVC file is refused on a device other than CUDA."""
    name = CODEC_NAMES[codec]
    return (f"{name}: NVDEC decodes it on the card only, not on {device} "
            "(decoder='software' reads it on the host)")


class Reader:
    """Frames of an H.264 or HEVC MP4 by index (presentation order, as
    cv2 counts them), as BGR uint8, decoded on a CUDA device's NVDEC
    (``cuda`` unless ``device`` names another). ``n_frames``, ``size``
    (width, height) and ``fps`` are the track's; an index past the end
    reads as None. Reading on is sequential; any other index decodes from
    the sync sample before the last one at or before it in presentation
    order (an open GOP's leading pictures need the GOP before)."""

    def __init__(self, fpath: str, device=None):
        self.fpath = fpath
        self.device = resolve_device(device)
        self.track = mp4.read_video_track(fpath)
        codec = self.track.codec
        if codec not in CODECS:
            raise UnsupportedVideo(fpath, f"{CODEC_NAMES.get(codec, repr(codec))}: not H.264 or "
                                          "HEVC")
        if self.device.type != "cuda":
            raise UnsupportedVideo(fpath, codec_reason(codec, self.device))
        why = refusal(self.device, codec, self.track.size)
        if why:
            raise UnsupportedVideo(fpath, why)
        tr = self.track
        self.n_frames, self.size, self.fps = tr.n_frames, tr.size, tr.fps
        self._frame_of = np.full(tr.n_samples, -1, np.int64)
        self._frame_of[tr.order] = np.arange(tr.n_frames)
        # each frame's decode start: the sync sample before the last one
        # presented at or before it
        syncs = np.flatnonzero(tr.sync)
        if len(syncs) == 0:
            syncs = np.zeros(1, np.int64)
        sync_pts = tr.pts[syncs]
        frame_pts = tr.pts[tr.order]
        last = np.searchsorted(np.maximum.accumulate(sync_pts), frame_pts, side="right") - 1
        self._start = syncs[np.clip(last - 1, 0, len(syncs) - 1)]
        self._file = open(fpath, "rb")
        self._h = None
        self._ended = False
        self._run_start = -1  # the sample the current run started at
        self._feed = 0  # the next sample to feed
        self._shown = -1  # the last frame shown in this run
        self._discontinuity = False
        self._ready: Dict[int, torch.Tensor] = {}
        self._fmt = None
        self._coefs = None
        self._shown_buf = np.zeros((SHOWN_CAP, 4), np.int64)

    # -- the decoder --

    def _open(self):
        lib = _library()
        h = _P()
        err = ctypes.create_string_buffer(_ERR)
        if lib.nvdec_create(_index(self.device), CODECS[self.track.codec], 0, ctypes.byref(h), err,
                            _ERR):
            raise RuntimeError(f"{self.fpath}: {err.value.decode()}")
        self._h = h

    def _close_decoder(self):
        if self._h is not None:
            _library().nvdec_destroy(self._h)
            self._h = None

    def _format(self) -> Dict[str, int]:
        rec = np.zeros(len(FORMAT_FIELDS), np.int32)
        _library().nvdec_format(self._h, _P(rec.ctypes.data))
        return dict(zip(FORMAT_FIELDS, (int(v) for v in rec)))

    def _restart(self, start: int):
        """A new decode run from sample start: a new parser (the decoder
        is kept), its first packet flagged as a discontinuity after a
        seek."""
        if self._h is None:
            self._open()
        else:
            err = ctypes.create_string_buffer(_ERR)
            if _library().nvdec_reset(self._h, err, _ERR):
                raise RuntimeError(f"{self.fpath}: {err.value.decode()}")
            self._discontinuity = True
        self._ended = False
        self._run_start = self._feed = int(start)
        self._shown = -1
        self._ready.clear()

    def _packet(self, data: bytes, timestamp: int, flags: int, want: int):
        lib = _library()
        n = ctypes.c_int(0)
        err = ctypes.create_string_buffer(_ERR)
        t0 = time.perf_counter()
        rc = lib.nvdec_parse(self._h, data, len(data), int(timestamp), flags,
                             _P(self._shown_buf.ctypes.data), SHOWN_CAP, ctypes.byref(n), err,
                             _ERR)
        COUNTERS["host_s"] += time.perf_counter() - t0
        if self._fmt is None:
            fmt = self._format()
            if fmt["have"]:
                why = format_reason(fmt)
                if why:
                    raise UnsupportedVideo(self.fpath, f"{CODEC_NAMES[self.track.codec]}: {why}")
                self._fmt = fmt
                self._coefs = colour_coefs(fmt["matrix"], fmt["full_range"])
                disp = (fmt["right"] - fmt["left"], fmt["bottom"] - fmt["top"])
                if disp != tuple(self.size):
                    self.size = disp  # the stream's own display size rules
        if rc:
            raise RuntimeError(f"{self.fpath}: {err.value.decode()}")
        for pic, ts, progressive, tff in self._shown_buf[:n.value].tolist():
            if 0 <= ts < self.n_frames and ts >= want and self._start[ts] >= self._run_start:
                self._ready[ts] = self._convert(pic, progressive, tff)
                self._shown = max(self._shown, ts)

    def _convert(self, pic, progressive, tff) -> torch.Tensor:
        """Map a shown picture, convert it into a new BGR tensor (one
        launch), unmap."""
        lib = _library()
        fmt = self._fmt
        W, H = self.size
        ptr, pitch = ctypes.c_uint64(0), ctypes.c_uint32(0)
        err = ctypes.create_string_buffer(_ERR)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            t0 = time.perf_counter()
            if lib.nvdec_map(self._h, int(pic), int(progressive), int(tff), _P(stream),
                             ctypes.byref(ptr), ctypes.byref(pitch), err, _ERR):
                raise RuntimeError(f"{self.fpath}: {err.value.decode()}")
            COUNTERS["map_s"] += time.perf_counter() - t0
            out = torch.empty((H, W, 3), dtype=torch.uint8, device=self.device)
            # the chroma plane starts after the surface's rows: the coded
            # height (the decoder's target height), rounded up to even
            surface_h = (fmt["coded_height"] + 1) & ~1
            try:
                _launch(ptr.value, pitch.value, surface_h, (fmt["left"], fmt["top"]), out,
                        self._coefs, stream)
            finally:
                if lib.nvdec_unmap(self._h, ptr, _P(stream), err, _ERR):
                    raise RuntimeError(f"{self.fpath}: {err.value.decode()}")
        return out

    def _sample(self, i: int) -> bytes:
        """Sample i in start-code form, the parameter sets in front at a
        run's first sample."""
        off, n = int(self.track.offsets[i]), int(self.track.sizes[i])
        if off < 0 or n == 0:
            return b""
        self._file.seek(off)
        nals = h26x.nal_units(self._file.read(n), self.track.length_size)
        if i == self._run_start:
            nals = list(self.track.param_sets) + nals
        return h26x.annexb(nals)

    # -- reading --

    def read_tensor(self, idx: int) -> Optional[torch.Tensor]:
        """Frame idx on the device, or None past the end."""
        idx = int(idx)
        if not 0 <= idx < self.n_frames:
            return None
        if idx in self._ready:
            return self._take(idx)
        start = int(self._start[idx])
        if not (self._h is not None and self._run_start >= 0 and self._run_start <= start
                <= self._feed and idx > self._shown):
            self._restart(start)
        while idx not in self._ready:
            if self._feed < self.track.n_samples:
                i = self._feed
                self._feed += 1
                t0 = time.perf_counter()
                data = self._sample(i)
                COUNTERS["host_s"] += time.perf_counter() - t0
                if not data:
                    continue
                flags = PKT_TIMESTAMP | PKT_ENDOFPICTURE
                if self._discontinuity:
                    flags |= PKT_DISCONTINUITY
                    self._discontinuity = False
                self._packet(data, self._frame_of[i], flags, idx)
            elif not self._ended:
                self._ended = True
                self._packet(b"", 0, PKT_ENDOFSTREAM, idx)
            else:
                return None
        return self._take(idx)

    def _take(self, idx):
        for k in [k for k in self._ready if k < idx]:
            del self._ready[k]
        return self._ready.pop(idx)

    def read(self, idx: int) -> Optional[np.ndarray]:
        """Frame idx as a numpy (H, W, 3) uint8 BGR array, or None."""
        f = self.read_tensor(idx)
        return None if f is None else f.cpu().numpy()

    def close(self):
        self._ready.clear()
        self._close_decoder()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
