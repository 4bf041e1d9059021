"""H.264 and HEVC in MP4 (``avc1``/``avc3``, ``hvc1``/``hev1``: what
GoPro cameras write) decoded on the card's NVDEC, the H100's
fixed-function decoder, through the driver's ``libnvcuvid`` (no package
of finished kernels: the library comes with the driver).

``csrc/nvdec.cu`` holds the binding and the one kernel: it is built with
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
than BT.601 and BT.709 (BT.2020 is one).

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
#: treats them. NVDEC reports 2 for a stream without colour description.
MATRICES = {1: "BT.709", 2: "BT.601", 5: "BT.601", 6: "BT.601"}
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
        name = {9: "BT.2020", 10: "BT.2020 (constant luminance)", 0: "identity (RGB)",
                4: "FCC", 7: "SMPTE 240M"}.get(fmt["matrix"], "")
        return (f"colour matrix {fmt['matrix']} {name}".rstrip() + ": the port converts "
                "BT.601 and BT.709 only")
    return None


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
