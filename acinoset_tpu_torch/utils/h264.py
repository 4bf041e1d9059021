"""H.264 in MP4 (``avc1``/``avc3``: what every GoPro camera can write)
decoded in software on the host, as cv2's ffmpeg decodes it for the JAX
package, with each picture converted to BGR on the device by the
hand-written NV12 -> BGR kernel (``nvdec.nv12_to_bgr``, one launch a
frame; its plain version on the CPU).

``csrc/h264.cpp`` is the decoder: progressive 8-bit 4:2:0 video in the
Constrained Baseline, Main and High profiles (CAVLC and CABAC; I, P and B
slices; the 8x8 transform and scaling matrices; weighted prediction;
spatial and temporal direct; long-term references and every MMCO; the
deblocking filter; several slices a picture). It is built by ``g++`` at
first use into ``acinoset_tpu_torch/_build/libh264.so`` and loaded with
``ctypes``. What it does not take raises ``mpeg4.UnsupportedVideo`` naming
the feature: interlace (field pictures, MBAFF), 4:0:0, 4:2:2 and 4:4:4,
more than 8 bits a sample, lossless coding, slice groups (FMO), arbitrary
slice order, SP/SI slices, data partitioning, SVC/MVC NAL units, and
colour matrices other than BT.601, BT.709 and BT.2020.

Frames are numbered as cv2 numbers them: frame k is the k-th by
composition time after the edit list (``mp4.VideoTrack.order``), whatever
the decoder's output order. A seek restarts at the last IDR (sync sample)
at or before the frame's sample, so that it gives the sequential decode's
frame. The same source holds a writer of test streams (``utils.h26x``'s
``RandomH264``) that drives the decoder's own syntax code.
"""
from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import _gxx, mp4, nvdec
from .device import resolve_device
from .mpeg4 import CODEC_NAMES, UnsupportedVideo

SOURCE = Path(__file__).resolve().parent / "csrc" / "h264.cpp"
LIBRARY = _gxx.BUILD_DIR / "libh264.so"
CODECS = ("avc1", "avc3")
#: h264_info's record
INFO_FIELDS = ("coded_width", "coded_height", "left", "top", "width", "height", "signal_type",
               "full_range", "colour_description", "matrix", "bit_depth", "chroma_loc")
#: the reader's work in this process: seconds in the C++ decoder, and
#: seconds copying pictures to the device and converting them there
COUNTERS = {"host_s": 0.0, "device_s": 0.0}

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_ERR = 512


def build() -> Path:
    """Compile csrc/h264.cpp into LIBRARY (``_gxx.build``)."""
    return _gxx.build(SOURCE, LIBRARY)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.h264_open.restype = _P
            lib.h264_close.argtypes = [_P]
            lib.h264_close.restype = None
            lib.h264_decode.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, _P,
                                        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_char_p, ctypes.c_int]
            lib.h264_info.argtypes = [_P, _P]
            lib.h264_reset.argtypes = [_P]
            lib.h264_reset.restype = None
            lib.h264w_open.argtypes = [_P, ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p,
                                       ctypes.c_int]
            lib.h264w_open.restype = _P
            lib.h264w_close.argtypes = [_P]
            lib.h264w_close.restype = None
            lib.h264w_param_sets.argtypes = [_P, _P, ctypes.c_int64]
            lib.h264w_param_sets.restype = ctypes.c_int64
            lib.h264w_picture.argtypes = [_P, _P, _P, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                                          ctypes.c_int]
            _lib = lib
    return _lib


class Decoder:
    """The C++ decoder: NAL units in, NV12 pictures (coded size) out, in
    decode order. Errors raise ``UnsupportedVideo`` (a feature it does not
    take) or ``ValueError`` (a malformed stream), naming fpath."""

    def __init__(self, fpath: str = "<stream>"):
        self.fpath = fpath
        self._lib = _library()
        self._h = _P(self._lib.h264_open())
        self._err = ctypes.create_string_buffer(_ERR)

    def _check(self, rc):
        if rc == -2:
            raise UnsupportedVideo(self.fpath, f"H.264: {self._err.value.decode()}")
        if rc:
            raise ValueError(f"{self.fpath}: malformed H.264 ({self._err.value.decode()})")

    def decode(self, data: bytes, length_size: int, out: Optional[np.ndarray]) -> bool:
        """Decode one MP4 sample (length_size 0: one NAL unit, such as a
        parameter set); where it finishes a picture, write it into out
        (uint8, coded height x 1.5 rows of the coded width) and return
        True."""
        got = ctypes.c_int32(0)
        ptr = None if out is None else _P(out.ctypes.data)
        cap = 0 if out is None else out.nbytes
        self._check(self._lib.h264_decode(self._h, data, len(data), length_size, ptr, cap,
                                          ctypes.byref(got), self._err, _ERR))
        return bool(got.value)

    def info(self) -> Optional[Dict[str, int]]:
        """The format of the last SPS (INFO_FIELDS), or None before one."""
        rec = np.zeros(len(INFO_FIELDS), np.int32)
        if self._lib.h264_info(self._h, _P(rec.ctypes.data)):
            return None
        return dict(zip(INFO_FIELDS, (int(v) for v in rec)))

    def reset(self):
        """Forget every picture (the next one decoded must be an IDR)."""
        self._lib.h264_reset(self._h)

    def close(self):
        if self._h:
            self._lib.h264_close(self._h)
            self._h = None


def colour_coefs(info: Dict[str, int]):
    """The conversion's constants for a stream's VUI: the matrix where a
    colour description is present (else 2, unspecified: BT.601) and the
    range where video_signal_type is present (else limited), as ffmpeg
    reads them; those of the 10-bit conversion where the SPS says 10 bits.
    (constants, None) or (None, why the stream is refused)."""
    matrix = info["matrix"] if info["signal_type"] and info["colour_description"] else 2
    full = bool(info["full_range"]) if info["signal_type"] else False
    if matrix not in nvdec.MATRICES:
        return None, nvdec.matrix_reason(matrix)
    if info["bit_depth"] > 8:
        try:
            nvdec.chroma_taps((info["width"], info["height"]), nvdec.chroma_siting(info["chroma_loc"]))
        except ValueError as e:
            return None, str(e)
        return nvdec.colour_coefs10(matrix, full), None
    return nvdec.colour_coefs(matrix, full), None


class Reader:
    """Frames of an H.264 MP4 by index (presentation order, as cv2 counts
    them), as BGR uint8 on the device (``cuda`` unless ``device`` names
    another), decoded by the port's software decoder. ``n_frames``,
    ``size`` (the stream's display width, height) and ``fps``; an index
    past the end reads as None. Reading on is sequential; any other index
    restarts at the last IDR at or before it."""

    #: what a codec's reader names: the module's counters this reader adds
    #: its seconds to, its decoder, its sample entries and the codec's name
    COUNTERS = COUNTERS
    DECODER = Decoder
    CODECS = CODECS
    NAME = "H.264"

    def __init__(self, fpath: str, device=None):
        self.fpath = fpath
        self.device = resolve_device(device)
        self.track = mp4.read_video_track(fpath)
        tr = self.track
        if tr.codec not in self.CODECS:
            raise UnsupportedVideo(fpath, f"{CODEC_NAMES.get(tr.codec, repr(tr.codec))}: not "
                                          f"{self.NAME}")
        self._ready: Dict[int, torch.Tensor] = {}
        self._file = open(fpath, "rb")
        self._dec = self.DECODER(fpath)
        try:
            for s in self._param_sets():
                self._dec.decode(s, 0, None)
            order, start = self._frames()
            info = self._dec.info()
            held = bool(np.any((tr.offsets >= 0) & (tr.sizes > 0)))
            if info is None and held:
                raise ValueError(f"{fpath}: an {self.NAME} track without a sequence parameter "
                                 "set")
            if info is not None:
                self._coefs, why = colour_coefs(info)
                if why:
                    raise UnsupportedVideo(fpath, f"{self.NAME}: {why}")
        except BaseException:
            self.close()
            raise
        self.info = info  # None where no chunk holds a sample: every frame reads as None
        self.size = tr.size if info is None else (info["width"], info["height"])
        self.fps = tr.fps
        # where no chunk holds a sample, the track's count of frames, each None
        self.n_frames = len(order) if info is not None else tr.n_frames
        self._order, self._start = order, start  # each frame's sample and decode start
        self._frame_of = np.full(tr.n_samples, -1, np.int64)
        self._frame_of[order] = np.arange(len(order))
        W, H = (info["coded_width"], info["coded_height"]) if info else (0, 0)
        # the decoder's picture: NV12, in 16-bit samples where it has 10 bits
        wide = info is not None and info["bit_depth"] > 8
        self._nv12 = torch.empty((H * 3 // 2, W), dtype=torch.int16 if wide else torch.uint8,
                                 pin_memory=self.device.type == "cuda" and info is not None)
        self._run_start = -1
        self._feed = 0

    def _param_sets(self):
        """The parameter sets fed before the samples: the sample entry's,
        or for avc3 those in the first sync sample."""
        sets = list(self.track.param_sets)
        if not any(s and s[0] & 31 == 7 for s in sets):  # avc3: parameter sets in band
            tr = self.track
            first = int(np.flatnonzero(tr.sync)[0]) if tr.sync.any() else 0
            sets = [n for n in self._nals(first) if n and n[0] & 31 in (7, 8)]
        return sets

    def _frames(self):
        """Each frame's sample (``mp4.VideoTrack.order``) and the sample its
        decode starts at: the last sync sample at or before its own."""
        tr = self.track
        syncs = np.flatnonzero(tr.sync)
        if len(syncs) == 0:
            syncs = np.zeros(1, np.int64)
        at = np.searchsorted(syncs, tr.order, side="right") - 1
        return tr.order, syncs[np.clip(at, 0, len(syncs) - 1)]

    def _nals(self, i: int):
        off, n = int(self.track.offsets[i]), int(self.track.sizes[i])
        if off < 0 or n == 0:
            return []
        self._file.seek(off)
        data, out, p, ls = self._file.read(n), [], 0, self.track.length_size
        while p + ls <= len(data):
            size = int.from_bytes(data[p:p + ls], "big")
            out.append(data[p + ls:p + ls + size])
            p += ls + size
        return out

    def _convert(self) -> torch.Tensor:
        """The picture in the NV12 buffer, on the device, as BGR: one
        launch of the kernel on a CUDA device (``nvdec.nv12_to_bgr``, or
        ``nvdec.yuv420p10_to_bgr`` for 10 bits)."""
        info = self.info
        t0 = time.perf_counter()
        surface = self._nv12.to(self.device, non_blocking=False)
        origin = (info["left"], info["top"])
        if info["bit_depth"] > 8:
            out = nvdec.yuv420p10_to_bgr(surface, info["coded_height"], self.size, self._coefs,
                                         origin, nvdec.chroma_siting(info["chroma_loc"]))
        else:
            out = nvdec.nv12_to_bgr(surface, info["coded_height"], self.size, self._coefs, origin)
        self.COUNTERS["device_s"] += time.perf_counter() - t0
        return out

    def read_tensor(self, idx: int) -> Optional[torch.Tensor]:
        """Frame idx on the device, or None past the end."""
        idx = int(idx)
        if self.info is None or not 0 <= idx < self.n_frames:
            return None
        if idx in self._ready:
            return self._take(idx)
        start, sample = int(self._start[idx]), int(self._order[idx])
        if not (0 <= self._run_start <= start <= self._feed and sample >= self._feed):
            self._dec.reset()
            self._ready.clear()
            self._run_start = self._feed = start
        buf = self._nv12.numpy()
        while idx not in self._ready:
            if self._feed >= self.track.n_samples:
                return None
            i = self._feed
            self._feed += 1
            off, n = int(self.track.offsets[i]), int(self.track.sizes[i])
            if off < 0 or n == 0:
                continue
            self._file.seek(off)
            data = self._file.read(n)
            t0 = time.perf_counter()
            got = self._dec.decode(data, self.track.length_size, buf)
            self.COUNTERS["host_s"] += time.perf_counter() - t0
            k = int(self._frame_of[i])
            if got and k >= idx:
                self._ready[k] = self._convert()
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
        self._dec.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
