"""HEVC in MP4 (``hvc1``/``hev1``: what GoPro cameras from the HERO6 on
write in their high-rate and high-resolution modes, at 10 bits where
their 10-bit colour is on) decoded in software on the host, as cv2's
ffmpeg decodes it for the JAX package, with each picture converted to BGR
on the device by a hand-written kernel, one launch a frame (its plain
version on the CPU): ``nvdec.nv12_to_bgr`` for 8-bit pictures,
``nvdec.yuv420p10_to_bgr`` (swscale's high-bit-depth arithmetic) for
10-bit ones.

``csrc/hevc.cpp`` is the decoder: progressive 8- and 10-bit 4:2:0 video in
the Main, Main 10 and Main Still Picture profiles (every coding tool of
the Main profile: CTBs of 16 to 64, AMP, transform skip, sign hiding, scaling
lists, PCM, transquant bypass, tiles, wavefronts, dependent slice
segments, weighted prediction, TMVP, long-term pictures, deblocking and
SAO; IDR, CRA and BLA pictures with their leading pictures). It is built by
``g++`` at first use into ``acinoset_tpu_torch/_build/libhevc.so`` and
loaded with ``ctypes``. What it does not take raises
``mpeg4.UnsupportedVideo`` naming the feature: bit depths other than 8
and 10, a chroma bit depth unlike the luma's, chroma formats other than
4:2:0, the range, multilayer, 3D and SCC extensions, field coding, colour
matrices other than BT.601, BT.709 and BT.2020, and 10-bit frames of
fewer than 10 rows. Pictures of nuh_layer_id > 0 are dropped, as ffmpeg
drops them.

Frames are numbered as cv2 numbers them: frame k is the k-th by
composition time after the edit list (``mp4.VideoTrack.order``) among the
pictures a decode of the whole file outputs, found by a scan of the file's
slice headers through the decoder's own DPB (a RASL picture of a CRA that
starts the stream, of a BLA or of a CRA after an end of sequence is not
output; nor is a picture with pic_output_flag 0, nor one still waiting
where an IRAP's NoOutputOfPriorPicsFlag empties the DPB). A seek restarts at the last IRAP sample from which a
sequential decode outputs that frame: the last one at or before its
sample, or for a RASL picture the one before its CRA. The same source
holds a writer of test streams (``utils.h26x``'s ``RandomHEVC``) that
drives the decoder's own syntax code.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import _gxx, h264
from .h264 import INFO_FIELDS
from .mpeg4 import UnsupportedVideo

SOURCE = Path(__file__).resolve().parent / "csrc" / "hevc.cpp"
LIBRARY = _gxx.BUILD_DIR / "libhevc.so"
CODECS = ("hvc1", "hev1")
#: the reader's work in this process: seconds in the C++ decoder, and
#: seconds copying pictures to the device and converting them there
COUNTERS = {"host_s": 0.0, "device_s": 0.0}
#: nal_unit_type ranges: IRAP pictures, RASL pictures
_IRAP, _RASL = range(16, 24), (8, 9)
#: nal_unit_types the scan takes after a sample's first slice segment:
#: SPS, PPS, end of sequence, end of bitstream
_SCANNED = (33, 34, 36, 37)
#: bytes of a sample read for its first slice header before the whole one
_PEEK_BYTES = 4096
#: most pictures one sample can output (the DPB holds at most 16)
_MAX_OUT = 64

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_ERR = 512


def build() -> Path:
    """Compile csrc/hevc.cpp into LIBRARY (``_gxx.build``)."""
    return _gxx.build(SOURCE, LIBRARY)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.hevc_open.restype = _P
            lib.hevc_close.argtypes = [_P]
            lib.hevc_close.restype = None
            lib.hevc_decode.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, _P,
                                        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_char_p, ctypes.c_int]
            lib.hevc_info.argtypes = [_P, _P]
            lib.hevc_reset.argtypes = [_P]
            lib.hevc_reset.restype = None
            lib.hevc_scan.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _P,
                                      ctypes.c_char_p, ctypes.c_int]
            lib.hevc_scan_end.argtypes = [_P, ctypes.c_int, _P, ctypes.c_int64]
            lib.hevc_scan_end.restype = ctypes.c_int64
            lib.hevcw_open.argtypes = [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_uint64,
                                       ctypes.c_char_p, ctypes.c_int]
            lib.hevcw_open.restype = _P
            lib.hevcw_close.argtypes = [_P]
            lib.hevcw_close.restype = None
            lib.hevcw_param_sets.argtypes = [_P, _P, ctypes.c_int64]
            lib.hevcw_param_sets.restype = ctypes.c_int64
            lib.hevcw_picture.argtypes = [_P, ctypes.c_int, _P, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                                          ctypes.c_int]
            _lib = lib
    return _lib


class Decoder:
    """The C++ decoder: NAL units in, NV12 pictures (coded size; 16-bit
    samples at 10 bits) out, in decode order. Errors raise ``UnsupportedVideo`` (a feature it does not
    take) or ``ValueError`` (a malformed stream), naming fpath."""

    def __init__(self, fpath: str = "<stream>"):
        self.fpath = fpath
        self._lib = _library()
        self._h = _P(self._lib.hevc_open())
        self._err = ctypes.create_string_buffer(_ERR)

    def _check(self, rc):
        if rc == -2:
            raise UnsupportedVideo(self.fpath, f"HEVC: {self._err.value.decode()}")
        if rc:
            raise ValueError(f"{self.fpath}: malformed HEVC ({self._err.value.decode()})")

    def decode(self, data: bytes, length_size: int, out: Optional[np.ndarray]) -> bool:
        """Decode one MP4 sample (length_size 0: one NAL unit, such as a
        parameter set); where it finishes a picture (output or not: the
        scan tells), write it into out (coded height x 1.5 rows of the
        coded width: uint8, or int16 at 10 bits) and return True."""
        got = ctypes.c_int32(0)
        ptr = None if out is None else _P(out.ctypes.data)
        cap = 0 if out is None else out.nbytes
        self._check(self._lib.hevc_decode(self._h, data, len(data), length_size, ptr, cap,
                                          ctypes.byref(got), self._err, _ERR))
        return bool(got.value)

    def scan(self, data: bytes, length_size: int, tag: int):
        """What decoding the sample in data (length_size 0: one NAL unit of
        it) does to the DPB, with no slice data; data may hold the sample's
        first bytes only. Its pictures are named by tag. (nal_unit_type of
        its first slice segment or -1, the byte offset of the first NAL
        unit data does not hold whole or -1): pass that one and those after
        it of ``_SCANNED``'s types, each alone, then call scan_end."""
        rec = np.zeros(2, np.int32)
        self._check(self._lib.hevc_scan(self._h, data, len(data), length_size, tag,
                                        _P(rec.ctypes.data), self._err, _ERR))
        return int(rec[0]), int(rec[1])

    def scan_end(self, last: bool, cap: int = _MAX_OUT) -> List[int]:
        """The end of a scanned sample (last: and of the stream): the tags
        of the pictures output since the last call, in output order (more
        than cap: a malformed stream)."""
        out = np.zeros(cap, np.int64)
        n = self._lib.hevc_scan_end(self._h, int(last), _P(out.ctypes.data), cap)
        if n > cap:
            raise ValueError(f"{self.fpath}: malformed HEVC ({n} pictures output at once)")
        return out[:n].tolist()

    def info(self) -> Optional[Dict[str, int]]:
        """The format of the active (else the first) SPS (h264.INFO_FIELDS),
        or None before one."""
        rec = np.zeros(len(INFO_FIELDS), np.int32)
        if self._lib.hevc_info(self._h, _P(rec.ctypes.data)):
            return None
        return dict(zip(INFO_FIELDS, (int(v) for v in rec)))

    def reset(self):
        """Forget every picture (the next one decoded must be an IRAP)."""
        self._lib.hevc_reset(self._h)

    def close(self):
        if self._h:
            self._lib.hevc_close(self._h)
            self._h = None


class Reader(h264.Reader):
    """Frames of an HEVC MP4 by index (presentation order among the
    pictures shown, as cv2 counts them), as BGR uint8 on the device
    (``cuda`` unless ``device`` names another), decoded by the port's
    software decoder: ``h264.Reader``'s reading (one NV12 copy and one
    conversion launch a frame) over this decoder, the frames and
    each one's decode start found by a scan of the samples through the
    decoder's own DPB (the module's notes). ``n_frames``, ``size`` (the
    stream's display width, height) and ``fps``; an index past the end
    reads as None. Reading on is sequential; any other index restarts at
    the IRAP sample a sequential decode passes through to reach it."""

    COUNTERS = COUNTERS
    DECODER = Decoder
    CODECS = CODECS
    NAME = "HEVC"

    def _param_sets(self):
        return self.track.param_sets

    def _read(self, i: int, at: int = 0, limit: Optional[int] = None) -> bytes:
        off, n = int(self.track.offsets[i]), int(self.track.sizes[i])
        if off < 0 or n <= at:
            return b""
        self._file.seek(off + at)
        return self._file.read(n - at if limit is None else min(n - at, limit))

    def _scan_sample(self, i: int) -> int:
        """Scan sample i (``Decoder.scan``), reading its first bytes, the
        NAL units after its first slice segment that the scan takes, or
        the whole sample where those do not do; its first slice's
        nal_unit_type, or -1."""
        tr, dec = self.track, self._dec
        ls = tr.length_size
        try:
            kind, rest = dec.scan(self._read(i, 0, _PEEK_BYTES), ls, i)
            if kind < 0 and rest >= 0:
                raise ValueError("no slice segment in the sample's first bytes")
        except ValueError:  # a header past the first bytes
            kind, rest = dec.scan(self._read(i), ls, i)
        while rest >= 0:  # the NAL units after the slice segment's first bytes
            head = self._read(i, rest, ls + 2)
            if len(head) < ls + 2:
                break
            size = int.from_bytes(head[:ls], "big")
            if head[ls] >> 1 & 63 in _SCANNED and not (head[ls] & 1 or head[ls + 1] >> 3):
                dec.scan(self._read(i, rest + ls, size), 0, i)
            rest += ls + size
        return kind

    def _frames(self):
        """Each frame's sample and the IRAP sample a decode that shows it
        starts at, from a scan of the whole file through the decoder's DPB:
        it outputs a picture or drops it as a decode does (pic_output_flag,
        RASL pictures where NoRaslOutputFlag is 1, NoOutputOfPriorPicsFlag,
        an end of sequence)."""
        tr, dec = self.track, self._dec
        start = np.zeros(tr.n_samples, np.int64)
        shown = []
        last_irap = prev_irap = -1
        for i in range(tr.n_samples):
            kind = self._scan_sample(i)
            if kind in _IRAP:
                prev_irap, last_irap = last_irap, i
            start[i] = max(prev_irap, 0) if kind in _RASL else max(last_irap, 0)
            shown += dec.scan_end(False)
        shown += dec.scan_end(True, tr.n_samples + _MAX_OUT)
        dec.reset()
        shown = np.zeros(tr.n_samples, bool) if not shown else np.isin(
            np.arange(tr.n_samples), shown)
        order = np.array([i for i in tr.order if shown[i]], np.int64)
        return order, start[order]
