"""H.264 and HEVC elementary streams: what the port's NVDEC reader
(``utils.nvdec``) feeds the card's decoder, two stream writers of known
reconstruction and two of random syntax for its tests and
``chip_smoke.py``.

- ``nal_units``/``annexb``: an MP4 sample's length-prefixed NAL units
  (``avcC``/``hvcC``'s length size) in start-code form (Annex B), with
  the parameter sets put in front at each decode start.
- ``H264Stream``: Main profile, CAVLC, POC type 0, frame cropping, a VUI
  with the colour matrix and range and ``bitstream_restriction``
  (``max_num_reorder_frames`` 2), deblocking off. Its GOP is ``I P B B P
  B B ...``: IDR frames of ``I_PCM`` macroblocks; P frames of ``P_Skip``
  runs around an ``I_PCM`` patch that moves; non-reference B frames of
  ``B_Skip`` macroblocks with spatial direct prediction, whose
  reconstruction is ``(L0 + L1 + 1) >> 1`` of the two anchors about them,
  around an ``I_PCM`` patch of their own (so that no two frames are
  alike, and a frame out of order shows).
- ``HevcStream``: Main profile, CTB 16 = min CB 16, PCM with its loop
  filter off, SAO and deblocking off, one merge candidate, no TMVP: an
  IDR of PCM CUs, then ``TRAIL_R`` P frames of skipped CUs around a
  moving PCM patch. CABAC codes only the context bins of
  ``cu_skip_flag``, ``pred_mode_flag`` and ``part_mode``; ``pcm_flag``
  and ``end_of_slice_segment_flag`` are terminate bins, and the engine
  starts afresh after the PCM samples.

Both are made from a seed at run time (``planes(k)`` is frame k's
reconstruction, in presentation order). ``RandomH264`` and ``RandomHEVC``
are streams of random syntax, written by the software decoders' own
syntax code (``csrc/h264.cpp``, ``csrc/hevc.cpp``) from a seed. All are
written into MP4 by ``write_mp4`` (``avc1``/``avc3``, ``hvc1``/``hev1``,
with ``ctts`` and ``elst`` where frames are reordered). They serve tests
and measurement; no user entry point writes them.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import mp4

#: VUI matrix_coefficients: BT.709, BT.601 (SMPTE 170M), BT.2020 (NCL)
BT709, BT601, BT2020 = 1, 6, 9
#: frames of an anchor's I_PCM patch (macroblocks, width x height)
PATCH_MBS = (8, 4)


# ---- NAL units ----


def nal_units(sample: bytes, length_size: int = 4) -> List[bytes]:
    """The NAL units of a length-prefixed MP4 sample."""
    out, p, n = [], 0, len(sample)
    while p + length_size <= n:
        size = int.from_bytes(sample[p:p + length_size], "big")
        p += length_size
        if p + size > n:
            raise ValueError(f"a NAL unit of {size} bytes overruns its {n}-byte sample")
        out.append(sample[p:p + size])
        p += size
    return out


def annexb(nals: Sequence[bytes]) -> bytes:
    """NAL units in start-code form."""
    return b"".join(b"\x00\x00\x00\x01" + bytes(n) for n in nals)


def escape(rbsp: np.ndarray) -> bytes:
    """Emulation prevention (H.264 7.4.1, HEVC 7.4.2): 0x03 after every
    two zero bytes that a byte <= 3 follows. Vectorised over zero runs: in
    a run of k zeros a 0x03 goes before its zeros 2, 4, ...; before the
    byte after the run too when k is even and that byte is <= 3."""
    b = np.asarray(rbsp, np.uint8)
    if b.size == 0:
        return b""
    z = np.concatenate([[0], (b == 0).astype(np.int8), [0]])
    d = np.diff(z)
    starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    k = ends - starts
    if not np.any(k >= 2):
        return b.tobytes()
    inside = [s + np.arange(2, L, 2) for s, L in zip(starts[k >= 3], k[k >= 3])]
    after = ends[(k >= 2) & (k % 2 == 0)]
    after = after[(after >= len(b)) | (b[np.minimum(after, len(b) - 1)] <= 3)]
    pos = np.sort(np.concatenate(inside + [after]).astype(np.int64))
    return np.insert(b, pos, 3).tobytes()


class Bits:
    """An MSB-first bit writer with Exp-Golomb codes."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def u(self, v: int, n: int) -> "Bits":
        if n:
            self.acc = (self.acc << n) | (int(v) & ((1 << n) - 1))
            self.n += n
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 0xFF)
            self.acc &= (1 << self.n) - 1
        return self

    def ue(self, v: int) -> "Bits":
        v = int(v) + 1
        k = v.bit_length()
        return self.u(0, k - 1).u(v, k)

    def se(self, v: int) -> "Bits":
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self, bit: int = 0) -> "Bits":
        if self.n:
            self.u((1 << (8 - self.n)) - 1 if bit else 0, 8 - self.n)
        return self

    def raw(self, data) -> "Bits":
        assert self.n == 0, "raw bytes need a byte-aligned writer"
        self.out += bytes(data)
        return self

    def trailing(self) -> bytes:
        """rbsp_trailing_bits, then the bytes."""
        self.u(1, 1).align(0)
        return bytes(self.out)


def _mb_samples(planes, mbs: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, 384) PCM samples of 16 x 16 macroblocks (or CUs) in raster
    order, each its 256 luma, 64 Cb and 64 Cr samples in raster order;
    mbs (n, 2) picks (mbx, mby), else all of them."""
    y, u, v = planes
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    Y = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(mbh * mbw, 256)
    U = u.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(mbh * mbw, 64)
    V = v.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(mbh * mbw, 64)
    out = np.concatenate([Y, U, V], axis=1)
    if mbs is not None:
        out = out[mbs[:, 1] * mbw + mbs[:, 0]]
    return out


# ---- the streams' content ----


class _Content:
    """A stream's frames and their reconstruction, from a seed: GOPs of
    ``gop`` frames, each an IDR whose samples are uniform noise, then
    anchors (P) every third frame with B frames between them (or every
    frame when b_frames is off); a GOP's last frames are P frames where no
    anchor follows them inside it. Each P anchor replaces a PATCH_MBS
    patch of its reference by noise, and each B frame one of the average
    of its anchors; the patch moves from frame to frame."""

    def __init__(self, size, n_frames, gop, seed, b_frames):
        self.size = (int(size[0]), int(size[1]))
        W, H = self.size
        if W % 2 or H % 2 or W <= 0 or H <= 0:
            raise ValueError(f"frame size {W} x {H}: width and height must be even")
        self.mbw, self.mbh = (W + 15) // 16, (H + 15) // 16
        self.coded = (16 * self.mbw, 16 * self.mbh)
        self.n, self.gop, self.seed = int(n_frames), int(gop), int(seed)
        self.types: List[str] = []
        self.decode: List[int] = []  # display indices in decode order
        for g0 in range(0, self.n, self.gop):
            length = min(self.gop, self.n - g0)
            kinds = ["I"] + ["P"] * (length - 1)
            if b_frames:
                for j in range(1, length):
                    nxt = (j // 3 + 1) * 3
                    kinds[j] = "P" if j % 3 == 0 or nxt >= length else "B"
            self.types += kinds
            pending = []
            for j, kind in enumerate(kinds):
                if kind == "B":
                    pending.append(g0 + j)
                else:
                    self.decode += [g0 + j] + pending
                    pending = []
        self.pw, self.ph = min(PATCH_MBS[0], self.mbw), min(PATCH_MBS[1], self.mbh)
        self._cache: Dict[int, tuple] = {}

    def _rng(self, *key):
        return np.random.default_rng([self.seed, *key])

    def patch(self, k) -> Tuple[int, int]:
        """The top-left macroblock (mbx, mby) of anchor k's patch."""
        return ((5 * k) % (self.mbw - self.pw + 1), (3 * k) % (self.mbh - self.ph + 1))

    def patch_mbs(self, k) -> np.ndarray:
        """(n, 2) the patch's macroblocks, raster order."""
        x0, y0 = self.patch(k)
        yy, xx = np.mgrid[y0:y0 + self.ph, x0:x0 + self.pw]
        return np.stack([xx.ravel(), yy.ravel()], 1)

    def _noise(self, shape, *key):
        return self._rng(*key).integers(0, 256, size=shape, dtype=np.uint8)

    def _put_patch(self, k, planes):
        x0, y0 = self.patch(k)
        s = self.patch_samples(k).reshape(self.ph, self.pw, 384)
        planes[0][16 * y0:16 * (y0 + self.ph), 16 * x0:16 * (x0 + self.pw)] = \
            s[..., :256].reshape(self.ph, self.pw, 16, 16).transpose(0, 2, 1, 3).reshape(
                16 * self.ph, 16 * self.pw)
        for c in (0, 1):
            planes[1 + c][8 * y0:8 * (y0 + self.ph), 8 * x0:8 * (x0 + self.pw)] = \
                s[..., 256 + 64 * c:320 + 64 * c].reshape(self.ph, self.pw, 8, 8).transpose(
                    0, 2, 1, 3).reshape(8 * self.ph, 8 * self.pw)
        return planes

    def anchor_ref(self, k) -> int:
        """The anchor before frame k (its reference)."""
        j = k - 1
        while self.types[j] == "B":
            j -= 1
        return j

    def anchor_next(self, k) -> int:
        j = k + 1
        while self.types[j] == "B":
            j += 1
        return j

    def patch_samples(self, k) -> np.ndarray:
        """(n, 384) anchor k's patch samples."""
        return self._noise((self.pw * self.ph, 384), 1, k)

    def planes(self, k) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame k's reconstruction at the coded size: uint8 Y, U, V."""
        k = int(k)
        if k in self._cache:
            return self._cache[k]
        W16, H16 = self.coded
        kind = self.types[k]
        if kind == "I":
            out = (self._noise((H16, W16), 0, k), self._noise((H16 // 2, W16 // 2), 2, k),
                   self._noise((H16 // 2, W16 // 2), 3, k))
        elif kind == "P":
            out = self._put_patch(k, tuple(p.copy() for p in self.planes(self.anchor_ref(k))))
        else:
            a, b = self.planes(self.anchor_ref(k)), self.planes(self.anchor_next(k))
            out = self._put_patch(k, tuple(((p.astype(np.uint16) + q + 1) >> 1).astype(np.uint8)
                                           for p, q in zip(a, b)))
        if kind != "B":
            self._cache = {j: v for j, v in self._cache.items() if j >= k - 2 * self.gop}
            self._cache[k] = out
        return out

    def nv12(self, k, pitch_align: int = 1) -> np.ndarray:
        """Frame k's reconstruction as an NV12 surface (coded height x 1.5
        rows: Y, then U and V interleaved), each row the coded width
        zero-padded to a multiple of pitch_align, as a decoder's surface
        is."""
        y, u, v = self.planes(k)
        uv = np.stack([u, v], -1).reshape(u.shape[0], 2 * u.shape[1])
        W = y.shape[1]
        surf = np.zeros((y.shape[0] + uv.shape[0], -(-W // pitch_align) * pitch_align), np.uint8)
        surf[:, :W] = np.concatenate([y, uv], 0)
        return surf

    def surface(self, k, device, pitch_align: int = 1):
        """Frame k's reconstruction as an NV12 surface (``nv12``) in a
        tensor on device."""
        import torch

        return torch.from_numpy(self.nv12(k, pitch_align)).to(device)

    @property
    def presentation_offsets(self) -> List[int]:
        """Each sample's (decode order) display index less its decode index."""
        return [k - i for i, k in enumerate(self.decode)]


def _vui_colour(bits: Bits, matrix, full_range):
    """video_signal_type: format 5 (unspecified), the range, and the
    colour description (primaries and transfer as the matrix for BT.709
    and BT.601, else unspecified); matrix None writes none."""
    if matrix is None:
        bits.u(0, 1)
        return
    prim = matrix if matrix in (BT709, BT601) else 2
    bits.u(1, 1).u(5, 3).u(int(bool(full_range)), 1).u(1, 1).u(prim, 8).u(prim, 8).u(matrix, 8)


# ---- H.264 ----

H264_PROFILE, H264_LEVEL = 77, 51  # Main, level 5.1
_IDR, _SLICE, _SPS, _PPS = 5, 1, 7, 8
#: mb_type of I_PCM in I, P and B slices
_I_PCM = {"I": 25, "P": 30, "B": 48}
LOG2_FRAME_NUM, LOG2_POC_LSB = 4, 8


class H264Stream(_Content):
    """An H.264 stream of known reconstruction (the module's notes): size
    (width, height), cropped from the coded size where that is not a
    multiple of 16; ``matrix`` and ``full_range`` go to the VUI."""

    def __init__(self, size, n_frames, gop=12, seed=0, matrix=BT709, full_range=True,
                 b_frames=True):
        super().__init__(size, n_frames, gop, seed, b_frames)
        self.matrix, self.full_range = matrix, bool(full_range)
        self.sps = self._sps()
        self.pps = self._pps()

    @property
    def param_sets(self) -> List[bytes]:
        return [self.sps, self.pps]

    @staticmethod
    def _nal(ref_idc, kind, rbsp) -> bytes:
        return bytes([(ref_idc << 5) | kind]) + escape(np.frombuffer(rbsp, np.uint8))

    def _sps(self) -> bytes:
        W, H = self.size
        W16, H16 = self.coded
        b = Bits().u(H264_PROFILE, 8).u(0x40, 8).u(H264_LEVEL, 8).ue(0)
        b.ue(LOG2_FRAME_NUM - 4).ue(0).ue(LOG2_POC_LSB - 4)
        b.ue(2).u(0, 1).ue(self.mbw - 1).ue(self.mbh - 1)
        b.u(1, 1).u(1, 1)  # frame_mbs_only, direct_8x8_inference
        crop = (W16 - W) // 2, (H16 - H) // 2
        if any(crop):
            b.u(1, 1).ue(0).ue(crop[0]).ue(0).ue(crop[1])
        else:
            b.u(0, 1)
        b.u(1, 1)  # vui_parameters_present_flag
        b.u(0, 1).u(0, 1)  # aspect_ratio_info, overscan_info
        _vui_colour(b, self.matrix, self.full_range)
        b.u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1)  # chroma_loc, timing, nal/vcl hrd, pic_struct
        b.u(1, 1).u(1, 1).ue(0).ue(0).ue(16).ue(16).ue(2).ue(3)  # bitstream_restriction
        return self._nal(3, _SPS, b.trailing())

    def _pps(self) -> bytes:
        b = Bits().ue(0).ue(0).u(0, 1).u(0, 1).ue(0).ue(0).ue(0).u(0, 1).u(0, 2)
        b.se(0).se(0).se(0).u(1, 1).u(0, 1).u(0, 1)
        return self._nal(3, _PPS, b.trailing())

    def _header(self, k, frame_num) -> Bits:
        """The slice header of display frame k (one slice a picture)."""
        kind = self.types[k]
        g0 = k - k % self.gop
        b = Bits().ue(0).ue({"P": 5, "B": 6, "I": 7}[kind]).ue(0)
        b.u(frame_num % (1 << LOG2_FRAME_NUM), LOG2_FRAME_NUM)
        if kind == "I":
            b.ue((g0 // self.gop) & 0xFFFF)  # idr_pic_id
        b.u((2 * (k - g0)) % (1 << LOG2_POC_LSB), LOG2_POC_LSB)
        if kind == "B":
            b.u(1, 1)  # direct_spatial_mv_pred_flag
        if kind != "I":
            b.u(0, 1).u(0, 1)  # num_ref_idx_active_override, ref_pic_list_modification l0
        if kind == "B":
            b.u(0, 1)  # ref_pic_list_modification l1
        if kind == "I":
            b.u(0, 1).u(0, 1)  # no_output_of_prior_pics, long_term_reference
        elif kind == "P":
            b.u(0, 1)  # adaptive_ref_pic_marking_mode_flag
        return b.se(0).ue(1)  # slice_qp_delta; disable_deblocking_filter_idc 1

    def _idr(self, k, b: Bits) -> bytes:
        """An IDR slice of I_PCM macroblocks: after the first, each one is
        ue(25) and its alignment (0x0D 0x00), then its 384 samples."""
        b.ue(_I_PCM["I"]).align(0)
        samples = _mb_samples(self.planes(k))
        rest = np.empty((len(samples) - 1, 386), np.uint8)
        rest[:, 0], rest[:, 1] = 0x0D, 0x00
        rest[:, 2:] = samples[1:]
        rbsp = np.concatenate([np.frombuffer(bytes(b.out), np.uint8), samples[0],
                               rest.reshape(-1), [0x80]]).astype(np.uint8)
        return bytes([(3 << 5) | _IDR]) + escape(rbsp)

    def _inter(self, k, b: Bits) -> bytes:
        """A P or B slice: skip runs around the frame's I_PCM patch."""
        kind = self.types[k]
        mbs = self.patch_mbs(k)
        patch = set(map(tuple, mbs))
        samples = self.patch_samples(k)
        run = i = 0
        for mby in range(self.mbh):
            for mbx in range(self.mbw):
                if (mbx, mby) in patch:
                    b.ue(run).ue(_I_PCM[kind]).align(0).raw(samples[i].tobytes())
                    run, i = 0, i + 1
                else:
                    run += 1
        if run:
            b.ue(run)
        return self._nal(2 if kind == "P" else 0, _SLICE, b.trailing())

    def samples(self) -> Iterator[Tuple[int, bool, List[bytes]]]:
        """(display index, sync, NAL units) of each picture, in decode
        order."""
        refs = 0
        for k in self.decode:
            kind = self.types[k]
            if kind == "I":
                refs = 0
            b = self._header(k, refs)
            nal = self._idr(k, b) if kind == "I" else self._inter(k, b)
            if kind != "B":
                refs += 1
            yield k, kind == "I", [nal]

    def config(self) -> bytes:
        """The avcC payload."""
        return _avcc(self.sps, self.pps)


def _avcc(sps: bytes, pps: bytes) -> bytes:
    """An avcC payload: one SPS, one PPS, 4-byte NAL lengths."""
    out = bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
    return out + bytes([1]) + struct.pack(">H", len(pps)) + pps


#: RandomH264's options, in the order of the C++ writer's WOpts
_WOPTS = ("width", "height", "cabac", "poc_type", "log2_max_frame_num", "log2_max_poc_lsb",
          "max_refs", "reorder", "transform8x8", "scaling", "weighted_pred", "weighted_bipred",
          "direct", "max_slices", "deblock_mask", "deblock_offsets", "mmco", "long_term",
          "constrained_intra", "qp_min", "qp_max", "matrix", "full_range", "cqp_offset",
          "cqp_offset2", "intra_percent", "gaps", "profile", "direct_8x8", "colour", "vui_extra")


class RandomH264:
    """An H.264 stream of random syntax, written by the decoder's own
    syntax code (``csrc/h264.cpp``'s writer) with every element picked
    from a seeded generator within its legal range; the frames it decodes
    to are whatever that syntax makes of them, so only an independent
    decoder (cv2) can judge them. size (width, height), cropped from the
    coded size where that is not a multiple of 16; GOPs of ``gop`` frames,
    each an IDR, then P anchors with ``b_frames`` B frames between
    (presentation order; B frames are references where ``b_refs``);
    ``intra_only`` makes every frame an I picture. ``mmco5`` puts
    memory_management_control_operation 5 on one P anchor a GOP (one that
    follows another anchor directly, so that presentation order survives
    the POC reset). The rest are the writer's options: ``cabac``,
    ``poc_type`` (2 takes no reordering), ``refs`` (max_num_ref_frames),
    ``slices`` (at most, a picture), ``transform8x8``, ``scaling``
    (scaling lists in the SPS and PPS), ``weighted`` (None, 'explicit',
    'implicit'), ``direct`` ('spatial', 'temporal', 'both'), ``deblock``
    (the disable_deblocking_filter_idc values to pick from),
    ``deblock_offsets``, ``mmco`` (adaptive marking), ``long_term``,
    ``constrained_intra``, ``qp`` (min, max), ``matrix`` and
    ``full_range`` (VUI; matrix None writes no colour description),
    ``chroma_qp_offsets``, ``intra_percent`` (intra macroblocks in P
    and B slices), ``direct_8x8`` (direct_8x8_inference_flag),
    ``log2_max_frame_num`` and
    ``log2_max_poc_lsb`` (small ones wrap within a GOP), ``gaps``
    (frame_num gaps in P-only streams) and ``vui_extra`` (the VUI's
    aspect ratio, overscan, chroma location, timing and HRD). The profile
    is the least of Constrained Baseline, Main and High that takes them."""

    def __init__(self, size, n_frames, seed=0, *, cabac=False, gop=8, b_frames=2, b_refs=False,
                 intra_only=False, poc_type=0, refs=3, slices=1, transform8x8=False,
                 scaling=False, weighted=None, direct="spatial", deblock=(0,),
                 deblock_offsets=False, mmco=False, long_term=False, mmco5=False,
                 constrained_intra=False, qp=(20, 34), matrix=BT709, full_range=True,
                 chroma_qp_offsets=(0, 0), intra_percent=15, direct_8x8=True,
                 log2_max_frame_num=5, log2_max_poc_lsb=8, gaps=False, vui_extra=False):
        from . import h264

        self.size = (int(size[0]), int(size[1]))
        W, H = self.size
        if W % 2 or H % 2 or W <= 0 or H <= 0:
            raise ValueError(f"frame size {W} x {H}: width and height must be even")
        self.mbw, self.mbh = (W + 15) // 16, (H + 15) // 16
        self.coded = (16 * self.mbw, 16 * self.mbh)
        self.n, self.gop, self.seed = int(n_frames), int(gop), int(seed)
        self.matrix, self.full_range = matrix, bool(full_range)
        high = transform8x8 or scaling or chroma_qp_offsets[1] != chroma_qp_offsets[0]
        bpred = b_frames and not intra_only
        profile = 100 if high else 77 if (cabac or bpred or weighted) else 66
        self.types, self.decode, plan = self._plan(b_frames, b_refs, intra_only, poc_type, mmco5)
        shown = {k: i for i, k in enumerate(self.decode)}
        reorder = max((sum(1 for j in self.decode[:shown[k]] if j > k) for k in self.decode),
                      default=0)
        if gaps and b_frames and not intra_only:
            raise ValueError("frame_num gaps are written in streams without B frames only")
        opts = dict(width=W, height=H, cabac=int(cabac), poc_type=poc_type,
                    log2_max_frame_num=log2_max_frame_num, log2_max_poc_lsb=log2_max_poc_lsb,
                    max_refs=refs, reorder=reorder,
                    transform8x8=int(transform8x8), scaling=int(scaling),
                    weighted_pred=int(weighted == "explicit"),
                    weighted_bipred={None: 0, "explicit": 1, "implicit": 2}[weighted],
                    direct={"spatial": 0, "temporal": 1, "both": 2}[direct], max_slices=slices,
                    deblock_mask=sum(1 << i for i in deblock), deblock_offsets=int(deblock_offsets),
                    mmco=int(mmco), long_term=int(long_term),
                    constrained_intra=int(constrained_intra), qp_min=qp[0], qp_max=qp[1],
                    matrix=matrix or 2, full_range=int(bool(full_range)),
                    cqp_offset=chroma_qp_offsets[0], cqp_offset2=chroma_qp_offsets[1],
                    intra_percent=intra_percent, gaps=int(gaps), profile=profile,
                    direct_8x8=int(direct_8x8), colour=int(matrix is not None),
                    vui_extra=int(vui_extra))
        arr = np.array([opts[k] for k in _WOPTS], np.int32)
        lib = h264._library()
        err = ctypes.create_string_buffer(512)
        h = lib.h264w_open(arr.ctypes.data, len(arr), ctypes.c_uint64(self.seed), err, 512)
        if not h:
            raise ValueError(f"RandomH264: {err.value.decode()}")
        try:
            n = lib.h264w_param_sets(h, None, 0)
            buf = np.zeros(n, np.uint8)
            lib.h264w_param_sets(h, buf.ctypes.data, n)
            self.sps, self.pps = nal_units(buf.tobytes())
            #: each picture's NAL units, in decode order
            self.pictures: List[List[bytes]] = []
            cap = 4 * self.coded[0] * self.coded[1] + (1 << 16)
            out = np.zeros(cap, np.uint8)
            nb = ctypes.c_int64(0)
            for p in plan:
                pl = np.array(p, np.int32)
                rc = lib.h264w_picture(h, pl.ctypes.data, out.ctypes.data, cap, ctypes.byref(nb),
                                       err, 512)
                if rc:
                    why = err.value.decode() if rc != -3 else f"a picture of more than {cap} bytes"
                    raise ValueError(f"RandomH264: {why}")
                self.pictures.append(nal_units(out[:nb.value].tobytes()))
        finally:
            lib.h264w_close(h)

    def _plan(self, b_frames, b_refs, intra_only, poc_type, mmco5):
        """(types by display index, display indices in decode order, the
        writer's plan of each picture in decode order: slice type, idr,
        nal_ref_idc, POC, mmco5)."""
        types, decode, marks = [], [], set()
        for g0 in range(0, self.n, self.gop):
            length = min(self.gop, self.n - g0)
            kinds = ["I"] + ["P"] * (length - 1)
            if intra_only:
                kinds = ["I"] * length
            elif b_frames:
                step = b_frames + 1
                for j in range(1, length):
                    nxt = (j // step + 1) * step
                    kinds[j] = "P" if j % step == 0 or nxt >= length else "B"
            if mmco5:
                for j in range(2, length):
                    if kinds[j] == "P" and kinds[j - 1] != "B":
                        marks.add(g0 + j)
                        break
            types += kinds
            pending = []
            for j, kind in enumerate(kinds):
                if kind == "B" and poc_type != 2:
                    pending.append(g0 + j)
                else:
                    decode += [g0 + j] + pending
                    pending = []
        plan, base = [], 0
        for k in decode:
            kind = types[k]
            idr = kind == "I" and k % self.gop == 0
            if idr:
                base = k
            ref = 0 if kind == "B" and not b_refs else 1 + (7 * k + self.seed) % 3
            plan.append([{"P": 0, "B": 1, "I": 2}[kind], int(idr), ref, 2 * (k - base),
                         int(k in marks)])
            if k in marks:
                base = k
        return types, decode, plan

    @property
    def param_sets(self) -> List[bytes]:
        return [self.sps, self.pps]

    def samples(self) -> Iterator[Tuple[int, bool, List[bytes]]]:
        """(display index, sync, NAL units) of each picture, in decode
        order; sync pictures are the IDRs."""
        for k, nals in zip(self.decode, self.pictures):
            yield k, k % self.gop == 0 and self.types[k] == "I", nals

    def config(self) -> bytes:
        return _avcc(self.sps, self.pps)

    @property
    def presentation_offsets(self) -> List[int]:
        return [k - i for i, k in enumerate(self.decode)]


# ---- HEVC ----

_VPS, _HSPS, _HPPS = 32, 33, 34
_IDR_W_RADL, _TRAIL_R = 19, 1
HEVC_LEVEL = 153  # 5.1

#: CABAC (H.264 9.3.3.2 and HEVC 9.3.4.3): rangeTabLps[pStateIdx][qRangeIdx]
RANGE_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216), (123, 150, 178, 205),
    (116, 142, 169, 195), (111, 135, 160, 185), (105, 128, 152, 175), (100, 122, 144, 166),
    (95, 116, 137, 158), (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116), (66, 80, 95, 110),
    (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94), (53, 65, 77, 89),
    (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62), (35, 43, 51, 59),
    (33, 41, 48, 56), (32, 39, 46, 53), (30, 37, 43, 50), (29, 35, 41, 48),
    (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33), (19, 23, 27, 31),
    (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27), (15, 19, 22, 25),
    (14, 18, 21, 24), (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18), (10, 12, 15, 17),
    (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14), (8, 10, 12, 14),
    (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2))
TRANS_LPS = (0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15, 16, 16, 18, 18,
             19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31,
             32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63)
#: HEVC context initValues at initType 0 (I) and 1 (P): part_mode bin 0,
#: cu_skip_flag (three, by ctxInc), pred_mode_flag
_INIT = {"part_mode": (184, 154), "cu_skip_flag": (None, (197, 185, 201)),
         "pred_mode_flag": (None, 149)}


def cabac_context(init_value: int, qp: int) -> List[int]:
    """[pStateIdx, valMps] of a context (HEVC 9.3.2.2)."""
    m = (init_value >> 4) * 5 - 45
    n = ((init_value & 15) << 3) - 16
    pre = min(max(((m * min(max(qp, 0), 51)) >> 4) + n, 1), 126)
    return [pre - 64, 1] if pre > 63 else [63 - pre, 0]


class Cabac:
    """The CABAC arithmetic encoder (HEVC 9.3.4.x / H.264 9.3.4.2)."""

    def __init__(self, bits: Bits):
        self.bits = bits
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, bit):
        if self.first:
            self.first = False
        else:
            self.bits.u(bit, 1)
        if self.outstanding:
            n = self.outstanding
            self.bits.u(0 if bit else (1 << n) - 1, n)
            self.outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: List[int], bin_val: int):
        state, mps = ctx
        lps = RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_LPS[state]
        else:
            ctx[0] = min(state + 1, 62)
        self._renorm()

    def terminate(self, bin_val: int):
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bits.u(((self.low >> 7) & 3) | 1, 2)
        else:
            self._renorm()


class HevcStream(_Content):
    """An HEVC stream of known reconstruction (the module's notes): no B
    frames; size (width, height) is cropped by the conformance window
    from the coded size where that is not a multiple of 16."""

    QP = 26

    def __init__(self, size, n_frames, gop=12, seed=0, matrix=BT709, full_range=True):
        super().__init__(size, n_frames, gop, seed, b_frames=False)
        self.matrix, self.full_range = matrix, bool(full_range)
        self.vps, self.sps, self.pps = self._vps(), self._sps(), self._pps()
        self._idr_memo: Dict[int, bytes] = {}

    @property
    def param_sets(self) -> List[bytes]:
        return [self.vps, self.sps, self.pps]

    @staticmethod
    def _nal(kind, rbsp) -> bytes:
        return bytes([kind << 1, 1]) + escape(np.frombuffer(rbsp, np.uint8))

    @staticmethod
    def _ptl(b: Bits) -> Bits:
        """profile_tier_level(1, 0): Main, tier Main, level 5.1."""
        b.u(0, 2).u(0, 1).u(1, 5).u(0x60000000, 32)
        b.u(1, 1).u(0, 1).u(0, 1).u(1, 1).u(0, 32).u(0, 12)  # progressive, frame only; 44 zero bits
        return b.u(HEVC_LEVEL, 8)

    def _vps(self) -> bytes:
        b = Bits().u(0, 4).u(1, 1).u(1, 1).u(0, 6).u(0, 3).u(1, 1).u(0xFFFF, 16)
        self._ptl(b).u(1, 1).ue(1).ue(0).ue(0)
        b.u(0, 6).ue(0).u(0, 1).u(0, 1)
        return self._nal(_VPS, b.trailing())

    def _sps(self) -> bytes:
        W, H = self.size
        W16, H16 = self.coded
        b = Bits().u(0, 4).u(0, 3).u(1, 1)
        self._ptl(b).ue(0).ue(1).ue(W16).ue(H16)
        crop = (W16 - W) // 2, (H16 - H) // 2
        if any(crop):
            b.u(1, 1).ue(0).ue(crop[0]).ue(0).ue(crop[1])
        else:
            b.u(0, 1)
        b.ue(0).ue(0).ue(LOG2_POC_LSB - 4)
        b.u(1, 1).ue(1).ue(0).ue(0)  # sub-layer ordering: 2 pictures, no reordering
        b.ue(1).ue(0).ue(0).ue(2).ue(0).ue(0)  # CB 16..16, TB 4..16, depths 0
        b.u(0, 1).u(0, 1).u(0, 1)  # scaling lists, AMP, SAO
        b.u(1, 1).u(7, 4).u(7, 4).ue(1).ue(0).u(1, 1)  # PCM 8 bit, 16 x 16, loop filter off
        b.ue(1).ue(1).ue(0).ue(0).u(1, 1)  # one RPS: the previous picture, used
        b.u(0, 1).u(0, 1).u(0, 1)  # long-term refs, TMVP, strong intra smoothing
        b.u(1, 1).u(0, 1).u(0, 1)  # VUI: no aspect ratio, no overscan
        _vui_colour(b, self.matrix, self.full_range)
        b.u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1)
        b.u(0, 1)  # sps_extension_present_flag
        return self._nal(_HSPS, b.trailing())

    def _pps(self) -> bytes:
        b = Bits().ue(0).ue(0).u(0, 1).u(0, 1).u(0, 3).u(0, 1).u(0, 1).ue(0).ue(0).se(0)
        b.u(0, 1).u(0, 1).u(0, 1).se(0).se(0).u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(0, 1)
        b.u(0, 1)  # loop filter across slices
        b.u(1, 1).u(0, 1).u(1, 1)  # deblocking control: no override, disabled
        b.u(0, 1).u(0, 1).ue(0).u(0, 1).u(0, 1)
        return self._nal(_HPPS, b.trailing())

    def _header(self, k) -> Bits:
        kind = self.types[k]
        b = Bits().u(1, 1)
        if kind == "I":
            b.u(0, 1).ue(0).ue(2)  # no_output_of_prior_pics; PPS 0; slice_type I
        else:
            j = k - k % self.gop
            b.ue(0).ue(1).u((k - j) % (1 << LOG2_POC_LSB), LOG2_POC_LSB).u(1, 1)
            b.u(0, 1).ue(4)  # num_ref_idx_active_override; five_minus_max_num_merge_cand
        return b.se(0).u(1, 1).align(0)  # slice_qp_delta; byte_alignment

    def _pcm_cu(self, cabac: Cabac, samples: np.ndarray):
        cabac.terminate(1)  # pcm_flag
        cabac.bits.align(0).raw(samples.tobytes())
        cabac.start()

    def _idr_head(self, state) -> bytes:
        """The bytes between one PCM CU's samples and the next's in an
        IDR: end_of_slice_segment_flag 0, part_mode 2Nx2N, pcm_flag and
        the alignment, from a fresh engine (they depend only on
        part_mode's context state, which the memo is keyed by)."""
        key = tuple(state)
        if key not in self._idr_memo:
            b = Bits()
            c = Cabac(b)
            c.terminate(0)
            ctx = list(state)
            c.decision(ctx, 1)
            c.terminate(1)
            self._idr_memo[key] = (bytes(b.align(0).out), ctx)
        return self._idr_memo[key]

    def _idr(self, k) -> bytes:
        b = self._header(k)
        cabac = Cabac(b)
        ctx = cabac_context(_INIT["part_mode"][0], self.QP)
        cabac.decision(ctx, 1)
        cabac.terminate(1)
        b.align(0)
        samples = _mb_samples(self.planes(k))
        parts = [np.frombuffer(bytes(b.out), np.uint8), samples[0]]
        for s in samples[1:]:
            head, ctx = self._idr_head(ctx)
            parts += [np.frombuffer(head, np.uint8), s]
        tail = Bits()
        Cabac(tail).terminate(1)  # end_of_slice_segment_flag and the stop bit
        parts.append(np.frombuffer(bytes(tail.align(0).out), np.uint8))
        rbsp = np.concatenate(parts).astype(np.uint8)
        return bytes([_IDR_W_RADL << 1, 1]) + escape(rbsp)

    def _p(self, k) -> bytes:
        b = self._header(k)
        cabac = Cabac(b)
        skip_ctx = [cabac_context(v, self.QP) for v in _INIT["cu_skip_flag"][1]]
        pred_ctx = cabac_context(_INIT["pred_mode_flag"][1], self.QP)
        part_ctx = cabac_context(_INIT["part_mode"][1], self.QP)
        x0, y0 = self.patch(k)
        samples = self.patch_samples(k)
        skip = np.ones((self.mbh, self.mbw), bool)
        skip[y0:y0 + self.ph, x0:x0 + self.pw] = False
        i = 0
        n = self.mbw * self.mbh
        for a in range(n):
            y, x = divmod(a, self.mbw)
            inc = int(x > 0 and skip[y, x - 1]) + int(y > 0 and skip[y - 1, x])
            if skip[y, x]:
                cabac.decision(skip_ctx[inc], 1)
            else:
                cabac.decision(skip_ctx[inc], 0)
                cabac.decision(pred_ctx, 1)  # MODE_INTRA
                cabac.decision(part_ctx, 1)  # PART_2Nx2N
                self._pcm_cu(cabac, samples[i])
                i += 1
            cabac.terminate(int(a == n - 1))  # end_of_slice_segment_flag
        return self._nal(_TRAIL_R, bytes(b.align(0).out))

    def samples(self) -> Iterator[Tuple[int, bool, List[bytes]]]:
        for k in self.decode:
            kind = self.types[k]
            yield k, kind == "I", [self._idr(k) if kind == "I" else self._p(k)]

    def config(self) -> bytes:
        """The hvcC payload."""
        out = bytes([1, 0x01]) + struct.pack(">I", 0x60000000) + bytes([0x90, 0, 0, 0, 0, 0])
        out += bytes([HEVC_LEVEL, 0xF0, 0x00, 0xFC, 0xFD, 0xF8, 0xF8, 0, 0, 0x0F, 3])
        for kind, nal in ((_VPS, self.vps), (_HSPS, self.sps), (_HPPS, self.pps)):
            out += bytes([0x80 | kind]) + struct.pack(">HH", 1, len(nal)) + nal
        return out


def _hvcc(vps: bytes, sps: bytes, pps: bytes, profile: int = 1, bit_depth: int = 8) -> bytes:
    """An hvcC payload: one VPS, SPS and PPS, 4-byte NAL lengths."""
    compat = {1: 0x60000000, 2: 0x20000000}.get(profile, 0x10000000)
    out = bytes([1, profile]) + struct.pack(">I", compat)
    out += bytes([0x90, 0, 0, 0, 0, 0])
    depth = 0xF8 | (bit_depth - 8)
    out += bytes([HEVC_LEVEL, 0xF0, 0x00, 0xFC, 0xFD, depth, depth, 0, 0, 0x0F, 3])
    for kind, nal in ((_VPS, vps), (_HSPS, sps), (_HPPS, pps)):
        out += bytes([0x80 | kind]) + struct.pack(">HH", 1, len(nal)) + nal
    return out


#: RandomHEVC's options, in the order of the C++ writer's WOpts
_HEVC_WOPTS = ("width", "height", "log2_ctb", "log2_min_cb", "depth_inter",
               "depth_intra", "amp", "tskip", "sign_hiding", "scaling", "sao", "deblock",
               "deblock_override", "deblock_offsets", "cu_qp_delta", "qp_depth", "cb_qp_offset",
               "cr_qp_offset", "slice_chroma_offsets", "bypass", "pcm", "pcm_loop_filter_disabled",
               "constrained_intra", "max_slices", "dependent_slices", "tile_cols", "tile_rows",
               "uniform", "wpp", "tmvp", "max_merge", "par_mrg", "weighted", "long_term",
               "list_mod", "log2_max_poc_lsb", "matrix", "full_range", "colour", "qp_min",
               "qp_max", "intra_percent", "max_refs", "reorder", "lf_across_tiles",
               "lf_across_slices", "cabac_init", "extra_bits", "header_ext", "vui_extra",
               "output_flag", "lt_sps", "profile", "bit_depth", "chroma_loc")
#: HEVC nal_unit_type of the writer's pictures
TRAIL_N, TRAIL_R, RADL_N, RASL_N, BLA_W_LP, IDR_W_RADL, IDR_N_LP, CRA_NUT = 0, 1, 6, 8, 16, 19, 20, 21
_EOS = 36
#: a prefix SEI (user_data_unregistered: a UUID and four bytes) and a
#: suffix SEI (decoded_picture_hash's absence: a user_data one again), as
#: cameras put about their pictures
_SEI_PAYLOAD = bytes([5, 20]) + bytes(range(16)) + b"GoPr" + bytes([0x80])


class RandomHEVC:
    """An HEVC stream of random syntax, written by the decoder's own
    syntax code (``csrc/hevc.cpp``'s writer) with every element picked
    from a seeded generator within its legal range; the frames it decodes
    to are whatever that syntax makes of them, so only an independent
    decoder (cv2) can judge them. size (width, height), cropped by the
    conformance window from the coded size where that is not a multiple
    of the smallest CB. GOPs of ``gop`` frames, each starting with an IDR (or, after the
    first, a CRA where ``open_gop``: the B frames before it in display
    order become its leading pictures, RASL then RADL), then P anchors
    with ``b_frames`` hierarchical B frames between them (the middle one a
    reference); ``intra_only`` makes every frame an I picture;
    ``cra_start`` starts the stream at a CRA whose ``b_frames`` RASL
    pictures refer to a picture the stream does not hold (a decoder drops
    them, so the stream has that many frames fewer); ``bla`` makes the
    CRAs after the first BLA pictures (a spliced stream: their RASL
    pictures are dropped too, and POC restarts from their lsb); ``eos``
    ends the sequence before each of them instead (an end of sequence NAL
    unit: the CRA after it acts as a BLA does), where ffmpeg derives the
    CRA's POC as the standard does (csrc/hevc.cpp's notes); an IRAP picture after the
    first may drop the pictures still waiting for output
    (no_output_of_prior_pics_flag, as a CRA after an end of sequence
    does);
    ``hidden`` writes pic_output_flag 0 on the last trailing picture of a
    GOP (not shown); ``sei`` puts a prefix and a suffix SEI NAL unit
    about each picture. ``shown`` lists the display indices a decoder
    shows, by the writer's own decoded picture buffer.
    The rest are the writer's options: ``ctb`` (16, 32, 64), ``min_cb``
    (8, 16), ``depths`` (inter, intra),
    ``amp``, ``transform_skip``, ``sign_hiding``, ``scaling`` (None,
    'default', 'sps', 'pps'), ``sao``, ``deblock`` ('on', 'off',
    'override'), ``deblock_offsets``, ``cu_qp_delta`` with ``qp_depth``,
    ``chroma_qp_offsets`` (cb, cr) and ``slice_chroma_offsets``,
    ``bypass`` (transquant bypass), ``pcm`` with ``pcm_loop_filter``
    (False: pcm_loop_filter_disabled_flag), ``constrained_intra``,
    ``slices`` (at most, a picture) and ``dependent_slices``, ``tiles``
    (columns, rows) with ``uniform_tiles``, ``wpp``, ``tmvp``,
    ``max_merge`` (0: random a slice), ``parallel_merge`` (its log2),
    ``weighted``, ``long_term`` (a GOP's IRAP kept as a long-term picture;
    ``lt_sps`` lists them in the SPS), ``list_mod``, ``log2_max_poc_lsb``
    (small ones wrap), ``qp`` (min, max), ``refs``, ``intra_percent``,
    ``cabac_init``, ``extra_bits``, ``header_ext``, ``vui_extra``,
    ``lf_across`` (tiles, slices), ``matrix`` and
    ``full_range`` (VUI; matrix None writes no colour description), and
    ``bit_depth`` (8, or 10: Main 10, every element drawn within its 10-bit
    range: QPs down to -12, SAO offsets to 31, PCM depths to 10), and
    ``chroma_loc`` (the VUI's chroma_sample_loc_type, 0-5; None writes
    none unless ``vui_extra`` writes 0).
    ``pictures`` holds each picture's NAL units in decode order."""

    def __init__(self, size, n_frames, seed=0, *, gop=8, b_frames=3, intra_only=False,
                 open_gop=False, cra_start=False, bla=False, eos=False, hidden=False, sei=False,
                 ctb=32, min_cb=8, depths=(1, 1), amp=False, transform_skip=False, sign_hiding=False, scaling=None,
                 sao=False, deblock="on", deblock_offsets=False, cu_qp_delta=False, qp_depth=1,
                 chroma_qp_offsets=(0, 0), slice_chroma_offsets=False, bypass=False, pcm=False,
                 pcm_loop_filter=True, constrained_intra=False, slices=1, dependent_slices=False,
                 tiles=(1, 1), uniform_tiles=True, wpp=False, tmvp=True, max_merge=5,
                 parallel_merge=2, weighted=False, long_term=False, lt_sps=False,
                 list_mod=False, log2_max_poc_lsb=8, qp=(22, 36), refs=4, intra_percent=15,
                 cabac_init=False, extra_bits=0, header_ext=False, vui_extra=False,
                 lf_across=(True, True), matrix=BT709, full_range=True, bit_depth=8,
                 chroma_loc=None):
        from . import hevc

        self.size = (int(size[0]), int(size[1]))
        W, H = self.size
        if W % 2 or H % 2 or W <= 0 or H <= 0:
            raise ValueError(f"frame size {W} x {H}: width and height must be even")
        if tiles[0] * tiles[1] > 1 and wpp:
            raise ValueError("tiles and wpp in one stream: the writer keeps clear of it "
                             "(csrc/hevc.cpp's notes)")
        if constrained_intra and min_cb > 8:
            raise ValueError("constrained_intra with CBs of 16 or more: the writer keeps clear of "
                             "it (csrc/hevc.cpp's notes)")
        if qp[1] + max(chroma_qp_offsets) > 57:
            raise ValueError("a QP and a chroma QP offset above 57 together: ffmpeg's deblocking "
                             "clips the chroma's QP there; the writer keeps clear of it "
                             "(csrc/hevc.cpp's notes)")
        self.coded = (-(-W // min_cb) * min_cb, -(-H // min_cb) * min_cb)
        self.n, self.gop, self.seed = int(n_frames), int(gop), int(seed)
        self.matrix, self.full_range = matrix, bool(full_range)
        if bit_depth not in (8, 10):
            raise ValueError(f"bit_depth {bit_depth}: the writer writes 8 or 10 bits")
        self.bit_depth = int(bit_depth)
        self.still = self.n == 1 and intra_only and bit_depth == 8
        self.kinds, self.decode, plan = self._plan(b_frames, intra_only, open_gop, cra_start, bla,
                                                   eos, hidden, 1 << log2_max_poc_lsb)
        #: each frame's picture type by display index: I, P or B
        self.types = ["I"] * self.n
        for (_kind, stype, *_rest), k in zip(plan, self.decode):
            self.types[k] = "BPI"[stype]
        shown = {k: i for i, k in enumerate(self.decode)}
        reorder = max((sum(1 for j in self.decode[:shown[k]] if j > k) for k in self.decode),
                      default=0)
        opts = dict(width=W, height=H, log2_ctb={16: 4, 32: 5, 64: 6}[ctb],
                    log2_min_cb={8: 3, 16: 4, 32: 5}[min_cb],
                    depth_inter=depths[0], depth_intra=depths[1], amp=int(amp),
                    tskip=int(transform_skip), sign_hiding=int(sign_hiding),
                    scaling={None: 0, "default": 1, "sps": 2, "pps": 3}[scaling], sao=int(sao),
                    deblock={"off": 0, "on": 1, "override": 2}[deblock],
                    deblock_override=int(deblock == "override"), deblock_offsets=int(deblock_offsets),
                    cu_qp_delta=int(cu_qp_delta), qp_depth=qp_depth,
                    cb_qp_offset=chroma_qp_offsets[0], cr_qp_offset=chroma_qp_offsets[1],
                    slice_chroma_offsets=int(slice_chroma_offsets), bypass=int(bypass), pcm=int(pcm),
                    pcm_loop_filter_disabled=int(not pcm_loop_filter),
                    constrained_intra=int(constrained_intra), max_slices=slices,
                    dependent_slices=int(dependent_slices), tile_cols=tiles[0], tile_rows=tiles[1],
                    uniform=int(uniform_tiles), wpp=int(wpp), tmvp=int(tmvp), max_merge=max_merge,
                    par_mrg=parallel_merge, weighted=int(weighted), long_term=int(long_term),
                    list_mod=int(list_mod), log2_max_poc_lsb=log2_max_poc_lsb, matrix=matrix or 2,
                    full_range=int(bool(full_range)), colour=int(matrix is not None),
                    qp_min=qp[0], qp_max=qp[1], intra_percent=intra_percent, max_refs=refs,
                    reorder=reorder,
                    lf_across_tiles=int(lf_across[0]), lf_across_slices=int(lf_across[1]),
                    cabac_init=int(cabac_init), extra_bits=extra_bits, header_ext=int(header_ext),
                    vui_extra=int(vui_extra), output_flag=int(hidden),
                    lt_sps=int(lt_sps), profile=self.profile, bit_depth=self.bit_depth,
                    chroma_loc=-1 if chroma_loc is None else int(chroma_loc))
        arr = np.array([opts[k] for k in _HEVC_WOPTS], np.int32)
        pl = np.array(plan, np.int32).reshape(-1)
        lib = hevc._library()
        err = ctypes.create_string_buffer(512)
        h = lib.hevcw_open(arr.ctypes.data, len(arr), pl.ctypes.data, len(plan),
                           ctypes.c_uint64(self.seed), err, 512)
        if not h:
            raise ValueError(f"RandomHEVC: {err.value.decode()}")
        try:
            n = lib.hevcw_param_sets(h, None, 0)
            buf = np.zeros(n, np.uint8)
            lib.hevcw_param_sets(h, buf.ctypes.data, n)
            self.vps, self.sps, self.pps = nal_units(buf.tobytes())
            #: each picture's NAL units, in decode order
            self.pictures: List[List[bytes]] = []
            cap = 6 * self.coded[0] * self.coded[1] + (1 << 16)
            out = np.zeros(cap, np.uint8)
            nb = ctypes.c_int64(0)
            for k in range(len(plan)):
                rc = lib.hevcw_picture(h, k, out.ctypes.data, cap, ctypes.byref(nb), err, 512)
                if rc:
                    why = err.value.decode() if rc != -3 else f"a picture of more than {cap} bytes"
                    raise ValueError(f"RandomHEVC: {why}")
                nals = nal_units(out[:nb.value].tobytes())
                if sei:  # the suffix SEI before an end of sequence
                    end = len(nals) - (nals[-1][0] >> 1 == _EOS)
                    nals = ([bytes([39 << 1, 1]) + _SEI_PAYLOAD] + nals[:end]
                            + [bytes([40 << 1, 1]) + _SEI_PAYLOAD] + nals[end:])
                self.pictures.append(nals)
            out_tags = np.zeros(len(plan), np.int64)
            n_out = lib.hevc_scan_end(h, 1, out_tags.ctypes.data, len(plan))
            #: display indices of the frames a decoder shows: all but the RASL
            #: pictures of a CRA that starts the stream or of a BLA (or a CRA
            #: after an end of sequence), pictures with pic_output_flag 0 and
            #: those an IRAP's NoOutputOfPriorPicsFlag drops
            self.shown = sorted(self.decode[t] for t in out_tags[:n_out])
        finally:
            lib.hevcw_close(h)

    def _plan(self, b_frames, intra_only, open_gop, cra_start, bla, eos, hidden, max_lsb):
        """(nal_unit_type by display index, display indices in decode order,
        the writer's plan of each picture in decode order: nal_unit_type,
        slice_type (0 B, 1 P, 2 I), POC, pic_output_flag)."""
        n, step = self.n, (1 if intra_only else b_frames + 1)
        lead = min(b_frames, n - 1) if cra_start and not intra_only else 0
        iraps = list(range(lead, n, self.gop))
        kinds, stype, out = [TRAIL_N] * n, [2] * n, [1] * n
        decode, pending = [], list(range(lead))
        for gi, g0 in enumerate(iraps):
            g1 = iraps[gi + 1] if gi + 1 < len(iraps) else n
            cra = (gi == 0 and cra_start) or (gi > 0 and open_gop)
            kinds[g0] = CRA_NUT if cra else (IDR_N_LP if gi % 2 else IDR_W_RADL)
            if cra and gi > 0 and bla:
                kinds[g0] = BLA_W_LP
            n_rasl = len(pending) if gi == 0 else (len(pending) + 1) // 2
            for i, k in enumerate(pending):  # RASL before RADL in output order
                kinds[k], stype[k] = (RASL_N if i < n_rasl else RADL_N), 0
            decode += [g0] + pending
            anchors = list(range(g0, g1, step))
            tail = list(range(anchors[-1] + 1, g1))
            if tail and not (gi + 1 < len(iraps) and open_gop):
                anchors.append(g1 - 1)  # a closed GOP ends with an anchor
                tail = []
            pending = tail
            for prev, anc in zip(anchors, anchors[1:]):
                kinds[anc], stype[anc] = TRAIL_R, 2 if intra_only else 1
                between = list(range(prev + 1, anc))
                order = [between[len(between) // 2]] if between else []
                order += [k for k in between if k not in order]
                for i, k in enumerate(order):  # the middle one a reference where others follow
                    kinds[k], stype[k] = (TRAIL_R if i == 0 and len(order) > 1 else TRAIL_N), 0
                decode += [anc] + order
            if hidden:
                trailing = [k for k in decode if g0 < k < g1 and kinds[k] in (TRAIL_N, TRAIL_R)]
                if trailing:
                    out[trailing[-1]] = 0
        # POC: the display index less a base that an IDR resets and a BLA
        # (or a CRA after an end of sequence) moves to its lsb (its POC's
        # msb is 0); in decode order, so that its leading pictures count
        # from it. An end of sequence goes only before a CRA whose POC
        # ffmpeg derives from the previous TemporalId 0 picture's as 0 plus
        # its lsb, the standard's value
        poc, base, eos_before, prev = [0] * n, 0, [0] * n, 0
        for k in decode:
            if kinds[k] in (IDR_W_RADL, IDR_N_LP):
                base = k
            elif kinds[k] == BLA_W_LP:
                base = k - (k - base) % max_lsb
            elif eos and kinds[k] == CRA_NUT and k != decode[0]:
                lsb, plsb = (k - base) % max_lsb, prev % max_lsb
                if abs(lsb - plsb) < max_lsb // 2 and prev - plsb == 0:
                    base, eos_before[k] = k - lsb, 1
            poc[k] = k - base
            if kinds[k] in (TRAIL_R, IDR_W_RADL, IDR_N_LP, CRA_NUT, BLA_W_LP):
                prev = poc[k]  # the previous TemporalId 0 picture (8.3.1)
        plan = [[kinds[k], stype[k], poc[k], out[k], eos_before[k]] for k in decode]
        return kinds, decode, plan

    @property
    def param_sets(self) -> List[bytes]:
        return [self.vps, self.sps, self.pps]

    def samples(self) -> Iterator[Tuple[int, bool, List[bytes]]]:
        """(display index, sync, NAL units) of each picture, in decode
        order; sync pictures are the IRAP pictures."""
        for k, nals in zip(self.decode, self.pictures):
            yield k, self.kinds[k] in (IDR_W_RADL, IDR_N_LP, CRA_NUT, BLA_W_LP), nals

    @property
    def profile(self) -> int:
        """general_profile_idc: Main (1), Main 10 (2) or Main Still Picture (3)."""
        return 2 if self.bit_depth == 10 else 3 if self.still else 1

    def config(self) -> bytes:
        return _hvcc(self.vps, self.sps, self.pps, self.profile, self.bit_depth)

    @property
    def presentation_offsets(self) -> List[int]:
        return [k - i for i, k in enumerate(self.decode)]


def write_mp4(path: str, stream, fps: float, codec: Optional[str] = None,
              signed_ctts: bool = False, edit: Optional[Tuple[int, int]] = None) -> str:
    """Write a stream into an MP4 of one video track. ``codec`` is the
    sample entry (``avc1``/``avc3`` for H264Stream, ``hvc1``/``hev1`` for
    HevcStream; ``avc3``/``hev1`` put the parameter sets in each IDR
    sample). Reordered frames get a ``ctts``: unsigned offsets and an
    ``elst`` whose media time is one frame (what muxers write), or with
    ``signed_ctts`` version-1 offsets from the decode time and no edit.
    ``edit`` (media start, frames) in frames writes that ``elst`` instead.
    Returns path."""
    hevc = isinstance(stream, (HevcStream, RandomHEVC))
    codec = codec or ("hvc1" if hevc else "avc1")
    if codec not in (("hvc1", "hev1") if hevc else ("avc1", "avc3")):
        raise ValueError(f"{codec} is not a sample entry for this stream")
    offsets = stream.presentation_offsets
    shift = 0 if signed_ctts else max(0, -min(offsets))
    if edit is None and shift:
        edit = (shift, stream.n)
    in_band = codec in ("avc3", "hev1")
    with mp4.Mp4Writer(path, stream.size, fps, stream.config(), codec=codec, edit=edit) as w:
        for (k, sync, nals), off in zip(stream.samples(), offsets):
            if sync and in_band:
                nals = stream.param_sets + nals
            w.add_sample(b"".join(struct.pack(">I", len(n)) + n for n in nals), sync,
                         offset=off + shift if any(offsets) else 0)
    return path
