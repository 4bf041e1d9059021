// H.264 and HEVC decoding on the card's NVDEC, and the NV12 -> BGR kernel.
//
// The binding: libcuda.so.1 and libnvcuvid.so.1 are opened with dlopen at
// first use (both come with the driver; no Video Codec SDK is needed). The
// parser (cuvidCreateVideoParser) takes Annex B packets, each with its
// presentation index as its timestamp; its sequence callback creates the
// decoder on the device's primary context (the one torch uses) behind a
// cuvidCtxLock, its decode callback passes CUVIDPICPARAMS through unread,
// and its display callback queues (picture index, timestamp) for the caller,
// who maps each frame (cuvidMapVideoFrame64 on torch's stream), converts it
// with the kernel below and unmaps it.
//
// The driver's structs are typed in here from the SDK's public headers
// (cuviddec.h, nvcuvid.h), only those this file passes or reads; where the
// SDK's headers are on the include path, every size and offset used is
// checked against theirs at compile time.
//
// The kernel, nv12_to_bgr: it replaces no TPU kernel (the JAX package
// decodes and converts on the host with cv2's ffmpeg). It reads the mapped
// NV12 surface in place, at its pitch (the chroma plane starts at pitch x
// the surface's height), and writes uint8 BGR (H, W, 3) of the display
// size in one launch a frame, in the integer arithmetic of swscale's
// yuv420p -> bgr24 converter that cv2 reads through: each sample << 3 less
// its offset, each term (x * c) >> 16, the sums saturated. A thread takes
// 4 columns of 2 rows (one chroma row): one 4-byte load per luma row and
// one for the two chroma pairs, three 4-byte stores per row. Bound: bytes,
// 1.5 W H in and 3 W H out (18.5 MB at 2704 x 1520, 5.52 us at 3.35 TB/s).
//
// The kernel yuv420p10_to_bgr: it too replaces no TPU kernel. It converts
// the software HEVC decoder's 10-bit pictures (16-bit samples in NV12's
// layout: luma rows, then interleaved Cb Cr rows, at a pitch in samples)
// to uint8 BGR in the arithmetic of swscale's scaler, which cv2 takes for
// 10-bit frames (utils/nvdec.py's notes): chroma filtered horizontally and
// vertically by four taps each (swscale's bicubic at the stream's chroma
// siting, 14- and 12-bit coefficients; a table of each output column's and
// row's first input and coefficients, which the caller builds), the
// horizontal pass to 15 bits ((sum s c) >> 9, at most 32767); every row but
// the last two in the x86 vertical scaler's arithmetic (each tap's product
// >> 16, a rounder of 4, the 13-bit constants), the last two in the C
// output's (8-bit Y, U, V looked up through the tables' formula). A thread
// takes 4 columns of one row: one 8-byte load of luma, 4-byte loads of the
// Cb Cr pairs its taps name (4 x 4 for each of its 2 chroma columns;
// neighbouring threads and rows read them again, from cache), three 4-byte
// stores. Bound: bytes, 3 W H in (16-bit) and 3 W H out (24.66 MB at 2704 x
// 1520, 7.36 us at 3.35 TB/s).
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace nv {

typedef void *DecoderHandle;
typedef void *ParserHandle;
typedef struct CtxLockOpaque *CtxLockHandle;
typedef long long Timestamp;

enum { PKT_ENDOFSTREAM = 0x01, PKT_TIMESTAMP = 0x02, PKT_DISCONTINUITY = 0x04,
       PKT_ENDOFPICTURE = 0x08 };
enum { CHROMA_420 = 1, SURFACE_NV12 = 0, DEINTERLACE_WEAVE = 0, CREATE_PREFER_CUVID = 0x04 };

struct VideoFormat {  // CUVIDEOFORMAT
  int codec;
  struct { unsigned numerator, denominator; } frame_rate;
  unsigned char progressive_sequence, bit_depth_luma_minus8, bit_depth_chroma_minus8,
      min_num_decode_surfaces;
  unsigned coded_width, coded_height;
  struct { int left, top, right, bottom; } display_area;
  int chroma_format;
  unsigned bitrate;
  struct { int x, y; } display_aspect_ratio;
  struct {
    unsigned char video_format : 3, video_full_range_flag : 1, reserved_zero_bits : 4;
    unsigned char color_primaries, transfer_characteristics, matrix_coefficients;
  } video_signal_description;
  unsigned seqhdr_data_length;
};

struct DispInfo {  // CUVIDPARSERDISPINFO
  int picture_index, progressive_frame, top_field_first, repeat_first_field;
  Timestamp timestamp;
};

typedef int (*SequenceCallback)(void *, VideoFormat *);
typedef int (*DecodeCallback)(void *, void *);  // CUVIDPICPARAMS, passed through
typedef int (*DisplayCallback)(void *, DispInfo *);

struct ParserParams {  // CUVIDPARSERPARAMS
  int CodecType;
  unsigned ulMaxNumDecodeSurfaces, ulClockRate, ulErrorThreshold, ulMaxDisplayDelay;
  unsigned bAnnexb : 1, uReserved : 31;
  unsigned uReserved1[4];
  void *pUserData;
  SequenceCallback pfnSequenceCallback;
  DecodeCallback pfnDecodePicture;
  DisplayCallback pfnDisplayPicture;
  void *pfnGetOperatingPoint;
  void *pfnGetSEIMsg;
  void *pvReserved2[5];
  void *pExtVideoInfo;
};

struct SourceDataPacket {  // CUVIDSOURCEDATAPACKET
  unsigned long flags, payload_size;
  const unsigned char *payload;
  Timestamp timestamp;
};

struct Rect16 { short left, top, right, bottom; };

struct DecodeCreateInfo {  // CUVIDDECODECREATEINFO
  unsigned long ulWidth, ulHeight, ulNumDecodeSurfaces;
  int CodecType, ChromaFormat;
  unsigned long ulCreationFlags, bitDepthMinus8, ulIntraDecodeOnly, ulMaxWidth, ulMaxHeight,
      Reserved1;
  Rect16 display_area;
  int OutputFormat, DeinterlaceMode;
  unsigned long ulTargetWidth, ulTargetHeight, ulNumOutputSurfaces;
  CtxLockHandle vidLock;
  Rect16 target_rect;
  unsigned long enableHistogram, Reserved2[4];
};

struct ProcParams {  // CUVIDPROCPARAMS
  int progressive_frame, second_field, top_field_first, unpaired_field;
  unsigned reserved_flags, reserved_zero;
  unsigned long long raw_input_dptr;
  unsigned raw_input_pitch, raw_input_format;
  unsigned long long raw_output_dptr;
  unsigned raw_output_pitch, Reserved1;
  CUstream output_stream;
  unsigned Reserved[46];
  unsigned long long *histogram_dptr;
  void *Reserved2[1];
};

struct DecodeCaps {  // CUVIDDECODECAPS
  int eCodecType, eChromaFormat;
  unsigned nBitDepthMinus8, reserved1[3];
  unsigned char bIsSupported, nNumNVDECs;
  unsigned short nOutputFormatMask;
  unsigned nMaxWidth, nMaxHeight, nMaxMBCount;
  unsigned short nMinWidth, nMinHeight;
  unsigned char bIsHistogramSupported, nCounterBitDepth;
  unsigned short nMaxHistogramBins;
  unsigned reserved3[10];
};

static_assert(sizeof(VideoFormat) == 64, "CUVIDEOFORMAT");
static_assert(offsetof(DecodeCaps, bIsSupported) == 24, "CUVIDDECODECAPS");
static_assert(offsetof(DecodeCaps, nMaxWidth) == 28, "CUVIDDECODECAPS");
static_assert(offsetof(VideoFormat, coded_width) == 16, "CUVIDEOFORMAT");
static_assert(offsetof(VideoFormat, video_signal_description) == 56, "CUVIDEOFORMAT");
static_assert(sizeof(DispInfo) == 24, "CUVIDPARSERDISPINFO");
static_assert(offsetof(ParserParams, pUserData) == 40, "CUVIDPARSERPARAMS");
static_assert(offsetof(ParserParams, pExtVideoInfo) == 128, "CUVIDPARSERPARAMS");
static_assert(sizeof(SourceDataPacket) == 32, "CUVIDSOURCEDATAPACKET");
static_assert(offsetof(DecodeCreateInfo, display_area) == 80, "CUVIDDECODECREATEINFO");
static_assert(offsetof(DecodeCreateInfo, vidLock) == 120, "CUVIDDECODECREATEINFO");
static_assert(sizeof(DecodeCreateInfo) == 176, "CUVIDDECODECREATEINFO");
static_assert(offsetof(ProcParams, output_stream) == 56, "CUVIDPROCPARAMS");

}  // namespace nv

#if __has_include(<nvcuvid.h>)
#include <nvcuvid.h>
#define NVDEC_SDK_HEADERS 1
#define SAME(ours, theirs, field) \
  static_assert(offsetof(nv::ours, field) == offsetof(theirs, field), #theirs "." #field)
SAME(VideoFormat, CUVIDEOFORMAT, coded_width);
SAME(VideoFormat, CUVIDEOFORMAT, display_area);
SAME(VideoFormat, CUVIDEOFORMAT, chroma_format);
SAME(VideoFormat, CUVIDEOFORMAT, video_signal_description);
SAME(DispInfo, CUVIDPARSERDISPINFO, timestamp);
SAME(ParserParams, CUVIDPARSERPARAMS, ulMaxDisplayDelay);
SAME(ParserParams, CUVIDPARSERPARAMS, pUserData);
SAME(ParserParams, CUVIDPARSERPARAMS, pfnSequenceCallback);
SAME(ParserParams, CUVIDPARSERPARAMS, pfnDecodePicture);
SAME(ParserParams, CUVIDPARSERPARAMS, pfnDisplayPicture);
SAME(SourceDataPacket, CUVIDSOURCEDATAPACKET, timestamp);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, ChromaFormat);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, display_area);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, OutputFormat);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, ulTargetWidth);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, ulNumOutputSurfaces);
SAME(DecodeCreateInfo, CUVIDDECODECREATEINFO, vidLock);
SAME(ProcParams, CUVIDPROCPARAMS, output_stream);
SAME(DecodeCaps, CUVIDDECODECAPS, bIsSupported);
SAME(DecodeCaps, CUVIDDECODECAPS, nMaxMBCount);
static_assert(sizeof(nv::VideoFormat) == sizeof(CUVIDEOFORMAT), "CUVIDEOFORMAT");
static_assert(sizeof(nv::DecodeCreateInfo) == sizeof(CUVIDDECODECREATEINFO), "CUVIDDECODECREATEINFO");
static_assert(sizeof(nv::ParserParams) == sizeof(CUVIDPARSERPARAMS), "CUVIDPARSERPARAMS");
static_assert(sizeof(nv::ProcParams) == sizeof(CUVIDPROCPARAMS), "CUVIDPROCPARAMS");
#else
#define NVDEC_SDK_HEADERS 0
#endif

// ---- the driver's functions, opened at first use ----

namespace {

using namespace nv;

struct Api {
  CUresult (*cuInit)(unsigned);
  CUresult (*cuDeviceGet)(CUdevice *, int);
  CUresult (*cuDevicePrimaryCtxRetain)(CUcontext *, CUdevice);
  CUresult (*cuDevicePrimaryCtxRelease)(CUdevice);
  CUresult (*cuCtxPushCurrent)(CUcontext);
  CUresult (*cuCtxPopCurrent)(CUcontext *);
  CUresult (*cuStreamSynchronize)(CUstream);
  CUresult (*cuGetErrorName)(CUresult, const char **);
  CUresult (*CreateVideoParser)(ParserHandle *, ParserParams *);
  CUresult (*ParseVideoData)(ParserHandle, SourceDataPacket *);
  CUresult (*DestroyVideoParser)(ParserHandle);
  CUresult (*CreateDecoder)(DecoderHandle *, DecodeCreateInfo *);
  CUresult (*DestroyDecoder)(DecoderHandle);
  CUresult (*DecodePicture)(DecoderHandle, void *);
  CUresult (*MapVideoFrame64)(DecoderHandle, int, unsigned long long *, unsigned *, ProcParams *);
  CUresult (*UnmapVideoFrame64)(DecoderHandle, unsigned long long);
  CUresult (*CtxLockCreate)(CtxLockHandle *, CUcontext);
  CUresult (*CtxLockDestroy)(CtxLockHandle);
  CUresult (*GetDecoderCaps)(DecodeCaps *);
};

Api api;
int api_state = 0;  // 0 not tried, 1 ready, -1 failed
char api_error[512];

template <class F>
bool sym(void *lib, const char *name, F &fn) {
  fn = reinterpret_cast<F>(dlsym(lib, name));
  if (!fn) snprintf(api_error, sizeof api_error, "the driver's libraries have no %s", name);
  return fn != nullptr;
}

bool load_api() {
  if (api_state) return api_state > 0;
  api_state = -1;
  void *cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!cuda) {
    snprintf(api_error, sizeof api_error, "libcuda.so.1 cannot be opened: %s", dlerror());
    return false;
  }
  void *cuvid = dlopen("libnvcuvid.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!cuvid) {
    snprintf(api_error, sizeof api_error,
             "libnvcuvid.so.1 (NVDEC, from the NVIDIA driver) cannot be opened: %s", dlerror());
    return false;
  }
  bool ok = sym(cuda, "cuInit", api.cuInit) && sym(cuda, "cuDeviceGet", api.cuDeviceGet) &&
            sym(cuda, "cuDevicePrimaryCtxRetain", api.cuDevicePrimaryCtxRetain) &&
            sym(cuda, "cuDevicePrimaryCtxRelease_v2", api.cuDevicePrimaryCtxRelease) &&
            sym(cuda, "cuCtxPushCurrent_v2", api.cuCtxPushCurrent) &&
            sym(cuda, "cuCtxPopCurrent_v2", api.cuCtxPopCurrent) &&
            sym(cuda, "cuStreamSynchronize", api.cuStreamSynchronize) &&
            sym(cuda, "cuGetErrorName", api.cuGetErrorName) &&
            sym(cuvid, "cuvidCreateVideoParser", api.CreateVideoParser) &&
            sym(cuvid, "cuvidParseVideoData", api.ParseVideoData) &&
            sym(cuvid, "cuvidDestroyVideoParser", api.DestroyVideoParser) &&
            sym(cuvid, "cuvidCreateDecoder", api.CreateDecoder) &&
            sym(cuvid, "cuvidDestroyDecoder", api.DestroyDecoder) &&
            sym(cuvid, "cuvidDecodePicture", api.DecodePicture) &&
            sym(cuvid, "cuvidMapVideoFrame64", api.MapVideoFrame64) &&
            sym(cuvid, "cuvidUnmapVideoFrame64", api.UnmapVideoFrame64) &&
            sym(cuvid, "cuvidCtxLockCreate", api.CtxLockCreate) &&
            sym(cuvid, "cuvidCtxLockDestroy", api.CtxLockDestroy) &&
            sym(cuvid, "cuvidGetDecoderCaps", api.GetDecoderCaps);
  if (!ok) return false;
  CUresult r = api.cuInit(0);
  if (r != CUDA_SUCCESS) {
    snprintf(api_error, sizeof api_error, "cuInit failed (%d)", (int)r);
    return false;
  }
  api_state = 1;
  return true;
}

const char *err_name(CUresult r) {
  const char *s = nullptr;
  if (api.cuGetErrorName) api.cuGetErrorName(r, &s);
  return s ? s : "an unknown error";
}

const int QUEUE = 64;

struct Decoder {
  int codec = 0;
  CUdevice dev = 0;
  CUcontext ctx = nullptr;
  CtxLockHandle lock = nullptr;
  ParserHandle parser = nullptr;
  DecoderHandle decoder = nullptr;
  VideoFormat fmt;
  int have_fmt = 0, refused = 0, surfaces = 0;
  int probe = 0;  // record the format only: no decoder
  unsigned dec_w = 0, dec_h = 0;
  int n_shown = 0;
  DispInfo shown[QUEUE];
  CUresult err = CUDA_SUCCESS;
  char msg[256] = {0};
};

void fail(Decoder *d, CUresult r, const char *what) {
  if (d->err == CUDA_SUCCESS) {
    d->err = r == CUDA_SUCCESS ? CUDA_ERROR_UNKNOWN : r;
    snprintf(d->msg, sizeof d->msg, "%s failed: %s (%d)", what, err_name(r), (int)r);
  }
}

int on_sequence(void *user, VideoFormat *f) {
  Decoder *d = static_cast<Decoder *>(user);
  d->fmt = *f;
  d->have_fmt = 1;
  if (d->probe) return 0;
  // what an NV12 8-bit decoder cannot take: the caller names it
  if (f->chroma_format != CHROMA_420 || f->bit_depth_luma_minus8 || f->bit_depth_chroma_minus8 ||
      !f->progressive_sequence) {
    d->refused = 1;
    return 0;
  }
  int n = f->min_num_decode_surfaces + 4;  // headroom: a shown surface is not reused at once
  if (d->decoder) {
    if (d->dec_w == f->coded_width && d->dec_h == f->coded_height && n <= d->surfaces)
      return d->surfaces;
    api.DestroyDecoder(d->decoder);
    d->decoder = nullptr;
  }
  union { DecodeCreateInfo ci; char pad[1024]; } u;
  memset(&u, 0, sizeof u);
  DecodeCreateInfo &ci = u.ci;
  ci.ulWidth = ci.ulMaxWidth = ci.ulTargetWidth = f->coded_width;
  ci.ulHeight = ci.ulMaxHeight = ci.ulTargetHeight = f->coded_height;
  ci.ulNumDecodeSurfaces = n;
  ci.CodecType = f->codec;
  ci.ChromaFormat = CHROMA_420;
  // the whole coded frame, unscaled: the kernel crops to the display area
  ci.display_area = {0, 0, (short)f->coded_width, (short)f->coded_height};
  ci.ulCreationFlags = CREATE_PREFER_CUVID;
  ci.OutputFormat = SURFACE_NV12;
  ci.DeinterlaceMode = DEINTERLACE_WEAVE;
  ci.ulNumOutputSurfaces = 2;
  ci.vidLock = d->lock;
  CUresult r = api.CreateDecoder(&d->decoder, &ci);
  if (r != CUDA_SUCCESS) {
    d->decoder = nullptr;
    fail(d, r, "cuvidCreateDecoder");
    return 0;
  }
  d->dec_w = f->coded_width;
  d->dec_h = f->coded_height;
  d->surfaces = n;
  return n;
}

int on_decode(void *user, void *pic) {
  Decoder *d = static_cast<Decoder *>(user);
  if (!d->decoder) return 0;
  CUresult r = api.DecodePicture(d->decoder, pic);
  if (r != CUDA_SUCCESS) {
    fail(d, r, "cuvidDecodePicture");
    return 0;
  }
  return 1;
}

int on_display(void *user, DispInfo *info) {
  Decoder *d = static_cast<Decoder *>(user);
  if (!info) return 1;
  if (d->n_shown >= QUEUE) {
    fail(d, CUDA_ERROR_UNKNOWN, "the display queue (64 frames)");
    return 0;
  }
  d->shown[d->n_shown++] = *info;
  return 1;
}

CUresult make_parser(Decoder *d) {
  ParserParams p;
  memset(&p, 0, sizeof p);
  p.CodecType = d->codec;
  p.ulMaxNumDecodeSurfaces = 1;  // the sequence callback returns the count
  p.ulMaxDisplayDelay = 0;
  p.pUserData = d;
  p.pfnSequenceCallback = on_sequence;
  p.pfnDecodePicture = on_decode;
  p.pfnDisplayPicture = on_display;
  return api.CreateVideoParser(&d->parser, &p);
}

struct Push {
  bool ok;
  explicit Push(CUcontext c) { ok = api.cuCtxPushCurrent(c) == CUDA_SUCCESS; }
  ~Push() {
    CUcontext c;
    if (ok) api.cuCtxPopCurrent(&c);
  }
};

void copy_msg(const char *src, char *msg, int len) {
  if (msg && len > 0) snprintf(msg, len, "%s", src);
}

// ---- the kernel ----

struct Coefs { int ycoef, yoff, cb_b, cb_g, cr_g, cr_r; };

__device__ __forceinline__ unsigned char sat8(int v) { return (unsigned char)min(max(v, 0), 255); }

__global__ void __launch_bounds__(256) nv12_to_bgr_kernel(
    const uint8_t *__restrict__ luma, const uint8_t *__restrict__ chroma, int pitch,
    uint8_t *__restrict__ bgr, int W, int H, Coefs k, int vec) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int yc = blockIdx.y * blockDim.y + threadIdx.y;  // chroma row: luma rows 2 yc, 2 yc + 1
  if (x0 >= W || 2 * yc >= H) return;
  const int n = min(4, W - x0);  // W is even: 4 or 2 columns
  uint8_t uv[4] = {128, 128, 128, 128};
  const uint8_t *c = chroma + (size_t)yc * pitch + x0;
  if (vec) {
    *reinterpret_cast<uchar4 *>(uv) = *reinterpret_cast<const uchar4 *>(c);
  } else {
    for (int i = 0; i < n; ++i) uv[i] = c[i];
  }
  int tb[2], tg[2], tr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = ((int)uv[2 * j] << 3) - 1024, e = ((int)uv[2 * j + 1] << 3) - 1024;
    tb[j] = (d * k.cb_b) >> 16;
    tg[j] = ((d * k.cb_g) >> 16) + ((e * k.cr_g) >> 16);
    tr[j] = (e * k.cr_r) >> 16;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int y = 2 * yc + r;
    if (y >= H) break;
    const uint8_t *l = luma + (size_t)y * pitch + x0;
    uint8_t yy[4] = {0, 0, 0, 0};
    if (vec) {
      *reinterpret_cast<uchar4 *>(yy) = *reinterpret_cast<const uchar4 *>(l);
    } else {
      for (int i = 0; i < n; ++i) yy[i] = l[i];
    }
    uint8_t out[12];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yv = ((((int)yy[i] << 3) - k.yoff) * k.ycoef) >> 16;
      out[3 * i] = sat8(yv + tb[i >> 1]);
      out[3 * i + 1] = sat8(yv + tg[i >> 1]);
      out[3 * i + 2] = sat8(yv + tr[i >> 1]);
    }
    uint8_t *o = bgr + ((size_t)y * W + x0) * 3;
    if (vec) {
      uint32_t *o4 = reinterpret_cast<uint32_t *>(o);
      const uint32_t *w = reinterpret_cast<const uint32_t *>(out);
      o4[0] = w[0];
      o4[1] = w[1];
      o4[2] = w[2];
    } else {
      for (int i = 0; i < 3 * n; ++i) o[i] = out[i];
    }
  }
}

// the 10-bit conversion's constants: the vertical scaler's six (as Coefs)
// and the tables' six (cy, ybase, Cb->B, Cb->G, Cr->G, Cr->R)
struct Coefs10 { int ycoef, yoff, cb_b, cb_g, cr_g, cr_r, cy, ybase, t_cb_b, t_cb_g, t_cr_g, t_cr_r; };

__global__ void __launch_bounds__(256) yuv420p10_to_bgr_kernel(
    const uint16_t *__restrict__ luma, const uint16_t *__restrict__ chroma, int pitch,
    const int *__restrict__ htaps, const int *__restrict__ vtaps, uint8_t *__restrict__ bgr, int W,
    int H, Coefs10 k, int vec) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= W || y >= H) return;
  const int n = min(4, W - x0);  // W is even: 4 or 2 columns, 2 or 1 chroma pairs
  const int *vt = vtaps + 5 * y;  // first chroma row, four coefficients
  const bool table_rows = y >= H - 2;
  int acc[4] = {0, 0, 0, 0};  // Cb, Cr, Cb, Cr of the columns' two pairs
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = vt[1 + j];
    const uint16_t *row = chroma + (size_t)(vt[0] + j) * pitch;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (2 * q >= n) break;
      // the horizontal pass: 15-bit Cb and Cr of chroma column x0 / 2 + q
      const int *ht = htaps + 5 * (x0 / 2 + q);
      int cb = 0, cr = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t pair = *reinterpret_cast<const uint32_t *>(row + 2 * (ht[0] + i));
        cb += (int)(pair & 0xFFFF) * ht[1 + i];
        cr += (int)(pair >> 16) * ht[1 + i];
      }
      cb = min(cb >> 9, 32767);
      cr = min(cr >> 9, 32767);
      acc[2 * q] += table_rows ? cb * c : (cb * c) >> 16;
      acc[2 * q + 1] += table_rows ? cr * c : (cr * c) >> 16;
    }
  }
  uint16_t yy[4] = {0, 0, 0, 0};
  const uint16_t *l = luma + (size_t)y * pitch + x0;
  if (vec) {
    *reinterpret_cast<uint2 *>(yy) = *reinterpret_cast<const uint2 *>(l);
  } else {
    for (int i = 0; i < n; ++i) yy[i] = l[i];
  }
  uint8_t out[12];
  if (!table_rows) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = acc[2 * j] + 4 - 1024, e = acc[2 * j + 1] + 4 - 1024;
      const int tb = (d * k.cb_b) >> 16;
      const int tg = ((d * k.cb_g) >> 16) + ((e * k.cr_g) >> 16);
      const int tr = (e * k.cr_r) >> 16;
#pragma unroll
      for (int i = 2 * j; i < 2 * j + 2; ++i) {
        const int yv = ((2 * (int)yy[i] + 4 - k.yoff) * k.ycoef) >> 16;
        out[3 * i] = sat8(yv + tb);
        out[3 * i + 1] = sat8(yv + tg);
        out[3 * i + 2] = sat8(yv + tr);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = min(max((acc[2 * j] + (1 << 18)) >> 19, 0), 255);
      const int v = min(max((acc[2 * j + 1] + (1 << 18)) >> 19, 0), 255);
      const int ob = ((u * k.t_cb_b) >> 16) - (k.t_cb_b >> 9);
      const int og = ((u * k.t_cb_g) >> 16) - (k.t_cb_g >> 9) + ((v * k.t_cr_g) >> 16) - (k.t_cr_g >> 9);
      const int orr = ((v * k.t_cr_r) >> 16) - (k.t_cr_r >> 9);
#pragma unroll
      for (int i = 2 * j; i < 2 * j + 2; ++i) {
        const int y8 = (((int)yy[i] << 17) + (1 << 18)) >> 19;
        out[3 * i] = sat8((k.ybase + (y8 + ob) * k.cy) >> 16);
        out[3 * i + 1] = sat8((k.ybase + (y8 + og) * k.cy) >> 16);
        out[3 * i + 2] = sat8((k.ybase + (y8 + orr) * k.cy) >> 16);
      }
    }
  }
  uint8_t *o = bgr + ((size_t)y * W + x0) * 3;
  if (vec) {
    uint32_t *o4 = reinterpret_cast<uint32_t *>(o);
    const uint32_t *w = reinterpret_cast<const uint32_t *>(out);
    o4[0] = w[0];
    o4[1] = w[1];
    o4[2] = w[2];
  } else {
    for (int i = 0; i < 3 * n; ++i) o[i] = out[i];
  }
}

}  // namespace

extern "C" {

// 1 when the SDK's headers were found (and the structs checked against them)
int nvdec_sdk_headers() { return NVDEC_SDK_HEADERS; }

// 0 when libcuda.so.1 and libnvcuvid.so.1 open and cuInit succeeds; else the
// reason in msg
int nvdec_available(char *msg, int len) {
  if (load_api()) return 0;
  copy_msg(api_error, msg, len);
  return 1;
}

// NVDEC's capabilities for a codec at 4:2:0 8-bit on a device (8 int32:
// supported, NVDEC engines, output format mask, max width, height and
// macroblocks, min width and height). Returns cuvidGetDecoderCaps' result
// (with msg), or 1 with msg when the driver's libraries are missing.
int nvdec_caps(int device, int codec, int32_t *out, char *msg, int len) {
  if (!load_api()) {
    copy_msg(api_error, msg, len);
    return 1;
  }
  CUdevice dev;
  CUcontext ctx;
  CUresult r = api.cuDeviceGet(&dev, device);
  if (r == CUDA_SUCCESS) r = api.cuDevicePrimaryCtxRetain(&ctx, dev);
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "the primary context of device %d: %s (%d)", device, err_name(r), (int)r);
    return (int)r;
  }
  union { DecodeCaps c; char pad[512]; } u;
  memset(&u, 0, sizeof u);
  u.c.eCodecType = codec;
  u.c.eChromaFormat = CHROMA_420;
  {
    Push push(ctx);
    r = api.GetDecoderCaps(&u.c);
  }
  api.cuDevicePrimaryCtxRelease(dev);
  int32_t v[8] = {u.c.bIsSupported, u.c.nNumNVDECs, u.c.nOutputFormatMask, (int32_t)u.c.nMaxWidth,
                  (int32_t)u.c.nMaxHeight, (int32_t)u.c.nMaxMBCount, u.c.nMinWidth, u.c.nMinHeight};
  memcpy(out, v, sizeof v);
  if (r != CUDA_SUCCESS) snprintf(msg, len, "cuvidGetDecoderCaps failed: %s (%d)", err_name(r), (int)r);
  return (int)r;
}

// A decoder of one stream (codec: cudaVideoCodec); with probe, a parser
// only, which records the stream's format (nvdec_format) and decodes
// nothing.
int nvdec_create(int device, int codec, int probe, void **out, char *msg, int len) {
  *out = nullptr;
  if (!load_api()) {
    copy_msg(api_error, msg, len);
    return 1;
  }
  Decoder *d = new Decoder();
  d->codec = codec;
  d->probe = probe;
  CUresult r = api.cuDeviceGet(&d->dev, device);
  if (r == CUDA_SUCCESS) r = api.cuDevicePrimaryCtxRetain(&d->ctx, d->dev);
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "the primary context of device %d: %s (%d)", device, err_name(r), (int)r);
    delete d;
    return 1;
  }
  r = api.CtxLockCreate(&d->lock, d->ctx);
  if (r == CUDA_SUCCESS) r = make_parser(d);
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "creating the NVDEC parser: %s (%d)", err_name(r), (int)r);
    if (d->lock) api.CtxLockDestroy(d->lock);
    api.cuDevicePrimaryCtxRelease(d->dev);
    delete d;
    return 1;
  }
  *out = d;
  return 0;
}

// One packet (Annex B bytes; size 0 with PKT_ENDOFSTREAM ends the stream).
// The frames the parser shows go to shown (4 int64 each: picture index,
// timestamp, progressive, top field first), at most cap of them; n_shown
// their count. Returns 0, or a CUDA error with msg.
int nvdec_parse(void *h, const uint8_t *data, int64_t size, int64_t timestamp, int flags,
                int64_t *shown, int cap, int *n_shown, char *msg, int len) {
  Decoder *d = static_cast<Decoder *>(h);
  *n_shown = 0;
  d->n_shown = 0;
  SourceDataPacket pkt;
  memset(&pkt, 0, sizeof pkt);
  pkt.flags = (unsigned long)flags;
  pkt.payload_size = (unsigned long)size;
  pkt.payload = data;
  pkt.timestamp = timestamp;
  CUresult r;
  {
    Push push(d->ctx);
    r = api.ParseVideoData(d->parser, &pkt);
  }
  if (d->err != CUDA_SUCCESS) {
    copy_msg(d->msg, msg, len);
    return (int)d->err;
  }
  if (r != CUDA_SUCCESS && !d->refused && !d->probe) {
    snprintf(msg, len, "cuvidParseVideoData failed: %s (%d)", err_name(r), (int)r);
    return (int)r;
  }
  if (d->n_shown > cap) {
    snprintf(msg, len, "%d frames shown by one packet, more than %d", d->n_shown, cap);
    return (int)CUDA_ERROR_UNKNOWN;
  }
  for (int i = 0; i < d->n_shown; ++i) {
    shown[4 * i] = d->shown[i].picture_index;
    shown[4 * i + 1] = d->shown[i].timestamp;
    shown[4 * i + 2] = d->shown[i].progressive_frame;
    shown[4 * i + 3] = d->shown[i].top_field_first;
  }
  *n_shown = d->n_shown;
  return 0;
}

// The stream's format as the sequence callback saw it (20 int32): have it,
// refused, codec, coded width, height, display left, top, right, bottom,
// chroma format, luma and chroma bit depth - 8, progressive, full range,
// matrix, primaries, transfer, decode surfaces, frame rate numerator and
// denominator.
void nvdec_format(void *h, int32_t *out) {
  Decoder *d = static_cast<Decoder *>(h);
  const VideoFormat &f = d->fmt;
  int32_t v[20] = {d->have_fmt, d->refused, f.codec, (int32_t)f.coded_width,
                   (int32_t)f.coded_height, f.display_area.left, f.display_area.top,
                   f.display_area.right, f.display_area.bottom, f.chroma_format,
                   f.bit_depth_luma_minus8, f.bit_depth_chroma_minus8, f.progressive_sequence,
                   f.video_signal_description.video_full_range_flag,
                   f.video_signal_description.matrix_coefficients,
                   f.video_signal_description.color_primaries,
                   f.video_signal_description.transfer_characteristics, d->surfaces,
                   (int32_t)f.frame_rate.numerator, (int32_t)f.frame_rate.denominator};
  memcpy(out, v, sizeof v);
}

// Map a shown picture on the stream: its NV12 surface's device address and pitch.
int nvdec_map(void *h, int picture, int progressive, int top_field_first, void *stream,
              uint64_t *ptr, uint32_t *pitch, char *msg, int len) {
  Decoder *d = static_cast<Decoder *>(h);
  union { ProcParams p; char pad[1024]; } u;
  memset(&u, 0, sizeof u);
  u.p.progressive_frame = progressive;
  u.p.top_field_first = top_field_first;
  u.p.output_stream = static_cast<CUstream>(stream);
  unsigned long long dptr = 0;
  unsigned p = 0;
  CUresult r;
  {
    Push push(d->ctx);
    r = api.MapVideoFrame64(d->decoder, picture, &dptr, &p, &u.p);
  }
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "cuvidMapVideoFrame64 failed: %s (%d)", err_name(r), (int)r);
    return (int)r;
  }
  *ptr = dptr;
  *pitch = p;
  return 0;
}

// Unmap, once what was enqueued on the stream (the conversion) has run.
int nvdec_unmap(void *h, uint64_t ptr, void *stream, char *msg, int len) {
  Decoder *d = static_cast<Decoder *>(h);
  Push push(d->ctx);
  CUresult r = api.cuStreamSynchronize(static_cast<CUstream>(stream));
  CUresult u = api.UnmapVideoFrame64(d->decoder, ptr);
  if (r == CUDA_SUCCESS) r = u;
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "unmapping a frame: %s (%d)", err_name(r), (int)r);
    return (int)r;
  }
  return 0;
}

// A new parser for a new decode run (a seek, or after the end of the
// stream): nothing the old one held is shown. The decoder is kept while
// the stream's size is.
int nvdec_reset(void *h, char *msg, int len) {
  Decoder *d = static_cast<Decoder *>(h);
  Push push(d->ctx);
  if (d->parser) api.DestroyVideoParser(d->parser);
  d->parser = nullptr;
  CUresult r = make_parser(d);
  if (r != CUDA_SUCCESS) {
    snprintf(msg, len, "creating the NVDEC parser: %s (%d)", err_name(r), (int)r);
    return (int)r;
  }
  return 0;
}

void nvdec_destroy(void *h) {
  Decoder *d = static_cast<Decoder *>(h);
  if (!d) return;
  {
    Push push(d->ctx);
    if (d->parser) api.DestroyVideoParser(d->parser);
    if (d->decoder) api.DestroyDecoder(d->decoder);
  }
  if (d->lock) api.CtxLockDestroy(d->lock);
  api.cuDevicePrimaryCtxRelease(d->dev);
  delete d;
}

// NV12 (luma and chroma planes at pitch) -> uint8 BGR (H, W, 3); coefs the
// six constants (ycoef, yoff, Cb->B, Cb->G, Cr->G, Cr->R). Returns the
// launch's CUDA error.
int nv12_to_bgr(const uint8_t *luma, const uint8_t *chroma, int pitch, uint8_t *bgr, int W,
                int H, const int32_t *coefs, void *stream) {
  if (W <= 0 || H <= 0) return 0;
  Coefs k = {coefs[0], coefs[1], coefs[2], coefs[3], coefs[4], coefs[5]};
  const int vec = (W % 4 == 0) && (pitch % 4 == 0) && !((uintptr_t)luma & 3) &&
                  !((uintptr_t)chroma & 3) && !((uintptr_t)bgr & 3);
  dim3 block(64, 4);
  dim3 grid((unsigned)((W + 4 * 64 - 1) / (4 * 64)), (unsigned)(((H + 1) / 2 + 3) / 4));
  nv12_to_bgr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, chroma, pitch, bgr, W, H, k, vec);
  return (int)cudaGetLastError();
}

// 10-bit samples in NV12's layout (luma and chroma planes at pitch
// samples) -> uint8 BGR (H, W, 3); taps the (W / 2 + H, 5) int32 table of
// each output chroma column's, then each output row's, first input and four
// coefficients; coefs the twelve constants of Coefs10. Returns the launch's
// CUDA error.
int yuv420p10_to_bgr(const uint16_t *luma, const uint16_t *chroma, int pitch, const int32_t *taps,
                     uint8_t *bgr, int W, int H, const int32_t *coefs, void *stream) {
  if (W <= 0 || H <= 0) return 0;
  Coefs10 k = {coefs[0], coefs[1], coefs[2], coefs[3], coefs[4],  coefs[5],
               coefs[6], coefs[7], coefs[8], coefs[9], coefs[10], coefs[11]};
  // luma and BGR in 8- and 4-byte words where aligned; chroma is read in
  // 4-byte Cb Cr pairs always (the caller keeps it 4-byte aligned)
  const int vec = (W % 4 == 0) && (pitch % 4 == 0) && !((uintptr_t)luma & 7) &&
                  !((uintptr_t)bgr & 3);
  dim3 block(64, 4);
  dim3 grid((unsigned)((W + 4 * 64 - 1) / (4 * 64)), (unsigned)((H + 3) / 4));
  yuv420p10_to_bgr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, chroma, pitch, taps, taps + 5 * ((W + 1) / 2), bgr, W, H, k, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
