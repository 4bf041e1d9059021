// The bitstream half of the port's MPEG-4 Part 2 (ISO/IEC 14496-2) Simple
// Profile codec: headers, macroblock layer and the variable-length codes.
// The block transforms (dequantisation, IDCT, motion compensation, DCT,
// quantisation) are done by the caller on the device (utils/mpeg4.py);
// this file only turns bits into quantised levels and motion vectors and
// back.
//
// Decoded: VOS/VO/VOL/GOV/user data/VOP headers; I-, P- and N-VOPs; 1MV
// with median prediction, f_code wrap and half-pel vectors; not-coded and
// intra macroblocks in P-VOPs; dquant; intra DC (DC-size VLCs, gradient
// predictor) and AC prediction with the scan switch and QP rescaling;
// TCOEF with the three escape modes. Anything else (4MV, B- and S-VOPs,
// resync markers, data partitioning, RVLC, quarter-pel, interlace,
// sprites, MPEG quantisation matrices, not-8-bit, shape, ...) is refused
// with a message that names it.
//
// Encoded: I-, P- and N-VOPs from per-macroblock modes (not coded, inter,
// intra, each with or without dquant), vectors and levels, with DC and
// (where asked) AC prediction, the vectors' median prediction and f_code
// wrap; the port's writer asks for I-VOPs and zero-vector P-VOPs.
//
// Plain C interface for ctypes. Every function returns 0 on success, -1 on
// a malformed stream and -2 on a stream that uses a feature this codec
// does not implement, with a message in `err`.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vlc {
    uint16_t code;
    uint8_t len;
};

// ---------------------------------------------------------------------------
// Tables (ISO/IEC 14496-2 Annex B)
// ---------------------------------------------------------------------------

// B-6: MCBPC for I-VOPs; index = 4 * (mb_type == 4) + cbpc, 8 = stuffing
const Vlc INTRA_MCBPC[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                            {1, 6}, {2, 6}, {3, 6}, {1, 9}};

// B-7: MCBPC for P-VOPs; index = 4 * mb_type + cbpc (types 0 inter,
// 1 inter+q, 2 inter4v, 3 intra, 4 intra+q), 20 = stuffing
const Vlc INTER_MCBPC[21] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},  // inter
    {3, 3}, {7, 7}, {6, 7}, {5, 9},  // inter+q
    {2, 3}, {5, 7}, {4, 7}, {5, 8},  // inter4v
    {3, 5}, {4, 8}, {3, 8}, {3, 7},  // intra
    {4, 6}, {4, 9}, {3, 9}, {2, 9},  // intra+q
    {1, 9},                          // stuffing
};

// B-8: CBPY, indexed by the intra meaning of the pattern (inter
// macroblocks send it inverted)
const Vlc CBPY[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                      {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};

// B-12: motion vector difference, indexed by |motion_code|; a sign bit
// follows every code but the first
const Vlc MVD[33] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                     {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                     {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                     {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                     {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};

// B-13 and B-14: dct_dc_size for luminance and chrominance
const Vlc DC_LUM[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                        {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Vlc DC_CHROM[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                          {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// B-16: TCOEF for intra blocks, B-17: for inter blocks. Entry i codes
// (last, run, level) with last = i >= *_LAST0; the last entry is ESCAPE.
// A sign bit follows every code but ESCAPE.
const Vlc INTRA_TCOEF[103] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t INTRA_RUN[102] = {
    0,  0,  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6,  6,  6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2,  2,  3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t INTRA_LEVEL[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int INTRA_LAST0 = 67;

const Vlc INTER_TCOEF[103] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t INTER_RUN[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t INTER_LEVEL[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int INTER_LAST0 = 58;
const int ESCAPE = 102;

// Scans (7.4.3), as raster positions
const uint8_t ZIGZAG[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                            12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                            35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                            58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t ALT_HORIZONTAL[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t ALT_VERTICAL[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// Table 7-1: dc_scaler by QP
int dc_scaler(int qp, bool luma) {
    if (qp <= 4) return 8;
    if (luma) return qp <= 8 ? 2 * qp : qp <= 24 ? qp + 8 : 2 * qp - 16;
    return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

// ---------------------------------------------------------------------------
// Lookup tables built from the code tables
// ---------------------------------------------------------------------------

struct Lut {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;
    void build(const Vlc* t, int n, int b) {
        bits = b;
        sym.assign(size_t(1) << b, -1);
        len.assign(size_t(1) << b, 0);
        for (int s = 0; s < n; s++) {
            int l = t[s].len, shift = b - l;
            uint32_t first = uint32_t(t[s].code) << shift;
            for (uint32_t k = 0; k < (1u << shift); k++) {
                sym[first + k] = int16_t(s);
                len[first + k] = uint8_t(l);
            }
        }
    }
};

struct RunLevel {
    const Vlc* vlc;
    const int8_t* run;
    const int8_t* level;
    int last0;
    Lut lut;
    int lmax[2][64];   // most level of (last, run); 0 where the run has none
    int rmax[2][128];  // most run of (last, level); -1 where the level has none
    int16_t index[2][64][32];  // table entry of (last, run, level) or -1
    void build(const Vlc* v, const int8_t* r, const int8_t* l, int l0) {
        vlc = v, run = r, level = l, last0 = l0;
        lut.build(v, 103, 12);
        memset(lmax, 0, sizeof(lmax));
        for (auto& a : rmax)
            for (int& x : a) x = -1;
        for (auto& a : index)
            for (auto& b : a)
                for (int16_t& x : b) x = -1;
        for (int i = 0; i < 102; i++) {
            int last = i >= l0;
            lmax[last][r[i]] = std::max(lmax[last][r[i]], int(l[i]));
            rmax[last][l[i]] = std::max(rmax[last][l[i]], int(r[i]));
            index[last][r[i]][l[i]] = int16_t(i);
        }
    }
    int entry(int last, int r, int l) const {
        return (r < 64 && l < 32) ? index[last][r][l] : -1;
    }
};

struct Tables {
    Lut intra_mcbpc, inter_mcbpc, cbpy, mvd, dc_lum, dc_chrom;
    RunLevel intra, inter;
    Tables() {
        intra_mcbpc.build(INTRA_MCBPC, 9, 9);
        inter_mcbpc.build(INTER_MCBPC, 21, 9);
        cbpy.build(CBPY, 16, 6);
        mvd.build(MVD, 33, 12);
        dc_lum.build(DC_LUM, 13, 11);
        dc_chrom.build(DC_CHROM, 13, 12);
        intra.build(INTRA_TCOEF, INTRA_RUN, INTRA_LEVEL, INTRA_LAST0);
        inter.build(INTER_TCOEF, INTER_RUN, INTER_LEVEL, INTER_LAST0);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---------------------------------------------------------------------------
// Errors
// ---------------------------------------------------------------------------

struct Error {
    int code;
    char msg[256];
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
    Error e;
    e.code = code;
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(e.msg, sizeof(e.msg), fmt, ap);
    va_end(ap);
    throw e;
}

#define MALFORMED(...) fail(-1, __VA_ARGS__)
#define UNSUPPORTED(...) fail(-2, __VA_ARGS__)

int report(const Error& e, char* err, int errlen) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.msg);
    return e.code;
}

// ---------------------------------------------------------------------------
// Bits
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;
    int64_t size;  // bytes
    int64_t pos = 0;  // bits

    BitReader(const uint8_t* b, int64_t n) : buf(b), size(n) {}

    uint32_t peek(int n) const {  // n <= 32; zeros past the end
        int64_t byte = pos >> 3;
        uint64_t v = 0;
        if (byte + 8 <= size) {
            for (int i = 0; i < 8; i++) v = (v << 8) | buf[byte + i];
        } else {
            for (int i = 0; i < 8; i++) v = (v << 8) | (byte + i < size ? buf[byte + i] : 0);
        }
        v <<= (pos & 7);
        return uint32_t(v >> (64 - n));
    }
    void skip(int n) {
        pos += n;
        if (pos > size * 8) MALFORMED("the bitstream ends inside a VOP");
    }
    uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    int get1() { return int(get(1)); }
    void marker(const char* what) {
        if (!get1()) MALFORMED("missing marker bit after %s", what);
    }
    int vlc(const Lut& t, const char* what) {
        uint32_t i = peek(t.bits);
        if (t.sym[i] < 0) MALFORMED("invalid %s code at bit %lld", what, (long long)pos);
        skip(t.len[i]);
        return t.sym[i];
    }
    int64_t left() const { return size * 8 - pos; }
};

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int n = 0;  // bits in acc
    void put(uint32_t v, int len) {
        if (len == 0) return;
        acc = (acc << len) | (v & ((len == 32) ? 0xffffffffu : ((1u << len) - 1)));
        n += len;
        while (n >= 8) {
            out.push_back(uint8_t(acc >> (n - 8)));
            n -= 8;
        }
    }
    void put(const Vlc& v) { put(v.code, v.len); }
    void stuffing() {  // next_start_code(): a zero, then ones to the byte boundary
        put(0, 1);
        while (n) put(1, 1);
    }
    void start_code(uint32_t code) {
        put(0x000001, 24);
        put(code & 0xff, 8);
    }
};

// ---------------------------------------------------------------------------
// The video object layer
// ---------------------------------------------------------------------------

// Indices of the int32 array that carries the VOL between the calls
enum {
    VOL_FOUND, VOL_WIDTH, VOL_HEIGHT, VOL_TIME_RES, VOL_TIME_BITS, VOL_VERID, VOL_N
};

int bits_for(int res) {  // vop_time_increment length for a resolution
    int b = 1;
    while ((1 << b) < res) b++;
    return b;
}

void parse_vol(BitReader& br, int32_t* vol) {
    br.get1();                        // random_accessible_vol
    int type = int(br.get(8));        // video_object_type_indication
    if (type == 0x12) UNSUPPORTED("fine granularity scalable video objects");
    int verid = 1;
    if (br.get1()) {  // is_object_layer_identifier
        verid = int(br.get(4));
        br.get(3);  // priority
    }
    if (br.get(4) == 15) br.get(16);  // aspect_ratio_info, extended PAR
    if (br.get1()) {                  // vol_control_parameters
        int chroma = int(br.get(2));
        if (chroma != 1) UNSUPPORTED("chroma_format %d (4:2:0 only)", chroma);
        br.get1();  // low_delay
        if (br.get1()) br.get(79);  // vbv_parameters: 15+1+15+1+15+1+3+1+11+1+15+1
    }
    int shape = int(br.get(2));
    if (shape != 0) UNSUPPORTED("video_object_layer_shape %d (binary or grey shape)", shape);
    br.marker("video_object_layer_shape");
    int res = int(br.get(16));
    if (res == 0) MALFORMED("vop_time_increment_resolution 0");
    br.marker("vop_time_increment_resolution");
    int time_bits = bits_for(res);
    if (br.get1()) br.get(time_bits);  // fixed_vop_rate, fixed_vop_time_increment
    br.marker("fixed_vop_rate");
    int width = int(br.get(13));
    br.marker("video_object_layer_width");
    int height = int(br.get(13));
    br.marker("video_object_layer_height");
    if (br.get1()) UNSUPPORTED("interlaced video");
    if (!br.get1()) UNSUPPORTED("OBMC (obmc_disable 0)");
    int sprite = int(br.get(verid == 1 ? 1 : 2));
    if (sprite) UNSUPPORTED("sprites/GMC (sprite_enable %d)", sprite);
    if (br.get1()) UNSUPPORTED("not-8-bit video");
    if (br.get1()) UNSUPPORTED("MPEG quantisation matrices (quant_type 1)");
    if (verid != 1 && br.get1()) UNSUPPORTED("quarter-pel motion (quarter_sample 1)");
    if (!br.get1()) UNSUPPORTED("complexity estimation headers");
    if (!br.get1()) UNSUPPORTED("resync markers (resync_marker_disable 0)");
    if (br.get1()) UNSUPPORTED("data partitioning and RVLC");
    if (verid != 1) {
        if (br.get1()) UNSUPPORTED("NEWPRED");
        if (br.get1()) UNSUPPORTED("reduced-resolution VOPs");
    }
    if (br.get1()) UNSUPPORTED("scalability");
    if (width <= 0 || height <= 0) MALFORMED("VOL of size %d x %d", width, height);
    vol[VOL_FOUND] = 1;
    vol[VOL_WIDTH] = width;
    vol[VOL_HEIGHT] = height;
    vol[VOL_TIME_RES] = res;
    vol[VOL_TIME_BITS] = time_bits;
    vol[VOL_VERID] = verid;
}

// Find the next start code prefix (00 00 01) at or after byte p; returns
// the offset of its first byte, or -1.
int64_t next_start(const uint8_t* buf, int64_t len, int64_t p) {
    for (; p + 3 < len; p++)
        if (buf[p] == 0 && buf[p + 1] == 0 && buf[p + 2] == 1) return p;
    return -1;
}

// ---------------------------------------------------------------------------
// Intra prediction state (7.4.3): per 8x8 block the dequantised DC and the
// quantised first row and column, and per macroblock its QP
// ---------------------------------------------------------------------------

struct IntraState {
    int mbw, mbh;
    // luma blocks on a (2 mbh) x (2 mbw) grid; chroma on mbh x mbw grids
    std::vector<int> dc[3];
    std::vector<int16_t> ac[3];  // 16 a block: [0..7] first column, [8..15] first row
    std::vector<uint8_t> intra[3];  // the block belongs to an intra macroblock
    std::vector<int> qp;          // per macroblock

    IntraState(int w, int h) : mbw(w), mbh(h) {
        for (int c = 0; c < 3; c++) {
            size_t n = c == 0 ? size_t(4) * w * h : size_t(w) * h;
            dc[c].assign(n, 1024);
            ac[c].assign(n * 16, 0);
            intra[c].assign(n, 0);
        }
        qp.assign(size_t(w) * h, 0);
    }

    // plane, grid width, and the block's (x, y) on its grid
    void where(int mbx, int mby, int b, int& plane, int& gw, int& x, int& y) const {
        if (b < 4) {
            plane = 0, gw = 2 * mbw, x = 2 * mbx + (b & 1), y = 2 * mby + (b >> 1);
        } else {
            plane = b - 3, gw = mbw, x = mbx, y = mby;
        }
    }

    // DC of the block at (x, y) of a plane, 1024 outside the VOP or in a
    // non-intra macroblock
    int dc_at(int plane, int gw, int x, int y) const {
        if (x < 0 || y < 0) return 1024;
        size_t i = size_t(y) * gw + x;
        return intra[plane][i] ? dc[plane][i] : 1024;
    }

    // The predicted quantised DC and the direction: 1 = from above (C),
    // 0 = from the left (A)
    int predict_dc(int mbx, int mby, int b, int scale, int& dir) const {
        int plane, gw, x, y;
        where(mbx, mby, b, plane, gw, x, y);
        int a = dc_at(plane, gw, x - 1, y), bb = dc_at(plane, gw, x - 1, y - 1),
            c = dc_at(plane, gw, x, y - 1);
        int pred;
        if (std::abs(a - bb) < std::abs(bb - c)) {
            pred = c, dir = 1;
        } else {
            pred = a, dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }

    void store_dc(int mbx, int mby, int b, int level, int scale) {
        int plane, gw, x, y;
        where(mbx, mby, b, plane, gw, x, y);
        int v = level * scale;
        if (v & ~2047) v = v < 0 ? 0 : 2047;
        size_t i = size_t(y) * gw + x;
        dc[plane][i] = v;
        intra[plane][i] = 1;
    }

    // The AC prediction of a block: the neighbour's first row (dir 1, from
    // above) or column (dir 0, from the left), rescaled to this block's QP;
    // zeros where the neighbour is outside the VOP or not intra.
    void ac_predictor(int mbx, int mby, int b, int dir, int pred[8]) const {
        int plane, gw, x, y;
        where(mbx, mby, b, plane, gw, x, y);
        int q = qp[size_t(mby) * mbw + mbx];
        for (int i = 0; i < 8; i++) pred[i] = 0;
        int nx = dir ? x : x - 1, ny = dir ? y - 1 : y;
        if (nx < 0 || ny < 0 || !intra[plane][size_t(ny) * gw + nx]) return;
        const int16_t* p = &ac[plane][(size_t(ny) * gw + nx) * 16];
        int nmbx = plane == 0 ? nx >> 1 : nx, nmby = plane == 0 ? ny >> 1 : ny;
        int nq = qp[size_t(nmby) * mbw + nmbx];
        for (int i = 1; i < 8; i++) {
            int v = dir ? p[8 + i] : p[i];
            if (nq != q) {
                int num = v * nq;
                v = (num > 0 ? num + (q >> 1) : num - (q >> 1)) / q;
            }
            pred[i] = v;
        }
    }

    // Keep a block's first column and row (its levels, raster order) for
    // the blocks to its right and below.
    void store_ac(int mbx, int mby, int b, const int16_t* blk) {
        int plane, gw, x, y;
        where(mbx, mby, b, plane, gw, x, y);
        int16_t* s = &ac[plane][(size_t(y) * gw + x) * 16];
        for (int i = 1; i < 8; i++) {
            s[i] = blk[i * 8];
            s[8 + i] = blk[i];
        }
    }
};

// the raster position of the i-th predicted AC level of a direction
inline int ac_pos(int dir, int i) { return dir ? i : i * 8; }

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct DecodeOut {
    int16_t* mb;        // n_mb x 3: type (0 not coded, 1 inter, 2 intra), mvx, mvy
    int32_t* blk_idx;   // coded blocks: 6 * macroblock + block
    uint8_t* blk_qp;
    int16_t* levels;    // 64 a coded block, raster order, quantised
    int64_t n_blocks = 0;
};

int decode_dc_diff(BitReader& br, bool luma) {
    const Tables& t = tables();
    int size = br.vlc(luma ? t.dc_lum : t.dc_chrom, "dct_dc_size");
    if (size == 0) return 0;
    int v = int(br.get(size));
    if (!(v >> (size - 1))) v -= (1 << size) - 1;
    if (size > 8) br.marker("dct_dc_differential");
    return v;
}

// TCOEF events into blk (raster), from scan position `start`
void decode_ac(BitReader& br, const RunLevel& rl, const uint8_t* scan, int start, int16_t* blk) {
    int i = start;
    for (;;) {
        int e = br.vlc(rl.lut, "TCOEF");
        int last, run, level;
        if (e != ESCAPE) {
            last = e >= rl.last0, run = rl.run[e], level = rl.level[e];
            if (br.get1()) level = -level;
        } else if (!br.get1()) {  // type 1: level offset
            e = br.vlc(rl.lut, "TCOEF");
            if (e == ESCAPE) MALFORMED("escape inside an escape");
            last = e >= rl.last0, run = rl.run[e];
            level = rl.level[e] + rl.lmax[last][run];
            if (br.get1()) level = -level;
        } else if (!br.get1()) {  // type 2: run offset
            e = br.vlc(rl.lut, "TCOEF");
            if (e == ESCAPE) MALFORMED("escape inside an escape");
            last = e >= rl.last0, level = rl.level[e];
            run = rl.run[e] + rl.rmax[last][level] + 1;
            if (br.get1()) level = -level;
        } else {  // type 3: fixed length
            last = br.get1();
            run = int(br.get(6));
            br.marker("escape run");
            level = int(br.get(12));
            if (level & 0x800) level -= 0x1000;
            br.marker("escape level");
            if (level == 0) MALFORMED("escaped level 0");
        }
        i += run;
        if (i > 63) MALFORMED("more than 64 coefficients in a block");
        blk[scan[i]] = int16_t(level);
        i++;
        if (last) return;
    }
}

int decode_mvd(BitReader& br, int pred, int fcode) {
    int code = br.vlc(tables().mvd, "motion_code");
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = fcode - 1, val = code;
    if (shift) val = (((val - 1) << shift) | int(br.get(shift))) + 1;
    if (sign) val = -val;
    val += pred;
    int range = 64 << shift, low = -(32 << shift), high = (32 << shift) - 1;
    if (val < low) val += range;
    else if (val > high) val -= range;
    return val;
}

int median3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// The median prediction of a macroblock's vector (7.6.5; no video packets:
// the left neighbour alone on the first row, zero outside the VOP)
void predict_mv(const std::vector<int>& mvx, const std::vector<int>& mvy, int mbw, int mbx,
                int mby, int& px, int& py) {
    size_t m = size_t(mby) * mbw + mbx;
    int ax = 0, ay = 0;
    if (mbx > 0) ax = mvx[m - 1], ay = mvy[m - 1];
    if (mby == 0) {
        px = ax, py = ay;
        return;
    }
    size_t up = m - mbw;
    int cx = mbx + 1 < mbw ? mvx[up + 1] : 0, cy = mbx + 1 < mbw ? mvy[up + 1] : 0;
    px = median3(ax, mvx[up], cx), py = median3(ay, mvy[up], cy);
}

void decode_vop(BitReader& br, const int32_t* vol, int32_t* hdr, DecodeOut& out) {
    const Tables& t = tables();
    int width = vol[VOL_WIDTH], height = vol[VOL_HEIGHT];
    int mbw = (width + 15) / 16, mbh = (height + 15) / 16;
    int type = int(br.get(2));
    if (type == 2) UNSUPPORTED("B-VOPs");
    if (type == 3) UNSUPPORTED("sprite (S-)VOPs");
    while (br.get1()) {  // modulo_time_base
        if (br.left() <= 0) MALFORMED("the VOP header ends in modulo_time_base");
    }
    br.marker("modulo_time_base");
    br.get(vol[VOL_TIME_BITS]);  // vop_time_increment
    br.marker("vop_time_increment");
    hdr[0] = type;
    hdr[1] = br.get1();  // vop_coded
    hdr[2] = 0;
    if (!hdr[1]) return;  // N-VOP: the previous frame again
    if (type == 1) hdr[2] = br.get1();  // vop_rounding_type
    int dc_thr = int(br.get(3));
    if (dc_thr) UNSUPPORTED("intra_dc_vlc_thr %d (intra DC coded as AC)", dc_thr);
    int qp = int(br.get(5));
    if (qp == 0) MALFORMED("vop_quant 0");
    int fcode = 1;
    if (type == 1) {
        fcode = int(br.get(3));
        if (fcode == 0) MALFORMED("vop_fcode_forward 0");
    }
    hdr[3] = qp;
    hdr[4] = fcode;

    IntraState st(mbw, mbh);
    std::vector<int> mvx(size_t(mbw) * mbh, 0), mvy(size_t(mbw) * mbh, 0);
    for (int mby = 0; mby < mbh; mby++) {
        for (int mbx = 0; mbx < mbw; mbx++) {
            size_t m = size_t(mby) * mbw + mbx;
            int16_t* mb = out.mb + 3 * m;
            bool intra;
            int cbpc, mb_type;
            for (;;) {  // MCBPC, past any stuffing
                if (type == 1 && br.get1()) {  // not_coded
                    mb_type = -1;
                    break;
                }
                int s = br.vlc(type == 0 ? t.intra_mcbpc : t.inter_mcbpc, "MCBPC");
                if (type == 0 ? s == 8 : s == 20) continue;
                if (type == 0) {
                    mb_type = 3 + (s >> 2), cbpc = s & 3;
                } else {
                    mb_type = s >> 2, cbpc = s & 3;
                }
                break;
            }
            if (mb_type < 0) {
                mb[0] = 0, mb[1] = 0, mb[2] = 0;
                st.qp[m] = qp;
                continue;
            }
            if (mb_type == 2) UNSUPPORTED("4MV (inter4v macroblocks)");
            intra = mb_type >= 3;
            bool ac_pred = intra ? br.get1() : false;
            int cbpy = br.vlc(t.cbpy, "CBPY");
            if (!intra) cbpy ^= 15;
            if (mb_type == 1 || mb_type == 4) {
                static const int DQ[4] = {-1, -2, 1, 2};
                qp = std::min(31, std::max(1, qp + DQ[br.get(2)]));
            }
            st.qp[m] = qp;
            int cbp = (cbpy << 2) | cbpc;  // bit 5 - b: block b coded
            mb[0] = intra ? 2 : 1;
            if (!intra) {
                int px, py;
                predict_mv(mvx, mvy, mbw, mbx, mby, px, py);
                mvx[m] = decode_mvd(br, px, fcode);
                mvy[m] = decode_mvd(br, py, fcode);
            }
            mb[1] = int16_t(mvx[m]), mb[2] = int16_t(mvy[m]);
            for (int b = 0; b < 6; b++) {
                bool coded = (cbp >> (5 - b)) & 1;
                if (!intra && !coded) continue;
                int16_t* blk = out.levels + 64 * out.n_blocks;
                memset(blk, 0, 64 * sizeof(int16_t));
                if (intra) {
                    bool luma = b < 4;
                    int scale = dc_scaler(qp, luma), dir;
                    int pred = st.predict_dc(mbx, mby, b, scale, dir);
                    int level = decode_dc_diff(br, luma) + pred;
                    st.store_dc(mbx, mby, b, level, scale);
                    blk[0] = int16_t(level);
                    const uint8_t* scan = !ac_pred ? ZIGZAG : dir ? ALT_HORIZONTAL : ALT_VERTICAL;
                    if (coded) decode_ac(br, t.intra, scan, 1, blk);
                    if (ac_pred) {
                        int pred[8];
                        st.ac_predictor(mbx, mby, b, dir, pred);
                        for (int i = 1; i < 8; i++)
                            blk[ac_pos(dir, i)] = int16_t(blk[ac_pos(dir, i)] + pred[i]);
                    }
                    st.store_ac(mbx, mby, b, blk);
                } else {
                    decode_ac(br, t.inter, ZIGZAG, 0, blk);
                }
                out.blk_idx[out.n_blocks] = int32_t(6 * m + b);
                out.blk_qp[out.n_blocks] = uint8_t(qp);
                out.n_blocks++;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Encoding
// ---------------------------------------------------------------------------

void put_dc_diff(BitWriter& bw, int diff, bool luma) {
    int a = std::abs(diff), size = 0;
    while (a >> size) size++;
    if (size > 12) fail(-1, "intra DC differential %d out of range", diff);
    bw.put(luma ? DC_LUM[size] : DC_CHROM[size]);
    if (size == 0) return;
    bw.put(uint32_t(diff > 0 ? diff : diff + (1 << size) - 1), size);
    if (size > 8) bw.put(1, 1);
}

void put_event(BitWriter& bw, const RunLevel& rl, int last, int run, int level) {
    int a = std::abs(level), sign = level < 0;
    int e = rl.entry(last, run, a);
    if (e >= 0) {
        bw.put(rl.vlc[e]);
        bw.put(sign, 1);
        return;
    }
    int lm = rl.lmax[last][run < 64 ? run : 0];
    if (run < 64 && lm && a > lm && (e = rl.entry(last, run, a - lm)) >= 0) {
        bw.put(rl.vlc[ESCAPE]);
        bw.put(0, 1);
        bw.put(rl.vlc[e]);
        bw.put(sign, 1);
        return;
    }
    if (a < 128 && rl.rmax[last][a] >= 0 && run > rl.rmax[last][a] &&
        (e = rl.entry(last, run - rl.rmax[last][a] - 1, a)) >= 0) {
        bw.put(rl.vlc[ESCAPE]);
        bw.put(2, 2);
        bw.put(rl.vlc[e]);
        bw.put(sign, 1);
        return;
    }
    if (a > 2047) fail(-1, "level %d out of range", level);
    bw.put(rl.vlc[ESCAPE]);
    bw.put(3, 2);
    bw.put(uint32_t(last), 1);
    bw.put(uint32_t(run), 6);
    bw.put(1, 1);
    bw.put(uint32_t(level) & 0xfff, 12);
    bw.put(1, 1);
}

void put_ac(BitWriter& bw, const RunLevel& rl, const int16_t* blk, const uint8_t* scan,
            int start) {
    int lastpos = -1;
    for (int i = 63; i >= start; i--)
        if (blk[scan[i]]) {
            lastpos = i;
            break;
        }
    int run = 0;
    for (int i = start; i <= lastpos; i++) {
        int v = blk[scan[i]];
        if (!v) {
            run++;
            continue;
        }
        put_event(bw, rl, i == lastpos, run, v);
        run = 0;
    }
}

bool any_ac(const int16_t* blk, int start) {
    for (int i = start; i < 64; i++)
        if (blk[i]) return true;
    return false;
}

void put_mvd(BitWriter& bw, int diff, int fcode) {
    int shift = fcode - 1, range = 64 << shift;
    if (diff < -(32 << shift)) diff += range;
    if (diff > (32 << shift) - 1) diff -= range;
    if (diff == 0) {
        bw.put(MVD[0]);
        return;
    }
    int a = std::abs(diff) - 1;
    bw.put(MVD[(a >> shift) + 1]);
    bw.put(diff < 0, 1);
    bw.put(uint32_t(a & ((1 << shift) - 1)), shift);
}

// The fields of the int32 header an encoder call takes
enum { ENC_TYPE, ENC_CODED, ENC_QP, ENC_ROUNDING, ENC_FCODE, ENC_MODULO, ENC_TIME, ENC_GOV };
// Macroblock modes: not coded, inter, inter+q, intra, intra+q
enum { MB_SKIP, MB_INTER, MB_INTER_Q, MB_INTRA, MB_INTRA_Q };

// Encode one VOP. mbs: per macroblock (mode, dquant, ac_pred, mvx, mvy),
// vectors absolute in half pels; levels: the 6 blocks of every macroblock
// that is not MB_SKIP, in order, as the decoder gives them back (raster,
// quantised, after prediction; an intra block's [0] its DC level).
void encode_vop(BitWriter& bw, const int32_t* vol, const int32_t* hdr, const int16_t* mbs,
                const int16_t* levels) {
    const Tables& t = tables();
    int mbw = (vol[VOL_WIDTH] + 15) / 16, mbh = (vol[VOL_HEIGHT] + 15) / 16;
    int type = hdr[ENC_TYPE], qp = hdr[ENC_QP], fcode = hdr[ENC_FCODE];
    if (type != 0 && type != 1) fail(-1, "VOP type %d: I (0) or P (1) only", type);
    if (qp < 1 || qp > 31) fail(-1, "QP %d out of 1..31", qp);
    if (type == 1 && (fcode < 1 || fcode > 7)) fail(-1, "f_code %d out of 1..7", fcode);
    if (hdr[ENC_GOV] >= 0) {  // group_of_vop: time_code, closed_gov, broken_link
        int sec = hdr[ENC_GOV];
        bw.start_code(0xb3);
        bw.put(uint32_t(sec / 3600 % 24), 5);
        bw.put(uint32_t(sec / 60 % 60), 6);
        bw.put(1, 1);
        bw.put(uint32_t(sec % 60), 6);
        bw.put(1, 1);  // closed_gov: no B-VOPs
        bw.put(0, 1);
        bw.stuffing();
    }
    bw.start_code(0xb6);
    bw.put(uint32_t(type), 2);
    for (int i = 0; i < hdr[ENC_MODULO]; i++) bw.put(1, 1);
    bw.put(0, 1);
    bw.put(1, 1);
    bw.put(uint32_t(hdr[ENC_TIME]), vol[VOL_TIME_BITS]);
    bw.put(1, 1);
    bw.put(uint32_t(hdr[ENC_CODED] != 0), 1);
    if (!hdr[ENC_CODED]) {  // N-VOP
        bw.stuffing();
        return;
    }
    if (type == 1) bw.put(uint32_t(hdr[ENC_ROUNDING] & 1), 1);
    bw.put(0, 3);  // intra_dc_vlc_thr
    bw.put(uint32_t(qp), 5);
    if (type == 1) bw.put(uint32_t(fcode), 3);

    IntraState st(mbw, mbh);
    std::vector<int> mvx(size_t(mbw) * mbh, 0), mvy(size_t(mbw) * mbh, 0);
    int lo = -(32 << (fcode - 1)), hi = (32 << (fcode - 1)) - 1;
    const int16_t* blk = levels;
    for (int mby = 0; mby < mbh; mby++) {
        for (int mbx = 0; mbx < mbw; mbx++) {
            size_t m = size_t(mby) * mbw + mbx;
            const int16_t* d = mbs + 5 * m;
            int mode = d[0];
            if (mode < MB_SKIP || mode > MB_INTRA_Q || (type == 0 && mode < MB_INTRA))
                fail(-1, "macroblock %d: mode %d in a %s-VOP", int(m), mode, type ? "P" : "I");
            if (mode == MB_SKIP) {
                bw.put(1, 1);  // not_coded
                st.qp[m] = qp;
                continue;
            }
            bool intra = mode >= MB_INTRA, q = mode == MB_INTER_Q || mode == MB_INTRA_Q;
            int dq = q ? d[1] : 0;
            static const int DQ_CODE[5] = {1, 0, -1, 2, 3};  // dquant -2..2 -> its 2 bits
            if (q && (dq < -2 || dq > 2 || dq == 0))
                fail(-1, "macroblock %d: dquant %d not in -2, -1, 1, 2", int(m), dq);
            qp = std::min(31, std::max(1, qp + dq));
            st.qp[m] = qp;
            bool ac_pred = intra && d[2];
            int16_t sent[6][64];  // what goes into the bitstream: levels less their prediction
            int dirs[6] = {0};
            int cbp = 0;
            for (int b = 0; b < 6; b++) {
                memcpy(sent[b], blk + 64 * b, sizeof(sent[b]));
                if (intra) {
                    bool luma = b < 4;
                    int scale = dc_scaler(qp, luma);
                    int pred = st.predict_dc(mbx, mby, b, scale, dirs[b]);
                    sent[b][0] = int16_t(blk[64 * b] - pred);  // the DC differential
                    st.store_dc(mbx, mby, b, blk[64 * b], scale);
                    if (ac_pred) {
                        int ap[8];
                        st.ac_predictor(mbx, mby, b, dirs[b], ap);
                        for (int i = 1; i < 8; i++)
                            sent[b][ac_pos(dirs[b], i)] =
                                int16_t(sent[b][ac_pos(dirs[b], i)] - ap[i]);
                    }
                    st.store_ac(mbx, mby, b, blk + 64 * b);
                    int16_t ac[64];
                    memcpy(ac, sent[b], sizeof(ac));
                    ac[0] = 0;
                    cbp |= any_ac(ac, 0) << (5 - b);
                } else {
                    cbp |= any_ac(sent[b], 0) << (5 - b);
                }
            }
            int cbpc = cbp & 3, cbpy = cbp >> 2;
            if (type == 1) {
                bw.put(0, 1);  // not_coded
                static const int MB_TYPE[5] = {0, 0, 1, 3, 4};  // by mode: inter, +q, intra, +q
                bw.put(INTER_MCBPC[4 * MB_TYPE[mode] + cbpc]);
            } else {
                bw.put(INTRA_MCBPC[(mode == MB_INTRA_Q ? 4 : 0) + cbpc]);
            }
            if (intra) bw.put(ac_pred, 1);
            bw.put(CBPY[intra ? cbpy : cbpy ^ 15]);
            if (q) bw.put(uint32_t(DQ_CODE[dq + 2]), 2);
            if (!intra) {
                if (d[3] < lo || d[3] > hi || d[4] < lo || d[4] > hi)
                    fail(-1, "macroblock %d: vector (%d, %d) outside f_code %d's range",
                         int(m), d[3], d[4], fcode);
                int px, py;
                predict_mv(mvx, mvy, mbw, mbx, mby, px, py);
                mvx[m] = d[3], mvy[m] = d[4];
                put_mvd(bw, d[3] - px, fcode);
                put_mvd(bw, d[4] - py, fcode);
            }
            for (int b = 0; b < 6; b++) {
                if (intra) {
                    put_dc_diff(bw, sent[b][0], b < 4);
                    const uint8_t* scan = !ac_pred ? ZIGZAG : dirs[b] ? ALT_HORIZONTAL
                                                                      : ALT_VERTICAL;
                    if ((cbp >> (5 - b)) & 1) put_ac(bw, t.intra, sent[b], scan, 1);
                } else if ((cbp >> (5 - b)) & 1) {
                    put_ac(bw, t.inter, sent[b], ZIGZAG, 0);
                }
            }
            blk += 6 * 64;
        }
    }
    bw.stuffing();
}

}  // namespace

extern "C" {

// Scan a decoder configuration (the esds DecoderSpecificInfo, or a sample
// that carries its own headers) for a VOL; fills vol[VOL_N].
int m4v_parse_config(const uint8_t* buf, int64_t len, int32_t* vol, char* err, int errlen) {
    try {
        for (int64_t p = next_start(buf, len, 0); p >= 0; p = next_start(buf, len, p + 3)) {
            int code = buf[p + 3];
            if (code >= 0x20 && code <= 0x2f) {
                BitReader br(buf + p + 4, len - p - 4);
                parse_vol(br, vol);
            }
        }
        return 0;
    } catch (const Error& e) {
        return report(e, err, errlen);
    }
}

// Decode one sample: its VOL (if it carries one, into vol), GOV and user
// data are read or skipped, and its VOP decoded. hdr: [type, coded,
// rounding, qp, fcode, has_vop]. mb, blk_idx, blk_qp and levels hold
// max_mb macroblocks; a VOL that changes the frame size, or a frame of
// more macroblocks, is refused before anything is written. Returns the
// number of coded blocks in *n_blocks.
int m4v_decode_vop(const uint8_t* buf, int64_t len, int32_t* vol, int32_t* hdr, int16_t* mb,
                   int32_t* blk_idx, uint8_t* blk_qp, int16_t* levels, int64_t max_mb,
                   int64_t* n_blocks, char* err, int errlen) {
    try {
        DecodeOut out{mb, blk_idx, blk_qp, levels};
        hdr[5] = 0;
        for (int64_t p = next_start(buf, len, 0); p >= 0; p = next_start(buf, len, p + 3)) {
            int code = buf[p + 3];
            if (code >= 0x20 && code <= 0x2f) {
                BitReader br(buf + p + 4, len - p - 4);
                int32_t found[VOL_N] = {0};
                parse_vol(br, found);
                if (vol[VOL_FOUND] && (found[VOL_WIDTH] != vol[VOL_WIDTH] ||
                                       found[VOL_HEIGHT] != vol[VOL_HEIGHT]))
                    UNSUPPORTED("a VOL that changes the frame size (%d x %d, then %d x %d)",
                                vol[VOL_WIDTH], vol[VOL_HEIGHT], found[VOL_WIDTH],
                                found[VOL_HEIGHT]);
                std::copy(found, found + VOL_N, vol);
            } else if (code == 0xb6) {
                if (!vol[VOL_FOUND]) MALFORMED("a VOP before any VOL header");
                int64_t n_mb = int64_t((vol[VOL_WIDTH] + 15) / 16) * ((vol[VOL_HEIGHT] + 15) / 16);
                if (n_mb > max_mb)
                    MALFORMED("a VOP of %lld macroblocks where %lld were expected",
                              (long long)n_mb, (long long)max_mb);
                BitReader br(buf + p + 4, len - p - 4);
                decode_vop(br, vol, hdr, out);
                hdr[5] = 1;
                break;
            }
            // 0xb0 VOS, 0xb1 end, 0xb2 user data, 0xb3 GOV, 0xb5 VO, 0x00-0x1f VO:
            // nothing in them is needed to decode the VOP
        }
        *n_blocks = out.n_blocks;
        return 0;
    } catch (const Error& e) {
        return report(e, err, errlen);
    }
}

// VOS, VO and VOL headers for a Simple Profile stream; returns the bytes
// written to out, or -1 if cap is too small.
int m4v_write_config(int32_t width, int32_t height, int32_t time_res, uint8_t* out, int cap) {
    BitWriter bw;
    bw.start_code(0xb0);
    bw.put(1, 8);  // profile_and_level_indication: Simple Profile, as ffmpeg's encoder writes
    bw.start_code(0xb5);
    bw.put(1, 1);  // is_visual_object_identifier
    bw.put(1, 4);  // visual_object_verid
    bw.put(1, 3);  // visual_object_priority
    bw.put(1, 4);  // visual_object_type: video
    bw.put(0, 1);  // video_signal_type
    bw.stuffing();
    bw.start_code(0x00);  // video_object_start_code
    bw.start_code(0x20);  // video_object_layer_start_code
    bw.put(0, 1);   // random_accessible_vol
    bw.put(1, 8);   // video_object_type_indication: Simple Object
    bw.put(1, 1);   // is_object_layer_identifier
    bw.put(1, 4);   // video_object_layer_verid
    bw.put(1, 3);   // video_object_layer_priority
    bw.put(1, 4);   // aspect_ratio_info: square pixels
    bw.put(1, 1);   // vol_control_parameters
    bw.put(1, 2);   // chroma_format 4:2:0
    bw.put(1, 1);   // low_delay
    bw.put(0, 1);   // vbv_parameters
    bw.put(0, 2);   // video_object_layer_shape: rectangular
    bw.put(1, 1);
    bw.put(uint32_t(time_res), 16);
    bw.put(1, 1);
    bw.put(0, 1);   // fixed_vop_rate
    bw.put(1, 1);
    bw.put(uint32_t(width), 13);
    bw.put(1, 1);
    bw.put(uint32_t(height), 13);
    bw.put(1, 1);
    bw.put(0, 1);   // interlaced
    bw.put(1, 1);   // obmc_disable
    bw.put(0, 1);   // sprite_enable
    bw.put(0, 1);   // not_8_bit
    bw.put(0, 1);   // quant_type: H.263
    bw.put(1, 1);   // complexity_estimation_disable
    bw.put(1, 1);   // resync_marker_disable
    bw.put(0, 1);   // data_partitioned
    bw.put(0, 1);   // scalability
    bw.stuffing();
    if (int(bw.out.size()) > cap) return -1;
    memcpy(out, bw.out.data(), bw.out.size());
    return int(bw.out.size());
}

// Encode one VOP of a VOL written by m4v_write_config. hdr: [type (0 I,
// 1 P), vop_coded, qp, vop_rounding_type, f_code, modulo_time_base,
// vop_time_increment, GOV seconds (-1: no GOV header)]; mbs and levels as
// encode_vop takes them. Returns the bytes in *out_len.
int m4v_encode_vop(const int32_t* vol, const int32_t* hdr, const int16_t* mbs,
                   const int16_t* levels, uint8_t* out, int64_t cap, int64_t* out_len, char* err,
                   int errlen) {
    try {
        BitWriter bw;
        bw.out.reserve(size_t(std::min<int64_t>(cap, int64_t(1) << 20)));
        encode_vop(bw, vol, hdr, mbs, levels);
        if (int64_t(bw.out.size()) > cap) fail(-1, "the VOP takes more than %lld bytes",
                                                (long long)cap);
        memcpy(out, bw.out.data(), bw.out.size());
        *out_len = int64_t(bw.out.size());
        return 0;
    } catch (const Error& e) {
        return report(e, err, errlen);
    }
}

}  // extern "C"
