// A software HEVC (ITU-T H.265 | ISO/IEC 23008-2) decoder for progressive
// 8- and 10-bit 4:2:0 video in the Main, Main 10 and Main Still Picture
// profiles, and a writer of test streams that drives the same syntax code.
// The sample code is templated on the bit depth (Pel<BD>: bytes at 8 bits,
// 16-bit words at 10), and follows every place the standard reads BitDepth:
// QpBdOffset in the QP ranges and the chroma QP, the dequantisation and
// transform shifts, the unavailable-sample value and the strong smoothing
// threshold, the interpolation and weighted-prediction shifts and offsets,
// beta and tC, SAO's offset range and band shift, PCM; a 10-bit picture is
// output as 16-bit words.
//
// Decoded, in the order of the standard's clauses: NAL units and the RBSP
// (emulation prevention, Exp-Golomb codes); the VPS, the SPS
// (profile_tier_level, the conformance window, CTB sizes 16, 32 and 64,
// transform block sizes and depths, AMP, SAO, PCM with
// pcm_loop_filter_disabled_flag, short-term RPS sets with inter-RPS
// prediction, long-term reference pictures, TMVP, strong intra smoothing,
// scaling lists with their prediction and defaults, the VUI's colour
// fields) and the PPS (sign data hiding, cabac_init_present_flag,
// constrained intra prediction, transform skip, cu_qp_delta, the chroma QP
// offsets, weighted prediction, transquant bypass, tiles, wavefronts
// (entropy_coding_sync_enabled_flag), the loop filters across slices and
// tiles, deblocking control and override, list modification, the parallel
// merge level, slice header extensions); the slice segment header with
// dependent slice segments and entry points; POC, the RPS, the DPB with its
// output and bumping process, pic_output_flag and no_output_of_prior_pics;
// IDR, CRA and BLA pictures, RASL pictures dropped where NoRaslOutputFlag
// says so, RADL pictures, and the generation of missing references; the
// reference picture lists; CABAC for every syntax element of the Main
// profile with the wavefront context storage and the resets at tiles and
// slices; the coding quadtree, every part_mode, PCM, intra modes with their
// MPMs, the transform tree with cu_qp_delta and QP prediction, residual
// coding with sign hiding and transform skip; intra prediction (35 modes,
// reference substitution, the [1 2 1] and strong smoothing filters, the DC
// and edge filters); dequantisation with scaling lists; the inverse DCT
// 4-32 and the 4x4 DST; merge (spatial, temporal, combined bi-predictive
// and zero candidates, the parallel merge level) and AMVP with TMVP; 8-tap
// luma and 4-tap chroma interpolation with default and explicit weights;
// the deblocking filter and SAO.
//
// Refused, naming the feature: bit depths other than 8 and 10, a chroma
// bit depth unlike the luma's, chroma formats other than 4:2:0, the range,
// multilayer, 3D and SCC extensions, field coding (field_seq_flag, or a
// pic_timing SEI that says the pictures are fields).
// Pictures of nuh_layer_id > 0 are dropped, as ffmpeg drops them.
//
// Which pictures a decode outputs, and in what order, is the DPB's
// (C.5.2): pic_output_flag, RASL pictures dropped, and an IRAP picture's
// NoOutputOfPriorPicsFlag (no_output_of_prior_pics_flag, or 1 for a CRA
// with NoRaslOutputFlag 1, as after an end of sequence) emptying the DPB
// of pictures still waiting. The caller takes each picture as it is
// decoded; hevc_scan runs the slice headers of a stream through the same
// DPB, without slice data, to name the pictures output.
//
// The writer (hevcw_*) runs the same parameter-set, slice-header and CTU
// syntax with a second engine: where a syntax element is due, it picks the
// element from a seeded generator within its legal range (motion vectors
// that keep the block within a window about the picture, reference
// indices within the lists, levels whose dequantised values and transform
// intermediates stay inside 16 bits) and writes it with a CABAC encoder.
// Its streams are for holding the decoder to ffmpeg (cv2), so the writer
// also keeps clear of what ffmpeg's HEVC decoder does otherwise than the
// standard on a conforming stream:
// - tiles and wavefronts in one PPS: ffmpeg misreads such a stream (CABAC
//   errors, cu_qp_delta out of range); the smallest stream that shows it is
//   one I picture of 176 x 144 in CTBs of 16 with two tile columns and
//   entropy_coding_sync_enabled_flag;
// - SAO edge offsets across a slice boundary where the two slices have
//   different slice_loop_filter_across_slices_enabled_flag: for a sample
//   whose neighbour lies in a later slice ffmpeg reads the flag of the
//   sample's own slice, where the standard (8.7.3.2) reads the later
//   slice's; the smallest stream is one picture of two slices, the first
//   with the flag 1 and the second with 0, and edge offsets on the first
//   one's last CTB row. The writer gives every slice of a picture one flag;
// - deblocking offsets that differ from slice to slice: ffmpeg takes tc's
//   offset for the chroma of a horizontal edge from its CTB pass (the left
//   CTB's for the first 8 luma columns of each 16, the current CTB's for
//   the last 8) where the standard takes the offset of the slice that
//   holds q0; for the vertical luma edges of a CTB's later 8-row bands it
//   takes the offsets of the last horizontal edge it filtered before them,
//   which may lie in the CTB to the left; and a slice with
//   slice_deblocking_filter_disabled_flag keeps the previous slice's
//   offsets (zero at the first). The smallest streams that show it: one I
//   picture of 96 x 80 in CTBs of 32, two slices (CTBs 0-1 and 2-) with tc
//   offsets 1 and 4 and an intra CU edge at x 56-63, y 16 (the chroma); one
//   I picture of 704 x 400 in CTBs of 64, slices at CTBs 0, 25, 41 and 65
//   with beta offsets 2, 0, -6 and 0 (the luma at x 544-568, y 200-207).
//   The writer gives every slice the PPS's offsets, and zero offsets where
//   slices override the deblocking;
// - the flag above inferred: a slice with neither SAO nor deblocking does
//   not code slice_loop_filter_across_slices_enabled_flag and takes the
//   PPS's, so the writer picks the PPS's value for the picture where slices
//   override the deblocking or the PPS disables it;
// - chroma SAO in CTBs of 16: ffmpeg runs a CTB's SAO before the chroma of
//   the horizontal edges in the CTB to its right is deblocked (it deblocks
//   those 16 luma columns late, in the next CTB's pass), so the corner
//   samples of a CTB's chroma take other neighbours; the smallest stream is
//   one I picture of 128 x 64 in CTBs of 16 with edge offsets on chroma.
//   The writer turns chroma SAO off in CTBs of 16;
// - constrained_intra_pred_flag with CBs of 16 or more (prediction units
//   of 8): ffmpeg's constrained reference substitution then predicts 4 x 4
//   blocks otherwise, even in a picture whose CUs are all intra, where the
//   flag changes nothing; the smallest stream is one I picture of 64 x 48
//   in CTBs of 32 with log2_min_luma_coding_block_size 4 and the flag. The
//   writer takes constrained intra prediction with CBs of 8 only;
// - SAO on the chroma of a transquant-bypass CU, or of a PCM CU under
//   pcm_loop_filter_disabled_flag: ffmpeg puts back the unfiltered chroma of
//   such CUs only in the top-left quadrant of each CTB (it sizes the region
//   in chroma samples and walks it in luma units), so elsewhere it applies
//   SAO where the standard leaves the samples as they are; the smallest
//   stream is one I picture of 64 x 64 in CTBs of 32, SAO band offsets on
//   chroma, and a bypass CU at (16, 16) of the first CTB. The writer puts
//   such CUs in that quadrant where the CTB's chroma SAO is on;
// - the chroma QP of deblocking (8.7.2.5.5): ffmpeg clips qPi (the two
//   QpY's mean plus pps_cb_qp_offset or pps_cr_qp_offset) to 0..57 before
//   Table 8-10, where the standard does not, so above 57 its tC for a
//   chroma edge is one QP step lower; the smallest stream that showed it:
//   three 10-bit pictures of 128 x 80 in CTBs of 16, QPs up to 46 and a
//   Cr offset of 12, a negative tc offset. The writer refuses QPs and PPS
//   chroma offsets that can sum above 57 (below 0 the two agree: tC is 0);
// - the POC of a CRA after an end of sequence NAL unit: the standard
//   (8.3.1) sets its PicOrderCntMsb to 0, as for a BLA, where ffmpeg
//   derives it from the previous TemporalId 0 picture's; where the two
//   differ, ffmpeg then fails to build the RPS of the CRA's RADL pictures
//   ("Could not find ref with POC") and drops one. The smallest stream
//   that showed it: 20 pictures of 64 x 48 with log2_max_poc_lsb 4, open
//   GOPs of 8 with 3 B pictures, an end of sequence before each CRA; the
//   second CRA (lsb 0, after a picture of POC 12) loses its RADL picture.
//   The writer ends a sequence only before a CRA whose POC ffmpeg derives
//   as the standard does.
//
// Plain C interface for ctypes. Every function returns 0 on success, -1 on
// a malformed stream and -2 on a stream that uses a feature this decoder
// does not implement, with a message in `err`.

#include <algorithm>
#include <array>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <type_traits>
#include <vector>

namespace {

struct Invalid : std::runtime_error {
    using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void invalid(const char* fmt, ...) {
    char buf[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Invalid(buf);
}

[[noreturn]] void unsupported(const char* what) { throw Unsupported(what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
// a sample of a BD-bit picture: 8-bit planes hold bytes, 10-bit ones
// 16-bit words; the sample code is templated on BD
template <int BD>
using Pel = typename std::conditional<(BD > 8), uint16_t, uint8_t>::type;
template <int BD>
inline Pel<BD> clip1(int v) {
    return (Pel<BD>)(v < 0 ? 0 : v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
}
inline int sign(int v) { return (v > 0) - (v < 0); }
inline int ceil_log2(int v) {
    int k = 0;
    while ((1 << k) < v) k++;
    return k;
}

// ---------------------------------------------------------------------------
// Tables
// ---------------------------------------------------------------------------

// CABAC, 9.3.4.3.2: rangeTabLps[pStateIdx][qRangeIdx] and transIdxLps
const uint8_t RANGE_LPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
const uint8_t TRANS_LPS[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// The context variables, by syntax element: the first ctxIdx of each (the
// element's contexts follow in ctxInc order)
enum Ctx {
    C_SAO_MERGE = 0, C_SAO_TYPE = 1, C_SPLIT_CU = 2, C_TQ_BYPASS = 5, C_SKIP = 6, C_QP_DELTA = 9,
    C_PRED_MODE = 12, C_PART_MODE = 13, C_PREV_INTRA = 17, C_CHROMA_MODE = 18, C_MERGE_FLAG = 20,
    C_MERGE_IDX = 21, C_INTER_PRED = 22, C_REF_IDX = 27, C_MVD_G0 = 31, C_MVD_G1 = 34, C_MVP = 35,
    C_ROOT_CBF = 36, C_SPLIT_TR = 37, C_CBF_LUMA = 40, C_CBF_CHROMA = 42, C_TSKIP = 47,
    C_LAST_X = 53, C_LAST_Y = 71, C_CSBF = 89, C_SIG = 93, C_GT1 = 137, C_GT2 = 161, N_CTX = 167
};

// Tables 9-5 to 9-37: initValue of each context above, by initType (0: I,
// 1 and 2: P and B as cabac_init_flag picks); 154 where an initType has no
// such context
const uint8_t INIT_VALUE[3][N_CTX] = {
    {
     153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 154, 154, 154, 184, 154, 154, 154, 184, 63, 139,
     154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 153, 138, 138,
     111, 141, 94, 138, 182, 154, 154, 139, 139, 139, 139, 139, 139, 110, 110, 124, 125, 140, 153, 125,
     127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63, 110, 110, 124, 125, 140, 153, 125, 127, 140,
     109, 111, 143, 127, 111, 79, 108, 123, 63, 91, 171, 134, 141, 111, 111, 125, 110, 110, 94, 124,
     108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125,
     140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 141, 111, 140, 92, 137,
     138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122,
     197, 138, 153, 136, 167, 152, 152,
    },
    {
     153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 149, 154, 139, 154, 154, 154, 152, 139,
     110, 122, 95, 79, 63, 31, 31, 153, 153, 153, 153, 140, 198, 140, 198, 168, 79, 124, 138, 94,
     153, 111, 149, 107, 167, 154, 154, 139, 139, 139, 139, 139, 139, 125, 110, 94, 110, 95, 79, 125,
     111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108, 125, 110, 94, 110, 95, 79, 125, 111, 110,
     78, 110, 111, 111, 95, 94, 108, 123, 108, 121, 140, 61, 154, 155, 154, 139, 153, 139, 123, 123,
     63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154,
     170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140, 154, 196, 196,
     167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137,
     182, 107, 167, 91, 122, 107, 167,
    },
    {
     153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 134, 154, 139, 154, 154, 183, 152, 139,
     154, 137, 95, 79, 63, 31, 31, 153, 153, 153, 153, 169, 198, 169, 198, 168, 79, 224, 167, 122,
     153, 111, 149, 92, 167, 154, 154, 139, 139, 139, 139, 139, 139, 125, 110, 124, 110, 95, 94, 125,
     111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93, 125, 110, 124, 110, 95, 94, 125, 111, 111,
     79, 125, 126, 111, 111, 79, 108, 123, 93, 121, 140, 61, 154, 170, 154, 139, 153, 139, 123, 123,
     63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154,
     170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140, 154, 196, 167,
     167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167,
     182, 107, 167, 91, 107, 107, 167,
    },
};

// Table 8-10: QpC as a function of qPi for ChromaArrayType 1
inline int chroma_qp_table(int qpi) {
    static const uint8_t T[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
    return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : T[qpi - 30];
}

const int LEVEL_SCALE[6] = {40, 45, 51, 57, 64, 72};

// Table 7-6: the default 8x8 scaling factors, intra and inter (raster
// order, row y then column x; both are symmetric)
const uint8_t DEFAULT_8X8[2][64] = {
    {16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25, 16, 16, 17, 18, 20, 22,
     25, 29, 16, 16, 18, 21, 24, 27, 31, 36, 17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27,
     35, 44, 54, 65, 21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115},
    {16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25, 16, 16, 17, 18, 20, 24,
     25, 28, 16, 17, 18, 20, 24, 25, 28, 33, 17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25,
     28, 33, 41, 54, 20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91}};

// 6.5.3-6.5.5: the up-right diagonal, horizontal and vertical scans of
// blocks of 1, 2, 4 and 8 on a side, scan position -> (x, y)
struct Scans {
    uint8_t pos[4][3][64][2];
    Scans() {
        for (int l = 0; l < 4; l++) {
            int n = 1 << l, i = 0, x = 0, y = 0;
            bool stop = false;
            while (!stop) {
                while (y >= 0) {
                    if (x < n && y < n) {
                        pos[l][0][i][0] = (uint8_t)x;
                        pos[l][0][i][1] = (uint8_t)y;
                        i++;
                    }
                    y--;
                    x++;
                }
                y = x;
                x = 0;
                if (i >= n * n) stop = true;
            }
            for (int k = 0; k < n * n; k++) {
                pos[l][1][k][0] = (uint8_t)(k % n);
                pos[l][1][k][1] = (uint8_t)(k / n);
                pos[l][2][k][0] = (uint8_t)(k / n);
                pos[l][2][k][1] = (uint8_t)(k % n);
            }
        }
    }
};
const Scans SCAN;

// 8.6.4.2: the DCT matrix coefficient of basis k at sample n for a
// 32-point transform (smaller sizes take every (32 / size)-th basis)
struct Dct {
    int8_t m[32][32];
    Dct() {
        static const int T[32] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
                                  64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4};
        for (int k = 0; k < 32; k++)
            for (int n = 0; n < 32; n++) {
                int a = (k * (2 * n + 1)) % 128, v;
                if (a < 32)
                    v = T[a];
                else if (a < 64)
                    v = a == 32 ? 0 : -T[64 - a];
                else if (a < 96)
                    v = -T[a - 64];
                else
                    v = a == 96 ? 0 : T[128 - a];
                m[k][n] = (int8_t)std::max(-128, std::min(127, v));
            }
    }
};
const Dct DCT;
const int DST4[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

// 8.4.4.2.6: intraPredAngle by mode (2..34) and invAngle by mode (11..25)
const int INTRA_ANGLE[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                             -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                             -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
inline int inv_angle(int angle) {
    switch (angle) {
        case -2: return -4096;
        case -5: return -1638;
        case -9: return -910;
        case -13: return -630;
        case -17: return -482;
        case -21: return -390;
        case -26: return -315;
        default: return -256;
    }
}

// 8.5.3.3.3: the luma and chroma interpolation filters by fraction
const int LUMA_FILTER[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                               {-1, 4, -10, 58, 17, -5, 1, 0},
                               {-1, 4, -11, 40, 40, -11, 4, -1},
                               {0, 1, -5, 17, 58, -10, 4, -1}};
const int CHROMA_FILTER[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                 {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                 {-2, 16, 54, -4},  {-2, 10, 58, -2}};

// Table 8-12: beta' and tc' of the deblocking filter by Q
const uint8_t BETA_TABLE[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                                8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                                34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t TC_TABLE[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  1,  1,  1,  1, 1,
                              2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// ---------------------------------------------------------------------------
// Bits (7.2, 9.2) and the CABAC engines (9.3.2.5, 9.3.4.3, 9.3.5)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* p = nullptr;
    size_t nbytes = 0, pos = 0, end = 0;  // end: the bit after the last 1 bit

    void init(const uint8_t* data, size_t n) {
        p = data;
        nbytes = n;
        pos = 0;
        end = 0;
        for (size_t i = n; i-- > 0;)
            if (p[i]) {
                end = 8 * i + 8 - __builtin_ctz(p[i]) - 1;
                break;
            }
    }
    uint32_t peek32() const {
        size_t byte = pos >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 5; i++) v = (v << 8) | (byte + i < nbytes ? p[byte + i] : 0);
        return (uint32_t)(v >> (8 - (pos & 7)));
    }
    uint32_t u(int k) {
        if (k == 0) return 0;
        if (pos + k > 8 * nbytes) invalid("a syntax element runs past the end of its NAL unit");
        uint32_t v = peek32() >> (32 - k);
        pos += k;
        return v;
    }
    int bit() {  // past the end reads 0 (the CABAC engine reads ahead)
        int b = pos < 8 * nbytes ? (p[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
        pos++;
        return b;
    }
    uint32_t ue() {
        int lz = 0;
        while (!u(1))
            if (++lz > 31) invalid("an Exp-Golomb code of more than 31 leading zeros");
        return lz == 0 ? 0 : (uint32_t)((1ull << lz) - 1 + u(lz));
    }
    int32_t se() {
        uint32_t k = ue();
        return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
    }
    bool more_rbsp_data() const { return pos < end; }
    bool aligned() const { return (pos & 7) == 0; }
};

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int n = 0;

    void clear() {
        out.clear();
        acc = 0;
        n = 0;
    }
    void u(uint32_t v, int k) {
        if (k > 24) {
            u(v >> 16, k - 16);
            u(v & 0xFFFF, 16);
            return;
        }
        acc = (acc << k) | (v & ((1u << k) - 1));
        n += k;
        while (n >= 8) {
            n -= 8;
            out.push_back((uint8_t)(acc >> n));
        }
        acc &= (1ull << n) - 1;
    }
    void ue(uint32_t v) {
        uint64_t x = (uint64_t)v + 1;
        int len = 64 - __builtin_clzll(x);
        u(0, len - 1);
        if (len > 24) {
            u((uint32_t)(x >> 16), len - 16);
            u((uint32_t)(x & 0xFFFF), 16);
        } else {
            u((uint32_t)x, len);
        }
    }
    void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
    bool aligned() const { return n == 0; }
    void align(int bit) {
        while (n) u(bit, 1);
    }
    size_t bits() const { return 8 * out.size() + n; }
};

struct CabacDec {
    BitReader* br = nullptr;
    uint32_t range = 510, offset = 0;

    void init() {
        range = 510;
        offset = 0;
        for (int i = 0; i < 9; i++) offset = (offset << 1) | br->bit();
        if (offset >= 510) invalid("a CABAC substream starts with ivlOffset 510 or 511");
    }
    int decision(uint8_t& s) {
        int state = s & 63, mps = s >> 6;
        uint32_t lps = RANGE_LPS[state][(range >> 6) & 3];
        range -= lps;
        int bin;
        if (offset >= range) {
            bin = !mps;
            offset -= range;
            range = lps;
            if (state == 0) mps = 1 - mps;
            state = TRANS_LPS[state];
        } else {
            bin = mps;
            if (state < 62) state++;
        }
        s = (uint8_t)(state | (mps << 6));
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | br->bit();
        }
        return bin;
    }
    int bypass() {
        offset = (offset << 1) | br->bit();
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }
    int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | br->bit();
        }
        return 0;
    }
};

struct CabacEnc {
    BitWriter* bw = nullptr;
    uint32_t low = 0, range = 510;
    int outstanding = 0;
    bool first = true;

    void init() {
        low = 0;
        range = 510;
        outstanding = 0;
        first = true;
    }
    void put(int b) {
        if (first)
            first = false;
        else
            bw->u(b, 1);
        for (; outstanding > 0; outstanding--) bw->u(1 - b, 1);
    }
    void renorm() {
        while (range < 256) {
            if (low < 256) {
                put(0);
            } else if (low >= 512) {
                low -= 512;
                put(1);
            } else {
                low -= 256;
                outstanding++;
            }
            range <<= 1;
            low <<= 1;
        }
    }
    void decision(uint8_t& s, int bin) {
        int state = s & 63, mps = s >> 6;
        uint32_t lps = RANGE_LPS[state][(range >> 6) & 3];
        range -= lps;
        if (bin != mps) {
            low += range;
            range = lps;
            if (state == 0) mps = 1 - mps;
            state = TRANS_LPS[state];
        } else if (state < 62) {
            state++;
        }
        s = (uint8_t)(state | (mps << 6));
        renorm();
    }
    void bypass(int bin) {
        low <<= 1;
        if (bin) low += range;
        if (low >= 1024) {
            put(1);
            low -= 1024;
        } else if (low < 512) {
            put(0);
        } else {
            low -= 512;
            outstanding++;
        }
    }
    // a terminate bin of 1 flushes the engine (9.3.5.6): its last bit
    // written is the 1 of rbsp_stop_one_bit, alignment_bit_equal_to_one or
    // the bit before pcm_alignment_zero_bit
    void terminate(int bin) {
        range -= 2;
        if (bin) {
            low += range;
            range = 2;
            renorm();
            put((low >> 9) & 1);
            bw->u(((low >> 7) & 3) | 1, 2);
        } else {
            renorm();
        }
    }
};

// splitmix64: the writer's generator (the same stream on every machine)
struct Rng {
    uint64_t s = 0;
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    int range(int lo, int hi) { return hi <= lo ? lo : lo + (int)(next() % (uint64_t)(hi - lo + 1)); }
    bool chance(int percent) { return (int)(next() % 100) < percent; }
};

// The syntax engine: in reading mode each element comes from the bits; in
// writing mode (W) the value given is written and returned.
struct Syn {
    bool W = false;
    BitReader br;
    BitWriter bw;
    CabacDec cd;
    CabacEnc ce;
    Rng rng;
    uint8_t ctx[N_CTX];

    Syn() {
        cd.br = &br;
        ce.bw = &bw;
    }
    int u(int n, int v = 0) {
        if (W) {
            bw.u((uint32_t)v, n);
            return v;
        }
        return (int)br.u(n);
    }
    int flag(int v = 0) { return u(1, v); }
    int ue(int v = 0) {
        if (W) {
            if (v < 0) invalid("writer: ue(v) of %d", v);
            bw.ue((uint32_t)v);
            return v;
        }
        uint32_t k = br.ue();
        if (k > 0x7FFFFFFF) invalid("ue(v) out of range");
        return (int)k;
    }
    int se(int v = 0) {
        if (W) {
            bw.se(v);
            return v;
        }
        return br.se();
    }
    int bin(int ci, int b = 0) {
        if (W) {
            ce.decision(ctx[ci], b);
            return b;
        }
        return cd.decision(ctx[ci]);
    }
    int byp(int b = 0) {
        if (W) {
            ce.bypass(b);
            return b;
        }
        return cd.bypass();
    }
    int byps(int n, int v = 0) {  // n bypass bins, most significant first
        int x = 0;
        for (int i = n - 1; i >= 0; i--) x = (x << 1) | byp((v >> i) & 1);
        return x;
    }
    int term(int b = 0) {
        if (W) {
            ce.terminate(b);
            return b;
        }
        return cd.terminate();
    }
    // 9.3.2.2
    void init_contexts(int init_type, int qp) {
        for (int i = 0; i < N_CTX; i++) {
            int v = INIT_VALUE[init_type][i];
            int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
            int pre = clip3(1, 126, ((m * clip3(0, 51, qp)) >> 4) + n);
            ctx[i] = pre <= 63 ? (uint8_t)(63 - pre) : (uint8_t)((pre - 64) | 64);
        }
    }
    void start_engine() {
        if (W)
            ce.init();
        else
            cd.init();
    }
    // after a terminate bin of 1: the bits up to the next byte boundary
    void align_after_flush() {
        if (W) {
            bw.align(0);
        } else {
            while (!br.aligned())
                if (br.u(1)) invalid("a nonzero alignment bit after a CABAC flush");
        }
    }
};

// ---------------------------------------------------------------------------
// Parameter sets (7.3.2, Annex E)
// ---------------------------------------------------------------------------

struct ShortRps {
    int n_neg = 0, n_pos = 0;
    int delta[32] = {};  // the n_neg negative deltas (closest first), then the positive ones
    uint8_t used[32] = {};
    int n() const { return n_neg + n_pos; }
};

// the scaling factors m[x][y] of every size and matrixId, raster order
// (x + size * y); matrixId 3 * (inter) + cIdx
struct ScalingLists {
    uint8_t list[4][6][64];
    int dc[4][6];
    uint8_t sf[4][6][1024];

    void defaults() {
        for (int s = 0; s < 4; s++)
            for (int m = 0; m < 6; m++) {
                dc[s][m] = 16;
                for (int i = 0; i < 64; i++) {
                    if (s == 0) {
                        list[s][m][i] = 16;
                    } else {
                        int x = SCAN.pos[3][0][i][0], y = SCAN.pos[3][0][i][1];
                        list[s][m][i] = DEFAULT_8X8[m >= 3][8 * y + x];
                    }
                }
            }
    }
    // 7.4.5
    void derive() {
        for (int s = 0; s < 4; s++)
            for (int m = 0; m < 6; m++) {
                int n = 4 << s;
                for (int i = 0; i < (s == 0 ? 16 : 64); i++) {
                    int l = s == 0 ? 2 : 3;
                    int x = SCAN.pos[l][0][i][0], y = SCAN.pos[l][0][i][1];
                    int rep = s <= 1 ? 1 : (1 << (s - 1));
                    for (int j = 0; j < rep; j++)
                        for (int k = 0; k < rep; k++) sf[s][m][(x * rep + k) + n * (y * rep + j)] = list[s][m][i];
                }
                if (s >= 2) sf[s][m][0] = (uint8_t)dc[s][m];
            }
    }
};

struct SPS {
    bool valid = false;
    int id = 0, vps_id = 0, max_sub_layers = 1, profile_idc = 1;
    int chroma_format_idc = 1, W = 0, H = 0;
    int conf = 0, conf_l = 0, conf_r = 0, conf_t = 0, conf_b = 0;  // in chroma samples
    int bit_depth = 8, bit_depth_c = 8, log2_max_poc_lsb = 8;
    int max_dec_pic_buffering = 1, max_num_reorder = 0, max_latency_increase = 0;
    int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
    int max_th_depth_inter = 0, max_th_depth_intra = 0;
    int scaling_enabled = 0, scaling_present = 0;
    ScalingLists sl;
    int amp = 0, sao = 0, pcm = 0, pcm_bits = 8, pcm_bits_c = 8, log2_min_pcm = 3, log2_max_pcm = 3;
    int pcm_loop_filter_disabled = 0;
    int num_st_rps = 0;
    ShortRps st_rps[65];
    int long_term_present = 0, num_lt_sps = 0;
    int lt_lsb_sps[33] = {}, lt_used_sps[33] = {};
    int temporal_mvp = 0, strong_intra_smoothing = 0;
    int vui = 0, signal_type = 0, full_range = 0, colour_desc = 0, matrix = 2, field_seq = 0;
    int chroma_loc = -1;  // chroma_sample_loc_type_top_field, -1 where the VUI has none
    int frame_field_info = 0;
    int vui_extra = 0;  // writer: the VUI's other fields
    // derived
    int ctb = 16, ctbw = 0, ctbh = 0, nctb = 0, minw = 0;
};

struct PPS {
    bool valid = false;
    int id = 0, sps_id = 0, dependent_slices = 0, output_flag_present = 0, extra_bits = 0;
    int sign_hiding = 0, cabac_init_present = 0, num_ref_idx_default[2] = {1, 1}, init_qp = 26;
    int constrained_intra = 0, transform_skip = 0, cu_qp_delta = 0, diff_cu_qp_delta_depth = 0;
    int cb_qp_offset = 0, cr_qp_offset = 0, slice_chroma_offsets = 0;
    int weighted_pred = 0, weighted_bipred = 0, transquant_bypass = 0, tiles = 0, wpp = 0;
    int tile_cols = 1, tile_rows = 1, uniform = 1;
    std::vector<int> col_w, row_h;  // coded, in CTBs (the last one derived)
    int lf_across_tiles = 1, lf_across_slices = 0, deblock_control = 0, deblock_override = 0;
    int deblock_disabled = 0, beta_offset = 0, tc_offset = 0;  // the _div2 values
    int scaling_present = 0;
    ScalingLists sl;
    int lists_modification = 0, log2_par_mrg = 2, header_extension = 0;
};

void profile_tier_level(Syn& e, int max_sub_layers_minus1, int profile_idc) {
    e.u(2, 0);                 // general_profile_space
    e.u(1, 0);                 // general_tier_flag
    int p = e.u(5, profile_idc);  // general_profile_idc
    for (int j = 0; j < 32; j++) e.u(1, j == p || (p == 1 && j == 2));
    e.u(1, 1);  // general_progressive_source_flag
    e.u(1, 0);  // general_interlaced_source_flag
    e.u(1, 0);  // general_non_packed_constraint_flag
    e.u(1, 1);  // general_frame_only_constraint_flag
    e.u(32, 0);
    e.u(12, 0);     // 43 reserved bits and general_inbld_flag
    e.u(8, 153);    // general_level_idc (5.1)
    int prof[8] = {}, lev[8] = {};
    for (int i = 0; i < max_sub_layers_minus1; i++) {
        prof[i] = e.u(1, 0);
        lev[i] = e.u(1, 0);
    }
    if (max_sub_layers_minus1 > 0)
        for (int i = max_sub_layers_minus1; i < 8; i++) e.u(2, 0);
    for (int i = 0; i < max_sub_layers_minus1; i++) {
        if (prof[i]) {
            e.u(32, 0);
            e.u(32, 0);
            e.u(24, 0);
        }
        if (lev[i]) e.u(8, 0);
    }
}

void sub_layer_hrd(Syn& e, int cpb_cnt, int sub_pic) {
    for (int j = 0; j <= cpb_cnt; j++) {
        e.ue(20000);  // bit_rate_value_minus1
        e.ue(30000);  // cpb_size_value_minus1
        if (sub_pic) {
            e.ue(30000);
            e.ue(20000);
        }
        e.flag(0);  // cbr_flag
    }
}

// E.2.2
void hrd_parameters(Syn& e, int common, int max_sub_layers_minus1) {
    int nal = 0, vcl = 0, sub_pic = 0;
    if (common) {
        nal = e.flag(1);
        vcl = e.flag(0);
        if (nal || vcl) {
            sub_pic = e.flag(0);
            if (sub_pic) {
                e.u(8, 0);
                e.u(5, 0);
                e.u(1, 0);
                e.u(5, 0);
            }
            e.u(4, 0);  // bit_rate_scale
            e.u(4, 0);  // cpb_size_scale
            if (sub_pic) e.u(4, 0);
            e.u(5, 23);
            e.u(5, 23);
            e.u(5, 23);
        }
    }
    for (int i = 0; i <= max_sub_layers_minus1; i++) {
        int fixed_general = e.flag(1);
        int fixed_cvs = 1, low_delay = 0, cpb_cnt = 0;
        if (!fixed_general) fixed_cvs = e.flag(1);
        if (fixed_cvs)
            e.ue(0);  // elemental_duration_in_tc_minus1
        else
            low_delay = e.flag(0);
        if (!low_delay) cpb_cnt = e.ue(0);
        if (cpb_cnt > 31) invalid("cpb_cnt_minus1 above 31");
        if (nal) sub_layer_hrd(e, cpb_cnt, sub_pic);
        if (vcl) sub_layer_hrd(e, cpb_cnt, sub_pic);
    }
}

// E.2.1
void vui_parameters(Syn& e, SPS& s) {
    int x = s.vui_extra;
    if (e.flag(x)) {  // aspect_ratio_info_present_flag
        if (e.u(8, 255) == 255) {
            e.u(16, 1);
            e.u(16, 1);
        }
    }
    if (e.flag(x)) e.flag(0);  // overscan
    s.signal_type = e.flag(s.signal_type);
    if (s.signal_type) {
        e.u(3, 5);  // video_format
        s.full_range = e.flag(s.full_range);
        s.colour_desc = e.flag(s.colour_desc);
        if (s.colour_desc) {
            e.u(8, s.matrix == 6 ? 6 : 1);  // colour_primaries
            e.u(8, s.matrix == 6 ? 6 : 1);  // transfer_characteristics
            s.matrix = e.u(8, s.matrix);
        }
    }
    // chroma_loc_info_present_flag: the writer writes it where asked, or
    // (type 0) with the other fields
    if (e.flag(s.chroma_loc >= 0 || x)) {
        s.chroma_loc = e.ue(std::max(s.chroma_loc, 0));  // chroma_sample_loc_type_top_field
        int bottom = e.ue(std::max(s.chroma_loc, 0));
        if (s.chroma_loc > 5 || bottom > 5) invalid("chroma_sample_loc_type above 5");
    } else {
        s.chroma_loc = -1;
    }
    e.flag(0);  // neutral_chroma_indication_flag
    s.field_seq = e.flag(0);
    s.frame_field_info = e.flag(0);
    if (e.flag(x)) {  // default_display_window_flag (not applied, as ffmpeg by default)
        e.ue(1);
        e.ue(0);
        e.ue(0);
        e.ue(1);
    }
    if (e.flag(x)) {  // vui_timing_info_present_flag
        e.u(32, 1001);
        e.u(32, 60000);
        if (e.flag(1)) e.ue(0);  // poc proportional to timing
        if (e.flag(1)) hrd_parameters(e, 1, s.max_sub_layers - 1);
    }
    if (e.flag(x)) {  // bitstream_restriction_flag
        e.flag(0);
        e.flag(1);
        e.flag(0);
        e.ue(0);
        e.ue(2);
        e.ue(1);
        e.ue(15);
        e.ue(15);
    }
}

// 7.3.4: one list (scaling_list_data's loop body)
void scaling_list_data(Syn& e, ScalingLists& sl, Rng* rng) {
    for (int s = 0; s < 4; s++)
        for (int m = 0; m < 6; m += (s == 3) ? 3 : 1) {
            int step = s == 3 ? 3 : 1;
            int coded = 1, delta = 0;
            if (e.W) {  // the writer: a list of its own, or one predicted (a default where delta is 0)
                coded = rng->chance(60);
                if (!coded) delta = rng->range(0, m / step);
            }
            coded = e.flag(coded);  // scaling_list_pred_mode_flag
            if (!coded) {
                delta = e.ue(delta);  // scaling_list_pred_matrix_id_delta
                if (delta > m / step) invalid("scaling_list_pred_matrix_id_delta %d", delta);
                if (delta == 0) {
                    sl.dc[s][m] = 16;
                    for (int i = 0; i < 64; i++) {
                        int x = SCAN.pos[3][0][i][0], y = SCAN.pos[3][0][i][1];
                        sl.list[s][m][i] = s == 0 ? 16 : DEFAULT_8X8[m >= 3][8 * y + x];
                    }
                } else {
                    int r = m - delta * step;
                    memcpy(sl.list[s][m], sl.list[s][r], 64);
                    sl.dc[s][m] = sl.dc[s][r];
                }
            } else {
                int next = 8, n = std::min(64, 1 << (4 + (s << 1)));
                if (s > 1) {
                    int dc = e.W ? rng->range(1, 80) : 0;
                    dc = e.se(dc - 8) + 8;
                    if (dc < 1 || dc > 255) invalid("scaling_list_dc_coef_minus8 out of range");
                    sl.dc[s][m] = dc;
                    next = dc;
                }
                for (int i = 0; i < n; i++) {
                    int d = 0;
                    if (e.W) {
                        int want = rng->range(4, 60);
                        d = ((want - next + 128 + 256) % 256) - 128;
                    }
                    d = e.se(d);
                    if (d < -128 || d > 127) invalid("scaling_list_delta_coef out of range");
                    next = (next + d + 256) % 256;
                    if (next == 0) invalid("a scaling list entry of 0");
                    sl.list[s][m][i] = (uint8_t)next;
                }
            }
        }
}

// 7.3.7: st_ref_pic_set(idx) of a set table (the SPS's, with the slice's
// own set at index num)
void st_ref_pic_set(Syn& e, ShortRps* sets, int idx, int num, ShortRps& out, int pred_ref = -1) {
    int inter = 0;
    if (idx != 0) inter = e.flag(pred_ref >= 0);
    if (inter) {
        int delta_idx = 1;
        if (idx == num) delta_idx = e.ue(e.W ? idx - pred_ref - 1 : 0) + 1;
        if (delta_idx > idx) invalid("delta_idx_minus1 above the sets before");
        int ref = idx - delta_idx;
        const ShortRps& R = sets[ref];
        // the writer: deltaRps and the flags that give `out` from R
        int want_delta = 0, use[33] = {}, usedf[33] = {};
        if (e.W) {
            // found by the caller (rps_predictable): out.delta[31] carries deltaRps
            want_delta = out.delta[31];
            auto find = [&](int d, int& u) {
                for (int i = 0; i < out.n(); i++)
                    if (out.delta[i] == d) {
                        u = out.used[i];
                        return true;
                    }
                return false;
            };
            for (int j = 0; j <= R.n(); j++) {
                int d = (j < R.n() ? R.delta[j] : 0) + want_delta;
                int u = 0;
                use[j] = d != 0 && find(d, u);
                usedf[j] = use[j] ? u : 0;
            }
        }
        int sgn = e.flag(want_delta < 0);
        int abs_delta = e.ue(std::abs(want_delta) - 1) + 1;
        if (abs_delta > 32768) invalid("abs_delta_rps_minus1 out of range");
        int delta_rps = (1 - 2 * sgn) * abs_delta;
        int used_by[33], use_delta[33];
        for (int j = 0; j <= R.n(); j++) {
            used_by[j] = e.flag(usedf[j]);
            use_delta[j] = 1;
            if (!used_by[j]) use_delta[j] = e.flag(use[j]);
        }
        ShortRps o;
        int i = 0;
        auto put_neg = [&](int d, int u) {
            if (i >= 16) invalid("a short-term RPS of more than 16 pictures");
            o.delta[i] = d;
            o.used[i++] = (uint8_t)u;
        };
        int nR = R.n_neg;
        for (int j = R.n_pos - 1; j >= 0; j--) {
            int d = R.delta[nR + j] + delta_rps;
            if (d < 0 && use_delta[nR + j]) put_neg(d, used_by[nR + j]);
        }
        if (delta_rps < 0 && use_delta[R.n()]) put_neg(delta_rps, used_by[R.n()]);
        for (int j = 0; j < R.n_neg; j++) {
            int d = R.delta[j] + delta_rps;
            if (d < 0 && use_delta[j]) put_neg(d, used_by[j]);
        }
        o.n_neg = i;
        int pos[33], pu[33], np = 0;
        for (int j = R.n_neg - 1; j >= 0; j--) {
            int d = R.delta[j] + delta_rps;
            if (d > 0 && use_delta[j]) pos[np] = d, pu[np++] = used_by[j];
        }
        if (delta_rps > 0 && use_delta[R.n()]) pos[np] = delta_rps, pu[np++] = used_by[R.n()];
        for (int j = 0; j < R.n_pos; j++) {
            int d = R.delta[nR + j] + delta_rps;
            if (d > 0 && use_delta[nR + j]) pos[np] = d, pu[np++] = used_by[nR + j];
        }
        if (o.n_neg + np > 16) invalid("a short-term RPS of more than 16 pictures");
        for (int k = 0; k < np; k++) {
            o.delta[o.n_neg + k] = pos[k];
            o.used[o.n_neg + k] = (uint8_t)pu[k];
        }
        o.n_pos = np;
        if (e.W) {
            for (int k = 0; k < o.n(); k++)
                if (o.delta[k] != out.delta[k] || o.used[k] != out.used[k])
                    invalid("writer: an RPS that inter-RPS prediction does not give");
            o.delta[31] = out.delta[31];  // deltaRps, for the next time it is written
        }
        out = o;
    } else {
        int nn = e.ue(out.n_neg), np = e.ue(out.n_pos);
        if (nn > 16 || np > 16 || nn + np > 16) invalid("a short-term RPS of more than 16 pictures");
        ShortRps o;
        o.n_neg = nn;
        o.n_pos = np;
        int prev = 0;
        for (int i = 0; i < nn; i++) {
            int d = e.ue(e.W ? prev - out.delta[i] - 1 : 0) + 1;
            prev -= d;
            o.delta[i] = prev;
            o.used[i] = (uint8_t)e.flag(out.used[i]);
        }
        prev = 0;
        for (int i = 0; i < np; i++) {
            int d = e.ue(e.W ? out.delta[nn + i] - prev - 1 : 0) + 1;
            prev += d;
            o.delta[nn + i] = prev;
            o.used[nn + i] = (uint8_t)e.flag(out.used[nn + i]);
        }
        out = o;
    }
}

// whether `want` can be predicted from R (7.4.8) with some deltaRps: sets
// want.delta[31] to it
bool rps_predictable(const ShortRps& R, ShortRps& want) {
    for (int dr = -8; dr <= 8; dr++) {
        if (dr == 0) continue;
        bool ok = true;
        for (int i = 0; i < want.n() && ok; i++) {
            bool found = want.delta[i] == dr;
            for (int j = 0; j < R.n() && !found; j++) found = R.delta[j] + dr == want.delta[i];
            ok = found;
        }
        if (ok) {
            want.delta[31] = dr;
            return true;
        }
    }
    return false;
}

void sps_syntax(Syn& e, SPS& s, Rng* rng) {
    s.vps_id = e.u(4, s.vps_id);
    s.max_sub_layers = e.u(3, s.max_sub_layers - 1) + 1;
    if (s.max_sub_layers > 7) invalid("sps_max_sub_layers_minus1 7");
    e.flag(1);  // sps_temporal_id_nesting_flag
    profile_tier_level(e, s.max_sub_layers - 1, s.profile_idc);
    s.id = e.ue(s.id);
    if (s.id > 15) invalid("sps_seq_parameter_set_id %d", s.id);
    s.chroma_format_idc = e.ue(s.chroma_format_idc);
    if (s.chroma_format_idc == 3) e.flag(0);
    if (s.chroma_format_idc != 1) {
        static const char* names[4] = {"4:0:0", "4:2:0", "4:2:2", "4:4:4"};
        static char msg[96];
        snprintf(msg, sizeof msg, "chroma_format_idc %d (%s): the decoder takes 4:2:0 only",
                 s.chroma_format_idc, names[std::min(s.chroma_format_idc, 3)]);
        unsupported(msg);
    }
    s.W = e.ue(s.W);
    s.H = e.ue(s.H);
    s.conf = e.flag(s.conf);
    if (s.conf) {
        s.conf_l = e.ue(s.conf_l);
        s.conf_r = e.ue(s.conf_r);
        s.conf_t = e.ue(s.conf_t);
        s.conf_b = e.ue(s.conf_b);
    } else {
        s.conf_l = s.conf_r = s.conf_t = s.conf_b = 0;
    }
    s.bit_depth = e.ue(s.bit_depth - 8) + 8;
    s.bit_depth_c = e.ue(s.bit_depth_c - 8) + 8;
    if (s.bit_depth != 8 && s.bit_depth != 10) {
        static char msg[128];
        snprintf(msg, sizeof msg, "luma bit depth %d (bit_depth_luma_minus8 %d): the port decodes 8- and "
                 "10-bit HEVC only", s.bit_depth, s.bit_depth - 8);
        unsupported(msg);
    }
    if (s.bit_depth_c != s.bit_depth) {
        static char msg[128];
        snprintf(msg, sizeof msg, "chroma bit depth %d unlike the luma's %d: the port decodes equal "
                 "bit depths only", s.bit_depth_c, s.bit_depth);
        unsupported(msg);
    }
    s.log2_max_poc_lsb = e.ue(s.log2_max_poc_lsb - 4) + 4;
    if (s.log2_max_poc_lsb > 16) invalid("log2_max_pic_order_cnt_lsb_minus4 above 12");
    int ordering = e.flag(0);
    for (int i = ordering ? 0 : s.max_sub_layers - 1; i < s.max_sub_layers; i++) {
        s.max_dec_pic_buffering = e.ue(s.max_dec_pic_buffering - 1) + 1;
        s.max_num_reorder = e.ue(s.max_num_reorder);
        s.max_latency_increase = e.ue(s.max_latency_increase);
    }
    if (s.max_dec_pic_buffering > 16 || s.max_num_reorder > 16) invalid("a DPB of more than 16 pictures");
    s.log2_min_cb = e.ue(s.log2_min_cb - 3) + 3;
    s.log2_ctb = e.ue(s.log2_ctb - s.log2_min_cb) + s.log2_min_cb;
    s.log2_min_tb = e.ue(s.log2_min_tb - 2) + 2;
    s.log2_max_tb = e.ue(s.log2_max_tb - s.log2_min_tb) + s.log2_min_tb;
    if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_min_cb > s.log2_ctb)
        invalid("a CTB size other than 16, 32 or 64");
    if (s.log2_max_tb > 5 || s.log2_max_tb > s.log2_ctb || s.log2_min_tb >= s.log2_min_cb)
        invalid("transform block sizes out of range");
    s.max_th_depth_inter = e.ue(s.max_th_depth_inter);
    s.max_th_depth_intra = e.ue(s.max_th_depth_intra);
    if (s.max_th_depth_inter > s.log2_ctb - s.log2_min_tb || s.max_th_depth_intra > s.log2_ctb - s.log2_min_tb)
        invalid("max_transform_hierarchy_depth out of range");
    s.scaling_enabled = e.flag(s.scaling_enabled);
    s.sl.defaults();
    if (s.scaling_enabled) {
        s.scaling_present = e.flag(s.scaling_present);
        if (s.scaling_present) scaling_list_data(e, s.sl, rng);
    }
    s.sl.derive();
    s.amp = e.flag(s.amp);
    s.sao = e.flag(s.sao);
    s.pcm = e.flag(s.pcm);
    if (s.pcm) {
        s.pcm_bits = e.u(4, s.pcm_bits - 1) + 1;
        s.pcm_bits_c = e.u(4, s.pcm_bits_c - 1) + 1;
        s.log2_min_pcm = e.ue(s.log2_min_pcm - 3) + 3;
        s.log2_max_pcm = e.ue(s.log2_max_pcm - s.log2_min_pcm) + s.log2_min_pcm;
        s.pcm_loop_filter_disabled = e.flag(s.pcm_loop_filter_disabled);
        if (s.pcm_bits > s.bit_depth || s.pcm_bits_c > s.bit_depth_c || s.log2_max_pcm > 5)
            invalid("PCM sample bit depths or sizes out of range");
    }
    s.num_st_rps = e.ue(s.num_st_rps);
    if (s.num_st_rps > 64) invalid("num_short_term_ref_pic_sets above 64");
    for (int i = 0; i < s.num_st_rps; i++) {
        int pred = -1;
        if (e.W && i > 0 && rps_predictable(s.st_rps[i - 1], s.st_rps[i]) && rng->chance(70)) pred = i - 1;
        st_ref_pic_set(e, s.st_rps, i, s.num_st_rps, s.st_rps[i], pred);
    }
    s.long_term_present = e.flag(s.long_term_present);
    if (s.long_term_present) {
        s.num_lt_sps = e.ue(s.num_lt_sps);
        if (s.num_lt_sps > 32) invalid("num_long_term_ref_pics_sps above 32");
        for (int i = 0; i < s.num_lt_sps; i++) {
            s.lt_lsb_sps[i] = e.u(s.log2_max_poc_lsb, s.lt_lsb_sps[i]);
            s.lt_used_sps[i] = e.flag(s.lt_used_sps[i]);
        }
    }
    s.temporal_mvp = e.flag(s.temporal_mvp);
    s.strong_intra_smoothing = e.flag(s.strong_intra_smoothing);
    s.vui = e.flag(s.vui);
    if (s.vui) {
        vui_parameters(e, s);
    } else {
        s.signal_type = s.colour_desc = 0;
        s.chroma_loc = -1;
    }
    if (s.vui && s.field_seq) unsupported("field_seq_flag: the pictures are fields (interlaced)");
    if (e.flag(0)) {  // sps_extension_present_flag
        int range = e.flag(0), multilayer = e.flag(0), ext3d = e.flag(0), scc = e.flag(0);
        e.u(4, 0);
        if (range) {
            static const char* names[9] = {"transform_skip_rotation_enabled_flag",
                                           "transform_skip_context_enabled_flag",
                                           "implicit_rdpcm_enabled_flag",
                                           "explicit_rdpcm_enabled_flag",
                                           "extended_precision_processing_flag",
                                           "intra_smoothing_disabled_flag",
                                           "high_precision_offsets_enabled_flag",
                                           "persistent_rice_adaptation_enabled_flag",
                                           "cabac_bypass_alignment_enabled_flag"};
            for (int i = 0; i < 9; i++)
                if (e.flag(0)) {
                    static char msg[128];
                    snprintf(msg, sizeof msg, "the range extension (%s)", names[i]);
                    unsupported(msg);
                }
        }
        if (multilayer) unsupported("the multilayer extension (sps_multilayer_extension_flag)");
        if (ext3d) unsupported("the 3D extension (sps_3d_extension_flag)");
        if (scc) unsupported("the screen content coding extension (sps_scc_extension_flag)");
    }
    if (s.W <= 0 || s.H <= 0 || s.W % (1 << s.log2_min_cb) || s.H % (1 << s.log2_min_cb) || s.W > 16888 ||
        s.H > 16888)
        invalid("a picture size of %d x %d", s.W, s.H);
    if (2 * (s.conf_l + s.conf_r) >= s.W || 2 * (s.conf_t + s.conf_b) >= s.H) invalid("a conformance window wider than the picture");
    s.ctb = 1 << s.log2_ctb;
    s.ctbw = (s.W + s.ctb - 1) >> s.log2_ctb;
    s.ctbh = (s.H + s.ctb - 1) >> s.log2_ctb;
    s.nctb = s.ctbw * s.ctbh;
    s.valid = true;
}

void pps_syntax(Syn& e, PPS& p, Rng* rng) {
    p.id = e.ue(p.id);
    if (p.id > 63) invalid("pps_pic_parameter_set_id %d", p.id);
    p.sps_id = e.ue(p.sps_id);
    if (p.sps_id > 15) invalid("pps_seq_parameter_set_id %d", p.sps_id);
    p.dependent_slices = e.flag(p.dependent_slices);
    p.output_flag_present = e.flag(p.output_flag_present);
    p.extra_bits = e.u(3, p.extra_bits);
    p.sign_hiding = e.flag(p.sign_hiding);
    p.cabac_init_present = e.flag(p.cabac_init_present);
    p.num_ref_idx_default[0] = e.ue(p.num_ref_idx_default[0] - 1) + 1;
    p.num_ref_idx_default[1] = e.ue(p.num_ref_idx_default[1] - 1) + 1;
    if (p.num_ref_idx_default[0] > 15 || p.num_ref_idx_default[1] > 15) invalid("num_ref_idx_default above 15");
    p.init_qp = e.se(p.init_qp - 26) + 26;
    // -(26 + QpBdOffsetY) at the most bits the decoder takes (10); the
    // slice's SliceQpY is held to its own SPS's range
    if (p.init_qp < -12 || p.init_qp > 51) invalid("init_qp_minus26 out of range");
    p.constrained_intra = e.flag(p.constrained_intra);
    p.transform_skip = e.flag(p.transform_skip);
    p.cu_qp_delta = e.flag(p.cu_qp_delta);
    p.diff_cu_qp_delta_depth = p.cu_qp_delta ? e.ue(p.diff_cu_qp_delta_depth) : 0;
    if (p.diff_cu_qp_delta_depth > 3) invalid("diff_cu_qp_delta_depth above 3");
    p.cb_qp_offset = e.se(p.cb_qp_offset);
    p.cr_qp_offset = e.se(p.cr_qp_offset);
    if (std::abs(p.cb_qp_offset) > 12 || std::abs(p.cr_qp_offset) > 12) invalid("pps chroma QP offsets out of range");
    p.slice_chroma_offsets = e.flag(p.slice_chroma_offsets);
    p.weighted_pred = e.flag(p.weighted_pred);
    p.weighted_bipred = e.flag(p.weighted_bipred);
    p.transquant_bypass = e.flag(p.transquant_bypass);
    p.tiles = e.flag(p.tiles);
    p.wpp = e.flag(p.wpp);
    if (p.tiles) {
        p.tile_cols = e.ue(p.tile_cols - 1) + 1;
        p.tile_rows = e.ue(p.tile_rows - 1) + 1;
        if (p.tile_cols > 20 || p.tile_rows > 22) invalid("more tiles than a level allows");
        p.uniform = e.flag(p.uniform);
        if (!p.uniform) {
            p.col_w.resize(p.tile_cols);
            p.row_h.resize(p.tile_rows);
            for (int i = 0; i < p.tile_cols - 1; i++) p.col_w[i] = e.ue(p.col_w[i] - 1) + 1;
            for (int i = 0; i < p.tile_rows - 1; i++) p.row_h[i] = e.ue(p.row_h[i] - 1) + 1;
        }
        p.lf_across_tiles = e.flag(p.lf_across_tiles);
    } else {
        p.tile_cols = p.tile_rows = 1;
        p.uniform = 1;
        p.lf_across_tiles = 1;
    }
    p.lf_across_slices = e.flag(p.lf_across_slices);
    p.deblock_control = e.flag(p.deblock_control);
    if (p.deblock_control) {
        p.deblock_override = e.flag(p.deblock_override);
        p.deblock_disabled = e.flag(p.deblock_disabled);
        if (!p.deblock_disabled) {
            p.beta_offset = e.se(p.beta_offset);
            p.tc_offset = e.se(p.tc_offset);
            if (std::abs(p.beta_offset) > 6 || std::abs(p.tc_offset) > 6) invalid("pps deblocking offsets out of range");
        } else {
            p.beta_offset = p.tc_offset = 0;
        }
    } else {
        p.deblock_override = p.deblock_disabled = p.beta_offset = p.tc_offset = 0;
    }
    p.scaling_present = e.flag(p.scaling_present);
    p.sl.defaults();
    if (p.scaling_present) scaling_list_data(e, p.sl, rng);
    p.sl.derive();
    p.lists_modification = e.flag(p.lists_modification);
    p.log2_par_mrg = e.ue(p.log2_par_mrg - 2) + 2;
    if (p.log2_par_mrg > 6) invalid("log2_parallel_merge_level above CtbLog2SizeY");
    p.header_extension = e.flag(p.header_extension);
    if (e.flag(0)) {  // pps_extension_present_flag
        int range = e.flag(0), multilayer = e.flag(0), ext3d = e.flag(0), scc = e.flag(0);
        e.u(4, 0);
        if (range) unsupported("the range extension (pps_range_extension_flag)");
        if (multilayer) unsupported("the multilayer extension (pps_multilayer_extension_flag)");
        if (ext3d) unsupported("the 3D extension (pps_3d_extension_flag)");
        if (scc) unsupported("the screen content coding extension (pps_scc_extension_flag)");
    }
    p.valid = true;
}

// ---------------------------------------------------------------------------
// Pictures and slices
// ---------------------------------------------------------------------------

// the motion of one 4x4 block: pf bit 0 predFlagL0, bit 1 predFlagL1 (0:
// intra or not inter)
struct MvField {
    int16_t mv[2][2] = {{0, 0}, {0, 0}};
    int8_t ref[2] = {-1, -1};
    uint8_t pf = 0;
};

inline bool same_motion(const MvField& a, const MvField& b) {
    if (a.pf != b.pf) return false;
    for (int l = 0; l < 2; l++)
        if ((a.pf >> l & 1) && (a.ref[l] != b.ref[l] || a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1]))
            return false;
    return true;
}

// a slice's reference picture lists as TMVP reads them from a collocated
// picture: each entry's POC and whether it was long-term
struct SliceRefs {
    int n[2] = {0, 0};
    int poc[2][16] = {};
    uint8_t lt[2][16] = {};
};

struct Pic {
    int id = -1, poc = 0;
    int64_t tag = 0;  // the caller's name for it (the reader's sample, the writer's picture)
    bool in_dpb = false, ref = false, lt = false, output = false, missing = false;
    int latency = 0, out_flag = 1;
    int W = 0, H = 0;
    std::vector<uint8_t> y, cb, cr;           // the samples of an 8-bit picture
    std::vector<uint16_t> y16, cb16, cr16;    // of a 10-bit one
    std::vector<MvField> mvf;     // per 4x4 block
    std::vector<int16_t> ctb_refs;  // per CTB: index into refs
    std::vector<SliceRefs> refs;

    void alloc(int w, int h, int nctb, bool pixels, bool motion, int bd) {
        W = w;
        H = h;
        y.clear();
        cb.clear();
        cr.clear();
        y16.clear();
        cb16.clear();
        cr16.clear();
        if (pixels) {  // 1 << (BitDepth - 1): the samples of a generated picture (8.3.3.2)
            if (bd > 8) {
                y16.assign((size_t)w * h, (uint16_t)(1 << (bd - 1)));
                cb16.assign((size_t)w * h / 4, (uint16_t)(1 << (bd - 1)));
                cr16.assign((size_t)w * h / 4, (uint16_t)(1 << (bd - 1)));
            } else {
                y.assign((size_t)w * h, 128);
                cb.assign((size_t)w * h / 4, 128);
                cr.assign((size_t)w * h / 4, 128);
            }
        }
        mvf.assign(motion ? (size_t)(w / 4) * (h / 4) : 0, MvField());
        ctb_refs.assign(motion ? nctb : 0, 0);
        refs.assign(1, SliceRefs());
    }
    bool has_pixels() const { return !y.empty() || !y16.empty(); }
    template <int BD>
    Pel<BD>* plane(int c);
    template <int BD>
    const Pel<BD>* plane(int c) const { return const_cast<Pic*>(this)->plane<BD>(c); }
};
template <>
inline uint8_t* Pic::plane<8>(int c) { return c == 0 ? y.data() : c == 1 ? cb.data() : cr.data(); }
template <>
inline uint16_t* Pic::plane<10>(int c) { return c == 0 ? y16.data() : c == 1 ? cb16.data() : cr16.data(); }

struct SliceHdr {
    int nal_type = 1, tid = 0;
    int first = 1, no_output_prior = 0, pps_id = 0, dependent = 0, address = 0;
    int type = 2;  // 0 B, 1 P, 2 I
    int pic_output = 1, poc_lsb = 0;
    int st_sps = 0, st_idx = 0;
    ShortRps st;       // the slice's own set (st_sps 0)
    int st_pred = -1;  // writer: the set it predicts from
    int n_lt_sps = 0, n_lt_pics = 0;
    int lt_idx_sps[32] = {}, poc_lsb_lt[32] = {}, used_lt[32] = {}, msb_present[32] = {}, msb_cycle[32] = {};
    int tmvp = 0, sao_luma = 0, sao_chroma = 0;
    int num_ref_idx[2] = {0, 0}, mod_flag[2] = {0, 0}, list_entry[2][16] = {};
    int mvd_l1_zero = 0, cabac_init = 0, col_from_l0 = 1, col_ref_idx = 0;
    int luma_denom = 0, chroma_denom = 0;
    int lw_flag[2][16] = {}, cw_flag[2][16] = {};
    int lw[2][16] = {}, lo[2][16] = {}, cw[2][16][2] = {}, co[2][16][2] = {};  // derived weights, offsets
    int max_merge = 5, qp_delta = 0, cb_off = 0, cr_off = 0;
    int deblock_override = 0, deblock_disabled = 0, beta_offset = 0, tc_offset = 0, lf_across = 0;
    int n_entry = 0, offset_len = 1;
    std::vector<uint32_t> entry;
    int ext_len = 0;
    // derived
    int qp = 26, addr_rs = 0;  // SliceQpY, SliceAddrRs
    Pic* list[2][16] = {};
    bool is_lt[2][16] = {};
    int refs_idx = 0;  // its SliceRefs in the current picture
};

// one CTB's SAO parameters (7.3.8.3): type 0 none, 1 band, 2 edge
struct Sao {
    int type[3] = {0, 0, 0}, band[3] = {0, 0, 0}, eo[3] = {0, 0, 0};
    int off[3][5] = {};
};

// the writer's choices, from the caller (hevcw_open's options, in order)
struct WOpts {
    int width = 64, height = 48, log2_ctb = 4, log2_min_cb = 3, depth_inter = 1;
    int depth_intra = 1, amp = 0, tskip = 0, sign_hiding = 0, scaling = 0, sao = 0;
    int deblock = 1, deblock_override = 0, deblock_offsets = 0, cu_qp_delta = 0, qp_depth = 0;
    int cb_qp_offset = 0, cr_qp_offset = 0, slice_chroma_offsets = 0, bypass = 0, pcm = 0;
    int pcm_loop_filter_disabled = 0, constrained_intra = 0, max_slices = 1, dependent_slices = 0;
    int tile_cols = 1, tile_rows = 1, uniform = 1, wpp = 0, tmvp = 1, max_merge = 5;
    int par_mrg = 2, weighted = 0, long_term = 0, list_mod = 0, log2_max_poc_lsb = 8;
    int matrix = 1, full_range = 1, colour = 1, qp_min = 22, qp_max = 36, intra_percent = 15;
    int max_refs = 4, reorder = 0, lf_across_tiles = 1, lf_across_slices = 1;
    int cabac_init = 0, extra_bits = 0, header_ext = 0, vui_extra = 0, output_flag = 0;
    int lt_sps = 0, profile = 1, bit_depth = 8, chroma_loc = -1;
};
const int WOPTS_N = 55;
// the writer's odds (percent) of a skipped CU, of a merged PU and of PCM
// among eligible intra CUs; how far (luma samples) a prediction block may
// reach past the picture; the largest level it picks most of the time
const int SKIP_PERCENT = 25, MERGE_PERCENT = 40, PCM_PERCENT = 15, MV_RANGE = 24, MAX_LEVEL = 40;

// part_mode values (Table 7-10)
enum Part { P_2Nx2N, P_2NxN, P_Nx2N, P_NxN, P_2NxnU, P_2NxnD, P_nLx2N, P_nRx2N };

// per 4x4 block flags of the current picture
enum : uint8_t { F_INTRA = 1, F_SKIP = 2, F_PCM = 4, F_BYPASS = 8, F_CBF = 16 };

struct Decoder {
    Syn e;
    SPS sps[16];
    PPS pps[64];
    const SPS* act = nullptr;
    const PPS* actp = nullptr;
    int W = 0, H = 0, w4 = 0, h4 = 0;
    // the active PPS's tiles (6.5.1) and z-scan order (6.5.2)
    std::vector<int> col_bd, row_bd, rs2ts, ts2rs, tile_id, zs;
    int wtb = 0;  // width in minimum transform blocks
    std::vector<std::unique_ptr<Pic>> pool;
    std::array<int, 4> pool_geometry = {0, 0, 0, 0};  // W, H, CtbLog2SizeY, BitDepth
    Pic* cur = nullptr;
    Pic* done = nullptr;  // the last picture finished
    int next_id = 0;
    bool in_pic = false, skip_pic = false, first_pic = true, after_eos = false;
    int no_rasl_output = 1;  // of the last IRAP
    // the scan (hevc_scan): slice headers and the DPB, no slice data
    bool scanning = false;
    int64_t tag = 0;                // the next picture's
    std::vector<int64_t> out_tags;  // the pictures output, in order
    // 8.3.1: the previous TemporalId 0 picture's POC
    int prev_tid0_poc = 0;
    std::vector<SliceHdr> slices;
    SliceHdr* sh = nullptr;
    // per 4x4 block of the current picture
    std::vector<uint8_t> flags, depth, ipm, bs_v, bs_h;
    std::vector<int8_t> qpy;
    // per CTB
    std::vector<int> ctb_addr, ctb_slice;  // SliceAddrRs (-1: not decoded), index into slices
    std::vector<Sao> sao;
    // CTU decoding state
    int ctb_rs = 0, ctb_ts = 0;
    int qp_y = 26, qp_prev = 26, is_qp_coded = 0, qp_delta_val = 0;
    int tq_bypass = 0;
    uint8_t wpp_ctx[N_CTX], ds_ctx[N_CTX];
    bool wpp_saved = false;
    // writer
    WOpts wo;
    std::vector<uint8_t> nals, param_nals;

    int mintb_z(int x, int y) const { return zs[(y >> act->log2_min_tb) * wtb + (x >> act->log2_min_tb)]; }
    int ctb_of(int x, int y) const { return (y >> act->log2_ctb) * act->ctbw + (x >> act->log2_ctb); }
    int b4(int x, int y) const { return (y >> 2) * w4 + (x >> 2); }

    // 6.4.1: whether the block at (xn, yn) is available to the one at (xc, yc)
    bool avail(int xc, int yc, int xn, int yn) const {
        if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
        if (mintb_z(xn, yn) > mintb_z(xc, yc)) return false;
        int a = ctb_of(xn, yn), c = ctb_of(xc, yc);
        if (ctb_addr[a] < 0 || ctb_addr[a] != ctb_addr[c]) return false;
        return tile_id[rs2ts[a]] == tile_id[rs2ts[c]];
    }

    // 6.4.2: prediction block availability
    bool avail_pb(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int partIdx, int xn,
                  int yn) const {
        bool same = xCb <= xn && yCb <= yn && xn < xCb + nCbS && yn < yCb + nCbS;
        bool a;
        if (!same)
            a = avail(xPb, yPb, xn, yn);
        else
            a = !((nPbW << 1) == nCbS && (nPbH << 1) == nCbS && partIdx == 1 && yCb + nPbH <= yn &&
                  xCb + nPbW > xn);
        return a && !(flags[b4(xn, yn)] & F_INTRA);
    }

    // ---- activation: tiles and scans (6.5) ----

    void activate(const PPS& p) {
        const SPS& s = sps[p.sps_id];
        if (!s.valid) invalid("a PPS refers to a missing SPS %d", p.sps_id);
        // the pool's pictures fit the SPS they were made for (an SPS may
        // replace another in its slot)
        std::array<int, 4> geometry = {s.W, s.H, s.log2_ctb, s.bit_depth};
        bool size_change = !act || geometry != pool_geometry;
        pool_geometry = geometry;
        act = &s;
        actp = &p;
        W = s.W;
        H = s.H;
        w4 = W / 4;
        h4 = H / 4;
        if (size_change) {
            pool.clear();
            cur = done = nullptr;
        }
        int cw = s.ctbw, ch = s.ctbh;
        std::vector<int> colw(p.tile_cols), rowh(p.tile_rows);
        if (p.uniform) {
            for (int i = 0; i < p.tile_cols; i++) colw[i] = ((i + 1) * cw) / p.tile_cols - (i * cw) / p.tile_cols;
            for (int j = 0; j < p.tile_rows; j++) rowh[j] = ((j + 1) * ch) / p.tile_rows - (j * ch) / p.tile_rows;
        } else {
            int sum = 0;
            for (int i = 0; i < p.tile_cols - 1; i++) sum += colw[i] = p.col_w[i];
            colw[p.tile_cols - 1] = cw - sum;
            sum = 0;
            for (int j = 0; j < p.tile_rows - 1; j++) sum += rowh[j] = p.row_h[j];
            rowh[p.tile_rows - 1] = ch - sum;
        }
        for (int v : colw)
            if (v <= 0) invalid("tile columns wider than the picture");
        for (int v : rowh)
            if (v <= 0) invalid("tile rows taller than the picture");
        col_bd.assign(p.tile_cols + 1, 0);
        row_bd.assign(p.tile_rows + 1, 0);
        for (int i = 0; i < p.tile_cols; i++) col_bd[i + 1] = col_bd[i] + colw[i];
        for (int j = 0; j < p.tile_rows; j++) row_bd[j + 1] = row_bd[j] + rowh[j];
        int n = s.nctb;
        rs2ts.assign(n, 0);
        ts2rs.assign(n + 1, n);
        tile_id.assign(n + 1, -1);
        for (int rs = 0; rs < n; rs++) {
            int tbX = rs % cw, tbY = rs / cw, tileX = 0, tileY = 0;
            for (int i = 0; i < p.tile_cols; i++)
                if (tbX >= col_bd[i]) tileX = i;
            for (int j = 0; j < p.tile_rows; j++)
                if (tbY >= row_bd[j]) tileY = j;
            int v = 0;
            for (int i = 0; i < tileX; i++) v += rowh[tileY] * colw[i];
            for (int j = 0; j < tileY; j++) v += cw * rowh[j];
            v += (tbY - row_bd[tileY]) * colw[tileX] + tbX - col_bd[tileX];
            rs2ts[rs] = v;
            ts2rs[v] = rs;
        }
        for (int j = 0, t = 0; j < p.tile_rows; j++)
            for (int i = 0; i < p.tile_cols; i++, t++)
                for (int y = row_bd[j]; y < row_bd[j + 1]; y++)
                    for (int x = col_bd[i]; x < col_bd[i + 1]; x++) tile_id[rs2ts[y * cw + x]] = t;
        int lt = s.log2_min_tb, d = s.log2_ctb - lt;
        wtb = (cw << d);
        int htb = (ch << d);
        zs.assign((size_t)wtb * htb, 0);
        for (int y = 0; y < htb; y++)
            for (int x = 0; x < wtb; x++) {
                int rs = cw * (y >> d) + (x >> d);
                int v = rs2ts[rs] << (2 * d);
                for (int i = 0; i < d; i++) {
                    int m = 1 << i;
                    v += (m & x ? m * m : 0) + (m & y ? 2 * m * m : 0);
                }
                zs[(size_t)y * wtb + x] = v;
            }
    }

    // ---- pictures, POC, RPS and the DPB (8.3, C.5.2) ----

    Pic* new_pic() {
        Pic* p = nullptr;
        for (auto& q : pool)
            if (!q->in_dpb && q.get() != cur && q.get() != done) {
                p = q.get();
                break;
            }
        if (!p) {
            pool.emplace_back(new Pic());
            p = pool.back().get();
        }
        p->alloc(W, H, act->nctb, !e.W && !scanning, !scanning, act->bit_depth);
        p->id = next_id++;
        p->tag = tag;
        p->in_dpb = true;
        p->ref = p->lt = p->output = p->missing = false;
        p->latency = 0;
        p->out_flag = 1;
        return p;
    }

    static bool is_irap(int t) { return t >= 16 && t <= 23; }
    static bool is_idr(int t) { return t == 19 || t == 20; }
    static bool is_bla(int t) { return t >= 16 && t <= 18; }
    static bool is_rasl(int t) { return t == 8 || t == 9; }
    static bool is_radl(int t) { return t == 6 || t == 7; }
    static bool is_slnr(int t) { return t <= 14 && !(t & 1); }  // sub-layer non-reference

    // C.5.2.2 and C.5.2.3: output the picture of the smallest POC needed for output
    void bump() {
        Pic* best = nullptr;
        for (auto& q : pool)
            if (q->in_dpb && q->output && (!best || q->poc < best->poc)) best = q.get();
        if (!best) return;
        best->output = false;  // output: the caller takes each picture as it is decoded
        out_tags.push_back(best->tag);
        if (!best->ref) best->in_dpb = false;
    }
    int n_waiting() const {
        int n = 0;
        for (auto& q : pool) n += q->in_dpb && q->output;
        return n;
    }
    int n_dpb() const {
        int n = 0;
        for (auto& q : pool) n += q->in_dpb;
        return n;
    }
    bool latency_due() const {
        if (!act->max_latency_increase) return false;
        int lim = act->max_num_reorder + act->max_latency_increase - 1;
        for (auto& q : pool)
            if (q->in_dpb && q->output && q->latency >= lim) return true;
        return false;
    }

    void remove_unused() {
        for (auto& q : pool)
            if (q->in_dpb && !q->output && !q->ref && q.get() != cur) q->in_dpb = false;
    }

    // 8.3.3: a picture for a reference the DPB does not hold
    Pic* generate_missing(int poc, bool lt) {
        Pic* g = new_pic();
        g->poc = poc;
        g->ref = true;
        g->lt = lt;
        g->missing = true;
        g->output = false;
        for (auto& m : g->mvf) m = MvField();  // intra: no motion
        return g;
    }

    // 8.3.2: the RPS of the current picture's first slice; marks the DPB
    // and fills the slice's candidate lists
    Pic* rps_curr[3][16];  // StCurrBefore, StCurrAfter, LtCurr
    int n_curr[3] = {0, 0, 0};
    bool lt_curr_flag[16];

    void apply_rps(SliceHdr& s) {
        for (int k = 0; k < 3; k++) n_curr[k] = 0;
        if (is_idr(s.nal_type)) {
            for (auto& q : pool) q->ref = q->lt = false;
            return;
        }
        const SPS& sp = *act;
        const ShortRps& R = s.st_sps ? sp.st_rps[s.st_idx] : s.st;
        int maxlsb = 1 << sp.log2_max_poc_lsb;
        int st_poc[32], st_used[32], nst = 0;
        for (int i = 0; i < R.n(); i++) {
            st_poc[nst] = cur->poc + R.delta[i];
            st_used[nst++] = R.used[i] ? (i < R.n_neg ? 1 : 2) : 0;
        }
        int lt_poc[32], lt_used[32], lt_msb[32], nlt = s.n_lt_sps + s.n_lt_pics;
        for (int i = 0; i < nlt; i++) {
            int lsb = i < s.n_lt_sps ? sp.lt_lsb_sps[s.lt_idx_sps[i]] : s.poc_lsb_lt[i];
            int used = i < s.n_lt_sps ? sp.lt_used_sps[s.lt_idx_sps[i]] : s.used_lt[i];
            int poc = lsb;
            if (s.msb_present[i]) poc += cur->poc - s.msb_cycle[i] * maxlsb - (cur->poc & (maxlsb - 1));
            lt_poc[i] = poc;
            lt_used[i] = used;
            lt_msb[i] = s.msb_present[i];
        }
        std::vector<Pic*> keep;
        // long-term first: any reference picture by POC (or its lsb)
        Pic* ltp[32];
        for (int i = 0; i < nlt; i++) {
            Pic* found = nullptr;
            for (auto& q : pool) {
                Pic* p = q.get();
                if (!p->in_dpb || !p->ref || p == cur) continue;
                if (lt_msb[i] ? p->poc == lt_poc[i] : (p->poc & (maxlsb - 1)) == lt_poc[i]) found = p;
            }
            ltp[i] = found;
        }
        Pic* stp[32];
        for (int i = 0; i < nst; i++) {
            Pic* found = nullptr;
            for (auto& q : pool) {
                Pic* p = q.get();
                if (p->in_dpb && p->ref && !p->lt && p != cur && p->poc == st_poc[i]) found = p;
            }
            bool taken = false;
            for (int j = 0; j < nlt; j++) taken |= ltp[j] == found;
            stp[i] = taken ? nullptr : found;
        }
        for (int i = 0; i < nlt; i++)
            if (ltp[i]) ltp[i]->lt = true;
        for (int i = 0; i < nst; i++)
            if (stp[i]) keep.push_back(stp[i]);
        for (int i = 0; i < nlt; i++)
            if (ltp[i]) keep.push_back(ltp[i]);
        for (auto& q : pool)
            if (q->ref && std::find(keep.begin(), keep.end(), q.get()) == keep.end() && q.get() != cur)
                q->ref = q->lt = false;
        // missing pictures (8.3.3), for the current lists
        for (int i = 0; i < nst; i++)
            if (!stp[i] && st_used[i]) stp[i] = generate_missing(st_poc[i], false);
        for (int i = 0; i < nlt; i++)
            if (!ltp[i] && lt_used[i]) ltp[i] = generate_missing(lt_msb[i] ? lt_poc[i] : lt_poc[i], true);
        for (int i = 0; i < nst; i++)
            if (st_used[i] == 1) rps_curr[0][n_curr[0]++] = stp[i];
        for (int i = 0; i < nst; i++)
            if (st_used[i] == 2) rps_curr[1][n_curr[1]++] = stp[i];
        for (int i = 0; i < nlt; i++)
            if (lt_used[i]) rps_curr[2][n_curr[2]++] = ltp[i];
    }

    // 8.3.4: the slice's reference picture lists
    void ref_lists(SliceHdr& s) {
        int total = n_curr[0] + n_curr[1] + n_curr[2];
        SliceRefs sr;
        for (int l = 0; l < (s.type == 0 ? 2 : s.type == 1 ? 1 : 0); l++) {
            if (total == 0) invalid("a P or B slice with no reference picture in its RPS");
            int n = std::max(s.num_ref_idx[l], total);
            Pic* temp[32];
            bool temp_lt[32];
            int r = 0;
            const int order[2][3] = {{0, 1, 2}, {1, 0, 2}};
            while (r < n)
                for (int k = 0; k < 3; k++)
                    for (int i = 0; i < n_curr[order[l][k]] && r < n; i++, r++) {
                        temp[r] = rps_curr[order[l][k]][i];
                        temp_lt[r] = order[l][k] == 2;
                    }
            for (int i = 0; i < s.num_ref_idx[l]; i++) {
                int k = s.mod_flag[l] ? s.list_entry[l][i] : i;
                if (k >= n) invalid("list_entry_l%d beyond NumPicTotalCurr", l);
                s.list[l][i] = temp[k];
                s.is_lt[l][i] = temp_lt[k];
                sr.poc[l][i] = temp[k]->poc;
                sr.lt[l][i] = temp_lt[k];
            }
            sr.n[l] = s.num_ref_idx[l];
        }
        cur->refs.push_back(sr);
        s.refs_idx = (int)cur->refs.size() - 1;
    }

    void start_picture(SliceHdr& s) {
        const PPS& p = pps[s.pps_id];
        activate(p);
        const SPS& sp = *act;
        bool irap = is_irap(s.nal_type);
        if (irap) no_rasl_output = is_idr(s.nal_type) || is_bla(s.nal_type) || first_pic || after_eos;
        // 8.3.1
        int maxlsb = 1 << sp.log2_max_poc_lsb, msb;
        if (irap && no_rasl_output) {
            msb = 0;
        } else {
            int plsb = prev_tid0_poc & (maxlsb - 1), pmsb = prev_tid0_poc - plsb;
            if (s.poc_lsb < plsb && plsb - s.poc_lsb >= maxlsb / 2)
                msb = pmsb + maxlsb;
            else if (s.poc_lsb > plsb && s.poc_lsb - plsb > maxlsb / 2)
                msb = pmsb - maxlsb;
            else
                msb = pmsb;
        }
        int poc = msb + s.poc_lsb;
        // C.5.2.2: the DPB before the current picture
        if (irap && no_rasl_output && !first_pic) {
            int no_output = s.nal_type == 21 ? 1 : s.no_output_prior;  // a CRA: NoOutputOfPriorPicsFlag 1
            if (!no_output)
                while (n_waiting()) bump();
            for (auto& q : pool) q->in_dpb = q->ref = q->lt = q->output = false;
        }
        cur = nullptr;
        cur = new_pic();
        cur->poc = poc;
        cur->out_flag = (is_rasl(s.nal_type) && no_rasl_output) ? 0 : s.pic_output;
        apply_rps(s);
        if (!(irap && no_rasl_output && !first_pic)) {
            remove_unused();
            while (n_waiting() > sp.max_num_reorder || latency_due() || n_dpb() > sp.max_dec_pic_buffering) {
                int before = n_waiting();
                bump();
                if (n_waiting() == before) break;
            }
        }
        if (s.tid == 0 && !is_rasl(s.nal_type) && !is_radl(s.nal_type) && !is_slnr(s.nal_type))
            prev_tid0_poc = poc;
        first_pic = after_eos = false;
        slices.clear();
        in_pic = true;
        if (scanning) return;
        size_t n4 = (size_t)w4 * h4;
        flags.assign(n4, 0);
        depth.assign(n4, 0);
        ipm.assign(n4, 1);
        bs_v.assign(n4, 0);
        bs_h.assign(n4, 0);
        qpy.assign(n4, 0);
        ctb_addr.assign(sp.nctb, -1);
        ctb_slice.assign(sp.nctb, 0);
        sao.assign(sp.nctb, Sao());
    }

    void finish_picture() {
        in_pic = false;
        if (!cur) return;
        if (!e.W && !scanning) {
            deblock_picture();
            sao_picture();
        }
        // C.5.2.3: the current picture after decoding
        cur->ref = true;
        cur->lt = false;
        for (auto& q : pool)
            if (q->in_dpb && q->output) q->latency++;
        cur->output = cur->out_flag != 0;
        cur->latency = 0;
        while (n_waiting() > act->max_num_reorder || latency_due()) bump();
        done = cur;
    }

    // ---- the slice segment header (7.3.6) ----

    void slice_header(SliceHdr& s) {
        s.first = e.flag(s.first);
        if (s.nal_type >= 16 && s.nal_type <= 23) s.no_output_prior = e.flag(s.no_output_prior);
        s.pps_id = e.ue(s.pps_id);
        if (s.pps_id > 63 || !pps[s.pps_id].valid) invalid("a slice refers to a missing PPS %d", s.pps_id);
        const PPS& p = pps[s.pps_id];
        const SPS& sp = sps[p.sps_id];
        if (!sp.valid) invalid("a slice refers to a missing SPS %d", p.sps_id);
        int dep = e.W ? s.dependent : 0;
        s.dependent = 0;
        if (!s.first) {
            if (p.dependent_slices) s.dependent = e.flag(dep);
            s.address = e.u(ceil_log2(sp.nctb), s.address);
            if (s.address >= sp.nctb) invalid("slice_segment_address %d beyond the picture", s.address);
        } else {
            s.address = 0;
        }
        if (s.dependent) {
            if (slices.empty()) invalid("a dependent slice segment without a slice before it");
            SliceHdr d = slices.back();  // every field of the slice it belongs to
            d.first = s.first;
            d.dependent = 1;
            d.address = s.address;
            d.nal_type = s.nal_type;
            d.tid = s.tid;
            d.n_entry = s.n_entry;
            d.offset_len = s.offset_len;
            d.entry = s.entry;
            s = d;
        } else {
            for (int i = 0; i < p.extra_bits; i++) e.flag(0);
            s.type = e.ue(s.type);
            if (s.type > 2) invalid("slice_type %d", s.type);
            s.pic_output = p.output_flag_present ? e.flag(s.pic_output) : 1;
            if (!is_idr(s.nal_type)) {
                s.poc_lsb = e.u(sp.log2_max_poc_lsb, s.poc_lsb);
                s.st_sps = e.flag(s.st_sps);
                if (!s.st_sps) {
                    st_ref_pic_set(e, const_cast<ShortRps*>(sp.st_rps), sp.num_st_rps, sp.num_st_rps, s.st, s.st_pred);
                    s.st_idx = sp.num_st_rps;
                } else {
                    if (sp.num_st_rps == 0) invalid("short_term_ref_pic_set_sps_flag with no sets in the SPS");
                    s.st_idx = sp.num_st_rps > 1 ? e.u(ceil_log2(sp.num_st_rps), s.st_idx) : 0;
                    if (s.st_idx >= sp.num_st_rps) invalid("short_term_ref_pic_set_idx out of range");
                }
                if (sp.long_term_present) {
                    s.n_lt_sps = sp.num_lt_sps > 0 ? e.ue(s.n_lt_sps) : 0;
                    s.n_lt_pics = e.ue(s.n_lt_pics);
                    if (s.n_lt_sps > sp.num_lt_sps || s.n_lt_sps + s.n_lt_pics > 16)
                        invalid("too many long-term pictures");
                    int prev_cycle = 0;
                    for (int i = 0; i < s.n_lt_sps + s.n_lt_pics; i++) {
                        if (i < s.n_lt_sps) {
                            s.lt_idx_sps[i] = sp.num_lt_sps > 1 ? e.u(ceil_log2(sp.num_lt_sps), s.lt_idx_sps[i]) : 0;
                            if (s.lt_idx_sps[i] >= sp.num_lt_sps) invalid("lt_idx_sps out of range");
                        } else {
                            s.poc_lsb_lt[i] = e.u(sp.log2_max_poc_lsb, s.poc_lsb_lt[i]);
                            s.used_lt[i] = e.flag(s.used_lt[i]);
                        }
                        s.msb_present[i] = e.flag(s.msb_present[i]);
                        if (s.msb_present[i]) {
                            bool restart = i == 0 || i == s.n_lt_sps;
                            int coded = e.ue(e.W ? s.msb_cycle[i] - (restart ? 0 : prev_cycle) : 0);
                            s.msb_cycle[i] = coded + (restart ? 0 : prev_cycle);
                            prev_cycle = s.msb_cycle[i];
                        } else {
                            if (i == 0 || i == s.n_lt_sps) prev_cycle = 0;
                            s.msb_cycle[i] = prev_cycle;
                        }
                    }
                } else {
                    s.n_lt_sps = s.n_lt_pics = 0;
                }
                s.tmvp = sp.temporal_mvp ? e.flag(s.tmvp) : 0;
            } else {
                s.poc_lsb = 0;
                s.n_lt_sps = s.n_lt_pics = 0;
                s.st = ShortRps();
                s.st_sps = 0;
                s.tmvp = 0;
            }
            if (sp.sao) {
                s.sao_luma = e.flag(s.sao_luma);
                s.sao_chroma = e.flag(s.sao_chroma);
            } else {
                s.sao_luma = s.sao_chroma = 0;
            }
            int total = 0;
            if (!is_idr(s.nal_type)) {
                const ShortRps& R = s.st_sps ? sp.st_rps[s.st_idx] : s.st;
                for (int i = 0; i < R.n(); i++) total += R.used[i];
                for (int i = 0; i < s.n_lt_sps + s.n_lt_pics; i++)
                    total += i < s.n_lt_sps ? sp.lt_used_sps[s.lt_idx_sps[i]] : s.used_lt[i];
            }
            s.mod_flag[0] = s.mod_flag[1] = 0;
            if (s.type != 2) {
                if (e.flag(e.W ? (s.num_ref_idx[0] != p.num_ref_idx_default[0] ||
                                  (s.type == 0 && s.num_ref_idx[1] != p.num_ref_idx_default[1]))
                               : 0)) {
                    s.num_ref_idx[0] = e.ue(s.num_ref_idx[0] - 1) + 1;
                    if (s.type == 0) s.num_ref_idx[1] = e.ue(s.num_ref_idx[1] - 1) + 1;
                } else {
                    s.num_ref_idx[0] = p.num_ref_idx_default[0];
                    s.num_ref_idx[1] = p.num_ref_idx_default[1];
                }
                if (s.num_ref_idx[0] > 15 || s.num_ref_idx[1] > 15) invalid("num_ref_idx_active above 15");
                if (s.type != 0) s.num_ref_idx[1] = 0;
                if (p.lists_modification && total > 1) {
                    for (int l = 0; l < (s.type == 0 ? 2 : 1); l++) {
                        s.mod_flag[l] = e.flag(s.mod_flag[l]);
                        if (s.mod_flag[l])
                            for (int i = 0; i < s.num_ref_idx[l]; i++) {
                                s.list_entry[l][i] = e.u(ceil_log2(total), s.list_entry[l][i]);
                                if (s.list_entry[l][i] >= total) invalid("list_entry beyond NumPicTotalCurr");
                            }
                    }
                }
                s.mvd_l1_zero = s.type == 0 ? e.flag(s.mvd_l1_zero) : 0;
                s.cabac_init = p.cabac_init_present ? e.flag(s.cabac_init) : 0;
                s.col_from_l0 = 1;
                s.col_ref_idx = 0;
                if (s.tmvp) {
                    if (s.type == 0) s.col_from_l0 = e.flag(s.col_from_l0);
                    int l = s.col_from_l0 ? 0 : 1;
                    if (s.num_ref_idx[l] > 1) s.col_ref_idx = e.ue(s.col_ref_idx);
                    if (s.col_ref_idx >= s.num_ref_idx[l]) invalid("collocated_ref_idx out of range");
                }
                if ((p.weighted_pred && s.type == 1) || (p.weighted_bipred && s.type == 0)) pred_weight_table(s);
                s.max_merge = 5 - e.ue(5 - s.max_merge);
                if (s.max_merge < 1 || s.max_merge > 5) invalid("five_minus_max_num_merge_cand out of range");
            } else {
                s.num_ref_idx[0] = s.num_ref_idx[1] = 0;
            }
            s.qp_delta = e.se(s.qp_delta);
            s.qp = 26 + (p.init_qp - 26) + s.qp_delta;
            if (s.qp < -6 * (sp.bit_depth - 8) || s.qp > 51) invalid("SliceQpY %d", s.qp);  // -QpBdOffsetY
            if (p.slice_chroma_offsets) {
                s.cb_off = e.se(s.cb_off);
                s.cr_off = e.se(s.cr_off);
                if (std::abs(s.cb_off) > 12 || std::abs(s.cr_off) > 12 || std::abs(s.cb_off + p.cb_qp_offset) > 12 ||
                    std::abs(s.cr_off + p.cr_qp_offset) > 12)
                    invalid("slice chroma QP offsets out of range");
            } else {
                s.cb_off = s.cr_off = 0;
            }
            s.deblock_override = p.deblock_override ? e.flag(s.deblock_override) : 0;
            if (s.deblock_override) {
                s.deblock_disabled = e.flag(s.deblock_disabled);
                if (!s.deblock_disabled) {
                    s.beta_offset = e.se(s.beta_offset);
                    s.tc_offset = e.se(s.tc_offset);
                    if (std::abs(s.beta_offset) > 6 || std::abs(s.tc_offset) > 6) invalid("slice deblocking offsets out of range");
                }
            } else {
                s.deblock_disabled = p.deblock_disabled;
                s.beta_offset = p.beta_offset;
                s.tc_offset = p.tc_offset;
            }
            if (p.lf_across_slices && (s.sao_luma || s.sao_chroma || !s.deblock_disabled))
                s.lf_across = e.flag(s.lf_across);
            else
                s.lf_across = p.lf_across_slices;
        }
        if (p.tiles || p.wpp) {
            s.n_entry = e.ue(s.n_entry);
            if (s.n_entry > sp.nctb) invalid("num_entry_point_offsets beyond the CTBs");
            if (s.n_entry) {
                s.offset_len = e.ue(s.offset_len - 1) + 1;
                if (s.offset_len > 32) invalid("offset_len_minus1 above 31");
                s.entry.resize(s.n_entry);
                for (int i = 0; i < s.n_entry; i++) s.entry[i] = (uint32_t)e.u(s.offset_len, (int)(s.entry[i] - 1)) + 1;
            }
        } else {
            s.n_entry = 0;
        }
        if (p.header_extension) {
            s.ext_len = e.ue(s.ext_len);
            if (s.ext_len > 256) invalid("slice_segment_header_extension_length above 256");
            for (int i = 0; i < s.ext_len; i++) e.u(8, i * 37 & 255);
        }
        // byte_alignment()
        e.flag(1);
        if (e.W)
            e.bw.align(0);
        else
            while (!e.br.aligned())
                if (e.br.u(1)) invalid("a nonzero byte_alignment bit after the slice header");
    }

    // 7.3.6.3
    void pred_weight_table(SliceHdr& s) {
        s.luma_denom = e.ue(s.luma_denom);
        if (s.luma_denom > 7) invalid("luma_log2_weight_denom above 7");
        s.chroma_denom = e.se(s.chroma_denom - s.luma_denom) + s.luma_denom;
        if (s.chroma_denom < 0 || s.chroma_denom > 7) invalid("ChromaLog2WeightDenom out of range");
        for (int l = 0; l < (s.type == 0 ? 2 : 1); l++) {
            int n = s.num_ref_idx[l];
            for (int i = 0; i < n; i++) s.lw_flag[l][i] = e.flag(s.lw_flag[l][i]);
            for (int i = 0; i < n; i++) s.cw_flag[l][i] = e.flag(s.cw_flag[l][i]);
            for (int i = 0; i < n; i++) {
                if (s.lw_flag[l][i]) {
                    int d = e.se(s.lw[l][i] - (1 << s.luma_denom));
                    if (d < -128 || d > 127) invalid("delta_luma_weight out of range");
                    s.lw[l][i] = (1 << s.luma_denom) + d;
                    s.lo[l][i] = e.se(s.lo[l][i]);
                    if (s.lo[l][i] < -128 || s.lo[l][i] > 127) invalid("luma_offset out of range");
                } else {
                    s.lw[l][i] = 1 << s.luma_denom;
                    s.lo[l][i] = 0;
                }
                for (int j = 0; j < 2; j++) {
                    if (s.cw_flag[l][i]) {
                        int d = e.se(s.cw[l][i][j] - (1 << s.chroma_denom));
                        if (d < -128 || d > 127) invalid("delta_chroma_weight out of range");
                        int w = (1 << s.chroma_denom) + d;
                        s.cw[l][i][j] = w;
                        // the writer's offsets are kept as delta_chroma_offset values in co
                        int dof = e.se(e.W ? s.co[l][i][j] : 0);
                        if (dof < -512 || dof > 511) invalid("delta_chroma_offset out of range");
                        s.co[l][i][j] = dof;
                    } else {
                        s.cw[l][i][j] = 1 << s.chroma_denom;
                        s.co[l][i][j] = 0;
                    }
                }
            }
        }
    }
    // ChromaOffset (7-56) of an entry
    int chroma_offset(const SliceHdr& s, int l, int i, int j) const {
        if (!s.cw_flag[l][i]) return 0;
        return clip3(-128, 127, (128 + s.co[l][i][j] - ((128 * s.cw[l][i][j]) >> s.chroma_denom)));
    }

    // ---- CTU syntax (7.3.8) ----

    int init_type() const {
        return sh->type == 2 ? 0 : sh->type == 1 ? (sh->cabac_init ? 2 : 1) : (sh->cabac_init ? 1 : 2);
    }

    // 7.3.8.3
    void sao_syntax(int rx, int ry) {
        const SliceHdr& s = *sh;
        Sao& c = sao[ctb_rs];
        int merge_left = 0, merge_up = 0;
        int cw = act->ctbw;
        if (rx > 0) {
            bool in_slice = ctb_rs - 1 >= 0 && ctb_addr[ctb_rs - 1] == s.addr_rs;
            bool in_tile = tile_id[ctb_ts] == tile_id[rs2ts[ctb_rs - 1]];
            if (in_slice && in_tile) merge_left = e.bin(C_SAO_MERGE, e.W && e.rng.chance(25));
        }
        if (ry > 0 && !merge_left) {
            bool in_slice = ctb_addr[ctb_rs - cw] == s.addr_rs;
            bool in_tile = tile_id[ctb_ts] == tile_id[rs2ts[ctb_rs - cw]];
            if (in_slice && in_tile) merge_up = e.bin(C_SAO_MERGE, e.W && e.rng.chance(25));
        }
        if (merge_left) {
            c = sao[ctb_rs - 1];
            return;
        }
        if (merge_up) {
            c = sao[ctb_rs - cw];
            return;
        }
        c = Sao();
        Rng& r = e.rng;
        for (int ci = 0; ci < 3; ci++) {
            if (!((s.sao_luma && ci == 0) || (s.sao_chroma && ci > 0))) continue;
            if (ci < 2) {
                int t = e.W ? r.range(0, 2) : 0;
                t = e.bin(C_SAO_TYPE, t != 0) ? (e.byp(t == 2) ? 2 : 1) : 0;
                c.type[ci] = t;
            } else {
                c.type[2] = c.type[1];
            }
            if (!c.type[ci]) continue;
            int abs_[4];
            int cmax = (1 << (std::min(act->bit_depth, 10) - 5)) - 1;
            for (int i = 0; i < 4; i++) {  // TR, cMax (1 << (Min(bitDepth, 10) - 5)) - 1, bypass
                int want = e.W ? r.range(0, cmax) : 0, v = 0;
                while (v < cmax && e.byp(v < want)) v++;
                abs_[i] = v;
            }
            if (c.type[ci] == 1) {
                for (int i = 0; i < 4; i++) {
                    int sg = abs_[i] ? e.byp(e.W && r.chance(50)) : 0;
                    c.off[ci][i + 1] = sg ? -abs_[i] : abs_[i];
                }
                c.band[ci] = e.byps(5, e.W ? r.range(0, 31) : 0);
            } else {
                c.off[ci][1] = abs_[0];
                c.off[ci][2] = abs_[1];
                c.off[ci][3] = -abs_[2];
                c.off[ci][4] = -abs_[3];
                if (ci == 0) c.eo[0] = e.byps(2, e.W ? r.range(0, 3) : 0);
                if (ci == 1) c.eo[1] = e.byps(2, e.W ? r.range(0, 3) : 0);
                if (ci == 2) c.eo[2] = c.eo[1];
            }
        }
    }

    int log2_min_qg() const { return act->log2_ctb - actp->diff_cu_qp_delta_depth; }

    // 7.3.8.4
    void coding_quadtree(int x0, int y0, int log2, int d) {
        const SPS& sp = *act;
        int size = 1 << log2, split;
        if (x0 + size <= W && y0 + size <= H && log2 > sp.log2_min_cb) {
            int ctx = (avail(x0, y0, x0 - 1, y0) && depth[b4(x0 - 1, y0)] > d) +
                      (avail(x0, y0, x0, y0 - 1) && depth[b4(x0, y0 - 1)] > d);
            split = e.bin(C_SPLIT_CU + ctx, e.W && e.rng.chance(log2 == 6 ? 70 : log2 == 5 ? 55 : 45));
        } else {
            split = log2 > sp.log2_min_cb;
        }
        if (actp->cu_qp_delta && log2 >= log2_min_qg()) {
            is_qp_coded = 0;
            qp_delta_val = 0;
        }
        if (split) {
            int h = size / 2;
            coding_quadtree(x0, y0, log2 - 1, d + 1);
            if (x0 + h < W) coding_quadtree(x0 + h, y0, log2 - 1, d + 1);
            if (y0 + h < H) coding_quadtree(x0, y0 + h, log2 - 1, d + 1);
            if (x0 + h < W && y0 + h < H) coding_quadtree(x0 + h, y0 + h, log2 - 1, d + 1);
        } else {
            coding_unit(x0, y0, log2, d);
        }
    }

    // 8.6.1: qPY_PRED of the quantization group at (xQg, yQg), for the CU at (xCb, yCb)
    int qp_pred(int xCb, int yCb) {
        int mask = (1 << log2_min_qg()) - 1, xq = xCb & ~mask, yq = yCb & ~mask;
        int prev = qp_prev;
        int a = (avail(xCb, yCb, xq - 1, yq) && ctb_of(xq - 1, yq) == ctb_rs) ? qpy[b4(xq - 1, yq)] : prev;
        int b = (avail(xCb, yCb, xq, yq - 1) && ctb_of(xq, yq - 1) == ctb_rs) ? qpy[b4(xq, yq - 1)] : prev;
        return (a + b + 1) >> 1;
    }
    int qpy_pred_cu = 26;
    // QpBdOffsetY (= QpBdOffsetC: the depths are equal)
    int qp_bd_offset() const { return 6 * (act->bit_depth - 8); }
    void set_qp() {
        int off = qp_bd_offset();
        qp_y = ((qpy_pred_cu + qp_delta_val + 52 + 2 * off) % (52 + off)) - off;
    }

    void fill(std::vector<uint8_t>& a, int x0, int y0, int w, int h, uint8_t v) {
        for (int y = y0; y < y0 + h; y += 4)
            for (int x = x0; x < x0 + w; x += 4) a[b4(x, y)] = v;
    }
    void set_flag(int x0, int y0, int w, int h, uint8_t f) {
        for (int y = y0; y < y0 + h; y += 4)
            for (int x = x0; x < x0 + w; x += 4) flags[b4(x, y)] |= f;
    }

    // CU state shared with the PU and TU syntax
    int cu_intra = 0, cu_part = 0, cu_chroma_mode = 0;
    int merge0 = 0;

    // 7.3.8.5
    void coding_unit(int x0, int y0, int log2, int d) {
        const SPS& sp = *act;
        const SliceHdr& s = *sh;
        Rng& r = e.rng;
        int size = 1 << log2;
        qpy_pred_cu = qp_pred(x0, y0);
        set_qp();
        bool free = !e.W || sao_restores_chroma(x0, y0, size);
        tq_bypass = actp->transquant_bypass ? e.bin(C_TQ_BYPASS, e.W && free && r.chance(15)) : 0;
        fill(depth, x0, y0, size, size, (uint8_t)d);
        int skip = 0;
        // the writer plans the CU first
        int w_intra = 1;
        if (e.W && s.type != 2) w_intra = r.chance(wo.intra_percent);
        if (s.type != 2) {
            int ctx = (avail(x0, y0, x0 - 1, y0) && (flags[b4(x0 - 1, y0)] & F_SKIP)) +
                      (avail(x0, y0, x0, y0 - 1) && (flags[b4(x0, y0 - 1)] & F_SKIP));
            int want = e.W && !w_intra && r.chance(SKIP_PERCENT) && merge_ok_any(x0, y0, size);
            skip = e.bin(C_SKIP + ctx, want);
        }
        cu_intra = 0;
        cu_part = P_2Nx2N;
        int pcm = 0;
        if (skip) {
            set_flag(x0, y0, size, size, F_SKIP);
            if (tq_bypass) set_flag(x0, y0, size, size, F_BYPASS);
            prediction_unit(x0, y0, size, x0, y0, size, size, 0, true);
        } else {
            cu_intra = s.type == 2 ? 1 : e.bin(C_PRED_MODE, w_intra);  // pred_mode_flag 1: MODE_INTRA
            if (cu_intra) set_flag(x0, y0, size, size, F_INTRA);
            if (tq_bypass) set_flag(x0, y0, size, size, F_BYPASS);
            if (!cu_intra || log2 == sp.log2_min_cb) cu_part = part_mode(log2);
            if (cu_intra) {
                if (cu_part == P_2Nx2N && sp.pcm && log2 >= sp.log2_min_pcm && log2 <= sp.log2_max_pcm)
                    pcm = e.term(e.W && (free || !sp.pcm_loop_filter_disabled) && r.chance(PCM_PERCENT));
                if (pcm) {
                    set_flag(x0, y0, size, size, F_PCM);
                    pcm_sample(x0, y0, log2);
                } else {
                    intra_modes(x0, y0, log2);
                }
            } else {
                merge0 = 0;
                int h = size / 2, q = size / 4;
                switch (cu_part) {
                    case P_2Nx2N: prediction_unit(x0, y0, size, x0, y0, size, size, 0, false); break;
                    case P_2NxN:
                        prediction_unit(x0, y0, size, x0, y0, size, h, 0, false);
                        prediction_unit(x0, y0, size, x0, y0 + h, size, h, 1, false);
                        break;
                    case P_Nx2N:
                        prediction_unit(x0, y0, size, x0, y0, h, size, 0, false);
                        prediction_unit(x0, y0, size, x0 + h, y0, h, size, 1, false);
                        break;
                    case P_2NxnU:
                        prediction_unit(x0, y0, size, x0, y0, size, q, 0, false);
                        prediction_unit(x0, y0, size, x0, y0 + q, size, size - q, 1, false);
                        break;
                    case P_2NxnD:
                        prediction_unit(x0, y0, size, x0, y0, size, size - q, 0, false);
                        prediction_unit(x0, y0, size, x0, y0 + size - q, size, q, 1, false);
                        break;
                    case P_nLx2N:
                        prediction_unit(x0, y0, size, x0, y0, q, size, 0, false);
                        prediction_unit(x0, y0, size, x0 + q, y0, size - q, size, 1, false);
                        break;
                    case P_nRx2N:
                        prediction_unit(x0, y0, size, x0, y0, size - q, size, 0, false);
                        prediction_unit(x0, y0, size, x0 + size - q, y0, q, size, 1, false);
                        break;
                    default:  // P_NxN
                        prediction_unit(x0, y0, size, x0, y0, h, h, 0, false);
                        prediction_unit(x0, y0, size, x0 + h, y0, h, h, 1, false);
                        prediction_unit(x0, y0, size, x0, y0 + h, h, h, 2, false);
                        prediction_unit(x0, y0, size, x0 + h, y0 + h, h, h, 3, false);
                }
            }
        }
        if (!skip) pu_edges(x0, y0, size);
        cu_edges(x0, y0, size);
        if (!skip && !pcm) {
            int root = 1;
            if (!cu_intra && !(cu_part == P_2Nx2N && merge0)) root = e.bin(C_ROOT_CBF, e.W && r.chance(75));
            if (root) {
                int split = cu_intra && cu_part == P_NxN;
                int maxd = cu_intra ? sp.max_th_depth_intra + split : sp.max_th_depth_inter;
                transform_tree(x0, y0, x0, y0, log2, 0, 0, maxd, split, 0, 0);
            }
        }
        for (int y = y0; y < y0 + size; y += 4)
            for (int x = x0; x < x0 + size; x += 4) qpy[b4(x, y)] = (int8_t)qp_y;
        // the last CU of its quantization group (the one that holds the group's
        // last sample inside the picture) gives qPY_PREV to the next group
        int qs = 1 << log2_min_qg(), xq = x0 & ~(qs - 1), yq = y0 & ~(qs - 1);
        if (x0 + size >= std::min(xq + qs, W) && y0 + size >= std::min(yq + qs, H)) qp_prev = qp_y;
    }

    // the writer: whether ffmpeg leaves the chroma of a transquant bypass or
    // PCM CU here as the standard does under SAO (it restores the chroma of
    // a CTB's top-left quadrant only; the notes above)
    bool sao_restores_chroma(int x0, int y0, int size) const {
        if (!sh->sao_chroma || !sao[ctb_rs].type[1]) return true;
        const SPS& sp = *act;
        int cx = (ctb_rs % sp.ctbw) * sp.ctb, cy = (ctb_rs / sp.ctbw) * sp.ctb, pu = 1 << (sp.log2_min_cb - 1);
        int lx = std::min(sp.ctb / 2, (W - cx) / 2) & ~(pu - 1), ly = std::min(sp.ctb / 2, (H - cy) / 2) & ~(pu - 1);
        return x0 + size - cx <= lx && y0 + size - cy <= ly;
    }

    int part_mode(int log2) {
        const SPS& sp = *act;
        Rng& r = e.rng;
        int want = P_2Nx2N;
        if (e.W) {
            std::vector<int> legal = {P_2Nx2N};
            if (cu_intra) {
                if (log2 > sp.log2_min_tb) legal.push_back(P_NxN);
            } else {
                legal.push_back(P_2NxN);
                legal.push_back(P_Nx2N);
                if (log2 == sp.log2_min_cb && log2 > 3) legal.push_back(P_NxN);
                if (log2 > sp.log2_min_cb && sp.amp)
                    for (int p : {P_2NxnU, P_2NxnD, P_nLx2N, P_nRx2N}) legal.push_back(p);
            }
            want = legal[r.range(0, (int)legal.size() - 1)];
        }
        if (e.bin(C_PART_MODE, want == P_2Nx2N)) return P_2Nx2N;
        if (cu_intra) {
            if (log2 <= sp.log2_min_tb) invalid("part_mode NxN where the CB is the smallest transform block");
            return P_NxN;
        }
        if (log2 == sp.log2_min_cb) {
            if (e.bin(C_PART_MODE + 1, want == P_2NxN)) return P_2NxN;
            if (log2 == 3) return P_Nx2N;
            if (e.bin(C_PART_MODE + 2, want == P_Nx2N)) return P_Nx2N;
            return P_NxN;
        }
        if (!sp.amp) return e.bin(C_PART_MODE + 1, want == P_2NxN) ? P_2NxN : P_Nx2N;
        bool hor = want == P_2NxN || want == P_2NxnU || want == P_2NxnD;
        if (e.bin(C_PART_MODE + 1, hor)) {
            if (e.bin(C_PART_MODE + 3, want == P_2NxN)) return P_2NxN;
            return e.byp(want == P_2NxnD) ? P_2NxnD : P_2NxnU;
        }
        if (e.bin(C_PART_MODE + 3, want == P_Nx2N)) return P_Nx2N;
        return e.byp(want == P_nRx2N) ? P_nRx2N : P_nLx2N;
    }

    // one sample of the current picture, written as it is
    void put(int c, size_t i, int v) {
        if (act->bit_depth > 8)
            cur->plane<10>(c)[i] = (uint16_t)v;
        else
            cur->plane<8>(c)[i] = (uint8_t)v;
    }

    // 7.3.8.7
    void pcm_sample(int x0, int y0, int log2) {
        const SPS& sp = *act;
        e.align_after_flush();
        int n = 1 << log2;
        Rng& r = e.rng;
        for (int j = 0; j < n; j++)
            for (int i = 0; i < n; i++) {
                int v = e.u(sp.pcm_bits, e.W ? r.range(0, (1 << sp.pcm_bits) - 1) : 0);
                if (!e.W) put(0, (size_t)(y0 + j) * W + x0 + i, v << (sp.bit_depth - sp.pcm_bits));
            }
        for (int c = 1; c <= 2; c++) {
            for (int j = 0; j < n / 2; j++)
                for (int i = 0; i < n / 2; i++) {
                    int v = e.u(sp.pcm_bits_c, e.W ? r.range(0, (1 << sp.pcm_bits_c) - 1) : 0);
                    if (!e.W) put(c, (size_t)(y0 / 2 + j) * (W / 2) + x0 / 2 + i, v << (sp.bit_depth_c - sp.pcm_bits_c));
                }
        }
        e.start_engine();
    }

    // 8.4.2: candModeList of the prediction block at (x, y)
    void mpm_list(int x, int y, int* c) {
        int m[2];
        for (int k = 0; k < 2; k++) {
            int xn = k ? x : x - 1, yn = k ? y - 1 : y;
            if (!avail(x, y, xn, yn))
                m[k] = 1;
            else if (!(flags[b4(xn, yn)] & F_INTRA) || (flags[b4(xn, yn)] & F_PCM))
                m[k] = 1;
            else if (k == 1 && y - 1 < ((y >> act->log2_ctb) << act->log2_ctb))
                m[k] = 1;
            else
                m[k] = ipm[b4(xn, yn)];
        }
        int A = m[0], B = m[1];
        if (A == B) {
            if (A < 2) {
                c[0] = 0;
                c[1] = 1;
                c[2] = 26;
            } else {
                c[0] = A;
                c[1] = 2 + ((A + 29) % 32);
                c[2] = 2 + ((A - 2 + 1) % 32);
            }
        } else {
            c[0] = A;
            c[1] = B;
            c[2] = (A != 0 && B != 0) ? 0 : (A != 1 && B != 1) ? 1 : 26;
        }
    }

    // 7.3.8.5's intra mode syntax and 8.4.2, 8.4.3
    void intra_modes(int x0, int y0, int log2) {
        int size = 1 << log2, nb = cu_part == P_NxN ? 2 : 1, step = size / nb;
        int prev[4] = {}, idx[4] = {};
        Rng& r = e.rng;
        if (e.W) {  // pick each mode and code it as its MPMs allow
            for (int k = 0; k < nb * nb; k++) {
                int x = x0 + (k % 2) * step, y = y0 + (k / 2) * step, c[3];
                mpm_list(x, y, c);
                int mode = r.range(0, 34);
                if (r.chance(40)) mode = c[r.range(0, 2)];
                prev[k] = mode == c[0] || mode == c[1] || mode == c[2];
                if (prev[k]) {
                    idx[k] = mode == c[0] ? 0 : mode == c[1] ? 1 : 2;
                } else {
                    idx[k] = mode - (c[0] < mode) - (c[1] < mode) - (c[2] < mode);
                }
                fill(ipm, x, y, step, step, (uint8_t)mode);
            }
        }
        for (int k = 0; k < nb * nb; k++) prev[k] = e.bin(C_PREV_INTRA, prev[k]);
        for (int k = 0; k < nb * nb; k++) {
            if (prev[k]) {
                int v = 0;
                if (e.byp(idx[k] > 0)) v = 1 + e.byp(idx[k] > 1);
                idx[k] = v;
            } else {
                idx[k] = e.byps(5, idx[k]);
            }
        }
        for (int k = 0; k < nb * nb; k++) {
            int x = x0 + (k % 2) * step, y = y0 + (k / 2) * step, c[3], mode;
            mpm_list(x, y, c);
            if (prev[k]) {
                mode = c[idx[k]];
            } else {
                std::sort(c, c + 3);
                mode = idx[k];
                for (int i = 0; i < 3; i++)
                    if (mode >= c[i]) mode++;
            }
            fill(ipm, x, y, step, step, (uint8_t)mode);
        }
        int want = e.W ? r.range(0, 4) : 0;
        int cm = e.bin(C_CHROMA_MODE, want != 4) ? e.byps(2, want) : 4;
        int luma = ipm[b4(x0, y0)];
        static const int M[4] = {0, 26, 10, 1};
        cu_chroma_mode = cm == 4 ? luma : (M[cm] == luma ? 34 : M[cm]);
    }

    // ---- inter prediction syntax and motion (7.3.8.6, 8.5.3.2) ----

    static int16_t scale_mv(int mv, int td, int tb) {
        td = clip3(-128, 127, td);
        tb = clip3(-128, 127, tb);
        int tx = (16384 + (std::abs(td) >> 1)) / td;
        int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
        int p = dsf * mv;
        return (int16_t)clip3(-32768, 32767, sign(p) * ((std::abs(p) + 127) >> 8));
    }

    const MvField& mvf_at(int x, int y) const { return cur->mvf[b4(x, y)]; }

    // 8.5.3.2.8: the temporal MV of list X for refIdx; false where none
    bool temporal_mv(int xPb, int yPb, int nPbW, int nPbH, int refIdx, int X, int16_t* mv) {
        const SliceHdr& s = *sh;
        if (!s.tmvp) return false;
        Pic* col = s.list[(s.type == 0 && !s.col_from_l0) ? 1 : 0][s.col_ref_idx];
        if (!col) return false;
        auto at = [&](int x, int y) -> bool {
            x = (x >> 4) << 4;
            y = (y >> 4) << 4;
            const MvField& m = col->mvf[b4(x, y)];
            if (!m.pf) return false;
            const SliceRefs& cr = col->refs[col->ctb_refs[ctb_of(x, y)]];
            int list;
            if (!(m.pf & 1))
                list = 1;
            else if (m.pf == 1)
                list = 0;
            else {
                bool no_backward = true;
                for (int l = 0; l < 2; l++)
                    for (int i = 0; i < s.num_ref_idx[l]; i++)
                        if (s.list[l][i]->poc > cur->poc) no_backward = false;
                list = no_backward ? X : (s.col_from_l0 ? 1 : 0);
            }
            int ri = m.ref[list];
            bool col_lt = cr.lt[list][ri], cur_lt = s.is_lt[X][refIdx];
            if (col_lt != cur_lt) return false;
            int col_diff = col->poc - cr.poc[list][ri];
            int cur_diff = cur->poc - s.list[X][refIdx]->poc;
            for (int c = 0; c < 2; c++)
                mv[c] = (cur_lt || col_diff == cur_diff || col_diff == 0) ? m.mv[list][c]
                                                                         : scale_mv(m.mv[list][c], col_diff, cur_diff);
            return true;
        };
        int xBr = xPb + nPbW, yBr = yPb + nPbH;
        if ((yPb >> act->log2_ctb) == (yBr >> act->log2_ctb) && yBr < H && xBr < W && at(xBr, yBr)) return true;
        return at(xPb + (nPbW >> 1), yPb + (nPbH >> 1));
    }

    // 8.5.3.2.2-8.5.3.2.5: merge candidate k (k <= upto) of a prediction block
    int merge_list(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int partIdx, int part,
                   MvField* list, int upto) {
        const SliceHdr& s = *sh;
        int pml = actp->log2_par_mrg;
        if (pml > 2 && nCbS == 8) {
            xPb = xCb;
            yPb = yCb;
            nPbW = nPbH = nCbS;
            partIdx = 0;
        }
        int n = 0;
        auto ok = [&](int xn, int yn) {
            if ((xPb >> pml) == (xn >> pml) && (yPb >> pml) == (yn >> pml)) return false;
            return avail_pb(xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, partIdx, xn, yn);
        };
        int xA1 = xPb - 1, yA1 = yPb + nPbH - 1;
        bool a1 = ok(xA1, yA1) &&
                  !(partIdx == 1 && (part == P_Nx2N || part == P_nLx2N || part == P_nRx2N));
        if (a1) list[n++] = mvf_at(xA1, yA1);
        int xB1 = xPb + nPbW - 1, yB1 = yPb - 1;
        // a neighbour's availability (with the merge level's and the partition's exclusions)
        // decides the comparisons, whether or not it was pruned (as the reference decoder does)
        bool b1 = ok(xB1, yB1) && !(partIdx == 1 && (part == P_2NxN || part == P_2NxnU || part == P_2NxnD));
        if (b1 && !(a1 && same_motion(mvf_at(xA1, yA1), mvf_at(xB1, yB1)))) list[n++] = mvf_at(xB1, yB1);
        int xB0 = xPb + nPbW, yB0 = yPb - 1;
        bool b0 = ok(xB0, yB0) && !(b1 && same_motion(mvf_at(xB1, yB1), mvf_at(xB0, yB0)));
        if (b0) list[n++] = mvf_at(xB0, yB0);
        int xA0 = xPb - 1, yA0 = yPb + nPbH;
        bool a0 = ok(xA0, yA0) && !(a1 && same_motion(mvf_at(xA1, yA1), mvf_at(xA0, yA0)));
        if (a0) list[n++] = mvf_at(xA0, yA0);
        int xB2 = xPb - 1, yB2 = yPb - 1;
        bool b2 = n < 4 && ok(xB2, yB2) && !(a1 && same_motion(mvf_at(xA1, yA1), mvf_at(xB2, yB2))) &&
                  !(b1 && same_motion(mvf_at(xB1, yB1), mvf_at(xB2, yB2)));
        if (b2) list[n++] = mvf_at(xB2, yB2);
        if (n > upto) return n;
        MvField col;
        int16_t mv[2];
        if (temporal_mv(xPb, yPb, nPbW, nPbH, 0, 0, mv)) {
            col.pf |= 1;
            col.ref[0] = 0;
            col.mv[0][0] = mv[0];
            col.mv[0][1] = mv[1];
        }
        if (s.type == 0 && temporal_mv(xPb, yPb, nPbW, nPbH, 0, 1, mv)) {
            col.pf |= 2;
            col.ref[1] = 0;
            col.mv[1][0] = mv[0];
            col.mv[1][1] = mv[1];
        }
        if (col.pf) list[n++] = col;
        int max = s.max_merge;
        if (s.type == 0 && n > 1 && n < max) {
            static const int L0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
            static const int L1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
            int orig = n;
            for (int k = 0; k < orig * (orig - 1) && n < max; k++) {
                const MvField& a = list[L0[k]];
                const MvField& b = list[L1[k]];
                if ((a.pf & 1) && (b.pf & 2) &&
                    (s.list[0][a.ref[0]]->poc != s.list[1][b.ref[1]]->poc || a.mv[0][0] != b.mv[1][0] ||
                     a.mv[0][1] != b.mv[1][1])) {
                    MvField c;
                    c.pf = 3;
                    c.ref[0] = a.ref[0];
                    c.ref[1] = b.ref[1];
                    c.mv[0][0] = a.mv[0][0];
                    c.mv[0][1] = a.mv[0][1];
                    c.mv[1][0] = b.mv[1][0];
                    c.mv[1][1] = b.mv[1][1];
                    list[n++] = c;
                }
            }
        }
        int nref = s.type == 1 ? s.num_ref_idx[0] : std::min(s.num_ref_idx[0], s.num_ref_idx[1]);
        for (int z = 0; n < max; z++) {
            MvField c;
            int ri = z < nref ? z : 0;
            c.pf = s.type == 1 ? 1 : 3;
            c.ref[0] = (int8_t)ri;
            c.ref[1] = (int8_t)(s.type == 1 ? -1 : ri);
            list[n++] = c;
        }
        return n;
    }

    // 8.5.3.2.6 and 8.5.3.2.7: mvpLX for refIdx (mvp_flag picks one of two)
    void amvp(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int partIdx, int X, int refIdx,
              int flag, int16_t* out) {
        const SliceHdr& s = *sh;
        Pic* target = s.list[X][refIdx];
        bool target_lt = s.is_lt[X][refIdx];
        int Y = 1 - X;
        auto pb_ok = [&](int xn, int yn) { return avail_pb(xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, partIdx, xn, yn); };
        int16_t mvA[2] = {0, 0}, mvB[2] = {0, 0};
        bool availA = false, availB = false;
        int xA[2] = {xPb - 1, xPb - 1}, yA[2] = {yPb + nPbH, yPb + nPbH - 1};
        bool okA[2] = {pb_ok(xA[0], yA[0]), pb_ok(xA[1], yA[1])};
        bool scaled_flag = okA[0] || okA[1];
        // the same picture, no scaling
        for (int k = 0; k < 2 && !availA; k++) {
            if (!okA[k]) continue;
            const MvField& m = mvf_at(xA[k], yA[k]);
            if ((m.pf >> X & 1) && s.list[X][m.ref[X]]->poc == target->poc) {
                availA = true;
                mvA[0] = m.mv[X][0];
                mvA[1] = m.mv[X][1];
            } else if ((m.pf >> Y & 1) && s.list[Y][m.ref[Y]]->poc == target->poc) {
                availA = true;
                mvA[0] = m.mv[Y][0];
                mvA[1] = m.mv[Y][1];
            }
        }
        for (int k = 0; k < 2 && !availA; k++) {
            if (!okA[k]) continue;
            const MvField& m = mvf_at(xA[k], yA[k]);
            for (int L : {X, Y}) {
                if (availA || !(m.pf >> L & 1) || s.is_lt[L][m.ref[L]] != target_lt) continue;
                availA = true;
                Pic* rp = s.list[L][m.ref[L]];
                mvA[0] = m.mv[L][0];
                mvA[1] = m.mv[L][1];
                if (!s.is_lt[L][m.ref[L]] && !target_lt && rp->poc != target->poc)
                    for (int c = 0; c < 2; c++) mvA[c] = scale_mv(mvA[c], cur->poc - rp->poc, cur->poc - target->poc);
            }
        }
        int xB[3] = {xPb + nPbW, xPb + nPbW - 1, xPb - 1}, yB[3] = {yPb - 1, yPb - 1, yPb - 1};
        bool okB[3] = {pb_ok(xB[0], yB[0]), pb_ok(xB[1], yB[1]), pb_ok(xB[2], yB[2])};
        for (int k = 0; k < 3 && !availB; k++) {
            if (!okB[k]) continue;
            const MvField& m = mvf_at(xB[k], yB[k]);
            if ((m.pf >> X & 1) && s.list[X][m.ref[X]]->poc == target->poc) {
                availB = true;
                mvB[0] = m.mv[X][0];
                mvB[1] = m.mv[X][1];
            } else if ((m.pf >> Y & 1) && s.list[Y][m.ref[Y]]->poc == target->poc) {
                availB = true;
                mvB[0] = m.mv[Y][0];
                mvB[1] = m.mv[Y][1];
            }
        }
        if (!scaled_flag && availB) {
            availA = true;
            mvA[0] = mvB[0];
            mvA[1] = mvB[1];
        }
        if (!scaled_flag) {
            availB = false;
            for (int k = 0; k < 3 && !availB; k++) {
                if (!okB[k]) continue;
                const MvField& m = mvf_at(xB[k], yB[k]);
                for (int L : {X, Y}) {
                    if (availB || !(m.pf >> L & 1) || s.is_lt[L][m.ref[L]] != target_lt) continue;
                    availB = true;
                    Pic* rp = s.list[L][m.ref[L]];
                    mvB[0] = m.mv[L][0];
                    mvB[1] = m.mv[L][1];
                    if (!s.is_lt[L][m.ref[L]] && !target_lt && rp->poc != target->poc)
                        for (int c = 0; c < 2; c++) mvB[c] = scale_mv(mvB[c], cur->poc - rp->poc, cur->poc - target->poc);
                }
            }
        }
        int16_t cand[3][2];
        int n = 0;
        if (availA) cand[n][0] = mvA[0], cand[n++][1] = mvA[1];
        if (availB && !(availA && mvA[0] == mvB[0] && mvA[1] == mvB[1])) cand[n][0] = mvB[0], cand[n++][1] = mvB[1];
        if (n < 2) {
            int16_t mv[2];
            if (temporal_mv(xPb, yPb, nPbW, nPbH, refIdx, X, mv)) cand[n][0] = mv[0], cand[n++][1] = mv[1];
        }
        while (n < 2) cand[n][0] = 0, cand[n++][1] = 0;
        out[0] = cand[flag][0];
        out[1] = cand[flag][1];
    }

    // whether a prediction block with this motion stays within the writer's window
    bool in_window(int xPb, int yPb, int w, int h, const MvField& m) const {
        for (int l = 0; l < 2; l++) {
            if (!(m.pf >> l & 1)) continue;
            int x = xPb + (m.mv[l][0] >> 2), y = yPb + (m.mv[l][1] >> 2);
            if (x < -MV_RANGE || y < -MV_RANGE || x + w > W + MV_RANGE || y + h > H + MV_RANGE) return false;
        }
        return true;
    }
    // the writer: whether some merge candidate of a 2Nx2N CU stays in the window
    bool merge_ok_any(int x0, int y0, int size) {
        MvField list[5];
        int n = merge_list(x0, y0, size, x0, y0, size, size, 0, P_2Nx2N, list, 4);
        for (int i = 0; i < std::min(n, sh->max_merge); i++)
            if (in_window(x0, y0, size, size, list[i])) return true;
        return false;
    }

    void mvd_coding(int* mvd) {
        int g0[2], g1[2] = {0, 0};
        for (int c = 0; c < 2; c++) g0[c] = e.bin(C_MVD_G0, mvd[c] != 0);
        for (int c = 0; c < 2; c++)
            if (g0[c]) g1[c] = e.bin(C_MVD_G1, std::abs(mvd[c]) > 1);
        for (int c = 0; c < 2; c++) {
            if (!g0[c]) {
                mvd[c] = 0;
                continue;
            }
            int a = 1;
            if (g1[c]) a = 2 + eg_bypass(1, std::abs(mvd[c]) - 2);
            int sg = e.byp(mvd[c] < 0);
            mvd[c] = sg ? -a : a;
        }
    }
    // k-th order Exp-Golomb, bypass bins (9.3.3.3)
    int eg_bypass(int k, int v) {
        int abs_v = 0;
        while (e.byp(e.W && v >= (1 << k))) {
            if (e.W) v -= 1 << k;
            abs_v += 1 << k;
            if (++k > 31) invalid("an Exp-Golomb bypass code too long");
        }
        return abs_v + e.byps(k, e.W ? v : 0);
    }

    // 7.3.8.6
    void prediction_unit(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int partIdx, bool skip) {
        const SliceHdr& s = *sh;
        Rng& r = e.rng;
        MvField m;
        int merge = skip;
        int merge_idx = 0;
        // the writer's choice
        MvField cands[5];
        int ncand = 0;
        if (e.W) {
            ncand = merge_list(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, cu_part, cands, 4);
            ncand = std::min(ncand, s.max_merge);
            std::vector<int> good;
            for (int i = 0; i < ncand; i++) {
                MvField c = cands[i];
                if (c.pf == 3 && w + h == 12) c.pf = 1;
                if (in_window(xPb, yPb, w, h, c)) good.push_back(i);
            }
            if (!skip) merge = !good.empty() && r.chance(MERGE_PERCENT);
            if (merge) {
                if (good.empty()) invalid("writer: no merge candidate within the window");
                merge_idx = good[r.range(0, (int)good.size() - 1)];
            }
        }
        if (!skip) merge = e.bin(C_MERGE_FLAG, merge);
        if (partIdx == 0) merge0 = merge;
        if (merge) {
            if (s.max_merge > 1) {  // TR, cMax MaxNumMergeCand - 1, first bin context-coded
                int v = 0;
                if (e.bin(C_MERGE_IDX, merge_idx > 0)) {
                    v = 1;
                    while (v < s.max_merge - 1 && e.byp(merge_idx > v)) v++;
                }
                merge_idx = v;
            }
            MvField list[5];
            merge_list(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, cu_part, list, merge_idx);
            m = list[merge_idx];
            if (m.pf == 3 && w + h == 12) {
                m.pf = 1;
                m.ref[1] = -1;
            }
        } else {
            int idc = 0;  // 0 PRED_L0, 1 PRED_L1, 2 PRED_BI
            int ri[2] = {0, 0}, flag[2] = {0, 0}, mvd[2][2] = {{0, 0}, {0, 0}};
            if (e.W) {  // every choice first: the predictors depend on the neighbours only
                idc = s.type == 0 ? (w + h == 12 ? r.range(0, 1) : r.range(0, 2)) : 0;
                for (int X = 0; X < 2; X++) {
                    if (X == 1 && s.type != 0) break;
                    ri[X] = r.range(0, s.num_ref_idx[X] - 1);
                    flag[X] = r.range(0, 1);
                    int16_t mvp[2];
                    amvp(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, X, ri[X], flag[X], mvp);
                    for (int c = 0; c < 2; c++) {
                        int lo = 4 * ((c ? -yPb : -xPb) - MV_RANGE);
                        int hi = 4 * ((c ? H - yPb - h : W - xPb - w) + MV_RANGE);
                        int v = r.chance(60) ? mvp[c] + r.range(-24, 24) : r.range(lo, hi);
                        mvd[X][c] = clip3(lo, hi, v) - mvp[c];
                    }
                    if (X == 1 && s.mvd_l1_zero && idc == 2) {  // MvdL1 0: the predictor must do
                        MvField t;
                        t.pf = 1;
                        t.mv[0][0] = mvp[0];
                        t.mv[0][1] = mvp[1];
                        if (!in_window(xPb, yPb, w, h, t)) idc = 0;
                    }
                }
            }
            if (s.type == 0) {
                if (w + h != 12) {
                    int ctx = depth[b4(xCb, yCb)];
                    if (e.bin(C_INTER_PRED + ctx, idc == 2))
                        idc = 2;
                    else
                        idc = e.bin(C_INTER_PRED + 4, idc == 1);
                } else {
                    idc = e.bin(C_INTER_PRED + 4, idc == 1);
                }
            }
            for (int X = 0; X < 2; X++) {
                if (X == 0 ? idc == 1 : idc == 0) continue;
                if (s.num_ref_idx[X] > 1) {  // TR, cMax num_ref_idx - 1, two context-coded bins
                    int v = 0, cmax = s.num_ref_idx[X] - 1;
                    while (v < cmax && (v < 2 ? e.bin(C_REF_IDX + v, ri[X] > v) : e.byp(ri[X] > v))) v++;
                    ri[X] = v;
                } else {
                    ri[X] = 0;
                }
                if (X == 1 && s.mvd_l1_zero && idc == 2)
                    mvd[1][0] = mvd[1][1] = 0;
                else
                    mvd_coding(mvd[X]);
                flag[X] = e.bin(C_MVP, flag[X]);
                int16_t mvp[2];
                amvp(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, X, ri[X], flag[X], mvp);
                m.pf |= 1 << X;
                m.ref[X] = (int8_t)ri[X];
                for (int c = 0; c < 2; c++) {
                    int u = (mvp[c] + mvd[X][c] + 65536) & 0xFFFF;
                    m.mv[X][c] = (int16_t)(u >= 32768 ? u - 65536 : u);
                }
            }
        }
        for (int y = yPb; y < yPb + h; y += 4)
            for (int x = xPb; x < xPb + w; x += 4) cur->mvf[b4(x, y)] = m;
        if (!e.W) predict_inter(xPb, yPb, w, h, m);
    }

    // ---- the transform tree (7.3.8.8-7.3.8.12) ----

    static int scan_of_mode(int mode) { return (mode >= 6 && mode <= 14) ? 2 : (mode >= 22 && mode <= 30) ? 1 : 0; }

    void transform_tree(int x0, int y0, int xBase, int yBase, int log2, int d, int blk, int maxd, int intra_split,
                        int cbf_cb_up, int cbf_cr_up) {
        const SPS& sp = *act;
        Rng& r = e.rng;
        int split;
        if (log2 <= sp.log2_max_tb && log2 > sp.log2_min_tb && d < maxd && !(intra_split && d == 0)) {
            split = e.bin(C_SPLIT_TR + 5 - log2, e.W && r.chance(40));
        } else {
            int inter_split = sp.max_th_depth_inter == 0 && !cu_intra && cu_part != P_2Nx2N && d == 0;
            split = log2 > sp.log2_max_tb || (intra_split && d == 0) || inter_split;
        }
        int cbf_cb = cbf_cb_up, cbf_cr = cbf_cr_up;
        if (log2 > 2) {
            cbf_cb = (d == 0 || cbf_cb_up) ? e.bin(C_CBF_CHROMA + d, e.W && r.chance(45)) : 0;
            cbf_cr = (d == 0 || cbf_cr_up) ? e.bin(C_CBF_CHROMA + d, e.W && r.chance(45)) : 0;
        }
        if (split) {
            int h = 1 << (log2 - 1);
            transform_tree(x0, y0, x0, y0, log2 - 1, d + 1, 0, maxd, intra_split, cbf_cb, cbf_cr);
            transform_tree(x0 + h, y0, x0, y0, log2 - 1, d + 1, 1, maxd, intra_split, cbf_cb, cbf_cr);
            transform_tree(x0, y0 + h, x0, y0, log2 - 1, d + 1, 2, maxd, intra_split, cbf_cb, cbf_cr);
            transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, d + 1, 3, maxd, intra_split, cbf_cb, cbf_cr);
        } else {
            int cbf_luma = 1;
            if (cu_intra || d != 0 || cbf_cb || cbf_cr) cbf_luma = e.bin(C_CBF_LUMA + (d == 0 ? 1 : 0), e.W && r.chance(55));
            transform_unit(x0, y0, xBase, yBase, log2, blk, cbf_luma, cbf_cb, cbf_cr);
        }
    }

    int qp_c[3] = {26, 26, 26};  // Qp'Y, Qp'Cb, Qp'Cr: the QPs of dequantisation
    void chroma_qps() {
        int off = qp_bd_offset();
        qp_c[0] = qp_y + off;
        int oc[2] = {actp->cb_qp_offset + sh->cb_off, actp->cr_qp_offset + sh->cr_off};
        for (int c = 0; c < 2; c++) qp_c[c + 1] = chroma_qp_table(clip3(-off, 57, qp_y + oc[c])) + off;
    }

    // 7.3.8.10
    void transform_unit(int x0, int y0, int xBase, int yBase, int log2, int blk, int cbf_luma, int cbf_cb, int cbf_cr) {
        if ((cbf_luma || cbf_cb || cbf_cr) && actp->cu_qp_delta && !is_qp_coded) {
            int want = 0;
            if (e.W) {  // a QpY within the writer's range
                int target = e.rng.range(wo.qp_min, wo.qp_max);
                int half = 26 + qp_bd_offset() / 2, m = 52 + qp_bd_offset();
                want = ((target - qpy_pred_cu + half) % m + m) % m - half;
            }
            int a = 0;
            while (a < 5 && e.bin(C_QP_DELTA + (a > 0), std::abs(want) > a)) a++;
            if (a == 5) a += eg_bypass(0, std::abs(want) - 5);
            int v = a && e.byp(want < 0) ? -a : a;
            if (v < -(26 + qp_bd_offset() / 2) || v > 25 + qp_bd_offset() / 2)
                invalid("CuQpDeltaVal %d out of range", v);
            is_qp_coded = 1;
            qp_delta_val = v;
            set_qp();
        }
        chroma_qps();
        int n = 1 << log2;
        if (cu_intra) intra_pred(0, x0, y0, log2, ipm[b4(x0, y0)], x0, y0);
        if (cbf_luma) {
            int si = cu_intra && log2 <= 3 ? scan_of_mode(ipm[b4(x0, y0)]) : 0;
            residual(0, x0, y0, log2, si);
            set_flag(x0, y0, n, n, F_CBF);
        }
        tu_edges(x0, y0, n);
        if (log2 > 2) {
            int si = cu_intra && log2 == 3 ? scan_of_mode(cu_chroma_mode) : 0;
            for (int c = 1; c <= 2; c++) {
                if (cu_intra) intra_pred(c, x0 / 2, y0 / 2, log2 - 1, cu_chroma_mode, x0, y0);
                if (c == 1 ? cbf_cb : cbf_cr) residual(c, x0 / 2, y0 / 2, log2 - 1, si);
            }
        } else if (blk == 3) {
            int si = cu_intra ? scan_of_mode(cu_chroma_mode) : 0;
            for (int c = 1; c <= 2; c++) {
                if (cu_intra) intra_pred(c, xBase / 2, yBase / 2, 2, cu_chroma_mode, xBase, yBase);
                if (c == 1 ? cbf_cb : cbf_cr) residual(c, xBase / 2, yBase / 2, 2, si);
            }
        }
    }

    // the writer: levels for a transform block (raster, n x n) with at least
    // one nonzero, sign-hiding parity kept, dequantised values and the
    // first transform stage inside 16 bits
    void choose_levels(int16_t* lev, int log2, int cIdx, int si, bool tskip) {
        Rng& r = e.rng;
        int n = 1 << log2, N = n * n;
        memset(lev, 0, sizeof(int16_t) * N);
        int count = r.chance(30) ? r.range(1, N) : r.range(1, std::min(N, 6));
        int reach = r.chance(50) ? N : std::min(N, 16);  // low frequencies most of the time
        for (int k = 0; k < count; k++) {
            int pos = r.range(0, reach - 1);
            int x, y;
            if (reach == N) {
                x = pos % n;
                y = pos / n;
            } else {
                x = SCAN.pos[2][0][pos][0];
                y = SCAN.pos[2][0][pos][1];
            }
            int a = r.chance(70) ? 1 : r.chance(75) ? r.range(2, 4) : r.chance(90) ? r.range(5, MAX_LEVEL) : r.range(MAX_LEVEL, 600);
            lev[x + n * y] = (int16_t)(r.chance(50) ? -a : a);
        }
        if (!tq_bypass) {  // keep d and the first stage inside 16 bits
            int qP = qp_c[cIdx];
            const ScalingLists& sl = actp->scaling_present ? actp->sl : act->sl;
            int64_t colsum[32] = {};
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int i = x + n * y;
                    if (!lev[i]) continue;
                    int m = act->scaling_enabled ? sl.sf[log2 - 2][(cu_intra ? 0 : 3) + cIdx][i] : 16;
                    int64_t scale = (int64_t)m * LEVEL_SCALE[qP % 6] << (qP / 6);
                    int bd = log2 + act->bit_depth - 5;
                    int64_t lim = ((int64_t)30000 << bd) / scale;
                    if (lim < 1) lim = 1;
                    if (std::abs(lev[i]) > lim) lev[i] = (int16_t)(lev[i] < 0 ? -lim : lim);
                    colsum[x] += ((std::abs((int64_t)lev[i]) * scale) >> bd) + 1;
                }
            for (int x = 0; x < n; x++)
                if (colsum[x] * 90 > 32000 * 128)
                    for (int y = 0; y < n; y++) lev[x + n * y] = (int16_t)(lev[x + n * y] / 4);
            bool any = false;
            for (int i = 0; i < N; i++) any |= lev[i] != 0;
            if (!any) lev[0] = 1;
        }
        (void)tskip;
        // sign hiding: the first coefficient's sign follows the parity of its sub-block's sum
        if (actp->sign_hiding && !tq_bypass) {
            int nsb = 1 << (2 * (log2 - 2));
            for (int i = 0; i < nsb; i++) {
                int xs = SCAN.pos[log2 - 2][si][i][0], ys = SCAN.pos[log2 - 2][si][i][1];
                int first = -1, last = -1, sum = 0;
                for (int p = 0; p < 16; p++) {
                    int x = 4 * xs + SCAN.pos[2][si][p][0], y = 4 * ys + SCAN.pos[2][si][p][1];
                    if (lev[x + n * y]) {
                        if (first < 0) first = p;
                        last = p;
                        sum += std::abs(lev[x + n * y]);
                    }
                }
                if (first < 0 || last - first <= 3) continue;
                int x = 4 * xs + SCAN.pos[2][si][first][0], y = 4 * ys + SCAN.pos[2][si][first][1];
                int16_t& v = lev[x + n * y];
                if ((sum & 1) != (v < 0)) v = (int16_t)(v < 0 ? v - 1 : v + 1);
            }
        }
    }

    // 9.3.3.11: coeff_abs_level_remaining with Rice parameter k
    int level_remaining(int k, int want) {
        int prefix = 0;
        if (e.W) {
            int p;
            if ((want >> k) < 3) {
                p = want >> k;
                for (int i = 0; i < p; i++) e.byp(1);
                e.byp(0);
                e.byps(k, want & ((1 << k) - 1));
            } else {
                p = 3;
                while (want >= (((1 << (p - 2)) + 2) << k)) p++;
                for (int i = 0; i < p; i++) e.byp(1);
                e.byp(0);
                e.byps(p - 3 + k, want - (((1 << (p - 3)) + 2) << k));
            }
            return want;
        }
        while (prefix < 32 && e.byp()) prefix++;
        if (prefix >= 32) invalid("coeff_abs_level_remaining prefix too long");
        if (prefix < 3) return (prefix << k) + e.byps(k);
        if (prefix - 3 + k > 30) invalid("coeff_abs_level_remaining suffix too long");
        return (((1 << (prefix - 3)) + 2) << k) + e.byps(prefix - 3 + k);
    }

    static int last_prefix_of(int p, int& suffix, int& sbits) {
        if (p < 4) {
            suffix = sbits = 0;
            return p;
        }
        for (int g = 4;; g++) {
            int base = (1 << ((g >> 1) - 1)) * (2 + (g & 1));
            int next = (1 << (((g + 1) >> 1) - 1)) * (2 + ((g + 1) & 1));
            if (p >= base && p < next) {
                suffix = p - base;
                sbits = (g >> 1) - 1;
                return g;
            }
        }
    }

    int16_t lev[32 * 32];

    // 7.3.8.11: residual_coding of one transform block, then its
    // dequantisation, inverse transform and reconstruction
    void residual(int cIdx, int x0, int y0, int log2, int si) {
        int n = 1 << log2;
        Rng& r = e.rng;
        int tskip = 0;
        bool want_ts = e.W && actp->transform_skip && !tq_bypass && log2 == 2 && r.chance(40);
        if (e.W) choose_levels(lev, log2, cIdx, si, want_ts);
        if (actp->transform_skip && !tq_bypass && log2 == 2) tskip = e.bin(C_TSKIP + (cIdx ? 1 : 0), want_ts);
        // the last significant position (in scan order) and its coordinates
        const uint8_t(*sbs)[2] = SCAN.pos[log2 - 2][si];
        const uint8_t(*s4)[2] = SCAN.pos[2][si];
        int nsb = 1 << (2 * (log2 - 2));
        int lastX = 0, lastY = 0;
        if (e.W) {
            bool found = false;
            for (int i = nsb - 1; i >= 0 && !found; i--)
                for (int p = 15; p >= 0 && !found; p--) {
                    int x = 4 * sbs[i][0] + s4[p][0], y = 4 * sbs[i][1] + s4[p][1];
                    if (lev[x + n * y]) {
                        lastX = x;
                        lastY = y;
                        found = true;
                    }
                }
            if (si == 2) std::swap(lastX, lastY);
        }
        {
            int off, shift;
            if (cIdx == 0) {
                off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
                shift = (log2 + 1) >> 2;
            } else {
                off = 15;
                shift = log2 - 2;
            }
            int cmax = (log2 << 1) - 1;
            int sx, bx, sy, by;
            int px = last_prefix_of(lastX, sx, bx), py = last_prefix_of(lastY, sy, by);
            int vx = 0, vy = 0;
            while (vx < cmax && e.bin(C_LAST_X + off + (vx >> shift), px > vx)) vx++;
            while (vy < cmax && e.bin(C_LAST_Y + off + (vy >> shift), py > vy)) vy++;
            if (vx > 3) {
                int nb = (vx >> 1) - 1;
                lastX = (1 << nb) * (2 + (vx & 1)) + e.byps(nb, sx);
            } else {
                lastX = vx;
            }
            if (vy > 3) {
                int nb = (vy >> 1) - 1;
                lastY = (1 << nb) * (2 + (vy & 1)) + e.byps(nb, sy);
            } else {
                lastY = vy;
            }
            if (lastX >= n || lastY >= n) invalid("a last significant coefficient outside its block");
            if (si == 2) std::swap(lastX, lastY);
        }
        int lastSb = nsb - 1, lastP = 16;
        {
            int xC, yC;
            do {
                if (lastP == 0) {
                    lastP = 16;
                    lastSb--;
                    if (lastSb < 0) invalid("no last coefficient position");
                }
                lastP--;
                xC = 4 * sbs[lastSb][0] + s4[lastP][0];
                yC = 4 * sbs[lastSb][1] + s4[lastP][1];
            } while (xC != lastX || yC != lastY);
        }
        int16_t out[32 * 32];
        memset(out, 0, sizeof(int16_t) * n * n);
        uint8_t csbf[8][8] = {};
        int nS = n >> 2;
        int c1_state = 1;
        bool hide = actp->sign_hiding && !tq_bypass;
        for (int i = lastSb; i >= 0; i--) {
            int xS = sbs[i][0], yS = sbs[i][1];
            int infer_dc = 0;
            int right = xS < nS - 1 ? csbf[xS + 1][yS] : 0, below = yS < nS - 1 ? csbf[xS][yS + 1] : 0;
            if (i < lastSb && i > 0) {
                bool any = false;
                if (e.W)
                    for (int p = 0; p < 16; p++) any |= lev[4 * xS + s4[p][0] + n * (4 * yS + s4[p][1])] != 0;
                csbf[xS][yS] = (uint8_t)e.bin(C_CSBF + std::min(1, right + below) + (cIdx ? 2 : 0), any);
                infer_dc = 1;
            } else {
                csbf[xS][yS] = 1;
            }
            int prev_csbf = right + 2 * below;
            uint8_t sig[16] = {};
            int start = i == lastSb ? lastP - 1 : 15;
            if (i == lastSb) sig[lastP] = 1;
            for (int p = start; p >= 0; p--) {
                int xC = 4 * xS + s4[p][0], yC = 4 * yS + s4[p][1];
                if (csbf[xS][yS] && (p > 0 || !infer_dc)) {
                    int sc;
                    if (log2 == 2) {
                        static const uint8_t MAP[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
                        sc = MAP[(yC << 2) + xC];
                    } else if (xC + yC == 0) {
                        sc = 0;
                    } else {
                        int xP = xC & 3, yP = yC & 3;
                        if (prev_csbf == 0)
                            sc = (xP + yP == 0) ? 2 : (xP + yP < 3) ? 1 : 0;
                        else if (prev_csbf == 1)
                            sc = yP == 0 ? 2 : yP == 1 ? 1 : 0;
                        else if (prev_csbf == 2)
                            sc = xP == 0 ? 2 : xP == 1 ? 1 : 0;
                        else
                            sc = 2;
                        if (cIdx == 0 && (xS > 0 || yS > 0)) sc += 3;
                        if (log2 == 3)
                            sc += si == 0 ? 9 : 15;
                        else
                            sc += cIdx == 0 ? 21 : 12;
                    }
                    int ci = cIdx == 0 ? sc : 27 + sc;
                    sig[p] = (uint8_t)e.bin(C_SIG + ci, e.W && lev[xC + n * yC] != 0);
                    if (sig[p]) infer_dc = 0;
                } else if (p == 0 && infer_dc && csbf[xS][yS]) {
                    sig[0] = 1;
                }
            }
            if (!csbf[xS][yS]) continue;
            int absv[16], g1[16] = {}, g2[16] = {}, sgn[16] = {};
            int first_sig = 16, last_sig = -1, ng1 = 0, last_g1_pos = -1;
            int ctx_set = (i == 0 || cIdx > 0) ? 0 : 2;
            bool any_sig = false;
            for (int p = 15; p >= 0; p--) any_sig |= sig[p] != 0;
            if (!any_sig) continue;
            if (i != lastSb && c1_state == 0) ctx_set++;
            int g1ctx = 1;
            for (int p = 15; p >= 0; p--) {
                int xC = 4 * xS + s4[p][0], yC = 4 * yS + s4[p][1];
                absv[p] = e.W ? std::abs(lev[xC + n * yC]) : 0;
                if (!sig[p]) continue;
                if (ng1 < 8) {
                    g1[p] = e.bin(C_GT1 + ctx_set * 4 + std::min(3, g1ctx) + (cIdx ? 16 : 0), absv[p] > 1);
                    ng1++;
                    if (g1[p]) {
                        g1ctx = 0;
                        if (last_g1_pos < 0) last_g1_pos = p;
                    } else if (g1ctx > 0) {
                        g1ctx++;
                    }
                }
                if (last_sig < 0) last_sig = p;
                first_sig = p;
            }
            c1_state = g1ctx;
            bool hidden = hide && last_sig - first_sig > 3;
            if (last_g1_pos >= 0) g2[last_g1_pos] = e.bin(C_GT2 + ctx_set + (cIdx ? 4 : 0), absv[last_g1_pos] > 2);
            for (int p = 15; p >= 0; p--) {
                if (!sig[p] || (hidden && p == first_sig)) continue;
                int xC = 4 * xS + s4[p][0], yC = 4 * yS + s4[p][1];
                sgn[p] = e.byp(e.W && lev[xC + n * yC] < 0);
            }
            int nsig = 0, rice = 0, sum = 0;
            for (int p = 15; p >= 0; p--) {
                if (!sig[p]) continue;
                int base = 1 + g1[p] + g2[p];
                int thr = nsig < 8 ? (p == last_g1_pos ? 3 : 2) : 1;
                int a = base;
                if (base == thr) {
                    a = base + level_remaining(rice, absv[p] - base);
                    if (a > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
                }
                if (a > 32768) invalid("a coefficient level beyond 16 bits");
                int xC = 4 * xS + s4[p][0], yC = 4 * yS + s4[p][1];
                int v = sgn[p] ? -a : a;
                if (hidden) {
                    sum += a;
                    if (p == first_sig && (sum & 1)) v = -v;
                }
                out[xC + n * yC] = (int16_t)clip3(-32768, 32767, v);
                nsig++;
            }
        }
        if (e.W) {
            for (int k = 0; k < n * n; k++)
                if (out[k] != lev[k]) invalid("writer: residual levels not reproduced");
            return;
        }
        reconstruct_residual(cIdx, x0, y0, log2, out, tskip);
    }

    // ---- reconstruction (8.6.2-8.6.7) ----

    template <int BD>
    Pel<BD>* plane(int c) { return cur->plane<BD>(c); }
    int stride(int c) const { return c == 0 ? W : W / 2; }

    void reconstruct_residual(int cIdx, int x0, int y0, int log2, const int16_t* c, int tskip) {
        if (act->bit_depth > 8)
            reconstruct_residual_t<10>(cIdx, x0, y0, log2, c, tskip);
        else
            reconstruct_residual_t<8>(cIdx, x0, y0, log2, c, tskip);
    }
    template <int BD>
    void reconstruct_residual_t(int cIdx, int x0, int y0, int log2, const int16_t* c, int tskip) {
        int n = 1 << log2;
        int32_t res[32 * 32];
        if (tq_bypass) {
            for (int i = 0; i < n * n; i++) res[i] = c[i];
        } else {
            int qP = qp_c[cIdx];
            int bd = log2 + BD - 5;
            const ScalingLists& sl = actp->scaling_present ? actp->sl : act->sl;
            const uint8_t* sf = act->scaling_enabled ? sl.sf[log2 - 2][(cu_intra ? 0 : 3) + cIdx] : nullptr;
            int32_t d[32 * 32];
            int64_t ls = (int64_t)LEVEL_SCALE[qP % 6] << (qP / 6);
            for (int i = 0; i < n * n; i++) {
                if (!c[i]) {
                    d[i] = 0;
                    continue;
                }
                int m = sf ? sf[i] : 16;
                int64_t v = ((int64_t)c[i] * m * ls + ((int64_t)1 << (bd - 1))) >> bd;
                d[i] = (int32_t)std::max<int64_t>(-32768, std::min<int64_t>(32767, v));
            }
            const int sh2 = 20 - BD;  // bdShift of the second stage (8.6.2)
            if (tskip) {
                for (int i = 0; i < n * n; i++) res[i] = (d[i] * 128 + (1 << (sh2 - 1))) >> sh2;
            } else {
                bool dst = cu_intra && cIdx == 0 && n == 4;
                int step = 32 / n;
                int m[32][32];  // m[k][i]: basis k at sample i
                for (int k = 0; k < n; k++)
                    for (int i = 0; i < n; i++) m[k][i] = dst ? DST4[k][i] : DCT.m[k * step][i];
                // |sums| stay below 32 * 32767 * 90 < 2^31: int32 holds them
                int32_t g[32 * 32];
                int last_col = -1;
                // columns (only those with a coefficient, and to their last row)
                for (int x = 0; x < n; x++) {
                    int last = -1;
                    for (int k = 0; k < n; k++)
                        if (d[x + n * k]) last = k;
                    if (last < 0) {
                        for (int y = 0; y < n; y++) g[x + n * y] = 0;
                        continue;
                    }
                    last_col = x;
                    for (int y = 0; y < n; y++) {
                        int32_t acc = 0;
                        for (int k = 0; k <= last; k++) acc += d[x + n * k] * m[k][y];
                        g[x + n * y] = clip3(-32768, 32767, (acc + 64) >> 7);
                    }
                }
                // rows, to the last column with a coefficient
                for (int y = 0; y < n; y++) {
                    const int32_t* gr = g + n * y;
                    for (int x = 0; x < n; x++) {
                        int32_t acc = 0;
                        for (int k = 0; k <= last_col; k++) acc += gr[k] * m[k][x];
                        res[x + n * y] = (acc + (1 << (sh2 - 1))) >> sh2;
                    }
                }
            }
        }
        Pel<BD>* pl = plane<BD>(cIdx);
        int st = stride(cIdx);
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                Pel<BD>& v = pl[(size_t)(y0 + y) * st + x0 + x];
                v = clip1<BD>(v + res[x + n * y]);
            }
    }

    // 8.4.4.2: intra prediction of a block at (x0, y0) of component c, from
    // the picture as reconstructed so far; (xL, yL) the block's luma place
    void intra_pred(int c, int x0, int y0, int log2, int mode, int xL, int yL) {
        if (e.W) return;
        if (act->bit_depth > 8)
            intra_pred_t<10>(c, x0, y0, log2, mode, xL, yL);
        else
            intra_pred_t<8>(c, x0, y0, log2, mode, xL, yL);
    }
    template <int BD>
    void intra_pred_t(int c, int x0, int y0, int log2, int mode, int xL, int yL) {
        int n = 1 << log2, sub = c ? 1 : 0;
        Pel<BD>* pl = plane<BD>(c);
        int st = stride(c);
        int N = 4 * n + 1;
        int ref[4 * 64 + 1];
        bool av[4 * 64 + 1];
        int unit = 4 >> sub;  // samples of one availability unit
        bool ci = actp->constrained_intra;
        auto ok = [&](int xc, int yc) {
            int xn = xc * (1 << sub), yn = yc * (1 << sub);
            if (!avail(xL, yL, xn, yn)) return false;
            return !ci || (flags[b4(xn, yn)] & F_INTRA);
        };
        // index 0: p[-1][2n-1] ... 2n-1: p[-1][0], 2n: p[-1][-1], 2n+1+x: p[x][-1]
        bool any = false;
        for (int k = 0; k < 2 * n; k += unit) {
            int y = 2 * n - 1 - k;  // the unit's top row is y - unit + 1
            bool a = ok(x0 - 1, y0 + y);
            for (int j = 0; j < unit; j++) {
                int yy = y - j;
                av[k + j] = a;
                if (a) ref[k + j] = pl[(size_t)(y0 + yy) * st + x0 - 1];
            }
            any |= a;
        }
        {
            bool a = ok(x0 - 1, y0 - 1);
            av[2 * n] = a;
            if (a) ref[2 * n] = pl[(size_t)(y0 - 1) * st + x0 - 1];
            any |= a;
        }
        for (int x = 0; x < 2 * n; x += unit) {
            bool a = ok(x0 + x, y0 - 1);
            for (int j = 0; j < unit; j++) {
                av[2 * n + 1 + x + j] = a;
                if (a) ref[2 * n + 1 + x + j] = pl[(size_t)(y0 - 1) * st + x0 + x + j];
            }
            any |= a;
        }
        if (!any) {
            for (int i = 0; i < N; i++) ref[i] = 1 << (BD - 1);
        } else {
            if (!av[0]) {
                for (int i = 1; i < N; i++)
                    if (av[i]) {
                        ref[0] = ref[i];
                        break;
                    }
            }
            for (int i = 1; i < N; i++)
                if (!av[i]) ref[i] = ref[i - 1];
        }
        // 8.4.4.2.3: filtering
        if (c == 0 && mode != 1 && n != 4) {
            int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
            int thr = n == 8 ? 7 : n == 16 ? 1 : 0;
            if (dist > thr) {
                int f[4 * 64 + 1];
                int C = ref[2 * n], L = ref[0], T = ref[4 * n];
                bool strong = act->strong_intra_smoothing && n == 32 && std::abs(C + T - 2 * ref[3 * n]) < (1 << (BD - 5)) &&
                              std::abs(C + L - 2 * ref[n]) < (1 << (BD - 5));
                if (strong) {
                    f[2 * n] = C;
                    for (int y = 0; y < 63; y++) f[2 * n - 1 - y] = ((63 - y) * C + (y + 1) * L + 32) >> 6;
                    f[0] = L;
                    for (int x = 0; x < 63; x++) f[2 * n + 1 + x] = ((63 - x) * C + (x + 1) * T + 32) >> 6;
                    f[4 * n] = T;
                } else {
                    f[0] = ref[0];
                    f[N - 1] = ref[N - 1];
                    for (int i = 1; i < N - 1; i++) f[i] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
                }
                memcpy(ref, f, sizeof(int) * N);
            }
        }
        auto left = [&](int y) { return ref[2 * n - 1 - y]; };  // p[-1][y], y >= -1
        auto top = [&](int x) { return x < 0 ? ref[2 * n] : ref[2 * n + 1 + x]; };  // p[x][-1]
        auto out = [&](int x, int y) -> Pel<BD>& { return pl[(size_t)(y0 + y) * st + x0 + x]; };
        if (mode == 0) {
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++)
                    out(x, y) = (Pel<BD>)(((n - 1 - x) * left(y) + (x + 1) * top(n) + (n - 1 - y) * top(x) +
                                           (y + 1) * left(n) + n) >> (log2 + 1));
        } else if (mode == 1) {
            int sum = n;
            for (int i = 0; i < n; i++) sum += top(i) + left(i);
            int dc = sum >> (log2 + 1);
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) out(x, y) = (Pel<BD>)dc;
            if (c == 0 && n < 32) {
                out(0, 0) = (Pel<BD>)((left(0) + 2 * dc + top(0) + 2) >> 2);
                for (int x = 1; x < n; x++) out(x, 0) = (Pel<BD>)((top(x) + 3 * dc + 2) >> 2);
                for (int y = 1; y < n; y++) out(0, y) = (Pel<BD>)((left(y) + 3 * dc + 2) >> 2);
            }
        } else {
            int angle = INTRA_ANGLE[mode];
            int r_[3 * 64 + 1];
            int* rr = r_ + 64;  // rr[-n .. 2n]
            bool vert = mode >= 18;
            auto main_ = [&](int k) { return vert ? top(k - 1) : left(k - 1); };  // ref[x] = p[-1+x][-1] (or left)
            auto side = [&](int k) { return vert ? left(k - 1) : top(k - 1); };
            for (int x = 0; x <= n; x++) rr[x] = main_(x);
            if (angle < 0) {
                if (((n * angle) >> 5) < -1) {
                    int inv = inv_angle(angle);
                    for (int x = (n * angle) >> 5; x <= -1; x++) rr[x] = side(((x * inv + 128) >> 8));
                }
            } else {
                for (int x = n + 1; x <= 2 * n; x++) rr[x] = main_(x);
            }
            for (int y = 0; y < n; y++) {
                int idx = ((y + 1) * angle) >> 5, fr = ((y + 1) * angle) & 31;
                for (int x = 0; x < n; x++) {
                    int v = fr ? ((32 - fr) * rr[x + idx + 1] + fr * rr[x + idx + 2] + 16) >> 5 : rr[x + idx + 1];
                    if (vert)
                        out(x, y) = (Pel<BD>)v;
                    else
                        out(y, x) = (Pel<BD>)v;
                }
            }
            if (c == 0 && n < 32) {
                if (mode == 26)
                    for (int y = 0; y < n; y++) out(0, y) = clip1<BD>(top(0) + ((left(y) - left(-1)) >> 1));
                if (mode == 10)
                    for (int x = 0; x < n; x++) out(x, 0) = clip1<BD>(left(0) + ((top(x) - top(-1)) >> 1));
            }
        }
    }

    // 8.5.3.3: fractional sample interpolation and weighted prediction
    int16_t predbuf[2][3][64 * 64];

    template <int BD>
    void mc(const Pic* ref, int c, int xP, int yP, int w, int h, const int16_t* mv, int16_t* dst) {
        const Pel<BD>* pl = ref->plane<BD>(c);
        int PW = c ? W / 2 : W, PH = c ? H / 2 : H;
        int fx, fy, ix, iy;
        if (c == 0) {
            fx = mv[0] & 3;
            fy = mv[1] & 3;
            ix = xP + (mv[0] >> 2);
            iy = yP + (mv[1] >> 2);
        } else {
            fx = mv[0] & 7;
            fy = mv[1] & 7;
            ix = xP + (mv[0] >> 3);
            iy = yP + (mv[1] >> 3);
        }
        int taps = c ? 4 : 8, half = c ? 1 : 3;
        const int* fh = c ? CHROMA_FILTER[fx] : LUMA_FILTER[fx];
        const int* fv = c ? CHROMA_FILTER[fy] : LUMA_FILTER[fy];
        // the reference window the filters read, its coordinates clipped
        // to the picture (8.5.3.3.3.1) once
        int bw = w + taps - 1, bh = h + taps - 1;
        Pel<BD> win[(64 + 7) * (64 + 7)];
        int x0 = ix - half, y0 = iy - half;
        for (int y = 0; y < bh; y++) {
            const Pel<BD>* row = pl + (size_t)clip3(0, PH - 1, y0 + y) * PW;
            Pel<BD>* out = win + bw * y;
            if (x0 >= 0 && x0 + bw <= PW) {
                memcpy(out, row + x0, bw * sizeof(Pel<BD>));
            } else {
                for (int x = 0; x < bw; x++) out[x] = row[clip3(0, PW - 1, x0 + x)];
            }
        }
        auto S = [&](int x, int y) { return (int)win[(y + half) * bw + x + half]; };  // relative to (ix, iy)
        if (!fx && !fy) {
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) dst[x + w * y] = (int16_t)(S(x, y) << (14 - BD));
            return;
        }
        if (!fy) {
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fh[i] * S(x + i - half, y);
                    dst[x + w * y] = (int16_t)(s >> (BD - 8));
                }
            return;
        }
        if (!fx) {
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    int s = 0;
                    for (int i = 0; i < taps; i++) s += fv[i] * S(x, y + i - half);
                    dst[x + w * y] = (int16_t)(s >> (BD - 8));
                }
            return;
        }
        int tmp[(64 + 7) * 64];
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < w; x++) {
                int s = 0;
                for (int i = 0; i < taps; i++) s += fh[i] * S(x + i - half, y - half);
                tmp[x + w * y] = s >> (BD - 8);
            }
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                int s = 0;
                for (int i = 0; i < taps; i++) s += fv[i] * tmp[x + w * (y + i)];
                dst[x + w * y] = (int16_t)(s >> 6);
            }
    }

    void predict_inter(int xP, int yP, int w, int h, const MvField& m) {
        if (act->bit_depth > 8)
            predict_inter_t<10>(xP, yP, w, h, m);
        else
            predict_inter_t<8>(xP, yP, w, h, m);
    }
    template <int BD>
    void predict_inter_t(int xP, int yP, int w, int h, const MvField& m) {
        const SliceHdr& s = *sh;
        for (int l = 0; l < 2; l++) {
            if (!(m.pf >> l & 1)) continue;
            const Pic* ref = s.list[l][m.ref[l]];
            if (!ref || !ref->has_pixels()) invalid("a reference picture without samples");
            mc<BD>(ref, 0, xP, yP, w, h, m.mv[l], predbuf[l][0]);
            mc<BD>(ref, 1, xP / 2, yP / 2, w / 2, h / 2, m.mv[l], predbuf[l][1]);
            mc<BD>(ref, 2, xP / 2, yP / 2, w / 2, h / 2, m.mv[l], predbuf[l][2]);
        }
        bool weighted = s.type == 1 ? actp->weighted_pred : actp->weighted_bipred;
        for (int c = 0; c < 3; c++) {
            int cw = c ? w / 2 : w, ch = c ? h / 2 : h, cx = c ? xP / 2 : xP, cy = c ? yP / 2 : yP;
            Pel<BD>* pl = plane<BD>(c);
            int st = stride(c);
            const int16_t* p0 = predbuf[0][c];
            const int16_t* p1 = predbuf[1][c];
            for (int y = 0; y < ch; y++)
                for (int x = 0; x < cw; x++) {
                    int i = x + cw * y, v;
                    if (!weighted) {
                        if (m.pf == 3)
                            v = (p0[i] + p1[i] + (1 << (14 - BD))) >> (15 - BD);
                        else
                            v = ((m.pf == 1 ? p0[i] : p1[i]) + (1 << (13 - BD))) >> (14 - BD);
                    } else {
                        int denom = c ? s.chroma_denom : s.luma_denom, l2 = denom + 14 - BD;
                        int wt[2], o[2];
                        for (int l = 0; l < 2; l++) {
                            if (!(m.pf >> l & 1)) continue;
                            int ri = m.ref[l];
                            wt[l] = c ? s.cw[l][ri][c - 1] : s.lw[l][ri];
                            o[l] = (c ? chroma_offset(s, l, ri, c - 1) : s.lo[l][ri]) * (1 << (BD - 8));
                        }
                        if (m.pf == 3) {
                            v = (p0[i] * wt[0] + p1[i] * wt[1] + (o[0] + o[1] + 1) * (1 << l2)) >> (l2 + 1);
                        } else {
                            int l = m.pf == 1 ? 0 : 1;
                            int p = l ? p1[i] : p0[i];
                            v = ((p * wt[l] + (1 << (l2 - 1))) >> l2) + o[l];
                        }
                    }
                    pl[(size_t)(cy + y) * st + cx + x] = clip1<BD>(v);
                }
        }
    }

    // ---- the deblocking filter (8.7.2) ----

    bool edge_ok(int xq, int yq, int xp, int yp) const {
        if (xp < 0 || yp < 0) return false;
        int cp = ctb_of(xp, yp), cq = ctb_of(xq, yq);
        if (cp == cq) return true;
        if (!actp->lf_across_tiles && tile_id[rs2ts[cp]] != tile_id[rs2ts[cq]]) return false;
        if (!sh->lf_across && ctb_addr[cp] != ctb_addr[cq]) return false;
        return true;
    }

    int ref_poc(int x, int y, int l) const {
        const SliceHdr& s = slices[ctb_slice[ctb_of(x, y)]];
        const MvField& m = cur->mvf[b4(x, y)];
        return s.list[l][m.ref[l]]->poc;
    }

    // 8.7.2.4
    int bs_of(int xp, int yp, int xq, int yq, bool tu) const {
        int fp = flags[b4(xp, yp)], fq = flags[b4(xq, yq)];
        if ((fp | fq) & F_INTRA) return 2;
        if (tu && ((fp | fq) & F_CBF)) return 1;
        const MvField& P = cur->mvf[b4(xp, yp)];
        const MvField& Q = cur->mvf[b4(xq, yq)];
        int np = (P.pf & 1) + (P.pf >> 1), nq = (Q.pf & 1) + (Q.pf >> 1);
        if (np != nq) return 1;
        auto far = [](const int16_t* a, const int16_t* b) { return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4; };
        if (np == 1) {
            int lp = P.pf == 1 ? 0 : 1, lq = Q.pf == 1 ? 0 : 1;
            if (ref_poc(xp, yp, lp) != ref_poc(xq, yq, lq)) return 1;
            return far(P.mv[lp], Q.mv[lq]) ? 1 : 0;
        }
        int a0 = ref_poc(xp, yp, 0), a1 = ref_poc(xp, yp, 1), b0 = ref_poc(xq, yq, 0), b1 = ref_poc(xq, yq, 1);
        if (!((a0 == b0 && a1 == b1) || (a0 == b1 && a1 == b0))) return 1;
        if (a0 != a1) {
            if (a0 == b0) return (far(P.mv[0], Q.mv[0]) || far(P.mv[1], Q.mv[1])) ? 1 : 0;
            return (far(P.mv[0], Q.mv[1]) || far(P.mv[1], Q.mv[0])) ? 1 : 0;
        }
        return ((far(P.mv[0], Q.mv[0]) || far(P.mv[1], Q.mv[1])) && (far(P.mv[0], Q.mv[1]) || far(P.mv[1], Q.mv[0])))
                   ? 1
                   : 0;
    }

    // the bS of a block's left and top edges on the 8x8 grid
    void block_edges(int x0, int y0, int w, int h, bool tu) {
        if (sh->deblock_disabled || e.W) return;
        if ((x0 & 7) == 0)
            for (int y = y0; y < y0 + h; y += 4)
                if (edge_ok(x0, y, x0 - 1, y)) {
                    int v = bs_of(x0 - 1, y, x0, y, tu);
                    bs_v[b4(x0, y)] = (uint8_t)(tu ? v : std::max<int>(bs_v[b4(x0, y)], v));
                }
        if ((y0 & 7) == 0)
            for (int x = x0; x < x0 + w; x += 4)
                if (edge_ok(x, y0, x, y0 - 1)) {
                    int v = bs_of(x, y0 - 1, x, y0, tu);
                    bs_h[b4(x, y0)] = (uint8_t)(tu ? v : std::max<int>(bs_h[b4(x, y0)], v));
                }
    }
    void cu_edges(int x0, int y0, int size) { block_edges(x0, y0, size, size, true); }
    void tu_edges(int x0, int y0, int n) { block_edges(x0, y0, n, n, true); }
    void pu_edges(int x0, int y0, int size) {
        int h = size / 2, q = size / 4;
        switch (cu_part) {
            case P_2NxN: block_edges(x0, y0 + h, size, h, false); break;
            case P_Nx2N: block_edges(x0 + h, y0, h, size, false); break;
            case P_2NxnU: block_edges(x0, y0 + q, size, size - q, false); break;
            case P_2NxnD: block_edges(x0, y0 + size - q, size, q, false); break;
            case P_nLx2N: block_edges(x0 + q, y0, size - q, size, false); break;
            case P_nRx2N: block_edges(x0 + size - q, y0, q, size, false); break;
            case P_NxN:
                if (cu_intra) break;
                block_edges(x0 + h, y0, h, h, false);
                block_edges(x0, y0 + h, h, h, false);
                block_edges(x0 + h, y0 + h, h, h, false);
                break;
            default: break;
        }
    }

    bool no_filter(int x, int y) const {
        int f = flags[b4(x, y)];
        return (f & F_BYPASS) || ((f & F_PCM) && act->pcm_loop_filter_disabled);
    }

    // one 4-sample luma edge segment: P(i, k) / Q(i, k) sample i away from
    // the edge on line k
    template <int BD>
    void filter_luma(Pel<BD>* q0, int step, int across, int bs, int xp, int yp, int xq, int yq) {
        const SliceHdr& s = slices[ctb_slice[ctb_of(xq, yq)]];
        int qpl = (qpy[b4(xq, yq)] + qpy[b4(xp, yp)] + 1) >> 1;
        int beta = BETA_TABLE[clip3(0, 51, qpl + 2 * s.beta_offset)] * (1 << (BD - 8));
        int tc = TC_TABLE[clip3(0, 53, qpl + 2 * (bs - 1) + 2 * s.tc_offset)] * (1 << (BD - 8));
        if (!tc) return;
        auto P = [&](int i, int k) -> Pel<BD>& { return q0[k * step - (i + 1) * across]; };
        auto Q = [&](int i, int k) -> Pel<BD>& { return q0[k * step + i * across]; };
        int dp0 = std::abs(P(2, 0) - 2 * P(1, 0) + P(0, 0)), dp3 = std::abs(P(2, 3) - 2 * P(1, 3) + P(0, 3));
        int dq0 = std::abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0)), dq3 = std::abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3));
        int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, dp = dp0 + dp3, dq = dq0 + dq3, d = dpq0 + dpq3;
        if (d >= beta) return;
        auto dsam = [&](int k, int dpq) {
            return 2 * dpq < (beta >> 2) && std::abs(P(3, k) - P(0, k)) + std::abs(Q(0, k) - Q(3, k)) < (beta >> 3) &&
                   std::abs(P(0, k) - Q(0, k)) < ((5 * tc + 1) >> 1);
        };
        int dE = (dsam(0, dpq0) && dsam(3, dpq3)) ? 2 : 1;
        int dEp = dp < ((beta + (beta >> 1)) >> 3), dEq = dq < ((beta + (beta >> 1)) >> 3);
        bool np = no_filter(xp, yp), nq = no_filter(xq, yq);
        for (int k = 0; k < 4; k++) {
            int p0 = P(0, k), p1 = P(1, k), p2 = P(2, k), p3 = P(3, k);
            int qq0 = Q(0, k), q1 = Q(1, k), q2 = Q(2, k), q3 = Q(3, k);
            if (dE == 2) {
                if (!np) {
                    P(0, k) = (Pel<BD>)clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * qq0 + q1 + 4) >> 3);
                    P(1, k) = (Pel<BD>)clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + qq0 + 2) >> 2);
                    P(2, k) = (Pel<BD>)clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + qq0 + 4) >> 3);
                }
                if (!nq) {
                    Q(0, k) = (Pel<BD>)clip3(qq0 - 2 * tc, qq0 + 2 * tc, (p1 + 2 * p0 + 2 * qq0 + 2 * q1 + q2 + 4) >> 3);
                    Q(1, k) = (Pel<BD>)clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + qq0 + q1 + q2 + 2) >> 2);
                    Q(2, k) = (Pel<BD>)clip3(q2 - 2 * tc, q2 + 2 * tc, (p0 + qq0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
                }
            } else {
                int delta = (9 * (qq0 - p0) - 3 * (q1 - p1) + 8) >> 4;
                if (std::abs(delta) >= tc * 10) continue;
                delta = clip3(-tc, tc, delta);
                if (!np) P(0, k) = clip1<BD>(p0 + delta);
                if (!nq) Q(0, k) = clip1<BD>(qq0 - delta);
                if (dEp && !np) {
                    int dpv = clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
                    P(1, k) = clip1<BD>(p1 + dpv);
                }
                if (dEq && !nq) {
                    int dqv = clip3(-(tc >> 1), tc >> 1, (((q2 + qq0 + 1) >> 1) - q1 - delta) >> 1);
                    Q(1, k) = clip1<BD>(q1 + dqv);
                }
            }
        }
    }

    // two chroma lines of an edge whose luma segment has bS 2
    template <int BD>
    void filter_chroma(Pel<BD>* q0, int step, int across, int c, int xp, int yp, int xq, int yq) {
        const SliceHdr& s = slices[ctb_slice[ctb_of(xq, yq)]];
        int off = c == 1 ? actp->cb_qp_offset : actp->cr_qp_offset;
        int qpi = ((qpy[b4(xq, yq)] + qpy[b4(xp, yp)] + 1) >> 1) + off;
        int qpc = chroma_qp_table(qpi);
        int tc = TC_TABLE[clip3(0, 53, qpc + 2 + 2 * s.tc_offset)] * (1 << (BD - 8));
        if (!tc) return;
        bool np = no_filter(xp, yp), nq = no_filter(xq, yq);
        for (int k = 0; k < 2; k++) {
            Pel<BD>& P0 = q0[k * step - across];
            Pel<BD>& Q0 = q0[k * step];
            int p1 = q0[k * step - 2 * across], q1 = q0[k * step + across];
            int delta = clip3(-tc, tc, ((((int)Q0 - P0) * 4) + p1 - q1 + 4) >> 3);
            int p0v = P0, q0v = Q0;
            if (!np) P0 = clip1<BD>(p0v + delta);
            if (!nq) Q0 = clip1<BD>(q0v - delta);
        }
    }

    void deblock_picture() {
        if (act->bit_depth > 8)
            deblock_picture_t<10>();
        else
            deblock_picture_t<8>();
    }
    template <int BD>
    void deblock_picture_t() {
        Pel<BD>* luma = plane<BD>(0);
        for (int dir = 0; dir < 2; dir++) {
            const std::vector<uint8_t>& bs = dir == 0 ? bs_v : bs_h;
            for (int y = 0; y < H; y += 4)
                for (int x = 0; x < W; x += 4) {
                    int v = bs[b4(x, y)];
                    if (!v) continue;
                    if (dir == 0) {
                        if (x & 7) continue;
                        filter_luma<BD>(luma + (size_t)y * W + x, W, 1, v, x - 1, y, x, y);
                        if (v == 2 && (x & 15) == 0)
                            for (int c = 1; c <= 2; c++)
                                filter_chroma<BD>(plane<BD>(c) + (size_t)(y / 2) * (W / 2) + x / 2, W / 2, 1, c, x - 1, y, x, y);
                    } else {
                        if (y & 7) continue;
                        filter_luma<BD>(luma + (size_t)y * W + x, 1, W, v, x, y - 1, x, y);
                        if (v == 2 && (y & 15) == 0)
                            for (int c = 1; c <= 2; c++)
                                filter_chroma<BD>(plane<BD>(c) + (size_t)(y / 2) * (W / 2) + x / 2, 1, W / 2, c, x, y - 1, x, y);
                    }
                }
        }
    }

    // ---- SAO (8.7.3) ----

    void sao_picture() {
        bool any = false;
        for (const SliceHdr& s : slices) any |= s.sao_luma || s.sao_chroma;
        if (!any) return;
        if (act->bit_depth > 8)
            sao_picture_t<10>();
        else
            sao_picture_t<8>();
    }
    template <int BD>
    void sao_picture_t() {
        const SPS& sp = *act;
        std::vector<Pel<BD>> src[3];
        for (int c = 0; c < 3; c++) src[c].assign(plane<BD>(c), plane<BD>(c) + (c ? (size_t)W * H / 4 : (size_t)W * H));
        static const int HP[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
        static const int VP[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
        for (int rs = 0; rs < sp.nctb; rs++) {
            if (ctb_addr[rs] < 0) continue;
            const Sao& c = sao[rs];
            int rx = rs % sp.ctbw, ry = rs / sp.ctbw;
            for (int ci = 0; ci < 3; ci++) {
                if (!c.type[ci]) continue;
                int sub = ci ? 1 : 0, PW = W >> sub, PH = H >> sub, cs = sp.ctb >> sub;
                int x0 = rx * cs, y0 = ry * cs, x1 = std::min(x0 + cs, PW), y1 = std::min(y0 + cs, PH);
                const Pel<BD>* in = src[ci].data();
                Pel<BD>* out = plane<BD>(ci);
                int table[32] = {};
                if (c.type[ci] == 1)
                    for (int k = 0; k < 4; k++) table[(k + c.band[ci]) & 31] = k + 1;
                for (int y = y0; y < y1; y++)
                    for (int x = x0; x < x1; x++) {
                        int xl = x << sub, yl = y << sub;
                        if (no_filter(xl, yl)) continue;
                        int v = in[(size_t)y * PW + x], k;
                        if (c.type[ci] == 1) {
                            k = table[v >> (BD - 5)];  // bandShift
                        } else {
                            int e0 = c.eo[ci];
                            int s_ = 0;
                            bool skip = false;
                            for (int j = 0; j < 2; j++) {
                                int xn = x + HP[e0][j], yn = y + VP[e0][j];
                                if (xn < 0 || yn < 0 || xn >= PW || yn >= PH) {
                                    skip = true;
                                    break;
                                }
                                int cn = ctb_of(xn << sub, yn << sub);
                                if (cn != rs) {
                                    if (ctb_addr[cn] < 0) {
                                        skip = true;
                                        break;
                                    }
                                    if (ctb_addr[cn] != ctb_addr[rs]) {
                                        // the later slice's flag decides
                                        bool later_is_n = rs2ts[cn] > rs2ts[rs];
                                        const SliceHdr& ls = slices[ctb_slice[later_is_n ? cn : rs]];
                                        if (!ls.lf_across) {
                                            skip = true;
                                            break;
                                        }
                                    }
                                    if (!actp->lf_across_tiles && tile_id[rs2ts[cn]] != tile_id[rs2ts[rs]]) {
                                        skip = true;
                                        break;
                                    }
                                }
                                s_ += sign(v - in[(size_t)yn * PW + xn]);
                            }
                            if (skip) continue;
                            static const int MAPE[5] = {1, 2, 0, 3, 4};
                            k = MAPE[2 + s_];
                        }
                        out[(size_t)y * PW + x] = clip1<BD>(v + c.off[ci][k]);
                    }
            }
        }
    }

    // ---- slice segment data (7.3.8.1) and the CABAC state (9.3.1, 9.3.2) ----

    std::vector<size_t> sub_starts;  // writer: each substream's first byte in the slice data
    int w_end_ts = 0;                // writer: the CTB (tile scan) that ends the segment

    void slice_data(SliceHdr& s, int sidx) {
        const SPS& sp = *act;
        const PPS& p = *actp;
        sh = &s;
        ctb_rs = s.address;
        ctb_ts = rs2ts[ctb_rs];
        if (!s.dependent) s.addr_rs = s.address;
        if (ctb_ts > 0 && ctb_addr[ts2rs[ctb_ts - 1]] < 0 && !e.W)
            unsupported("slices out of order or missing (arbitrary slice order)");
        e.start_engine();
        sub_starts.assign(1, 0);
        bool first = true;
        for (;;) {
            if (ctb_addr[ctb_rs] >= 0) invalid("a CTB decoded twice");
            int rx = ctb_rs % sp.ctbw, ry = ctb_rs / sp.ctbw;
            int x0 = rx << sp.log2_ctb, y0 = ry << sp.log2_ctb;
            bool tile_start = ctb_ts == 0 || tile_id[ctb_ts] != tile_id[ctb_ts - 1];
            bool row_start = p.wpp && (rx == 0 || tile_id[ctb_ts] != tile_id[rs2ts[ctb_rs - 1]]);
            ctb_addr[ctb_rs] = s.addr_rs;
            ctb_slice[ctb_rs] = sidx;
            cur->ctb_refs[ctb_rs] = (int16_t)s.refs_idx;
            auto sync_wpp = [&]() {
                if (wpp_saved && avail(x0, y0, x0 + sp.ctb, y0 - sp.ctb))
                    memcpy(e.ctx, wpp_ctx, N_CTX);
                else
                    e.init_contexts(init_type(), s.qp);
            };
            if (first) {
                if (tile_start)
                    e.init_contexts(init_type(), s.qp);
                else if (row_start)
                    sync_wpp();
                else if (s.dependent)
                    memcpy(e.ctx, ds_ctx, N_CTX);
                else
                    e.init_contexts(init_type(), s.qp);
                if (!s.dependent) qp_prev = s.qp;
            } else if (tile_start) {
                e.init_contexts(init_type(), s.qp);
            } else if (row_start) {
                sync_wpp();
            }
            if (tile_start || row_start) qp_prev = s.qp;
            if (row_start) wpp_saved = false;
            first = false;
            if (s.sao_luma || s.sao_chroma) sao_syntax(rx, ry);
            coding_quadtree(x0, y0, sp.log2_ctb, 0);
            // the storage after the second CTB of a row (of a tile)
            if (p.wpp) {
                int tile_x0 = rx;
                while (tile_x0 > 0 && tile_id[rs2ts[ctb_rs - (rx - tile_x0) - 1]] == tile_id[ctb_ts]) tile_x0--;
                if (rx - tile_x0 == 1) {
                    memcpy(wpp_ctx, e.ctx, N_CTX);
                    wpp_saved = true;
                }
            }
            int end = e.term(e.W && ctb_ts + 1 == w_end_ts);
            ctb_ts++;
            if (end) {
                if (p.dependent_slices) memcpy(ds_ctx, e.ctx, N_CTX);
                e.align_after_flush();
                break;
            }
            if (ctb_ts >= sp.nctb) invalid("a slice segment runs past the last CTB");
            ctb_rs = ts2rs[ctb_ts];
            int nrx = ctb_rs % sp.ctbw;
            if ((p.tiles && tile_id[ctb_ts] != tile_id[ctb_ts - 1]) ||
                (p.wpp && (nrx == 0 || tile_id[ctb_ts] != tile_id[rs2ts[ctb_rs - 1]]))) {
                if (!e.term(1)) invalid("end_of_subset_one_bit is 0");
                e.align_after_flush();
                if (e.W) sub_starts.push_back(e.bw.out.size());
                e.start_engine();
            }
        }
    }

    // ---- NAL units (7.3.1) ----

    std::vector<uint8_t> rbsp;

    void unescape(const uint8_t* d, size_t n) {
        rbsp.clear();
        rbsp.reserve(n);
        int zeros = 0;
        for (size_t i = 0; i < n; i++) {
            if (zeros >= 2 && d[i] == 3) {
                zeros = 0;
                continue;
            }
            rbsp.push_back(d[i]);
            zeros = d[i] == 0 ? zeros + 1 : 0;
        }
    }

    const SPS* any_sps() const {
        if (act) return act;
        for (int i = 0; i < 16; i++)
            if (sps[i].valid) return &sps[i];
        return nullptr;
    }

    // D.2.1: a prefix SEI's messages; a pic_timing message that says the
    // pictures are fields is refused
    void sei() {
        BitReader& b = e.br;
        while (b.more_rbsp_data() && b.pos + 16 <= 8 * b.nbytes) {
            int type = 0, size = 0, v;
            do {
                v = (int)b.u(8);
                type += v;
            } while (v == 255);
            do {
                v = (int)b.u(8);
                size += v;
            } while (v == 255);
            size_t next = b.pos + 8 * (size_t)size;
            if (next > 8 * b.nbytes) invalid("an SEI message past the end of its NAL unit");
            const SPS* s = any_sps();
            if (type == 1 && s && s->frame_field_info && size >= 1) {
                int ps = (int)b.u(4);
                if (ps == 1 || ps == 2 || (ps >= 9 && ps <= 12)) {
                    static char msg[96];
                    snprintf(msg, sizeof msg, "a pic_timing SEI with pic_struct %d: the pictures are fields", ps);
                    unsupported(msg);
                }
            }
            b.pos = next;
        }
    }

    void nal(const uint8_t* d, size_t n) {
        if (n < 2) invalid("a NAL unit shorter than its header");
        if (d[0] & 0x80) invalid("forbidden_zero_bit is 1");
        int type = (d[0] >> 1) & 63, layer = ((d[0] & 1) << 5) | (d[1] >> 3), tid = (d[1] & 7) - 1;
        if (tid < 0) invalid("nuh_temporal_id_plus1 is 0");
        if (layer > 0) return;  // dropped, as ffmpeg drops them
        unescape(d + 2, n - 2);
        e.br.init(rbsp.data(), rbsp.size());
        if (type == 33) {
            SPS s;
            sps_syntax(e, s, nullptr);
            if (act == &sps[s.id] && in_pic) invalid("an SPS replaced inside a picture");
            sps[s.id] = s;
        } else if (type == 34) {
            PPS p;
            pps_syntax(e, p, nullptr);
            if (actp == &pps[p.id] && in_pic) invalid("a PPS replaced inside a picture");
            pps[p.id] = p;
        } else if (type == 39) {
            sei();
        } else if (type == 36 || type == 37) {  // end of sequence or bitstream
            if (in_pic) finish_picture();
            after_eos = true;
        } else if (type <= 9 || (type >= 16 && type <= 21)) {
            slice_nal(type, tid);
        }
    }

    void slice_nal(int type, int tid) {
        SliceHdr s;
        s.nal_type = type;
        s.tid = tid;
        // the first fields, before the PPS is known to be the picture's
        bool first = e.br.u(1) != 0;
        e.br.pos = 0;
        if (first && in_pic) finish_picture();
        if (first) {
            skip_pic = false;
            bool irap = is_irap(type);
            if (!irap && (first_pic || after_eos)) {  // a decode that does not start at an IRAP
                skip_pic = true;
                return;
            }
            if (is_rasl(type) && no_rasl_output && !irap) {
                skip_pic = true;
                return;
            }
            slices.clear();
        } else if (skip_pic) {
            return;
        } else if (!in_pic) {
            invalid("a slice segment of a picture whose first slice segment is missing");
        }
        slice_header(s);
        if (first) start_picture(s);
        if (act != &sps[pps[s.pps_id].sps_id] || actp != &pps[s.pps_id])
            invalid("slices of one picture refer to different parameter sets");
        if (scanning) return;
        if (!s.dependent) ref_lists(s);
        slices.push_back(s);
        slice_data(slices.back(), (int)slices.size() - 1);
    }

    // decode one MP4 sample (length_size-byte NAL lengths; 0: data is one
    // NAL unit); returns whether a picture was finished
    bool decode(const uint8_t* data, size_t n, int length_size) {
        done = nullptr;
        out_tags.clear();
        if (length_size == 0) {
            nal(data, n);
        } else {
            size_t p = 0;
            while (p + length_size <= n) {
                size_t len = 0;
                for (int i = 0; i < length_size; i++) len = (len << 8) | data[p + i];
                p += length_size;
                if (p + len > n) invalid("a NAL unit of %zu bytes overruns its sample", len);
                nal(data + p, len);
                p += len;
            }
        }
        if (in_pic && length_size) finish_picture();
        return done != nullptr;
    }

    // the finished picture: luma rows, then rows of interleaved Cb Cr, in
    // bytes (8-bit) or in native 16-bit words (10-bit)
    template <int BD>
    void output(uint8_t* buf) const {
        Pel<BD>* y = reinterpret_cast<Pel<BD>*>(buf);
        memcpy(y, done->plane<BD>(0), (size_t)W * H * sizeof(Pel<BD>));
        Pel<BD>* uv = y + (size_t)W * H;
        const Pel<BD>* cb = done->plane<BD>(1);
        const Pel<BD>* cr = done->plane<BD>(2);
        for (size_t k = 0; k < (size_t)W * H / 4; k++) {
            uv[2 * k] = cb[k];
            uv[2 * k + 1] = cr[k];
        }
    }
    // the finished picture's own depth (its 16-bit planes are filled)
    void output(uint8_t* buf) const {
        if (!done->y16.empty())
            output<10>(buf);
        else
            output<8>(buf);
    }
    size_t output_bytes() const { return (size_t)W * H * 3 / 2 * (done->y16.empty() ? 1 : 2); }

    void reset() {
        for (auto& q : pool) q->in_dpb = q->ref = q->lt = q->output = false;
        cur = done = nullptr;
        in_pic = skip_pic = false;
        first_pic = true;
        after_eos = false;
        slices.clear();
        prev_tid0_poc = 0;
    }

    // The scan of a sample (or of one NAL unit where length_size is 0): its
    // parameter sets, ends of sequence and first slice segment header,
    // through POC, the RPS and the DPB's output process (C.5.2) with no
    // slice data; the pictures are named by t. data may hold the sample in
    // part. rec = (nal_unit_type of the first slice segment, -1 where data
    // holds none; the byte offset of the first NAL unit after it that data
    // does not hold whole, -1 where none).
    void scan(const uint8_t* data, size_t n, int length_size, int64_t t, int32_t* rec) {
        rec[0] = rec[1] = -1;
        tag = t;
        scanning = true;
        struct Done {
            bool& flag;
            ~Done() { flag = false; }
        } done_scanning{scanning};
        auto one = [&](const uint8_t* d, size_t len) {
            if (len < 2) invalid("a NAL unit shorter than its header");
            int type = (d[0] >> 1) & 63, layer = ((d[0] & 1) << 5) | (d[1] >> 3);
            bool vcl = type <= 9 || (type >= 16 && type <= 21);
            if (layer > 0 || (vcl && rec[0] >= 0)) return;  // the picture's other slice segments
            if (vcl) rec[0] = type;
            if (vcl || type == 33 || type == 34 || type == 36 || type == 37) nal(d, len);
        };
        if (length_size == 0) return one(data, n);
        size_t p = 0;
        while (p + length_size <= n) {
            size_t len = 0, at = p;
            for (int i = 0; i < length_size; i++) len = (len << 8) | data[p + i];
            p += length_size;
            if (p + len <= n) {
                one(data + p, len);
                p += len;
                continue;
            }
            // held in part: a slice segment's first bytes hold its header
            int type = p + 2 <= n ? (data[p] >> 1) & 63 : -1;
            bool vcl = type >= 0 && (type <= 9 || (type >= 16 && type <= 21));
            if (vcl && rec[0] < 0) {
                one(data + p, n - p);
                rec[1] = (int32_t)std::min(p + len, (size_t)INT32_MAX);
            } else {
                rec[1] = (int32_t)at;
            }
            return;
        }
    }

    // The end of a scanned sample: its picture finished; at the stream's
    // end (last), every picture waiting output.
    void scan_end(bool last) {
        scanning = true;
        if (in_pic) finish_picture();
        if (last)
            while (n_waiting()) bump();
        scanning = false;
    }

    // ---- the writer ----

    void put_nal(int type, const std::vector<uint8_t>& payload, std::vector<uint8_t>& dst,
                 std::vector<size_t>* map = nullptr) {
        std::vector<uint8_t> out = {(uint8_t)(type << 1), 1};
        if (map) map->clear();
        int zeros = 0;
        for (uint8_t x : payload) {
            if (zeros >= 2 && x <= 3) {
                out.push_back(3);
                zeros = 0;
            }
            if (map) map->push_back(out.size() - 2);
            out.push_back(x);
            zeros = x == 0 ? zeros + 1 : 0;
        }
        uint32_t len = (uint32_t)out.size();
        for (int i = 3; i >= 0; i--) dst.push_back((uint8_t)(len >> (8 * i)));
        dst.insert(dst.end(), out.begin(), out.end());
    }

    // the writer's plan of each picture, decode order
    struct WPic {
        int nal_type = 1, type = 1, poc = 0, output = 1, eos_before = 0;
        ShortRps st;
        std::vector<std::array<int, 3>> lt;  // (POC, used, msb_present)
        int sps_set = -1;                    // index of st among the SPS's sets
    };
    std::vector<WPic> plan;
    size_t w_next = 0;

    void w_open(const int32_t* opts, int n, const int32_t* pl, int npl, uint64_t seed) {
        int* fields = &wo.width;
        for (int i = 0; i < std::min(n, WOPTS_N); i++) fields[i] = opts[i];
        e.W = true;
        e.rng.s = seed;
        Rng& r = e.rng;
        int cb = 1 << wo.log2_min_cb;  // the coded size: whole smallest CBs
        int W8 = (wo.width + cb - 1) / cb * cb, H8 = (wo.height + cb - 1) / cb * cb;
        SPS s;
        s.profile_idc = wo.profile;
        s.W = W8;
        s.H = H8;
        s.conf = W8 != wo.width || H8 != wo.height;
        s.conf_r = (W8 - wo.width) / 2;
        s.conf_b = (H8 - wo.height) / 2;
        s.log2_ctb = wo.log2_ctb;
        s.log2_min_cb = wo.log2_min_cb;
        s.log2_min_tb = 2;
        s.log2_max_tb = std::min(wo.log2_ctb, 5);
        s.max_th_depth_inter = std::min(wo.depth_inter, s.log2_ctb - 2);
        s.max_th_depth_intra = std::min(wo.depth_intra, s.log2_ctb - 2);
        s.scaling_enabled = wo.scaling > 0;
        s.scaling_present = wo.scaling == 2;
        s.amp = wo.amp;
        s.sao = wo.sao;
        s.pcm = wo.pcm;
        s.bit_depth = s.bit_depth_c = wo.bit_depth;
        s.pcm_bits = r.range(5, s.bit_depth);
        s.pcm_bits_c = r.range(5, s.bit_depth_c);
        s.log2_min_pcm = 3;
        s.log2_max_pcm = std::min(5, s.log2_ctb);
        s.pcm_loop_filter_disabled = wo.pcm_loop_filter_disabled;
        s.log2_max_poc_lsb = wo.log2_max_poc_lsb;
        s.max_num_reorder = wo.reorder;
        s.temporal_mvp = wo.tmvp > 0;
        s.strong_intra_smoothing = r.chance(50);
        s.vui = 1;
        s.signal_type = 1;
        s.full_range = wo.full_range;
        s.colour_desc = wo.colour;
        s.matrix = wo.matrix;
        s.vui_extra = wo.vui_extra;
        s.chroma_loc = wo.chroma_loc;
        s.long_term_present = wo.long_term;
        plan_rps(pl, npl, s);
        e.bw.clear();
        sps_syntax(e, s, &r);
        e.bw.u(1, 1);  // rbsp_trailing_bits
        e.bw.align(0);
        std::vector<uint8_t> sps_rbsp = e.bw.out;
        sps[0] = s;
        // the PPS
        PPS p;
        p.dependent_slices = wo.dependent_slices;
        p.output_flag_present = wo.output_flag;
        p.extra_bits = wo.extra_bits;
        p.sign_hiding = wo.sign_hiding;
        p.cabac_init_present = wo.cabac_init;
        p.num_ref_idx_default[0] = r.range(1, 3);
        p.num_ref_idx_default[1] = r.range(1, 3);
        p.init_qp = (wo.qp_min + wo.qp_max) / 2;
        p.constrained_intra = wo.constrained_intra;
        p.transform_skip = wo.tskip;
        p.cu_qp_delta = wo.cu_qp_delta;
        if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = std::min(wo.qp_depth, s.log2_ctb - s.log2_min_cb);
        p.cb_qp_offset = wo.cb_qp_offset;
        p.cr_qp_offset = wo.cr_qp_offset;
        p.slice_chroma_offsets = wo.slice_chroma_offsets;
        p.weighted_pred = p.weighted_bipred = wo.weighted;
        p.transquant_bypass = wo.bypass;
        int cw = s.ctbw, ch = s.ctbh;
        p.tile_cols = std::min(wo.tile_cols, cw);
        p.tile_rows = std::min(wo.tile_rows, ch);
        p.tiles = p.tile_cols * p.tile_rows > 1;
        p.uniform = wo.uniform;
        if (p.tiles && !p.uniform) {
            auto split = [&](int total, int k, std::vector<int>& out) {
                out.assign(k, 1);
                for (int left = total - k; left > 0; left--) out[r.range(0, k - 1)]++;
            };
            split(cw, p.tile_cols, p.col_w);
            split(ch, p.tile_rows, p.row_h);
        }
        p.wpp = wo.wpp;
        p.lf_across_tiles = wo.lf_across_tiles;
        p.lf_across_slices = wo.lf_across_slices;
        p.deblock_control = wo.deblock != 1 || wo.deblock_override || wo.deblock_offsets;
        p.deblock_override = wo.deblock_override;
        p.deblock_disabled = wo.deblock == 0;
        if (!p.deblock_disabled && wo.deblock_offsets && !p.deblock_override) {  // (the notes above)
            p.beta_offset = r.range(-6, 6);
            p.tc_offset = r.range(-6, 6);
        }
        p.scaling_present = wo.scaling == 3;
        p.lists_modification = wo.list_mod;
        p.log2_par_mrg = std::min(wo.par_mrg, s.log2_ctb);
        p.header_extension = wo.header_ext;
        e.bw.clear();
        pps_syntax(e, p, &r);
        e.bw.u(1, 1);
        e.bw.align(0);
        std::vector<uint8_t> pps_rbsp = e.bw.out;
        pps[0] = p;
        // the VPS
        e.bw.clear();
        e.u(4, 0);
        e.u(1, 1);
        e.u(1, 1);
        e.u(6, 0);
        e.u(3, 0);
        e.u(1, 1);
        e.u(16, 0xFFFF);
        profile_tier_level(e, 0, s.profile_idc);
        e.u(1, 1);
        e.ue(s.max_dec_pic_buffering - 1);
        e.ue(s.max_num_reorder);
        e.ue(0);
        e.u(6, 0);
        e.ue(0);
        e.u(1, 0);
        e.u(1, 0);
        e.u(1, 1);
        e.bw.align(0);
        std::vector<uint8_t> vps_rbsp = e.bw.out;
        param_nals.clear();
        put_nal(32, vps_rbsp, param_nals);
        put_nal(33, sps_rbsp, param_nals);
        put_nal(34, pps_rbsp, param_nals);
        act = nullptr;
        activate(pps[0]);
    }

    // The RPS of every picture of the plan (rows of PLAN_N: nal_unit_type,
    // slice_type, POC, pic_output_flag, an end of sequence before it): the writer keeps the last max_refs
    // reference pictures, drops those before an IRAP at the first trailing
    // picture after it, and (long_term) turns a GOP's IRAP into a long-term
    // picture two pictures after it. The SPS gets the distinct short-term
    // sets, and (lt_sps) the POC lsbs of the long-term pictures.
    static const int PLAN_N = 5;

    void plan_rps(const int32_t* pl, int npl, SPS& s) {
        Rng& r = e.rng;
        struct Ref {
            int poc, idx;
            bool lt, pre;
        };
        std::vector<Ref> R;
        int irap_idx = -1, irap_poc = 0, maxlsb = 1 << s.log2_max_poc_lsb, most = 1;
        std::vector<ShortRps> sets;
        std::vector<int> lt_lsbs;
        plan.clear();
        for (int k = 0; k < npl; k++) {
            WPic w;
            w.nal_type = pl[PLAN_N * k];
            w.type = pl[PLAN_N * k + 1];
            w.poc = pl[PLAN_N * k + 2];
            w.output = pl[PLAN_N * k + 3];
            w.eos_before = pl[PLAN_N * k + 4];
            int t = w.nal_type;
            bool irap = is_irap(t), leading = is_rasl(t) || is_radl(t);
            if (k == 0 && t == 21 && k + 1 < npl && is_rasl(pl[PLAN_N])) {
                // a stream cut before its first CRA: the RASL pictures refer
                // to a picture the stream does not hold
                int lo = w.poc;
                for (int j = 1; j < npl && is_rasl(pl[PLAN_N * j]); j++) lo = std::min(lo, pl[PLAN_N * j + 2]);
                R.push_back({lo - 1, -1, false, true});
            }
            if (is_idr(t)) R.clear();
            if (irap && k > 0)  // no picture before the previous IRAP (7.4.3.2's CRA rule)
                R.erase(std::remove_if(R.begin(), R.end(), [](const Ref& x) { return x.pre; }), R.end());
            if (!irap && !leading) {
                R.erase(std::remove_if(R.begin(), R.end(), [](const Ref& x) { return x.pre; }), R.end());
                if (wo.long_term && irap_idx >= 0 && k >= irap_idx + 2)
                    for (Ref& x : R)
                        if (x.idx == irap_idx) x.lt = true;
            }
            std::vector<int> elig;
            for (size_t i = 0; i < R.size(); i++)
                if (!(is_radl(t) && R[i].pre)) elig.push_back((int)i);
            std::vector<int> used(R.size(), 0);
            if (w.type != 2 && !irap) {
                for (int i : elig) used[i] = r.chance(65);
                if (!elig.empty()) used[elig[r.range(0, (int)elig.size() - 1)]] = 1;
            }
            std::vector<std::pair<int, int>> neg, pos;
            for (size_t i = 0; i < R.size(); i++) {
                if (R[i].lt) {
                    w.lt.push_back({R[i].poc, used[i], 0});
                } else if (R[i].poc < w.poc) {
                    neg.push_back({R[i].poc - w.poc, used[i]});
                } else {
                    pos.push_back({R[i].poc - w.poc, used[i]});
                }
            }
            std::sort(neg.begin(), neg.end(), [](auto a, auto b) { return a.first > b.first; });
            std::sort(pos.begin(), pos.end());
            w.st.n_neg = (int)neg.size();
            w.st.n_pos = (int)pos.size();
            if (w.st.n() > 16) invalid("writer: an RPS of more than 16 pictures");
            for (int i = 0; i < w.st.n_neg; i++) w.st.delta[i] = neg[i].first, w.st.used[i] = (uint8_t)neg[i].second;
            for (int i = 0; i < w.st.n_pos; i++)
                w.st.delta[w.st.n_neg + i] = pos[i].first, w.st.used[w.st.n_neg + i] = (uint8_t)pos[i].second;
            if (w.type != 2 && !irap && w.st.n() + (int)w.lt.size() == 0) invalid("writer: a P or B picture with no reference");
            if (!is_idr(t)) {
                int found = -1;
                for (size_t i = 0; i < sets.size() && found < 0; i++) {
                    bool same = sets[i].n_neg == w.st.n_neg && sets[i].n_pos == w.st.n_pos;
                    for (int j = 0; j < w.st.n() && same; j++)
                        same = sets[i].delta[j] == w.st.delta[j] && sets[i].used[j] == w.st.used[j];
                    if (same) found = (int)i;
                }
                if (found < 0 && sets.size() < 16 && r.chance(70)) {
                    sets.push_back(w.st);
                    found = (int)sets.size() - 1;
                }
                w.sps_set = found;
            }
            for (auto& l : w.lt) {
                int lsb = l[0] & (maxlsb - 1);
                if (std::find(lt_lsbs.begin(), lt_lsbs.end(), lsb) == lt_lsbs.end()) lt_lsbs.push_back(lsb);
            }
            most = std::max(most, (int)R.size() + 1);
            plan.push_back(w);
            bool is_ref = irap || (t <= 14 && (t & 1));
            if (irap) {
                if (k > 0)  // the picture a cut stream's first RASL pictures refer to: gone
                    R.erase(std::remove_if(R.begin(), R.end(), [](const Ref& x) { return x.idx < 0; }), R.end());
                for (Ref& x : R) x.pre = true;
                irap_idx = k;
                irap_poc = w.poc;
            }
            if (is_ref) {
                R.push_back({w.poc, k, false, false});
                int n_st = 0;
                for (const Ref& x : R) n_st += !x.lt && !x.pre;
                while (n_st > wo.max_refs) {  // the oldest short-term one goes
                    auto it = std::find_if(R.begin(), R.end(), [](const Ref& x) { return !x.lt && !x.pre; });
                    R.erase(it);
                    n_st--;
                }
            }
        }
        (void)irap_poc;
        s.num_st_rps = (int)sets.size();
        for (size_t i = 0; i < sets.size(); i++) s.st_rps[i] = sets[i];
        if (wo.lt_sps && s.long_term_present) {
            s.num_lt_sps = std::min((int)lt_lsbs.size(), 32);
            for (int i = 0; i < s.num_lt_sps; i++) {
                s.lt_lsb_sps[i] = lt_lsbs[i];
                s.lt_used_sps[i] = 1;
            }
        }
        s.max_dec_pic_buffering = std::min(16, most + wo.reorder + 1);
    }

    // the CTB runs of the picture's slice segments (tile scan): (start, end, dependent)
    std::vector<std::array<int, 3>> plan_segments() {
        Rng& r = e.rng;
        const SPS& sp = *act;
        const PPS& p = *actp;
        int n = sp.nctb;
        std::vector<int> cuts;  // segment starts
        cuts.push_back(0);
        int tiles = p.tile_cols * p.tile_rows;
        std::vector<int> tile_start(tiles + 1, n);
        for (int ts = 0; ts < n; ts++)
            if (ts == 0 || tile_id[ts] != tile_id[ts - 1]) tile_start[tile_id[ts]] = ts;
        if (wo.max_slices > 1) {
            if (tiles > 1) {
                for (int t = 0; t < tiles; t++) {
                    int a = tile_start[t], b = tile_start[t + 1];
                    if (t > 0 && r.chance(60)) cuts.push_back(a);
                    if (r.chance(40))
                        for (int k = r.range(1, 2); k > 0; k--) {
                            int c = r.range(a + 1, b - 1);
                            if (c > a && c < b) cuts.push_back(c);
                        }
                }
            } else {
                for (int k = n > 1 ? r.range(0, 2 * wo.max_slices - 1) : 0; k > 0; k--) cuts.push_back(r.range(1, n - 1));
            }
            std::sort(cuts.begin(), cuts.end());
            cuts.erase(std::unique(cuts.begin(), cuts.end()), cuts.end());
            if (tiles > 1) {
                // a segment inside a tile ends inside it; one that spans tiles is whole tiles
                std::vector<int> fixed;
                for (size_t i = 0; i < cuts.size(); i++) {
                    int a = cuts[i];
                    fixed.push_back(a);
                    int b = i + 1 < cuts.size() ? cuts[i + 1] : n;
                    int tend = tile_start[tile_id[a] + 1];
                    if (b > tend && a != tile_start[tile_id[a]]) fixed.push_back(tend);
                    else if (b > tend && a == tile_start[tile_id[a]] && b != tile_start[tile_id[b - 1] + 1] &&
                             b != n)
                        fixed.push_back(tile_start[tile_id[b - 1]]);
                }
                cuts = fixed;
                std::sort(cuts.begin(), cuts.end());
                cuts.erase(std::unique(cuts.begin(), cuts.end()), cuts.end());
            }
            if (p.wpp) {  // one that starts inside a row ends in that row
                std::vector<int> fixed;
                for (size_t i = 0; i < cuts.size(); i++) {
                    int a = cuts[i], b = i + 1 < cuts.size() ? cuts[i + 1] : n;
                    fixed.push_back(a);
                    int rowend = (a / sp.ctbw + 1) * sp.ctbw;
                    if (a % sp.ctbw && b > rowend) fixed.push_back(rowend);
                }
                cuts = fixed;
            }
        }
        std::vector<std::array<int, 3>> segs;
        int slice_start = 0;
        for (size_t i = 0; i < cuts.size(); i++) {
            int a = cuts[i], b = i + 1 < cuts.size() ? cuts[i + 1] : n;
            int dep = i > 0 && p.dependent_slices && r.chance(50);
            if (dep) {  // the slice it extends must still be legal
                int sa = slice_start;
                if (tiles > 1 && tile_id[sa] != tile_id[b - 1] &&
                    !(sa == tile_start[tile_id[sa]] && b == tile_start[tile_id[b - 1] + 1]))
                    dep = 0;
                if (p.wpp && sa % sp.ctbw && (b - 1) / sp.ctbw != sa / sp.ctbw) dep = 0;
            }
            if (!dep) slice_start = a;
            segs.push_back({a, b, dep});
        }
        return segs;
    }

    void w_picture(int k) {
        if (k < 0 || k >= (int)plan.size()) invalid("writer: no picture %d in the plan", k);
        const WPic& w = plan[k];
        Rng& r = e.rng;
        tag = k;
        const SPS& sp = sps[0];
        const PPS& p = pps[0];
        nals.clear();
        int maxlsb = 1 << sp.log2_max_poc_lsb;
        SliceHdr base;
        base.nal_type = w.nal_type;
        base.type = w.type;
        base.first = 1;
        base.pic_output = w.output;
        base.poc_lsb = w.poc & (maxlsb - 1);
        base.no_output_prior = is_irap(w.nal_type) && k > 0 && r.chance(50);
        // the short-term set: the SPS's, or the slice's own (predicted from one where that works)
        if (w.sps_set >= 0 && r.chance(70)) {
            base.st_sps = 1;
            base.st_idx = w.sps_set;
        } else {
            base.st_sps = 0;
            base.st = w.st;
            base.st_pred = -1;
            for (int j = sp.num_st_rps - 1; j >= 0 && base.st_pred < 0; j--) {
                ShortRps t = w.st;
                if (rps_predictable(sp.st_rps[j], t) && r.chance(60)) {
                    base.st = t;
                    base.st_pred = j;
                }
            }
        }
        // long-term pictures: by the SPS's lsb where it lists it, else coded
        {
            std::vector<std::array<int, 4>> sps_lt, own;  // (poc, used, lsb or idx, msb)
            for (auto& l : w.lt) {
                int lsb = l[0] & (maxlsb - 1), idx = -1;
                for (int i = 0; i < sp.num_lt_sps; i++)
                    if (sp.lt_lsb_sps[i] == lsb && sp.lt_used_sps[i] == l[1]) idx = i;
                // the lsb alone is ambiguous where another picture of the stream so far shares it
                bool clash = false;
                for (int j = 0; j < k; j++)
                    if (plan[j].poc != l[0] && (plan[j].poc & (maxlsb - 1)) == lsb) clash = true;
                int msb = clash || r.chance(30);
                if (idx >= 0 && r.chance(70))
                    sps_lt.push_back({l[0], l[1], idx, msb});
                else
                    own.push_back({l[0], l[1], lsb, msb});
            }
            base.n_lt_sps = (int)sps_lt.size();
            base.n_lt_pics = (int)own.size();
            int i = 0;
            for (auto* grp : {&sps_lt, &own})
                for (auto& l : *grp) {
                    if (grp == &sps_lt)
                        base.lt_idx_sps[i] = l[2];
                    else
                        base.poc_lsb_lt[i] = l[2], base.used_lt[i] = l[1];
                    base.msb_present[i] = l[3];
                    int cur_msb = w.poc - (w.poc & (maxlsb - 1)), lt_msb = l[0] - (l[0] & (maxlsb - 1));
                    base.msb_cycle[i] = (cur_msb - lt_msb) / maxlsb;
                    if (base.msb_cycle[i] < 0) invalid("writer: a long-term picture after the current one");
                    i++;
                }
            // within each group the cycles must not fall (they are coded as differences)
            for (int g = 0; g < 2; g++) {
                int a = g ? base.n_lt_sps : 0, b = g ? base.n_lt_sps + base.n_lt_pics : base.n_lt_sps;
                int last = 0;
                for (int j = a; j < b; j++) {
                    if (base.msb_present[j]) {
                        if (base.msb_cycle[j] < last) base.msb_present[j] = 0;
                        else last = base.msb_cycle[j];
                    }
                }
            }
        }
        base.tmvp = sp.temporal_mvp && w.type != 2 && r.chance(70);
        base.pps_id = 0;
        start_picture(base);
        if (cur->poc != w.poc) invalid("writer: POC %d decodes as %d (an lsb jump of half the range)", w.poc, cur->poc);
        // the lists, the same for every slice of the picture
        int total = n_curr[0] + n_curr[1] + n_curr[2];
        if (w.type != 2) {
            for (int l = 0; l < (w.type == 0 ? 2 : 1); l++) {
                base.num_ref_idx[l] = r.chance(40) ? p.num_ref_idx_default[l] : r.range(1, std::min(4, total + 1));
                base.mod_flag[l] = p.lists_modification && total > 1 && r.chance(60);
                for (int i = 0; i < base.num_ref_idx[l]; i++) base.list_entry[l][i] = r.range(0, total - 1);
            }
            if (base.tmvp) {
                base.col_from_l0 = w.type == 0 ? r.chance(50) : 1;
                int l = base.col_from_l0 ? 0 : 1;
                base.col_ref_idx = r.range(0, base.num_ref_idx[l] - 1);
            }
        }
        // one value a picture (the notes above), the one a slice infers where it codes none
        int lf_across = (p.deblock_disabled || p.deblock_override) ? 1 : r.chance(50);
        auto segs = plan_segments();
        slices.clear();
        for (auto& seg : segs) {
            SliceHdr s = base;
            s.first = seg[0] == 0;
            s.address = ts2rs[seg[0]];
            s.dependent = seg[2];
            w_end_ts = seg[1];
            if (!s.dependent) {
                s.sao_luma = sp.sao && r.chance(80);
                s.sao_chroma = sp.sao && sp.log2_ctb > 4 && r.chance(70);  // (the notes above)
                s.mvd_l1_zero = w.type == 0 && r.chance(30);
                s.cabac_init = p.cabac_init_present && r.chance(50);
                s.max_merge = wo.max_merge ? wo.max_merge : r.range(1, 5);
                s.qp_delta = r.range(wo.qp_min, wo.qp_max) - p.init_qp;
                s.cb_off = p.slice_chroma_offsets ? clip3(-12 - p.cb_qp_offset, 12 - p.cb_qp_offset, r.range(-4, 4)) : 0;
                s.cr_off = p.slice_chroma_offsets ? clip3(-12 - p.cr_qp_offset, 12 - p.cr_qp_offset, r.range(-4, 4)) : 0;
                s.deblock_override = p.deblock_override && r.chance(60);
                if (s.deblock_override) {
                    s.deblock_disabled = r.chance(30);
                    s.beta_offset = s.deblock_disabled ? 0 : p.beta_offset;  // (the notes above)
                    s.tc_offset = s.deblock_disabled ? 0 : p.tc_offset;
                } else {
                    s.deblock_disabled = p.deblock_disabled;
                    s.beta_offset = p.beta_offset;
                    s.tc_offset = p.tc_offset;
                }
                s.lf_across = p.lf_across_slices ? lf_across : 0;
                if ((p.weighted_pred && w.type == 1) || (p.weighted_bipred && w.type == 0)) {
                    s.luma_denom = r.range(0, 7);
                    s.chroma_denom = r.range(0, 7);
                    for (int l = 0; l < (w.type == 0 ? 2 : 1); l++)
                        for (int i = 0; i < s.num_ref_idx[l]; i++) {
                            s.lw_flag[l][i] = r.chance(60);
                            s.cw_flag[l][i] = r.chance(60);
                            s.lw[l][i] = (1 << s.luma_denom) + r.range(-20, 20);
                            s.lo[l][i] = r.range(-30, 30);
                            for (int j = 0; j < 2; j++) {
                                s.cw[l][i][j] = (1 << s.chroma_denom) + r.range(-20, 20);
                                s.co[l][i][j] = r.range(-60, 60);
                            }
                        }
                }
                s.ext_len = p.header_extension ? r.range(0, 3) : 0;
            }
            // substreams: entry points, sized after the data is written
            s.n_entry = 0;
            if (p.tiles || p.wpp)
                for (int ts = seg[0] + 1; ts < seg[1]; ts++) {
                    int rs = ts2rs[ts];
                    if ((p.tiles && tile_id[ts] != tile_id[ts - 1]) ||
                        (p.wpp && (rs % sp.ctbw == 0 || tile_id[ts] != tile_id[rs2ts[rs - 1]])))
                        s.n_entry++;
                }
            s.entry.assign(s.n_entry, 1);
            s.offset_len = 1;
            e.bw.clear();
            slice_header(s);
            if (!s.dependent) ref_lists(s);
            slices.push_back(s);
            SliceHdr& sl = slices.back();
            e.bw.clear();
            slice_data(sl, (int)slices.size() - 1);
            std::vector<uint8_t> data = e.bw.out;
            std::vector<size_t> starts = sub_starts;
            std::vector<uint8_t> out, payload;
            std::vector<size_t> map;
            for (int iter = 0; iter < 8; iter++) {
                e.bw.clear();
                SliceHdr h = sl;
                slice_header(h);
                payload = e.bw.out;
                size_t hl = payload.size();
                payload.insert(payload.end(), data.begin(), data.end());
                out.clear();
                put_nal(w.nal_type, payload, out, &map);
                std::vector<uint32_t> sizes;
                for (size_t i = 0; i + 1 < starts.size(); i++)
                    sizes.push_back((uint32_t)(map[hl + starts[i + 1]] - map[hl + starts[i]]));
                uint32_t mx = 1;
                for (uint32_t v : sizes) mx = std::max(mx, v);
                int len = std::max(1, ceil_log2((int)mx));
                if ((1u << len) < mx) len++;
                if (sizes == sl.entry && len == sl.offset_len) break;
                sl.entry = sizes;
                sl.offset_len = len;
                if (iter == 7) invalid("writer: entry points do not settle");
            }
            nals.insert(nals.end(), out.begin(), out.end());
        }
        finish_picture();
        if (k + 1 < (int)plan.size() && plan[k + 1].eos_before) {
            put_nal(36, {}, nals);  // end of sequence: the IRAP after it starts a new one
            after_eos = true;
        }
    }
};

int fail(const std::exception& ex, int code, char* err, int errlen) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", ex.what());
    return code;
}

}  // namespace

extern "C" {

void* hevc_open() { return new Decoder(); }

void hevc_close(void* h) { delete static_cast<Decoder*>(h); }

// Decode one MP4 sample of NAL units with length_size-byte lengths (0: data
// is one NAL unit, as a parameter set from hvcC). Where it finishes a
// picture (output or not: hevc_scan tells), *got is 1 and the picture is
// written into nv12 of cap bytes (the coded width x height luma rows, then
// as many half rows of interleaved Cb Cr; 16-bit words where the SPS says
// 10 bits, as P010 less its shift).
int hevc_decode(void* h, const uint8_t* data, int64_t n, int length_size, uint8_t* nv12, int64_t cap,
                int32_t* got, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    *got = 0;
    try {
        if (d->decode(data, (size_t)n, length_size)) {
            *got = 1;
            if ((int64_t)d->output_bytes() > cap && nv12)
                invalid("a picture larger than its buffer (the size or the bit depth changed)");
            if (nv12) d->output(nv12);
        }
        return 0;
    } catch (const Unsupported& ex) {
        d->reset();
        return fail(ex, -2, err, errlen);
    } catch (const std::exception& ex) {
        d->reset();
        return fail(ex, -1, err, errlen);
    }
}

// The stream's format from its active (else first) SPS: coded width and
// height, the conformance window (left, top, width, height), VUI
// video_signal_type (present, full range, colour description present,
// matrix), the bit depth and the VUI's chroma_sample_loc_type_top_field
// (-1: none).
int hevc_info(void* h, int32_t* rec) {
    Decoder* d = static_cast<Decoder*>(h);
    const SPS* s = d->any_sps();
    if (!s) return -1;
    int v[12] = {s->W, s->H, 2 * s->conf_l, 2 * s->conf_t, s->W - 2 * (s->conf_l + s->conf_r),
                 s->H - 2 * (s->conf_t + s->conf_b), s->signal_type, s->full_range, s->colour_desc, s->matrix,
                 s->bit_depth, s->chroma_loc};
    memcpy(rec, v, sizeof v);
    return 0;
}

// Forget every picture (a new decode run starts at an IRAP picture).
void hevc_reset(void* h) { static_cast<Decoder*>(h)->reset(); }

// The scan of a sample (Decoder::scan): with no slice data, what a
// decode of it does to the DPB, its pictures named by tag. rec =
// (nal_unit_type of its first slice segment, -1 where none; the byte offset
// of the first NAL unit data does not hold whole, -1 where none): the
// caller passes that one and those after it that are parameter sets or ends
// of sequence (types 33, 34, 36, 37), each alone with length_size 0, then
// calls hevc_scan_end.
int hevc_scan(void* h, const uint8_t* data, int64_t n, int length_size, int64_t tag, int32_t* rec,
              char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    try {
        d->scan(data, (size_t)n, length_size, tag, rec);
        return 0;
    } catch (const Unsupported& ex) {
        return fail(ex, -2, err, errlen);
    } catch (const std::exception& ex) {
        return fail(ex, -1, err, errlen);
    }
}

// The end of a scanned sample (last: and of the stream, every picture
// waiting output): the tags of the pictures output since the last call, in
// output order, into out (their count is returned; at most cap written).
// On a writer, after its last picture: the pictures a decoder outputs.
int64_t hevc_scan_end(void* h, int last, int64_t* out, int64_t cap) {
    Decoder* d = static_cast<Decoder*>(h);
    d->scan_end(last != 0);
    int64_t n = (int64_t)d->out_tags.size();
    if (out && n) memcpy(out, d->out_tags.data(), sizeof(int64_t) * (size_t)std::min(n, cap));
    d->out_tags.clear();
    return n;
}

// The writer: opts as WOpts' fields in order, the plan as npl rows of
// (nal_unit_type, slice_type, POC, pic_output_flag, an end of sequence
// before it) in decode order; the
// parameter sets are written at once.
void* hevcw_open(const int32_t* opts, int n, const int32_t* plan, int npl, uint64_t seed, char* err, int errlen) {
    Decoder* d = new Decoder();
    try {
        d->w_open(opts, n, plan, npl, seed);
        return d;
    } catch (const std::exception& ex) {
        fail(ex, -1, err, errlen);
        delete d;
        return nullptr;
    }
}

void hevcw_close(void* h) { delete static_cast<Decoder*>(h); }

// The VPS, SPS and PPS, each with a 4-byte length.
int64_t hevcw_param_sets(void* h, uint8_t* out, int64_t cap) {
    Decoder* d = static_cast<Decoder*>(h);
    int64_t n = (int64_t)d->param_nals.size();
    if (out && n <= cap) memcpy(out, d->param_nals.data(), n);
    return n;
}

// Picture k of the plan: its NAL units, each with a 4-byte length, in out
// (*n bytes; -3 where cap is too small).
int hevcw_picture(void* h, int k, uint8_t* out, int64_t cap, int64_t* n, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    try {
        d->w_picture(k);
        *n = (int64_t)d->nals.size();
        if (*n > cap) return -3;
        memcpy(out, d->nals.data(), *n);
        return 0;
    } catch (const std::exception& ex) {
        return fail(ex, -1, err, errlen);
    }
}

}  // extern "C"
