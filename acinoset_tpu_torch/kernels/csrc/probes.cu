// The Mosaic probe kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/probe_mosaic.py (k1..k8, called by
// t1..t8) and scripts/probe_mosaic2.py (k1..k3 and chain_kernel, called by
// t1..t3 and time_chain). Each probe asks whether the chip expresses one
// pattern that the batched banded Cholesky (banded_chol.cu) is built from:
// batched 32 x 32 products, lane reductions, copies through a ring of
// shared-memory slots, dynamic scratch indexing, in-place recurrences,
// transposed contractions, and the latency of a chain of dependent 32 x 32
// products. Every kernel computes what its TPU kernel computes, in the
// Hopper mechanism that corresponds; none is a transcription of Mosaic
// tiles. Every tile is 32 x 32 float32, row-major.
//
// What bounds them on an H100. At the probes' shapes (16 or 4 tiles of
// 4 KB) every kernel but the chain moves at most 200 KB and does at most
// 1 MFLOP, under 0.1 us of bandwidth or FP32 peak: each is bound by its
// launch and its one pass through device memory, and the design keeps
// that pass coalesced. The chain (row 12) does K dependent products on
// data that stays on one SM a tile, so a step is bound by that SM: FP32 by
// the issue of its FMAs (A in registers, one float2 of x a k), TF32 by one
// round trip of x through shared memory around eight tensor-core MMAs a
// warp (a fragment load, the MMAs, a store, one __syncwarp).
//
// Each launcher is extern "C": device pointers, sizes and a stream in, the
// CUDA error of the launch out (0 on success). Shapes are checked by the
// Python wrapper (kernels/probes_cuda.py); the launchers refuse sizes that
// would overrun shared memory.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

namespace {

constexpr int T = 32;        // tile edge
constexpr int TILE = T * T;  // floats per tile
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may have on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously (both
// 16-byte aligned); completes at cp.async.wait_group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// ---- row 1: probe_mosaic.k1, batched dot (B,32,32) @ (B,32,32), HIGHEST:
// FP32 FMAs, no TF32. One CTA of DOT_THREADS = 128 threads a tile. Its
// threads first copy both operands into shared memory with 16-byte
// cp.async, all eight a thread in flight together, rows padded to DOT_LD =
// 36 floats (16-byte aligned, each row 4 banks on from the last). Thread
// (r, c) then owns a 2 x 4 block of the output in registers, rows r and
// r + 16 by columns 4c..4c+3: per 4 steps of k it reads one float4 of each
// of its two rows of a (a warp's four r, consecutive rows, fall on 16
// distinct banks) and one float4 of each of the four rows of b it needs
// (the warp's eight c cover one row, 32 banks), and issues 32 FMAs: 6
// shared-memory reads per 32 FMAs, where the parent's 1,024 threads read
// two words per FMA. Each sum runs in k order; the block is written as
// float4. At the probe's shape (16 tiles) the launch and one round trip
// bound it; at the flagship's (38,400 tiles) the bytes, each operand read
// once and the output written once, with twelve CTAs an SM (shared memory
// bounds them) so that some CTAs' loads overlap others' FMAs.
constexpr int DOT_LD = T + 4;      // a row of a tile in shared memory, floats
constexpr int DOT_RS = 16;         // a thread's rows of the output: r and r + DOT_RS
constexpr int DOT_THREADS = 8 * DOT_RS;  // eight float4 columns a row

__global__ void __launch_bounds__(DOT_THREADS)
    batched_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ o) {
  __shared__ __align__(16) float as[T * DOT_LD];
  __shared__ __align__(16) float bs[T * DOT_LD];
  const size_t base = (size_t)blockIdx.x * TILE;
#pragma unroll
  for (int i = 0; i < TILE / 4 / DOT_THREADS; ++i) {  // a's copies, then b's
    const int e = 4 * (threadIdx.x + i * DOT_THREADS);
    cp_async16(as + (e / T) * DOT_LD + e % T, a + base + e);
  }
#pragma unroll
  for (int i = 0; i < TILE / 4 / DOT_THREADS; ++i) {
    const int e = 4 * (threadIdx.x + i * DOT_THREADS);
    cp_async16(bs + (e / T) * DOT_LD + e % T, b + base + e);
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  float acc[2][4] = {};
#pragma unroll
  for (int k = 0; k < T; k += 4) {
    float4 av[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      av[j] = *reinterpret_cast<const float4*>(as + (r + DOT_RS * j) * DOT_LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(bs + (k + kk) * DOT_LD + 4 * c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = kk == 0 ? av[j].x : kk == 1 ? av[j].y : kk == 2 ? av[j].z : av[j].w;
        acc[j][0] = fmaf(x, bv.x, acc[j][0]);
        acc[j][1] = fmaf(x, bv.y, acc[j][1]);
        acc[j][2] = fmaf(x, bv.z, acc[j][2]);
        acc[j][3] = fmaf(x, bv.w, acc[j][3]);
      }
    }
  }
  // the stores must stay 128-bit (STG.E.128 in the SASS): variants that
  // ptxas compiled into scalar stores ran 3-6% slower at 38,400 tiles
  float* ot = o + base + r * T + 4 * c;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float4*>(ot + DOT_RS * j * T) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// ---- rows 2 and 7: y[b, i] = sum_j a[b, i, j] v[b, j], a (B,32,32), v (B,32).
// probe_mosaic.k2 (broadcast multiply + lane reduction) and probe_mosaic.k7
// (batched matvec) compute the same function and keep separate kernels, as the
// probes did, behind one device function. Bound by the bytes (each tile read
// once), so the design keeps each tile's bytes in flight together. One CTA of
// one warp a tile. Lane l takes the tile's float4 number l + 32k for k = 0..7,
// that is row (l >> 3) + 4k, columns 4(l & 7)..+3: each of the eight loads is
// one coalesced 512-byte warp access, and all eight are issued before any is
// used: 4 KB a warp, and with 32 such CTAs resident an SM (the most it holds)
// up to 128 KB an SM in flight, well above the ~20 KB that 3.35 TB/s over 132
// SMs needs at ~0.7 us of load latency. Lane l reads v's float4 number l & 7
// once and forms eight partial row sums of four products each (j order). A
// reduce-scatter over the eight lanes of a row group (shuffle distances 4, 2,
// 1; 4 + 2 + 1 values sent) leaves lane l the whole sum of row
// (l >> 3) + 4(l & 7), and the warp writes its 32 sums as one 128-byte store.
// The order of every sum is fixed: the result is the same on every launch.
// Eight tiles a CTA ran as fast at 38,400 tiles but 0.2 us slower at 16, where
// they put the 16 tiles on 2 SMs rather than 16.

// one of two partial sums plus the same one from the lane whose bit `d`
// differs: the lane with bit d clear keeps `lo` and sends `hi`, its partner
// the reverse
__device__ __forceinline__ float fold(float lo, float hi, int d) {
  const bool up = threadIdx.x & d;
  return (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, d);
}

__device__ __forceinline__ void tile_matvec(const float* __restrict__ a,
                                            const float* __restrict__ v,
                                            float* __restrict__ y) {
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x, q = lane & 7;
  const float4* at = reinterpret_cast<const float4*>(a + b * TILE) + lane;
  float4 t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = at[32 * k];
  const float4 w = reinterpret_cast<const float4*>(v + b * T)[q];
  float p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    p[k] = fmaf(t[k].w, w.w, fmaf(t[k].z, w.z, fmaf(t[k].y, w.y, t[k].x * w.x)));
  float r[4], s[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = fold(p[k], p[k + 4], 4);  // sum k + (q & 4)
#pragma unroll
  for (int k = 0; k < 2; ++k) s[k] = fold(r[k], r[k + 2], 2);  // sum k + (q & 6)
  y[b * T + (lane >> 3) + 4 * q] = fold(s[0], s[1], 1);  // sum q
}

__global__ void __launch_bounds__(32)
    lane_reduce_kernel(const float* __restrict__ a, const float* __restrict__ v,
                       float* __restrict__ y) {
  tile_matvec(a, v, y);
}

__global__ void __launch_bounds__(32)
    matvec_kernel(const float* __restrict__ a, const float* __restrict__ v,
                  float* __restrict__ y) {
  tile_matvec(a, v, y);
}

// ---- row 3: probe_mosaic.k3, columns 0..3 of every tile times 2. Columns
// 0..3 of a row are its first 16 bytes, so each thread takes one float4:
// the first of each row's eight is scaled in registers, the rest copied.
__global__ void scale_cols_kernel(const float4* __restrict__ a, float4* __restrict__ o,
                                  size_t n4) {
  const size_t q = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (q >= n4) return;
  float4 v = a[q];
  if (q % (T / 4) == 0) {
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
  }
  o[q] = v;
}

// ---- rows 4 and 6: the bulk-copy probes. Each row of x is split into
// column slices of BULK_THREADS float4 (2 KB; the last may be ragged, still
// a multiple of 16 bytes), and CTA b takes slice b of every row, so the
// grid grows with the row. A thread owns one float4 column of its slice.
// Both are bound by the bytes they move (each row read once and written
// once): the design keeps every CTA's copies in flight together, rather
// than one row's round trip after another's, and keeps each CTA within the
// 48 KB of shared memory a block has without an attribute call, so any row
// that is a multiple of 16 bytes and 16-byte aligned is taken. At the
// probes' own shape (4 rows of 2 KB, one CTA) they are bound instead by the
// launch and the latency of one bulk copy.
constexpr int BULK_THREADS = 128;
constexpr int RING_DEPTH = 16;  // row 4's slots: 32 KB of shared memory
constexpr int OUT_ROUND = 8;    // row 6's rows a round: two sets, 32 KB

// float4 in slice `first / BULK_THREADS` of a row of `row4` float4; with
// first = 0, the size of one shared slot
__host__ __device__ __forceinline__ int slice_width(int row4, int first) {
  return row4 - first < BULK_THREADS ? row4 - first : BULK_THREADS;
}

__device__ __forceinline__ float4 plus1(float4 v) {
  return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
}
__device__ __forceinline__ float4 times3(float4 v) {
  return make_float4(3.f * v.x, 3.f * v.y, 3.f * v.z, 3.f * v.w);
}

// ---- row 4: probe_mosaic.k4, o[n] = x[n] + 1, each row's slice brought
// into a ring of D = min(N, RING_DEPTH) shared-memory slots by a bulk
// asynchronous copy (the TPU kernel's HBM -> VMEM DMA) that completes on the
// slot's own mbarrier with its byte count. Thread 0 issues the first D
// copies before anyone waits, so at N <= D every copy is in flight at once:
// one round trip. Use k of a slot completes phase k of its mbarrier, waited
// on with parity k & 1. When every thread has read row n out of its slot
// (one __syncthreads), thread 0 refills the slot with row n + D. Rows are
// written with coalesced float4 stores.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void dma_ring_kernel(const float4* __restrict__ x, float4* __restrict__ o, int N,
                                int row4, int depth) {
  extern __shared__ __align__(128) float4 ring[];  // depth slots of `slot` float4
  __shared__ __align__(8) uint64_t bar[RING_DEPTH];
  const int slot = slice_width(row4, 0);
  const int c0 = blockIdx.x * BULK_THREADS;
  const int w = slice_width(row4, c0);
  const uint32_t bytes = w * sizeof(float4);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < depth; ++s) {
      mbar_expect_tx(&bar[s], bytes);
      bulk_load(ring + s * slot, x + (size_t)s * row4 + c0, bytes, &bar[s]);
    }
  }
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    const int s = n % depth;
    mbar_wait(&bar[s], (n / depth) & 1);
    if (t < w) o[(size_t)n * row4 + c0 + t] = plus1(ring[s * slot + t]);
    if (n + depth < N) {
      __syncthreads();  // every thread has read slot s
      if (t == 0) {
        mbar_expect_tx(&bar[s], bytes);
        bulk_load(ring + s * slot, x + (size_t)(n + depth) * row4 + c0, bytes, &bar[s]);
      }
    }
  }
}

// ---- rows 5 and 9: the prefix sum over the leading axis, each column of a
// row an independent chain s[n] = a[n] + s[n-1]. A thread owns one column
// (one float4 where the rows allow it), so the chain's adds run in
// registers and shared memory with no barrier: each thread reads back only
// what it wrote. Bound by launch and one pass through device memory.
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---- row 5: probe_mosaic.k5, o[n] = a[n] + o[n-1] through a 3-slot ring
// indexed by n % 3 in a device loop (the slot read is (n + 2) % 3, the one
// written the step before). Columns are float4 when a row is a multiple of
// 4 floats (then every row starts 16-byte aligned), else single floats: one
// kernel, two instantiations of its body. A thread issues the loads of
// RING_AHEAD rows before the dependent chain that consumes them, so it waits
// on device memory once per RING_AHEAD rows, not once per row. At the
// probe's shape (6 rows of 512 floats) that is one CTA of 128 threads.
constexpr int RING_THREADS = 128;
constexpr int RING_AHEAD = 8;

template <typename V>
__device__ __forceinline__ void ring_prefix(const V* __restrict__ a, V* __restrict__ o, int N,
                                            int cols) {
  __shared__ V ring[3][RING_THREADS];
  const int t = threadIdx.x;
  const int c = blockIdx.x * RING_THREADS + t;
  if (c >= cols) return;
  ring[2][t] = zero<V>();  // the slot read at n = 0
  for (int n0 = 0; n0 < N; n0 += RING_AHEAD) {
    V v[RING_AHEAD];
#pragma unroll
    for (int j = 0; j < RING_AHEAD; ++j)
      if (n0 + j < N) v[j] = a[(size_t)(n0 + j) * cols + c];
#pragma unroll
    for (int j = 0; j < RING_AHEAD; ++j) {
      const int n = n0 + j;
      if (n < N) {
        const V s = add(v[j], ring[(n + 2) % 3][t]);
        ring[n % 3][t] = s;
        o[(size_t)n * cols + c] = s;
      }
    }
  }
}

__global__ void ring_prefix_kernel(const float* __restrict__ a, float* __restrict__ o, int N,
                                   int cols, int vec) {
  if (vec)
    ring_prefix(reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(o), N, cols);
  else
    ring_prefix(a, o, N, cols);
}

// ---- row 6: probe_mosaic.k6, o[n] = 3 x[n], each row's slice staged in a
// shared scratch slot and written out by a bulk asynchronous store (the TPU
// kernel's VMEM -> HBM DMA). Rows go in rounds of R = min(N, OUT_ROUND):
// each thread issues the float4 loads of its column of the round's R rows
// before it uses any, scales them and writes them into R slots; then one
// fence.proxy.async (the ordinary stores made visible to the async proxy)
// and one barrier, after which thread 0 issues the R bulk stores as one
// group. With more than one round the slots form two sets used in turn;
// thread 0 waits for the previous group to have read its set (wait_group
// .read) before the barrier that lets the block rewrite that set, so a
// round's loads overlap the previous round's stores. It waits with .read
// again before the CTA exits: the stores need the shared memory, not each
// other.
__global__ void dma_out_kernel(const float4* __restrict__ x, float4* __restrict__ o, int N,
                               int row4) {
  extern __shared__ __align__(128) float4 buf[];  // (N > R ? 2 : 1) x R slots of `slot` float4
  const int slot = slice_width(row4, 0);
  const int c0 = blockIdx.x * BULK_THREADS;
  const int w = slice_width(row4, c0);
  const uint32_t bytes = w * sizeof(float4);
  const int R = N < OUT_ROUND ? N : OUT_ROUND;
  const int t = threadIdx.x;
  for (int n0 = 0, r = 0; n0 < N; n0 += R, ++r) {
    float4* set = buf + (r & 1) * R * slot;
    const int rows = N - n0 < R ? N - n0 : R;
    if (t < w) {
      float4 v[OUT_ROUND];
#pragma unroll
      for (int j = 0; j < OUT_ROUND; ++j)
        if (j < rows) v[j] = x[(size_t)(n0 + j) * row4 + c0 + t];
#pragma unroll
      for (int j = 0; j < OUT_ROUND; ++j)
        if (j < rows) set[j * slot + t] = times3(v[j]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    if (t == 0) {
      for (int j = 0; j < rows; ++j)
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                         o + (size_t)(n0 + j) * row4 + c0),
                     "r"(smem_addr(set + j * slot)), "r"(bytes)
                     : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ---- row 8: probe_mosaic.k8, the last two axes of (B, 32, 32) swapped. A
// copy, bound by the bytes: each tile read once and written once, 314.6 MB
// at the flagship's 38,400 tiles, 0.0939 ms at 3.35 TB/s. A CTA of 1,024
// threads a tile, one float each, let an SM hold two tiles (8 KB) of loads
// in flight, well under the ~20 KB that 3.35 TB/s over 132 SMs needs at
// ~0.7 us of load latency. Here a CTA of TRANSPOSE_WARPS = 4 warps takes a
// tile: lane l of warp w loads the tile's float4 number l + 32k for
// k = 2w, 2w + 1 (row (l >> 3) + 4k, columns 4(l & 7)..+3), coalesced
// 512-byte warp loads, all issued before any is used: 4 KB a CTA, and with
// 16 such CTAs resident 64 KB an SM in flight. They go whole into the CTA's
// 4 KB shared tile, unpadded, so that every float4 slot stays 16-byte
// aligned; element (i, c) sits in slot (c >> 2) ^ ((i >> 2) & 7) of row i.
// With that swizzle a quarter warp's float4 stores fill one row's eight
// slots, and lane l's scalar reads of the output's float4 number l + 32k
// (input rows 4(l & 7)..+3 at column (l >> 3) + 4k) fall on 32 distinct
// banks at each step. After one barrier each warp writes its two float4 a
// lane as coalesced 512-byte stores. One warp a tile (the same 4 KB in
// flight) ran as fast at 38,400 tiles but 0.09 us slower at 16 tiles.
constexpr int TRANSPOSE_WARPS = 4;
constexpr int TRANSPOSE_K = TILE / 4 / 32 / TRANSPOSE_WARPS;  // float4 a lane

__global__ void __launch_bounds__(32 * TRANSPOSE_WARPS)
    transpose_kernel(const float4* __restrict__ a, float4* __restrict__ o) {
  __shared__ __align__(16) float4 t[TILE / 4];  // 32 rows of 8 float4 slots
  const int lane = threadIdx.x & 31, q = lane & 7, r = lane >> 3;
  const int k0 = (threadIdx.x >> 5) * TRANSPOSE_K;
  const size_t base = (size_t)blockIdx.x * (TILE / 4) + lane;
  float4 v[TRANSPOSE_K];
#pragma unroll
  for (int j = 0; j < TRANSPOSE_K; ++j) v[j] = a[base + 32 * (k0 + j)];
#pragma unroll
  for (int j = 0; j < TRANSPOSE_K; ++j) {
    const int k = k0 + j;  // row r + 4k: (i >> 2) = k
    t[(r + 4 * k) * 8 + (q ^ k)] = v[j];
  }
  __syncthreads();
  // output row r + 4k is input column c = r + 4k: c >> 2 = k, c & 3 = r;
  // input rows 4q..4q + 3 have (i >> 2) = q
  const float* f = reinterpret_cast<const float*>(t) + 4 * q * T + r;
#pragma unroll
  for (int j = 0; j < TRANSPOSE_K; ++j) {
    const int k = k0 + j;
    const float* c = f + 4 * (k ^ q);
    o[base + 32 * k] = make_float4(c[0], c[T], c[2 * T], c[3 * T]);
  }
}

// ---- row 9: probe_mosaic2.k1, the (N, TB, 32, 32) scratch in dynamic shared
// memory indexed by the loop's n: s[n] = a[n] + s[n-1], o[n] = s[n]. The
// columns are spread over CTAs of DYN4D_THREADS threads, one float4 column a
// thread, and each CTA keeps its slab of the N-deep scratch
// (N x DYN4D_THREADS float4) in shared memory. A thread first issues its N
// 16-byte cp.async copies into the slab (none depends on another), waits for
// its own, then runs the scan through the slab. At the probe's shape (N = 5,
// TB = 4) that is 8 CTAs with a 10 KB slab each, under the 48 KB default, so
// no attribute call; the launcher refuses a slab over 227 KB (N > 113),
// whatever TB is, where the whole scratch in one CTA was refused over
// 227 KB (N * TB > 56).
constexpr int DYN4D_THREADS = 128;

__global__ void dyn4d_kernel(const float4* __restrict__ a, float4* __restrict__ o, int N,
                             int cols) {
  extern __shared__ __align__(128) float4 slab[];  // [N][DYN4D_THREADS]
  const int c = blockIdx.x * DYN4D_THREADS + threadIdx.x;
  if (c >= cols) return;
  float4* s = slab + threadIdx.x;
  for (int n = 0; n < N; ++n) cp_async16(s + n * DYN4D_THREADS, a + (size_t)n * cols + c);
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  for (int n = 0; n < N; ++n) {
    const float4 prev = n >= 1 ? s[(n - 1) * DYN4D_THREADS] : zero<float4>();
    s[n * DYN4D_THREADS] = add(s[n * DYN4D_THREADS], prev);
    o[(size_t)n * cols + c] = s[n * DYN4D_THREADS];
  }
}

// ---- row 10: probe_mosaic2.k2, the recurrence a[n] = 2 a[n] + a[n-1] run in
// place: o[n] = 2 a[n] + o[n-1], that is 2 cumsum(a, 0). Pallas wrote into
// its own copy of the input; here the result goes to the output and the
// caller's tensor is left as it was. One pass, row 5's design without its
// shared ring: a thread owns one column (a float4 where the rows allow it),
// reads each element once, writes each once, and carries o[n-1] in
// registers; it issues the loads of RING_AHEAD rows (none depends on
// another) before the dependent chain of adds that consumes them. Bound by
// the bytes of that one pass at the flagship's shape, by launch and one
// round trip at the probe's (5 rows of 4,096 floats: 8 CTAs).
__device__ __forceinline__ float twice_plus(float a, float s) { return 2.f * a + s; }
__device__ __forceinline__ float4 twice_plus(float4 a, float4 s) {
  return make_float4(2.f * a.x + s.x, 2.f * a.y + s.y, 2.f * a.z + s.z, 2.f * a.w + s.w);
}

template <typename V>
__device__ __forceinline__ void recur(const V* __restrict__ a, V* __restrict__ o, int N,
                                      int cols) {
  const int c = blockIdx.x * RING_THREADS + threadIdx.x;
  if (c >= cols) return;
  V s = zero<V>();
  for (int n0 = 0; n0 < N; n0 += RING_AHEAD) {
    V v[RING_AHEAD];
#pragma unroll
    for (int j = 0; j < RING_AHEAD; ++j)
      if (n0 + j < N) v[j] = a[(size_t)(n0 + j) * cols + c];
#pragma unroll
    for (int j = 0; j < RING_AHEAD; ++j)
      if (n0 + j < N) {
        s = twice_plus(v[j], s);  // 2 a is exact: the plain version's one rounding
        o[(size_t)(n0 + j) * cols + c] = s;
      }
  }
}

__global__ void recur_kernel(const float* __restrict__ a, float* __restrict__ o, int N, int cols,
                             int vec) {
  if (vec)
    recur(reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(o), N, cols);
  else
    recur(a, o, N, cols);
}

// ---- row 11: probe_mosaic2.k3, y[b, j] = sum_i A[b, i, j] x[b, i]. One warp
// per batch entry; lane j walks down column j, so every step reads one row
// of A, 32 consecutive floats, and x[b, i] is broadcast from lane i.
__global__ void matvec_t_kernel(const float* __restrict__ a, const float* __restrict__ x,
                                float* __restrict__ y, int B) {
  const int b = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const float xl = x[(size_t)b * T + lane];
  const float* ab = a + (size_t)b * TILE;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) acc = fmaf(ab[i * T + lane], __shfl_sync(0xffffffffu, xl, i), acc);
  y[(size_t)b * T + lane] = acc;
}

// ---- row 12: probe_mosaic2.chain_kernel, K dependent steps x <- A @ x from
// x = A on each of TB tiles, so o = A^(K+1). One CTA per tile, so the TB
// chains run on TB SMs. Column j of the next x depends only on column j of
// this one (and on A), so each warp owns a strip of eight columns for the
// whole chain: it reads and writes only its own strip of the ping-pong pair
// of x in shared memory, and a step needs one __syncwarp, no barrier over
// the CTA. x's rows are padded to XS floats.
//
// HIGHEST: four warps a tile. Lane (rq, cp) of warp w owns rows rq + 8r
// (r = 0..3) and columns 8w + 2cp, 8w + 2cp + 1, and holds its four rows of
// A in registers (128 floats) for all K steps. A step reads one float2 of x
// per k (a warp reads four distinct float2, one wavefront) and issues eight
// FP32 FMAs on it, each element's sum in q order 0..31: 256 FMAs a lane, so
// the step is bound by FMA issue on the SM's four schedulers, one warp each
// (256 of ~292 issue slots a step), plus the latency at its two ends.
constexpr int XS = T + 8;  // x's row in shared memory: rows 8 banks apart
constexpr int CHAIN_WARPS = 4;  // one 8-column strip a warp, at both precisions

__global__ void __launch_bounds__(32 * CHAIN_WARPS, 1)
    chain_fp32_kernel(const float* __restrict__ a, float* __restrict__ o, int K) {
  __shared__ __align__(16) float xs[2][T * XS];  // step k reads xs[k & 1], writes the other
  const int lane = threadIdx.x % 32;
  const int rq = lane / 4, c = 8 * (threadIdx.x / 32) + 2 * (lane % 4);
  const float* at = a + (size_t)blockIdx.x * TILE;
  float ar[4][T];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = at + (rq + 8 * r) * T;
#pragma unroll
    for (int q = 0; q < T; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + q);
      ar[r][q] = v.x;
      ar[r][q + 1] = v.y;
      ar[r][q + 2] = v.z;
      ar[r][q + 3] = v.w;
    }
    *reinterpret_cast<float2*>(xs[0] + (rq + 8 * r) * XS + c) =
        *reinterpret_cast<const float2*>(row + c);
  }
  __syncwarp();
  for (int k = 0; k < K; ++k) {
    const float* xc = xs[k & 1];
    float* xn = xs[(k & 1) ^ 1];
    float acc[4][2] = {};
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const float2 xv = *reinterpret_cast<const float2*>(xc + q * XS + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(ar[r][q], xv.x, acc[r][0]);
        acc[r][1] = fmaf(ar[r][q], xv.y, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float2*>(xn + (rq + 8 * r) * XS + c) = make_float2(acc[r][0], acc[r][1]);
    __syncwarp();  // the strip's writes before its reads, its reads before its next writes
  }
  float* ot = o + (size_t)blockIdx.x * TILE;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float2*>(ot + (rq + 8 * r) * T + c) =
        *reinterpret_cast<const float2*>(xs[K & 1] + (rq + 8 * r) * XS + c);
}

// DEFAULT (the TPU's default precision is bf16 passes; Hopper's counterpart
// is TF32 on the tensor cores): raw mma.sync m16n8k8 TF32 with FP32
// accumulation, four warps a tile, warp w owning the n-tile of columns
// 8w..8w+7. A's fragments (two m-tiles of 16 rows x four k-steps of 8) are
// rounded to TF32 (cvt.rna) once and held in registers; a step loads each
// x element of the strip once as a B fragment, rounds it once, and runs two
// chains of four dependent MMAs. Fragment layouts (PTX ISA, m16n8k8 .tf32),
// g = lane / 4, t = lane % 4: A holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B holds (t, g), (t + 4, g); C holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). With rows of XS = 40 floats a B load (rows
// t, columns g) and a float2 store of C (rows g, columns 2t) each hit 32
// distinct banks.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(32 * CHAIN_WARPS, 1)
    chain_tf32_kernel(const float* __restrict__ a, float* __restrict__ o, int K) {
  __shared__ __align__(16) float xs[2][T * XS];  // step k reads xs[k & 1], writes the other
  const int lane = threadIdx.x % 32, n0 = 8 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const float* at = a + (size_t)blockIdx.x * TILE;
  uint32_t af[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = at + (16 * mi + g) * T + 8 * kk + t;
      af[mi][kk][0] = tf32(p[0]);
      af[mi][kk][1] = tf32(p[8 * T]);
      af[mi][kk][2] = tf32(p[4]);
      af[mi][kk][3] = tf32(p[8 * T + 4]);
    }
  // lane i brings row i of the strip into x
#pragma unroll
  for (int h = 0; h < 8; h += 4)
    *reinterpret_cast<float4*>(xs[0] + lane * XS + n0 + h) =
        *reinterpret_cast<const float4*>(at + lane * T + n0 + h);
  __syncwarp();
  for (int k = 0; k < K; ++k) {
    const float* xc = xs[k & 1];
    float* xn = xs[(k & 1) ^ 1];
    uint32_t b[4][2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = xc + (8 * kk + t) * XS + n0 + g;
      b[kk][0] = tf32(p[0]);
      b[kk][1] = tf32(p[4 * XS]);
    }
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_tf32(acc[mi], af[mi][kk], b[kk][0], b[kk][1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float* p = xn + (16 * mi + g) * XS + n0 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mi][0], acc[mi][1]);
      *reinterpret_cast<float2*>(p + 8 * XS) = make_float2(acc[mi][2], acc[mi][3]);
    }
    __syncwarp();  // the strip's writes before its reads, its reads before its next writes
  }
  float* ot = o + (size_t)blockIdx.x * TILE;
#pragma unroll
  for (int h = 0; h < 8; h += 4)
    *reinterpret_cast<float4*>(ot + lane * T + n0 + h) =
        *reinterpret_cast<const float4*>(xs[K & 1] + lane * XS + n0 + h);
}

// A measuring aid, not a port of any TPU kernel: an empty kernel, whose
// device time per launch is the floor under every probe row's time at the
// scripts' shapes.
__global__ void empty_kernel() {}

int launched() { return (int)cudaGetLastError(); }

// The dynamic shared-memory limit of one kernel, per device ordinal: the
// size last set there by cudaFuncSetAttribute, 0 before the first.
constexpr int MAX_DEVICES = 64;
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // what a kernel may take without the attribute
using SmemLimits = std::atomic<int>[MAX_DEVICES];
std::mutex smem_mutex;  // orders the sets, so that a limit only rises

// Refuse more than a block may have; otherwise raise `kernel`'s limit on the
// current device only when `bytes` exceeds both the default and the size
// last set there: cudaFuncSetAttribute costs host time on every call, and a
// repeated launch of the same size makes none. (The limit cannot simply be
// set to MAX_SMEM once: a kernel's static shared memory counts against it.)
int smem_limit(const void* kernel, size_t bytes, SmemLimits& set) {
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bytes <= DEFAULT_SMEM) return 0;
  int dev = 0;
  const int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= MAX_DEVICES)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  if ((int)bytes <= set[dev].load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(smem_mutex);
  if ((int)bytes <= set[dev].load(std::memory_order_relaxed)) return 0;
  const int set_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!set_err) set[dev].store((int)bytes, std::memory_order_release);
  return set_err;
}

SmemLimits dyn4d_smem;

}  // namespace

// Shapes: a tile is 32 x 32; B counts tiles, N rows of a ring or recurrence,
// `row` the floats of one row; TB the tiles of the chain, K its steps.

extern "C" int probe_batched_dot(const float* a, const float* b, float* o, int B,
                                 void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  batched_dot_kernel<<<B, DOT_THREADS, 0, (cudaStream_t)stream>>>(a, b, o);
  return launched();
}

extern "C" int probe_lane_reduce(const float* a, const float* v, float* y, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  lane_reduce_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(a, v, y);
  return launched();
}

extern "C" int probe_matvec(const float* a, const float* v, float* y, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  matvec_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(a, v, y);
  return launched();
}

extern "C" int probe_scale_cols(const float* a, float* o, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)B * TILE / 4;
  scale_cols_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(o), n4);
  return launched();
}

extern "C" int probe_dma_ring(const float* x, float* o, int N, int row, void* stream) {
  if (N <= 0 || row <= 0 || row % 4 != 0) return (int)cudaErrorInvalidValue;
  const int row4 = row / 4;
  const int depth = N < RING_DEPTH ? N : RING_DEPTH;
  const size_t smem = (size_t)depth * slice_width(row4, 0) * sizeof(float4);
  dma_ring_kernel<<<(row4 + BULK_THREADS - 1) / BULK_THREADS, BULK_THREADS, smem,
                    (cudaStream_t)stream>>>(reinterpret_cast<const float4*>(x),
                                            reinterpret_cast<float4*>(o), N, row4, depth);
  return launched();
}

extern "C" int probe_ring_prefix(const float* a, float* o, int N, int row, void* stream) {
  if (N <= 0 || row <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(o);
  const int vec = row % 4 == 0 && ends % 16 == 0;
  const int cols = vec ? row / 4 : row;
  ring_prefix_kernel<<<(cols + RING_THREADS - 1) / RING_THREADS, RING_THREADS, 0,
                       (cudaStream_t)stream>>>(a, o, N, cols, vec);
  return launched();
}

extern "C" int probe_dma_out(const float* x, float* o, int N, int row, void* stream) {
  if (N <= 0 || row <= 0 || row % 4 != 0) return (int)cudaErrorInvalidValue;
  const int row4 = row / 4;
  const int slots = N <= OUT_ROUND ? N : 2 * OUT_ROUND;
  const size_t smem = (size_t)slots * slice_width(row4, 0) * sizeof(float4);
  dma_out_kernel<<<(row4 + BULK_THREADS - 1) / BULK_THREADS, BULK_THREADS, smem,
                   (cudaStream_t)stream>>>(reinterpret_cast<const float4*>(x),
                                           reinterpret_cast<float4*>(o), N, row4);
  return launched();
}

extern "C" int probe_transpose(const float* a, float* o, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  transpose_kernel<<<B, 32 * TRANSPOSE_WARPS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(o));
  return launched();
}

extern "C" int probe_dyn4d(const float* a, float* o, int N, int row, void* stream) {
  if (N <= 0 || row <= 0 || row % 4 != 0) return (int)cudaErrorInvalidValue;
  const int cols = row / 4;
  const size_t smem = (size_t)N * DYN4D_THREADS * sizeof(float4);
  const int err = smem_limit((const void*)dyn4d_kernel, smem, dyn4d_smem);
  if (err) return err;
  dyn4d_kernel<<<(cols + DYN4D_THREADS - 1) / DYN4D_THREADS, DYN4D_THREADS, smem,
                 (cudaStream_t)stream>>>(reinterpret_cast<const float4*>(a),
                                         reinterpret_cast<float4*>(o), N, cols);
  return launched();
}

extern "C" int probe_recur(const float* a, float* o, int N, int row, void* stream) {
  if (N <= 0 || row <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(o);
  const int vec = row % 4 == 0 && ends % 16 == 0;
  const int cols = vec ? row / 4 : row;
  recur_kernel<<<(cols + RING_THREADS - 1) / RING_THREADS, RING_THREADS, 0,
                 (cudaStream_t)stream>>>(a, o, N, cols, vec);
  return launched();
}

extern "C" int probe_matvec_t(const float* a, const float* x, float* y, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  matvec_t_kernel<<<(B + 7) / 8, 256, 0, (cudaStream_t)stream>>>(a, x, y, B);
  return launched();
}

extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return launched();
}

extern "C" int probe_chain_fp32(const float* a, float* o, int TB, int K, void* stream) {
  if (TB <= 0 || TB > 8 || K < 0) return (int)cudaErrorInvalidValue;
  chain_fp32_kernel<<<TB, 32 * CHAIN_WARPS, 0, (cudaStream_t)stream>>>(a, o, K);
  return launched();
}

extern "C" int probe_chain_tf32(const float* a, float* o, int TB, int K, void* stream) {
  if (TB <= 0 || TB > 8 || K < 0) return (int)cudaErrorInvalidValue;
  chain_tf32_kernel<<<TB, 32 * CHAIN_WARPS, 0, (cudaStream_t)stream>>>(a, o, K);
  return launched();
}
