// Batched block-banded SPD Cholesky factor + solve for Hopper (sm_90a).
//
// Replaces the TPU kernel acinoset_tpu/kernels/banded_pallas.py
// (banded_solve_pallas -> _banded_chol_kernel + _chol_and_inv): for each
// trajectory b, solve A x = g with A symmetric positive definite and
// block-banded in time (bandwidth 3, P x P blocks, P <= 32; P = 25 for the
// cheetah), Jacobi-scaled to unit diagonal by the caller. Bands arrive as
// four (B, N, P, P) arrays, bands[k][b][n] = block (n, n-k); g and x are
// (B, N, P). Same recurrence as the JAX kernel and as the plain PyTorch
// version (solvers/banded.py, block_banded_solve_unrolled):
//
//   L3 = A3 L0inv_{n-3}^T
//   L2 = (A2 - L3 L1_{n-2}^T) L0inv_{n-2}^T
//   L1 = (A1 - L3 L2_{n-1}^T - L2 L1_{n-1}^T) L0inv_{n-1}^T
//   S  = A0 - L1 L1^T - L2 L2^T - L3 L3^T;   L0 = chol(S), L0inv = L0^-1
//   y_n = L0inv_n (g_n - L1_n y_{n-1} - L2_n y_{n-2} - L3_n y_{n-3})
//   x_n = L0inv_n^T (y_n - L1_{n+1}^T x_{n+1} - L2_{n+2}^T x_{n+2} - L3_{n+3}^T x_{n+3})
//
// What bounds it on an H100. Per frame the recurrence needs 12.7 P^3 +
// 14 P^2 flops (chip_smoke.banded_bound_ms): 1.98 GFLOP for the flagship
// B = 96, N = 100, P = 25 solve, 0.0296 ms at 67 TFLOP/s of FP32; its
// 96 MB of bands take 0.029 ms at 3.35 TB/s. Neither is the real limit:
// the recurrence is a chain of N frames, each a chain of dependent
// products, P dependent Cholesky columns and P dependent inverse rows,
// and B = 96 trajectories fill 96 of the 132 SMs with one CTA each. The
// time is the latency along that chain, and shared-memory bandwidth
// inside each step of it.
//
// What the design does about it. One CTA of 256 threads per trajectory.
// - Products: a thread owns a 2 x 4 register tile of the live block (rows
//   r0, r0 + H; columns c0 + u W, H = ceil(P/2), W = ceil(P/4): 91
//   threads at P = 25) and reads both operands as float4 along k, so a
//   k-quad costs 6 shared loads for 32 FMAs. Shared rows are 36 floats,
//   16-byte aligned, so that eight consecutive rows' float4 fall on all
//   32 banks. The nine products run in six phases, one barrier each,
//   grouped by what they wait for: L3; then A2 -= L3 L1_{n-2}^T, A1 -= L3
//   L2_{n-1}^T and S -= L3 L3^T, which share L3's fragments; L2; then A1
//   -= L2 L1_{n-1}^T and S -= L2 L2^T; L1; and S -= L1 L1^T.
// - The Cholesky factor and its inverse together, in warp 0 alone, with
//   no block barrier between the P steps (chol_inv_warp): lane r keeps
//   row r of S and lane c column c of L0inv in registers, and step j's
//   column of L, shuffled from the lanes below the pivot, updates both.
//   The pivot chain carries no shuffle, and the inverse needs no pass of
//   its own. A pivot's reciprocal square root (rsqrt of max(d, 1e-30),
//   as the reference clamps) scales row j of the inverse instead of a
//   division by L_jj.
// - Meanwhile warps 1-7 load frame n+1's bands and g into the other of
//   two shared sets, so the frame loop never waits on device memory.
// - The forward substitution of frame n runs in warp 0 right after frame
//   n is factored; the backward substitution runs in warp 0 after the
//   last frame, reading the factor back from `fac` (B, N, 4, 32, 32).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 1.29 ms for the
// flagship solve, 44x the bound; per frame 3.2 us of products and 2.0 us
// of factor and inverse, then 0.55 ms of backward substitution after the
// frame loop (chip_smoke.phase_split). PERF.md has the readings.
// The TPU kernel's one-hot matmuls, (1, 32) row vectors, lane packing and
// batch tiles were Mosaic workarounds and have no counterpart here.
// Arithmetic is FP32 FMA throughout, no TF32: the JAX reference pins
// Precision.HIGHEST, and the factored L0inv pair is kept rather than a
// Newton-Schulz full inverse, which is unstable at kappa ~ 1/damping.
//
// Built with -DBANDED_PHASE_CLOCK (chip_smoke.phase_split), the library
// also exports banded_chol_solve_clocked, whose block 0 stamps clock64()
// at the phase borders of every frame.

#include <cuda_runtime.h>

namespace {

constexpr int PP = 32;                // padded block edge
constexpr int LD = PP + 4;            // shared-memory row stride
constexpr int MAT = PP * LD;          // floats per shared matrix
constexpr int NTHREADS = 8 * PP;     // eight warps: the products use the first H W
                                      // threads, the band loads warps 1-7
// shared matrices: two sets of A0..A3, set n % 2 holding frame n (A0 then
// holds S), L3, and a ring of three frames of (L0inv, L1, L2); then a
// ring of three y vectors, one rhs and g of two frames
constexpr int N_MATS = 8 + 1 + 9;
constexpr int SMEM_FLOATS = N_MATS * MAT + 6 * PP;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

// clock stamps per frame, with -DBANDED_PHASE_CLOCK: ten are written; at a
// stride of 10 the clocked kernel's block 0 ran 8% slower than at 16, so
// its split stood further from the plain build's (PERF.md section 6)
constexpr int NSLOT = 16;

#ifdef BANDED_PHASE_CLOCK
#define PHASE(slot)                                                                   \
  do {                                                                                \
    if (clk != nullptr && threadIdx.x == 0 && blockIdx.x == 0) clk[slot] = clock64(); \
  } while (0)
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define PHASE(slot) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool SUB>
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  const float s = SUB ? -1.f : 1.f;
  acc = fmaf(s * a.x, b.x, acc);
  acc = fmaf(s * a.y, b.y, acc);
  acc = fmaf(s * a.z, b.z, acc);
  return fmaf(s * a.w, b.w, acc);
}

// The thread's 2 x TC output tile: rows r0 + a H (a < 2) and columns c0 +
// u W (u < TC), H = ceil(P / 2), W = ceil(P / TC), so that the tiles
// cover the live block and no more; tile i of the H x W grid is thread i
constexpr int TC = 4;
struct Tile {
  int r0, c0, H, W;
  __device__ bool live() const { return r0 < H; }
};

// acc[m] += X Y[m]^T (SUB: -=) on the tile over k < 28, and k < 32 when
// P > 28 (columns at and past P are zero in every operand); the M
// products share X's fragments
template <bool SUB, int M>
__device__ __forceinline__ void tile_nt(float (&acc)[M][2][TC], const float* X,
                                        const float* const (&Y)[M], const Tile& t, int P) {
  const float* x0 = X + t.r0 * LD;
  const float* x1 = X + (t.r0 + t.H) * LD;
  auto quad = [&](int q) {
    const float4 a[2] = {ld4(x0 + 4 * q), ld4(x1 + 4 * q)};
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const float4 y = ld4(Y[m] + (t.c0 + u * t.W) * LD + 4 * q);
        acc[m][0][u] = fma4<SUB>(a[0], y, acc[m][0][u]);
        acc[m][1][u] = fma4<SUB>(a[1], y, acc[m][1][u]);
      }
  };
#pragma unroll
  for (int q = 0; q < PP / 4 - 1; ++q) quad(q);
  if (P > PP - 4) quad(PP / 4 - 1);
}

__device__ __forceinline__ void tile_load(float (&v)[2][TC], const float* M, const Tile& t) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int u = 0; u < TC; ++u) v[a][u] = M[(t.r0 + a * t.H) * LD + t.c0 + u * t.W];
}

__device__ __forceinline__ void tile_store(float* M, const float (&v)[2][TC], const Tile& t) {
  if (!t.live()) return;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int u = 0; u < TC; ++u) M[(t.r0 + a * t.H) * LD + t.c0 + u * t.W] = v[a][u];
}

// MUFU.RSQ alone: the argument (>= 1e-30) is never subnormal, so the
// flush-to-zero form gives rsqrtf's value without its subnormal fix-up
__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// L = chol(S) and Li = L^-1 for the leading P x P block of S (P <= K)
// by one warp (lane = threadIdx.x % 32), the pad forced to the identity
// as the JAX kernel does; writes Li (rows 0..K-1, zero outside the live
// block). Right-looking, both at once: lane r keeps row r of S, and lane
// c column c of X in L X = I. Step j takes column j of L from the lanes
// below the pivot by shuffles, updates each lane's row of S with it, and
// updates each lane's column of X with it (X's row j, final at step j, is
// scaled by the pivot's reciprocal square root instead of divided by
// L_jj). The chain from one pivot to the next needs only S_jj, S_{j+1,j},
// S_{j+1,j+1} and S_{j+2,j+1}: every lane keeps them (d0, e0, d1, e1) and
// advances them with the same FMAs as the lanes that own them, so the
// pivot chain is an rsqrt, a multiply and an FMA a step, with no shuffle
// on it. All K steps run, branch-free (a pad step is an identity step),
// so that the compiler can schedule across them.
template <int K>
__device__ __forceinline__ void chol_inv_warp(const float* S, float* Li, int lane, int P) {
  float s[K], x[K];
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 v = ld4(S + lane * LD + 4 * q);
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    s[c] = lane < P ? (c < P ? s[c] : 0.f) : (c == lane ? 1.f : 0.f);
    x[c] = c == lane ? 1.f : 0.f;
  }
  float d0 = __shfl_sync(FULL, s[0], 0), e0 = __shfl_sync(FULL, s[0], 1);
  float d1 = __shfl_sync(FULL, s[1], 1), e1 = __shfl_sync(FULL, s[1], 2);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    // S_{j+2,j+2} and S_{j+3,j+2} as they stand before step j
    const float d2 = j + 2 < K ? __shfl_sync(FULL, s[(j + 2) % K], (j + 2) % K) : 1.f;
    const float e2 = j + 3 < K ? __shfl_sync(FULL, s[(j + 2) % K], (j + 3) % K) : 0.f;
    const float p = rsqrt_approx(fmaxf(d0, 1e-30f));
    const float l = s[j] * p;  // L[lane][j]
    const float l1 = e0 * p;   // L[j+1][j], in every lane
    x[j] *= p;                 // X[j][lane]
    float l2 = 0.f, l3 = 0.f;  // L[j+2][j], L[j+3][j]
#pragma unroll
    for (int c = j + 1; c < K; ++c) {
      const float lc = c == j + 1 ? l1 : __shfl_sync(FULL, l, c);  // L[c][j]
      if (c == j + 2) l2 = lc;
      if (c == j + 3) l3 = lc;
      s[c] = fmaf(-l, lc, s[c]);
      x[c] = fmaf(-lc, x[j], x[c]);
    }
    d0 = fmaf(-l1, l1, d1);
    e0 = fmaf(-l2, l1, e1);
    d1 = fmaf(-l2, l2, d2);
    e1 = fmaf(-l3, l2, e2);
  }
#pragma unroll
  for (int c = 0; c < K; ++c) Li[c * LD + lane] = (c < P && lane < P) ? x[c] : 0.f;
}

// frame n's bands into one shared set (dst, live entries only) and its g
// into gdst, by the nt threads t = 0..nt-1 of a group: every load is
// issued before the first store, so one memory latency covers them all
__device__ __forceinline__ void load_frame(float* const (&dst)[4], float* gdst,
                                           const float* const (&Ag)[4], const float* g, int b,
                                           int n, int N, int P, int t, int nt) {
  constexpr int U = (PP * PP + 7 * PP - 1) / (7 * PP);  // elements a thread of 224 loads
  const int blk = P * P;
  const size_t base = ((size_t)b * N + n) * blk;
  float v[4][U];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = t + u * nt;
      v[k][u] = e < blk ? __ldg(Ag[k] + base + e) : 0.f;
    }
  const float gv = t < P ? __ldg(g + ((size_t)b * N + n) * P + t) : 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = t + u * nt;
    if (e < blk) {
      const int r = e / P, off = r * LD + e - r * P;
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k][off] = v[k][u];
    }
  }
  if (t < P) gdst[t] = gv;
}

__global__ void __launch_bounds__(NTHREADS, 1)
banded_chol_kernel(const float* __restrict__ A0g, const float* __restrict__ A1g,
                   const float* __restrict__ A2g, const float* __restrict__ A3g,
                   const float* __restrict__ g, float* __restrict__ x,
                   float* __restrict__ fac, int N, int P, long long* __restrict__ clk) {
  extern __shared__ __align__(16) float sm[];
  float* sets = sm;  // set s: A0..A3 at sets + (4s + k) MAT
  float* L3 = sm + 8 * MAT;
  float* ring = sm + 9 * MAT;  // slot s: L0inv at ring + 3s MAT, L1 +1, L2 +2
  float* yr = sm + N_MATS * MAT;  // three y vectors, slot = frame % 3
  float* rhs = yr + 3 * PP;
  float* gs = rhs + PP;  // g of frame n at gs + (n % 2) PP

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool warp0 = tid < PP;
  const int H = (P + 1) / 2, W = (P + TC - 1) / TC;
  const Tile tile{tid / W, tid % W, H, W};
  const bool tiles = tid / PP * PP < H * W;  // the warp holds tiles of the H x W grid
#ifdef BANDED_PHASE_CLOCK
  if (clk != nullptr && tid == 0) {
    if (b == 0) {
      clk[N * NSLOT] = clock64();
      clk[N * NSLOT + 1] = global_ns();
    }
    clk[N * NSLOT + 8 + 2 * b] = global_ns();
  }
#endif

  // all zero (pads stay zero), then frames -1, -2, -3: L0inv = I,
  // L1 = L2 = 0 (the recurrence's initial carry); frame 0's bands
  for (int i = tid; i < SMEM_FLOATS; i += NTHREADS) sm[i] = 0.f;
  __syncthreads();
  if (tid < P)
    for (int s = 0; s < 3; ++s) ring[3 * s * MAT + tid * LD + tid] = 1.f;
  const float* const Ag[4] = {A0g, A1g, A2g, A3g};
  {
    float* const dst[4] = {sets, sets + MAT, sets + 2 * MAT, sets + 3 * MAT};
    load_frame(dst, gs, Ag, g, b, 0, N, P, tid, NTHREADS);
  }

  for (int n = 0; n < N; ++n) {
    PHASE(n * NSLOT);
    __syncthreads();  // frame n's bands are in; frame n-1's forward substitution is done
    PHASE(n * NSLOT + 1);
    const int s0 = n % 3, s1 = (n + 2) % 3, s2 = (n + 1) % 3;  // frames n (= n-3), n-1, n-2
    const float* Li3 = ring + (3 * s0) * MAT;
    const float* Li2 = ring + (3 * s2) * MAT;
    const float* L1_2 = Li2 + MAT;
    const float* Li1 = ring + (3 * s1) * MAT;
    const float* L1_1 = Li1 + MAT;
    const float* L2_1 = Li1 + 2 * MAT;
    float* Li0 = ring + (3 * s0) * MAT;  // frame n-3's slot, free once L3 is formed
    float* L1 = Li0 + MAT;
    float* L2 = Li0 + 2 * MAT;
    float* A0 = sets + (n % 2) * 4 * MAT;
    float* A1 = A0 + MAT;
    float* A2 = A0 + 2 * MAT;
    float* A3 = A0 + 3 * MAT;

    // the nine products in six phases, each updating its tiles in place
    if (tiles) {
      float l3[1][2][TC] = {};
      tile_nt<false, 1>(l3, A3, {Li3}, tile, P);  // L3 = A3 Li3^T
      tile_store(L3, l3[0], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 2);
    if (tiles) {
      float acc[3][2][TC];  // A2, A1, S -= L3 [L1_2 | L2_1 | L3]^T
      tile_load(acc[0], A2, tile);
      tile_load(acc[1], A1, tile);
      tile_load(acc[2], A0, tile);
      tile_nt<true, 3>(acc, L3, {L1_2, L2_1, L3}, tile, P);
      tile_store(A2, acc[0], tile);
      tile_store(A1, acc[1], tile);
      tile_store(A0, acc[2], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 3);
    if (tiles) {
      float l2[1][2][TC] = {};
      tile_nt<false, 1>(l2, A2, {Li2}, tile, P);  // L2 = A2 Li2^T
      tile_store(L2, l2[0], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 4);
    if (tiles) {
      float acc[2][2][TC];  // A1, S -= L2 [L1_1 | L2]^T
      tile_load(acc[0], A1, tile);
      tile_load(acc[1], A0, tile);
      tile_nt<true, 2>(acc, L2, {L1_1, L2}, tile, P);
      tile_store(A1, acc[0], tile);
      tile_store(A0, acc[1], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 5);
    if (tiles) {
      float l1[1][2][TC] = {};
      tile_nt<false, 1>(l1, A1, {Li1}, tile, P);  // L1 = A1 Li1^T
      tile_store(L1, l1[0], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 6);
    if (tiles) {
      float sa[1][2][TC];  // S -= L1 L1^T
      tile_load(sa[0], A0, tile);
      tile_nt<true, 1>(sa, L1, {L1}, tile, P);
      tile_store(A0, sa[0], tile);
    }
    __syncthreads();
    PHASE(n * NSLOT + 7);

    // the Cholesky factor of S (in A0) and its inverse, into Li0, in
    // warp 0 alone; meanwhile the other warps load frame n+1 into the
    // other set
    if (warp0) {
      if (P <= PP - 4)
        chol_inv_warp<PP - 4>(A0, Li0, tid, P);
      else
        chol_inv_warp<PP>(A0, Li0, tid, P);
    } else if (n + 1 < N) {
      float* B = sets + ((n + 1) % 2) * 4 * MAT;
      float* const dst[4] = {B, B + MAT, B + 2 * MAT, B + 3 * MAT};
      load_frame(dst, gs + ((n + 1) % 2) * PP, Ag, g, b, n + 1, N, P, tid - PP, NTHREADS - PP);
    }
    __syncthreads();
    PHASE(n * NSLOT + 8);

    // the factor of frame n, for the backward pass: [L0inv | L1 | L2 | L3],
    // 4 x 256 float4, one of each matrix per thread
    {
      float* F = fac + ((size_t)b * N + n) * 4 * PP * PP;
      const float* const src[4] = {Li0, L1, L2, L3};
      const int row = tid / (PP / 4), q = tid % (PP / 4);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(F + u * PP * PP + row * PP + 4 * q) =
            ld4(src[u] + row * LD + 4 * q);
    }

    // forward substitution of frame n in warp 0, lane m = row m
    if (warp0) {
      const int m = tid;
      const float* y1 = yr + s1 * PP;
      const float* y2 = yr + s2 * PP;
      const float* y3 = yr + s0 * PP;
      float t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
      for (int q = 0; q < PP / 4; ++q) {
        t1 = fma4<false>(ld4(L1 + m * LD + 4 * q), ld4(y1 + 4 * q), t1);
        t2 = fma4<false>(ld4(L2 + m * LD + 4 * q), ld4(y2 + 4 * q), t2);
        t3 = fma4<false>(ld4(L3 + m * LD + 4 * q), ld4(y3 + 4 * q), t3);
      }
      rhs[m] = gs[(n % 2) * PP + m] - t1 - t2 - t3;
      __syncwarp();
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < PP / 4; ++q) y = fma4<false>(ld4(Li0 + m * LD + 4 * q), ld4(rhs + 4 * q), y);
      __syncwarp();
      yr[s0 * PP + m] = y;  // y_{n-3} was read above
      if (m < P) x[((size_t)b * N + n) * P + m] = y;
      __syncwarp();
    }
    PHASE(n * NSLOT + 9);
  }
  __syncthreads();
  PHASE(N * NSLOT + 4);

  // backward substitution in warp 0, reading the factor back; column reads
  // (F[k][m] for lane m) are coalesced
  if (warp0) {
    const int m = tid;
    float* xr = yr;  // ring of x_{n+1..n+3}, slot = frame % 3
    xr[m] = 0.f;
    xr[PP + m] = 0.f;
    xr[2 * PP + m] = 0.f;
    __syncwarp();
    for (int n = N - 1; n >= 0; --n) {
      float t[3] = {0.f, 0.f, 0.f};
      for (int q = 1; q <= 3; ++q) {
        if (n + q >= N) continue;
        const float* Fq = fac + (((size_t)b * N + n + q) * 4 + q) * PP * PP;
        const float* xq = xr + ((n + q) % 3) * PP;
        float acc = 0.f;
        for (int k = 0; k < P; ++k) acc = fmaf(Fq[k * PP + m], xq[k], acc);
        t[q - 1] = acc;
      }
      const float yn = m < P ? x[((size_t)b * N + n) * P + m] : 0.f;
      rhs[m] = yn - t[0] - t[1] - t[2];
      __syncwarp();
      const float* Fi = fac + ((size_t)b * N + n) * 4 * PP * PP;
      float xn = 0.f;
      for (int k = 0; k < P; ++k) xn = fmaf(Fi[k * PP + m], rhs[k], xn);
      __syncwarp();
      xr[(n % 3) * PP + m] = xn;  // x_{n+3} was read above
      if (m < P) x[((size_t)b * N + n) * P + m] = xn;
      __syncwarp();
    }
  }
#ifdef BANDED_PHASE_CLOCK
  if (clk != nullptr && tid == 0) {
    if (b == 0) {
      clk[N * NSLOT + 2] = clock64();
      clk[N * NSLOT + 3] = global_ns();
    }
    clk[N * NSLOT + 9 + 2 * b] = global_ns();
  }
#endif
}

int launch(const float* A0, const float* A1, const float* A2, const float* A3, const float* g,
           float* x, float* fac, int B, int N, int P, void* stream, long long* clk) {
  if (B <= 0 || N <= 0 || P <= 0 || P > PP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      banded_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  banded_chol_kernel<<<B, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(A0, A1, A2, A3, g, x,
                                                                        fac, N, P, clk);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`: x (B, N, P) solves the systems; fac (B, N, 4, 32, 32)
// is scratch. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int banded_chol_solve(const float* A0, const float* A1, const float* A2,
                                 const float* A3, const float* g, float* x, float* fac,
                                 int B, int N, int P, void* stream) {
  return launch(A0, A1, A2, A3, g, x, fac, B, N, P, stream, nullptr);
}

#ifdef BANDED_PHASE_CLOCK
// The same launch, with block 0's thread 0 stamping clock64() into clk
// (16 N + 8 + 2 B int64): for frame n at 16n + 0..9 (frame start; past
// the frame's first barrier; each of the six product phases done; factor
// and inverse done; forward substitution done); at 16N + 0/1 and 16N +
// 2/3 the kernel's first and last clock64(), each with the global timer
// (ns) beside it, and at 16N + 4 the start of the backward pass; and
// every block b's first and last global timer (ns) at 16N + 8 + 2b, + 1.
extern "C" int banded_chol_solve_clocked(const float* A0, const float* A1, const float* A2,
                                         const float* A3, const float* g, float* x, float* fac,
                                         int B, int N, int P, void* stream, long long* clk) {
  return launch(A0, A1, A2, A3, g, x, fac, B, N, P, stream, clk);
}
#endif
