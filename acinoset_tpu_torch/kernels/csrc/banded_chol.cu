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
// What bounds it on an H100. Per frame the recurrence needs three products
// with a triangular L0inv^T (P^3 flops each), three general products (2 P^3
// each), three symmetric updates of S (P^3 each), a Cholesky and a
// triangular inverse (P^3/3 each), and the two substitutions 14 P^2: about
// 0.21 MFLOP at P = 25, 1.98 GFLOP for the flagship B = 96, N = 100 solve,
// 30 us at 67 TFLOP/s of FP32. It reads 4 B N P^2 floats of bands (96 MB,
// 29 us at 3.35 TB/s). (This kernel computes the triangular and symmetric
// products as full ones, 0.30 MFLOP per frame.) Neither is the real
// limit: the recurrence is a chain of N frames, each a chain of P dependent
// Cholesky columns and P dependent inverse rows, and B = 96 trajectories
// fill only 96 of the 132 SMs. The time is synchronisation latency along
// that chain.
//
// What the design does about it. One CTA per trajectory, 1024 threads, one
// per element of the block padded to 32 x 32, so every product is one
// 25-long FMA chain per thread and every Cholesky column or inverse row is
// one step of all threads between two __syncthreads. The current frame's
// bands and a ring of the last three frames' [L0inv | L1 | L2] live in
// shared memory (rows padded to 33 floats, so a warp reading a column hits
// 32 banks), so the factor touches device memory only to read the bands
// once and to write the factor once for the backward pass. The forward
// substitution of frame n runs in warp 0 right after frame n is factored.
// The TPU kernel's one-hot matmuls, (1, 32) row vectors, lane packing and
// batch tiles were Mosaic workarounds and have no counterpart here.
// Arithmetic is FP32 FMA throughout, no TF32: the JAX reference pins
// Precision.HIGHEST, and the factored L0inv pair is kept rather than a
// Newton-Schulz full inverse, which is unstable at kappa ~ 1/damping.

#include <cuda_runtime.h>

namespace {

constexpr int PP = 32;                // padded block edge
constexpr int LD = PP + 1;            // shared-memory row stride
constexpr int MAT = PP * LD;          // floats per shared matrix
constexpr int NTHREADS = PP * PP;     // one thread per block element
// shared matrices: A0..A3 of the current frame, L3, and a ring of three
// frames of (L0inv, L1, L2); then a ring of three y vectors and one rhs
constexpr int N_MATS = 4 + 1 + 9;
constexpr int SMEM_FLOATS = N_MATS * MAT + 4 * PP;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// (r, c) entry of X Y^T over the first P columns
__device__ __forceinline__ float dot_nt(const float* X, const float* Y, int r, int c, int P) {
  float acc = 0.f;
  for (int k = 0; k < P; ++k) acc = fmaf(X[r * LD + k], Y[c * LD + k], acc);
  return acc;
}

__global__ void __launch_bounds__(NTHREADS, 1)
banded_chol_kernel(const float* __restrict__ A0g, const float* __restrict__ A1g,
                   const float* __restrict__ A2g, const float* __restrict__ A3g,
                   const float* __restrict__ g, float* __restrict__ x,
                   float* __restrict__ fac, int N, int P) {
  extern __shared__ float sm[];
  float* A0 = sm;
  float* A1 = sm + MAT;
  float* A2 = sm + 2 * MAT;
  float* A3 = sm + 3 * MAT;
  float* L3 = sm + 4 * MAT;
  float* ring = sm + 5 * MAT;  // slot s: L0inv at ring + 3s MAT, L1 +1, L2 +2
  float* yr = sm + N_MATS * MAT;  // three y vectors, slot = frame % 3
  float* rhs = yr + 3 * PP;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = tid / PP, c = tid % PP;
  const bool live = r < P && c < P;
  const size_t blk = (size_t)P * P;

  // frames -1, -2, -3: L0inv = I, L1 = L2 = 0 (the recurrence's initial carry)
  for (int s = 0; s < 3; ++s) {
    ring[(3 * s) * MAT + r * LD + c] = (r == c && r < P) ? 1.f : 0.f;
    ring[(3 * s + 1) * MAT + r * LD + c] = 0.f;
    ring[(3 * s + 2) * MAT + r * LD + c] = 0.f;
  }
  if (tid < 3 * PP) yr[tid] = 0.f;

  for (int n = 0; n < N; ++n) {
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

    const size_t off = ((size_t)b * N + n) * blk + (size_t)r * P + c;
    A0[r * LD + c] = live ? A0g[off] : 0.f;
    A1[r * LD + c] = live ? A1g[off] : 0.f;
    A2[r * LD + c] = live ? A2g[off] : 0.f;
    A3[r * LD + c] = live ? A3g[off] : 0.f;
    __syncthreads();

    L3[r * LD + c] = dot_nt(A3, Li3, r, c, P);
    __syncthreads();
    A2[r * LD + c] -= dot_nt(L3, L1_2, r, c, P);
    __syncthreads();
    L2[r * LD + c] = dot_nt(A2, Li2, r, c, P);
    __syncthreads();
    A1[r * LD + c] = A1[r * LD + c] - dot_nt(L3, L2_1, r, c, P) - dot_nt(L2, L1_1, r, c, P);
    __syncthreads();
    L1[r * LD + c] = dot_nt(A1, Li1, r, c, P);
    __syncthreads();
    A0[r * LD + c] = A0[r * LD + c] - dot_nt(L1, L1, r, c, P) - dot_nt(L2, L2, r, c, P) -
                     dot_nt(L3, L3, r, c, P);
    __syncthreads();

    // Cholesky of S (in A0), right-looking: step j reads column j only and
    // writes column j of L (into A3, consumed) and the trailing block of S
    float* S = A0;
    float* Lc = A3;
    for (int j = 0; j < P; ++j) {
      if (live && r >= j && c >= j) {
        const float piv = rsqrtf(fmaxf(S[j * LD + j], 1e-30f));
        const float lrj = S[r * LD + j] * piv;
        if (c == j)
          Lc[r * LD + j] = lrj;
        else if (r > j)
          S[r * LD + c] -= lrj * (S[c * LD + j] * piv);
      }
      __syncthreads();
    }

    // L0inv = L^-1 by forward substitution against I (work rows in A2,
    // consumed): step i finishes row i and updates the rows below it
    float* W = A2;
    W[r * LD + c] = (r == c && r < P) ? 1.f : 0.f;
    Li0[r * LD + c] = 0.f;
    __syncthreads();
    for (int i = 0; i < P; ++i) {
      if (live && r >= i) {
        const float xi = W[i * LD + c] / Lc[i * LD + i];
        if (r == i)
          Li0[i * LD + c] = xi;
        else
          W[r * LD + c] -= Lc[r * LD + i] * xi;
      }
      __syncthreads();
    }

    // the factor of frame n, for the backward pass: [L0inv | L1 | L2 | L3]
    float* F = fac + ((size_t)b * N + n) * 4 * PP * PP + r * PP + c;
    F[0] = Li0[r * LD + c];
    F[PP * PP] = L1[r * LD + c];
    F[2 * PP * PP] = L2[r * LD + c];
    F[3 * PP * PP] = L3[r * LD + c];

    // forward substitution of frame n in warp 0, lane m = row m
    if (tid < PP) {
      const int m = tid;
      const float* y1 = yr + s1 * PP;
      const float* y2 = yr + s2 * PP;
      const float* y3 = yr + s0 * PP;
      float t1 = 0.f, t2 = 0.f, t3 = 0.f;
      for (int k = 0; k < P; ++k) {
        t1 = fmaf(L1[m * LD + k], y1[k], t1);
        t2 = fmaf(L2[m * LD + k], y2[k], t2);
        t3 = fmaf(L3[m * LD + k], y3[k], t3);
      }
      const float gm = m < P ? g[((size_t)b * N + n) * P + m] : 0.f;
      rhs[m] = gm - t1 - t2 - t3;
      __syncwarp();
      float y = 0.f;
      for (int k = 0; k < P; ++k) y = fmaf(Li0[m * LD + k], rhs[k], y);
      __syncwarp();
      yr[s0 * PP + m] = y;  // y_{n-3} was read above
      if (m < P) x[((size_t)b * N + n) * P + m] = y;
      __syncwarp();
    }
  }
  __syncthreads();

  // backward substitution in warp 0, reading the factor back; column reads
  // (F[k][m] for lane m) are coalesced
  if (tid < PP) {
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
}

}  // namespace

// Launch on `stream`: x (B, N, P) solves the systems; fac (B, N, 4, 32, 32)
// is scratch. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int banded_chol_solve(const float* A0, const float* A1, const float* A2,
                                 const float* A3, const float* g, float* x, float* fac,
                                 int B, int N, int P, void* stream) {
  if (B <= 0 || N <= 0 || P <= 0 || P > PP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      banded_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  banded_chol_kernel<<<B, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(A0, A1, A2, A3, g, x,
                                                                        fac, N, P);
  return (int)cudaGetLastError();
}
