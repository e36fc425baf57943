// GGN probe sweep Y (P, D) = scale * (V R^T) R at estimator precision (TF32 tensor
// cores, FP32 accumulation), for Hopper (sm_90a).
//
// Replaces ggn_sweep (laplace_inducing_points_tpu/ops/pallas/matmul.py:213), which
// runs _matmul_nt_pallas (:68) and then _matmul_nn_pallas (:153) at the estimator
// precision DEFAULT: one reduced-precision pass with f32 accumulation. On Hopper that
// pass is TF32: every operand is rounded to TF32 (cvt.rna.tf32.f32) on its way into
// shared memory and multiplied by mma.sync m16n8k8 into FP32 accumulators.
//
// Why TF32 is allowed here and nowhere else in the port: the precision contract
// (ROADMAP, "precision contract") keeps the Gram and posterior algebra, the sample
// contractions and every operator inside an iterative solve in true FP32; only a
// trace estimator's probe sweep may take reduced-precision inputs, because its
// relative error (~1e-4 to 1e-3) sits below the estimator's own probe-to-probe
// noise (the JAX package's argument for DEFAULT, matmul.py:27-31). The Woodbury
// solve that forms the probes this sweep is applied to stays in the FP32 kernels.
//
// Path shape (the stochastic KL objective, S_X = gamma * Rx^T Rx + alpha I applied
// to P = 240 range-finder probes): V (240, 61706), R (1280, 61706), scale 468.75.
// Work: 2 * 2 * P * d * D = 75.8 GFLOP, 0.153 ms at the 495 TFLOP/s TF32 peak; the
// function's bytes (V and R read once, Y written once) are 434 MB, 0.130 ms at
// 3.35 TB/s, so the function is bound by operations. This two-stage design reads R
// twice (2 x 316 MB + 2 x 59 MB, about 750 MB: 0.224 ms), so its own floor is set by
// bytes; a fused single read of R, wgmma and TMA are later work.
//
// Stage 1, T (P, d) = V R^T, contracts the long axis D. Its output has only
// ceil(240/64) x ceil(1280/64) = 80 tiles of 64 x 64 for 132 SMs, so D is split
// across blocks (split-K): each block writes its partial tile to a workspace and a
// second pass sums the partials in a fixed order (deterministic, no atomics).
// Stage 2, Y = scale * T R, contracts d with (P, D) output tiles (4 x 965 at the
// path shape). In both stages consecutive blocks differ in the row tile of V or T,
// so the blocks that read the same strip of R run together and share it in L2.
//
// Each block is 4 warps in a 2 x 2 arrangement over a 64 x 64 output tile; a warp
// owns 32 x 32 outputs as 2 x 4 mma tiles of 16 x 8. The contraction is walked in
// strips of 32 staged in shared memory, padded so that the fragment reads of a warp
// hit 32 distinct banks. Ragged edges are masked (zeros staged), offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace lip_sweep {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 32;          // contraction strip
constexpr int THREADS = 128;    // 4 warps, 2 x 2, each 32 x 32 outputs
constexpr int KPAD = BK + 4;    // [row][k] tiles: fragment reads at stride 36 words
constexpr int NPAD = BN + 8;    // [k][col] tiles: fragment reads at stride 72 words

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D (16 x 8) += A (16 x 8, row) * B (8 x 8, col), TF32 in, FP32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + 64) x columns [k0, k0 + 32) of a row-major (rows, ld)
// matrix, columns limited to k < k_end, as TF32: s[r][k]. A warp reads 32
// consecutive k of one row.
__device__ __forceinline__ void stage_rows(uint32_t (&s)[BM][KPAD],
                                           const float* __restrict__ X, int64_t rows,
                                           int64_t ld, int64_t row0, int64_t k0,
                                           int64_t k_end) {
  constexpr int ROWS_PER_PASS = THREADS / BK;  // 4
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int64_t k = k0 + kk;
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    const int rr = r + i * ROWS_PER_PASS;
    const int64_t row = row0 + rr;
    s[rr][kk] = to_tf32((row < rows && k < k_end) ? X[row * ld + k] : 0.f);
  }
}

// Stage rows [k0, k0 + 32) x columns [col0, col0 + 64) of a row-major (K, N)
// matrix as TF32, as it lies: s[k][c]. A warp reads 32 consecutive columns.
__device__ __forceinline__ void stage_cols(uint32_t (&s)[BK][NPAD],
                                           const float* __restrict__ X, int64_t K,
                                           int64_t N, int64_t k0, int64_t col0) {
  constexpr int K_PER_PASS = THREADS / BN;  // 2
  const int c = threadIdx.x % BN;
  const int kr = threadIdx.x / BN;
  const int64_t col = col0 + c;
#pragma unroll
  for (int i = 0; i < BK / K_PER_PASS; ++i) {
    const int kk = kr + i * K_PER_PASS;
    const int64_t k = k0 + kk;
    s[kk][c] = to_tf32((k < K && col < N) ? X[k * N + col] : 0.f);
  }
}

struct WarpTile {
  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // One staged strip. A is As[m][k]; B is Bs[n][k] (B_KN false) or Bs[k][n]
  // (B_KN true). Fragment layouts of mma.m16n8k8.tf32, g = lane / 4, t = lane % 4:
  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g),
  // b1 (k = t + 4, n = g).
  template <bool B_KN, typename BTile>
  __device__ __forceinline__ void add_strip(const uint32_t (&As)[BM][KPAD],
                                            const BTile& Bs, int wm, int wn) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        a[i][0] = As[r][ks + t];
        a[i][1] = As[r + 8][ks + t];
        a[i][2] = As[r][ks + t + 4];
        a[i][3] = As[r + 8][ks + t + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        if constexpr (B_KN) {
          b[j][0] = Bs[ks + t][n];
          b[j][1] = Bs[ks + t + 4][n];
        } else {
          b[j][0] = Bs[n][ks + t];
          b[j][1] = Bs[n][ks + t + 4];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a[i], b[j]);
    }
  }

  // out[r][c] = scale * acc for the warp's outputs inside (rows, cols); C fragment
  // layout: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
  __device__ __forceinline__ void store(float* __restrict__ out, int64_t rows,
                                        int64_t cols, int64_t row0, int64_t col0,
                                        int wm, int wn, float scale) const {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t r = row0 + wm + 16 * i + g + 8 * (e / 2);
          const int64_t c = col0 + wn + 8 * j + 2 * t + (e % 2);
          if (r < rows && c < cols) out[r * cols + c] = scale * acc[i][j][e];
        }
  }
};

// Stage 1: part[split] (P, d) = V[:, chunk] R[:, chunk]^T. One block per
// (row tile of V, row tile of R, split), the row tile of V varying fastest.
__global__ void __launch_bounds__(THREADS)
sweep_project_kernel(const float* __restrict__ V, const float* __restrict__ R,
                     float* __restrict__ part, int64_t P, int64_t d, int64_t D,
                     int64_t chunk) {
  __shared__ uint32_t As[BM][KPAD];
  __shared__ uint32_t Bs[BN][KPAD];
  const int64_t p_tiles = (P + BM - 1) / BM;
  const int64_t d_tiles = (d + BN - 1) / BN;
  const int64_t b = blockIdx.x;
  const int64_t row0 = (b % p_tiles) * BM;
  const int64_t col0 = ((b / p_tiles) % d_tiles) * BN;
  const int64_t split = b / (p_tiles * d_tiles);
  const int64_t k_begin = split * chunk;
  const int64_t k_end = k_begin + chunk < D ? k_begin + chunk : D;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  WarpTile tile;
  tile.zero();
  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    stage_rows(As, V, P, D, row0, k0, k_end);
    stage_rows(Bs, R, d, D, col0, k0, k_end);
    __syncthreads();
    tile.add_strip<false>(As, Bs, wm, wn);
    __syncthreads();
  }
  tile.store(part + split * P * d, P, d, row0, col0, wm, wn, 1.f);
}

// T = sum over splits of the partials, in split order.
__global__ void sweep_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ T, int64_t n, int64_t splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int64_t k = 0; k < splits; ++k) s += part[k * n + i];
    T[i] = s;
  }
}

// Stage 2: Y (P, D) = scale * T (P, d) R (d, D). One block per (row tile of T,
// column tile of R), the row tile varying fastest.
__global__ void __launch_bounds__(THREADS)
sweep_push_kernel(const float* __restrict__ T, const float* __restrict__ R,
                  float* __restrict__ Y, int64_t P, int64_t d, int64_t D, float scale) {
  __shared__ uint32_t As[BM][KPAD];
  __shared__ uint32_t Bs[BK][NPAD];
  const int64_t p_tiles = (P + BM - 1) / BM;
  const int64_t b = blockIdx.x;
  const int64_t row0 = (b % p_tiles) * BM;
  const int64_t col0 = (b / p_tiles) * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  WarpTile tile;
  tile.zero();
  for (int64_t k0 = 0; k0 < d; k0 += BK) {
    stage_rows(As, T, P, d, row0, k0, d);
    stage_cols(Bs, R, d, D, k0, col0);
    __syncthreads();
    tile.add_strip<true>(As, Bs, wm, wn);
    __syncthreads();
  }
  tile.store(Y, P, D, row0, col0, wm, wn, scale);
}

}  // namespace lip_sweep

// Plain C entry point, loaded with ctypes. `part` holds `splits` partial (P, d)
// tiles and may be T itself when splits == 1; T and Y are outputs. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int lip_ggn_sweep_tf32(const float* V, const float* R, float* part, float* T,
                                  float* Y, int64_t P, int64_t d, int64_t D,
                                  int64_t splits, float scale, void* stream) {
  using namespace lip_sweep;
  if (P <= 0 || d <= 0 || D <= 0 || splits <= 0 || (splits == 1) != (part == T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = ((D + splits - 1) / splits + BK - 1) / BK * BK;
  const int64_t p_tiles = (P + BM - 1) / BM;
  const int64_t project_blocks = p_tiles * ((d + BN - 1) / BN) * splits;
  const int64_t push_blocks = p_tiles * ((D + BN - 1) / BN);
  if (project_blocks > 2147483647LL || push_blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweep_project_kernel<<<static_cast<unsigned>(project_blocks), THREADS, 0, s>>>(
      V, R, part, P, d, D, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int64_t n = P * d;
    const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    sweep_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(part, T, n, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_push_kernel<<<static_cast<unsigned>(push_blocks), THREADS, 0, s>>>(
      T, R, Y, P, d, D, scale);
  return static_cast<int>(cudaGetLastError());
}
