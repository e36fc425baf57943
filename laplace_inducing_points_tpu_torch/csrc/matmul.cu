// Long-contraction FP32 matrix products of the LLA sampler, for Hopper (sm_90a).
//
// lip_matmul_nt_f32: C (m, n) = A (m, K) B (n, K)^T.
//   Replaces _matmul_nt_pallas (laplace_inducing_points_tpu/ops/pallas/matmul.py:68).
//   On the serving path it is U = eps R^T: eps (200, 61706), R (1000, 61706).
//   Both operands are read along their contiguous long axis; B^T is never formed.
// lip_matmul_nn_f32: C (m, N) = A (m, z) B (z, N), A small, B long.
//   Replaces _matmul_nn_pallas (laplace_inducing_points_tpu/ops/pallas/matmul.py:153).
//   On the serving path it is the push-back (mixed V^T) R: (200, 1000) x (1000, 61706).
//
// What bounds them on an H100: at these shapes both are FP32-compute bound
// (24.7 GFLOP each against 0.25-0.3 GB of operands), and true FP32 rules out the
// tensor cores. The NT product has only ceil(200/64) x ceil(1000/64) = 64 output
// tiles, under half of the 132 SMs; splitting K across blocks is later work. The
// NN product has 4 x 965 tiles and fills the card. The design keeps the tiles in
// shared memory (one global read of each operand element per tile that needs it),
// masks the ragged edges (61,706 and 1,000 are not tile multiples) and sums in two
// levels with Kahan compensation, so that the error does not grow with D.
#include "gemm_f32.cuh"

namespace lip {

__global__ void __launch_bounds__(THREADS)
matmul_nt_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int64_t m, int64_t n, int64_t K) {
  __shared__ Tile As;
  __shared__ Tile Bs;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  Accumulator acc;
  acc.zero();
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    load_rows(As, A, m, K, row0, k0);
    load_rows(Bs, B, n, K, col0, k0);
    __syncthreads();
    acc.add_strip(As, Bs);
    __syncthreads();
  }
  const int tx = threadIdx.x % TDIM;
  const int ty = threadIdx.x / TDIM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + TDIM * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = col0 + tx + TDIM * j;
      if (r < m && c < n) C[r * n + c] = acc.sum[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
matmul_nn_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int64_t m, int64_t z, int64_t N) {
  __shared__ Tile As;
  __shared__ Tile Bs;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  Accumulator acc;
  acc.zero();
  for (int64_t k0 = 0; k0 < z; k0 += BK) {
    load_rows(As, A, m, z, row0, k0);
    load_cols(Bs, B, z, N, k0, col0);
    __syncthreads();
    acc.add_strip(As, Bs);
    __syncthreads();
  }
  const int tx = threadIdx.x % TDIM;
  const int ty = threadIdx.x / TDIM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + TDIM * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = col0 + tx + TDIM * j;
      if (r < m && c < N) C[r * N + c] = acc.sum[i][j];
    }
  }
}

}  // namespace lip

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is seen.
extern "C" int lip_matmul_nt_f32(const float* A, const float* B, float* C,
                                 int64_t m, int64_t n, int64_t K, void* stream) {
  const int64_t row_tiles = (m + lip::BM - 1) / lip::BM;
  const int64_t col_tiles = (n + lip::BN - 1) / lip::BN;
  if (!lip::grid_fits(row_tiles, col_tiles) || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  lip::matmul_nt_kernel<<<grid, lip::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, m, n, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lip_matmul_nn_f32(const float* A, const float* B, float* C,
                                 int64_t m, int64_t z, int64_t N, void* stream) {
  const int64_t row_tiles = (m + lip::BM - 1) / lip::BM;
  const int64_t col_tiles = (N + lip::BN - 1) / lip::BN;
  if (!lip::grid_fits(row_tiles, col_tiles) || z <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  lip::matmul_nn_kernel<<<grid, lip::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, m, z, N);
  return static_cast<int>(cudaGetLastError());
}
