// SYRK C (d, d) = A A^T for a short-by-long A (d, D), FP32, for Hopper (sm_90a).
//
// Replaces _syrk_pallas (laplace_inducing_points_tpu/ops/pallas/syrk.py:71). On the
// serving path A is the row factor R (1000, 61706) and C is the Gram that eigh
// factors, so the product must be true FP32 and exactly symmetric.
//
// What bounds it on an H100: 61.7 GFLOP over the lower triangle against 0.25 GB of
// A, so FP32 compute. The TPU kernel walked a prefetched list of lower-triangle
// tiles sequentially and carried each tile's sum across k-steps of the grid; here
// each block owns one lower tile (tile row >= tile column, found from blockIdx.x by
// the triangular index) and loops over the whole of D itself, in the tile
// machinery of gemm_f32.cuh. Only ceil(d/64)(ceil(d/64)+1)/2 = 136 blocks exist at
// d = 1000, about one wave on 132 SMs; splitting D across blocks is later work.
// The epilogue writes each element with row >= column and its mirror, so C is
// symmetric bit for bit (JAX's tril(L) + tril(L, -1)^T).
#include <cmath>

#include "gemm_f32.cuh"

namespace lip {

__device__ __forceinline__ void lower_tile(int64_t b, int64_t* ti, int64_t* tj) {
  int64_t i = static_cast<int64_t>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= b) ++i;
  while (i * (i + 1) / 2 > b) --i;
  *ti = i;
  *tj = b - i * (i + 1) / 2;
}

__global__ void __launch_bounds__(THREADS)
syrk_kernel(const float* __restrict__ A, float* __restrict__ C, int64_t d, int64_t K) {
  __shared__ Tile As;
  __shared__ Tile Bs;
  int64_t ti, tj;
  lower_tile(blockIdx.x, &ti, &tj);
  const int64_t row0 = ti * BM;
  const int64_t col0 = tj * BN;
  Accumulator acc;
  acc.zero();
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    load_rows(As, A, d, K, row0, k0);
    load_rows(Bs, A, d, K, col0, k0);
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
      if (r < d && c <= r) {
        C[r * d + c] = acc.sum[i][j];
        C[c * d + r] = acc.sum[i][j];
      }
    }
  }
}

}  // namespace lip

// Plain C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is seen.
extern "C" int lip_syrk_f32(const float* A, float* C, int64_t d, int64_t K, void* stream) {
  const int64_t t = (d + lip::BM - 1) / lip::BM;
  const int64_t blocks = t * (t + 1) / 2;
  if (d <= 0 || K <= 0 || blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lip::syrk_kernel<<<static_cast<unsigned>(blocks), lip::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(A, C, d, K);
  return static_cast<int>(cudaGetLastError());
}
