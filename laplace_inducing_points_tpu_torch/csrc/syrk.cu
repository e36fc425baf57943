// SYRK C (d, d) = A A^T for a short-by-long A (d, D), FP32, for Hopper (sm_90a).
//
// Replaces _syrk_pallas (laplace_inducing_points_tpu/ops/pallas/syrk.py:71). On the
// path A is the row factor Rz or R (1000, 61706) and C is the Gram that Cholesky
// and eigh factor, so the product must be FP32-accurate and exactly symmetric.
//
// What bounds it on an H100: d (d + 1) D = 61.8 GFLOP over the lower triangle
// against 0.25 GB of A, so operations: 0.37 ms at the 3xTF32 rate (a third of the
// 495 TFLOP/s TF32 peak), 0.92 ms at the 67 TFLOP/s FFMA peak. The TPU kernel walked
// a prefetched list of lower-triangle tiles and carried each tile's sum across the
// k-steps of its grid. Here the NT tile machinery of tiled.cuh (3xTF32 mma.sync,
// Kahan-folded sums with the truncation loss put back, a cp.async ring) runs in its
// LOWER mode: only the 64 x 128 (or 32 x 128) tiles that hold an element on or below
// the diagonal are launched, 72 of them at d = 1000 (18% of their work lies above the
// diagonal). 72 tiles fill about half of 132 SMs, so D is split across blocks by wave
// fill (the wrapper's planner: 5 splits at d = 1000, 360 blocks in three waves 91%
// full), the blocks of one split side by side so that they share A's strips in L2.
//
// Exact symmetry: a second pass sums the partials in split order (Kahan) and writes
// each sum with row >= column to C[r][c] and C[c][r]; without a split the tile's
// epilogue does the same. The upper half of a tile on the diagonal is never written:
// there (r, c) and (c, r) are different lanes' sums, whose lo*hi and hi*lo terms are
// swapped, so they are not bitwise equal. C is symmetric bit for bit (JAX's
// tril(L) + tril(L, -1)^T).
//
// The diagonal: the tensor cores' truncation of sums of squares loses more than
// TRUNCATION takes back (a coherent -3.5e-8 to -5e-8 of the diagonal at every shape
// on an H100, four times the 1e-8 gate where D is short and cuBLAS's own bias is
// small), so the blocks that hold diagonal entries sum them again on the CUDA cores
// from the strips in shared memory (tiled.cuh, diagonal_strip) and write those.
#include "tiled.cuh"

namespace lip_tc {

// C[r][c] = C[c][r] = the sum over s of part[s][r][c] for r >= c, split by split.
__global__ void mirror_reduce_kernel(const float* __restrict__ part, float* __restrict__ C,
                                     int64_t d, int64_t splits) {
  const int64_t count = d * d;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / d;
    const int64_t c = i % d;
    if (c > r) continue;
    float sum = 0.f, comp = 0.f;
    for (int64_t k = 0; k < splits; ++k) lip_mm::kahan_add(sum, comp, part[k * count + i]);
    C[i] = sum - comp;
    C[c * d + r] = sum - comp;
  }
}

cudaError_t syrk_resident_blocks(int64_t& small, int64_t& large) {
  const cudaError_t err = resident_blocks<1, 4, false, true>(small);
  return err != cudaSuccess ? err : resident_blocks<2, 4, false, true>(large);
}

}  // namespace lip_tc

// Plain C entry point, loaded with ctypes. C = A A^T over `splits` blocks per lower
// tile of tile_rows (32 or 64) x 128, through `part` (the (splits, d, d) partials; C
// itself when splits == 1). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is seen.
extern "C" int lip_syrk_f32(const float* A, float* part, float* C, int64_t d, int64_t K,
                            int64_t tile_rows, int64_t splits, void* stream) {
  using namespace lip_tc;
  if (d <= 0 || K <= 0 || splits <= 0 ||
      (tile_rows != SmallTile::BM && tile_rows != LargeTile::BM) || (splits == 1) != (part == C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = lower_tiles(d, static_cast<int>(tile_rows), TILE_COLS);
  if (tiles * splits > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(tiles * splits);
  const int64_t chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiles<false, true>(tile_rows, vec_width(A, A, K, K), blocks, s, A,
                                              A, part, d, d, K, chunk, splits == 1);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t threads = 256;
  const int64_t grid = (d * d + threads - 1) / threads < 4096 ? (d * d + threads - 1) / threads
                                                               : 4096;
  mirror_reduce_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(part, C, d, splits);
  return static_cast<int>(cudaGetLastError());
}
