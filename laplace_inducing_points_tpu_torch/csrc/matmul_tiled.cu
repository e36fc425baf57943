// Tiled paths of the FP32 NT and NN products (B2, B3; the skinny paths and the
// source note are in matmul.cu), for Hopper (sm_90a).
//
// lip_nt_tiled_f32: C (m, n) = A (m, K) B (n, K)^T for m > 8: the Woodbury projection
//   (16 | 240, 61706) x (1000, 61706)^T, serving's eps R^T (200 rows) and the
//   cross-Gram Gxz (1280 rows). 2 m n K operations: at 200 rows 24.7 GFLOP against
//   0.25 GB, so bound by operations (0.37 ms at the 67 TFLOP/s FFMA peak, 0.15 ms
//   at a third of the 495 TFLOP/s TF32 peak); at 16 rows by one read of B.
// lip_nn_tiled_f32: C (m, N) = A (m, z) B (z, N): serving's (200, 1000) x (1000,
//   61706), the Woodbury correction (16 | 240 rows) and the backward products
//   (1000, 1000 | 1280) x (1000 | 1280, 61706).
//
// The tile machinery (3xTF32 mma.sync with Kahan-folded sums, the cp.async ring,
// split-K) is in tiled.cuh, shared with the Gram (syrk.cu). The NT products have
// few output tiles (serving: 4 x 8 for 132 SMs), so the long axis is split across
// blocks by the wrapper's planner, and a second pass sums the partials in split
// order. Tiles of 32 x 128 are taken when m <= 32 (16 rows would waste 4x of a
// 64-row tile).
#include "tiled.cuh"

namespace lip_tc {

// C = the product over `splits` blocks per output tile, through `part` (the
// (splits, m, n) partials; C itself when splits == 1).
template <bool B_KN>
int launch(const float* A, const float* B, float* part, float* C, int64_t m, int64_t n,
           int64_t K, int64_t tile_rows, int64_t splits, void* stream) {
  if (m <= 0 || n <= 0 || K <= 0 || splits <= 0 ||
      (tile_rows != SmallTile::BM && tile_rows != LargeTile::BM) || (splits == 1) != (part == C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = ((m + tile_rows - 1) / tile_rows) * ((n + TILE_COLS - 1) / TILE_COLS);
  if (tiles * splits > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(tiles * splits);
  const int64_t chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const int w = vec_width(A, B, K, B_KN ? n : K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_tiles<B_KN, false>(tile_rows, w, blocks, s, A, B, part, m, n, K, chunk, 0);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(split_reduce(part, C, m * n, splits, s));
}

}  // namespace lip_tc

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is seen.
// tile_rows is 32 or 64 (the block's output rows); the block's columns are 128.

// What the wrapper's path planner needs of the NT and NN kernels on the current
// device, and what the Gram's planner needs, into out[0..13): its SMs; the most
// output rows of the row paths; the deepest contraction of the rank path; the output
// columns of an NN row block; the output columns of a tiled block; the small and the
// large tiled block heights; the resident tiled blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of NT at the small and the large
// height, then of NN, then of the Gram's lower tiles (syrk.cu).
extern "C" int lip_matmul_geometry(int64_t* out) {
  using namespace lip_tc;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = sms;
  out[1] = lip_mm::ROW_MAX;
  out[2] = lip_mm::RANK_MAX;
  out[3] = lip_mm::COL_BLOCK;
  out[4] = TILE_COLS;
  out[5] = SmallTile::BM;
  out[6] = LargeTile::BM;
  const cudaError_t errs[] = {resident_blocks<1, 4, false, false>(out[7]),
                              resident_blocks<2, 4, false, false>(out[8]),
                              resident_blocks<1, 4, true, false>(out[9]),
                              resident_blocks<2, 4, true, false>(out[10]),
                              syrk_resident_blocks(out[11], out[12])};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// C (m, n) = A (m, K) B (n, K)^T.
extern "C" int lip_nt_tiled_f32(const float* A, const float* B, float* part, float* C,
                                int64_t m, int64_t n, int64_t K, int64_t tile_rows,
                                int64_t splits, void* stream) {
  return lip_tc::launch<false>(A, B, part, C, m, n, K, tile_rows, splits, stream);
}

// C (m, N) = A (m, z) B (z, N).
extern "C" int lip_nn_tiled_f32(const float* A, const float* B, float* part, float* C,
                                int64_t m, int64_t z, int64_t N, int64_t tile_rows,
                                int64_t splits, void* stream) {
  return lip_tc::launch<true>(A, B, part, C, m, N, z, tile_rows, splits, stream);
}
