// Tile machinery of the port's true-FP32 SYRK (syrk.cu).
//
// Every kernel here computes one BM x BN output tile per block of 256 threads. The
// contraction axis is walked in BK-strips staged in shared memory; thread (tx, ty)
// owns the 4 x 4 outputs at rows ty + 16 i and columns tx + 16 j of the tile.
//
// Precision: the products feed eigh (the Gram) or cancel a prior draw (the sample
// contractions), so they run as IEEE FP32 FFMA on the CUDA cores, never TF32. Each
// BK-strip is summed in a fresh register accumulator and the strip sums are added
// to the running total with Kahan compensation: over D = 61,706 terms a plain
// serial f32 sum loses about sqrt(D) times more than this two-level sum.
//
// Offsets are 64-bit: d x D reaches 2^31 at ResNet-size D.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lip {

constexpr int BM = 64;            // output tile rows
constexpr int BN = 64;            // output tile columns
constexpr int BK = 32;            // contraction strip
constexpr int TM = 4;             // rows per thread
constexpr int TN = 4;             // columns per thread
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int TDIM = 16;
constexpr int SPAD = BM + 1;      // +1 column: transposed stores hit 32 distinct banks

static_assert(BM == BN, "one shared-memory tile shape serves both operands");
static_assert(TDIM * TM == BM && TDIM * TN == BN, "thread grid covers the tile");

using Tile = float[BK][SPAD];

// Stage rows [row0, row0 + BM) x columns [k0, k0 + BK) of a row-major (rows, K)
// matrix, transposed: s[k][r]. A warp reads 32 consecutive k of one row.
__device__ __forceinline__ void load_rows(Tile& s, const float* __restrict__ X,
                                          int64_t rows, int64_t K, int64_t row0,
                                          int64_t k0) {
  constexpr int ROWS_PER_PASS = THREADS / BK;  // 8
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int64_t k = k0 + kk;
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    const int rr = r + i * ROWS_PER_PASS;
    const int64_t row = row0 + rr;
    s[kk][rr] = (row < rows && k < K) ? X[row * K + k] : 0.f;
  }
}

struct Accumulator {
  float sum[TM][TN];
  float comp[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sum[i][j] = comp[i][j] = 0.f;
  }

  // strip[i][j] = sum over the staged strip of As[k][row_i] * Bs[k][col_j],
  // then Kahan-add it to the running total.
  __device__ __forceinline__ void add_strip(const Tile& As, const Tile& Bs) {
    const int tx = threadIdx.x % TDIM;
    const int ty = threadIdx.x / TDIM;
    float strip[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) strip[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + TDIM * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + TDIM * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) strip[i][j] = fmaf(a[i], b[j], strip[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float y = strip[i][j] - comp[i][j];
        const float t = sum[i][j] + y;
        comp[i][j] = (t - sum[i][j]) - y;
        sum[i][j] = t;
      }
  }
};

}  // namespace lip
