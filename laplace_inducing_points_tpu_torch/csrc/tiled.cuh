// The 3xTF32 tile machinery of the FP32 products on Hopper (sm_90a): the tiled
// paths of B2 and B3 (matmul_tiled.cu) and the Gram B1 (syrk.cu) instantiate it.
//
// Arithmetic: 3xTF32 on the tensor cores. Each operand x splits at fragment load
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (away) on the bit
// pattern (an integer add and mask: cvt.rna.tf32 gives the same bits and is slower),
// so x = hi + lo + O(2^-22 |x|); mma.sync m16n8k8 forms hi*hi, lo*hi and hi*lo in
// FP32 (lo*lo is below the FP32 rounding).
//
// The tensor cores' FP32 accumulation truncates each sum toward zero. Chained over a
// strip, the truncations of the running sums all shrink the result: a coherent bias,
// which a product like Gxz passes on to the KL value amplified by gamma/alpha, where
// round-to-nearest errors would cancel. So the block never chains hi*hi: each 8-deep
// step's hi*hi products go to a fresh accumulator (one truncation, of an 8-term sum)
// and are added to the strip's sum in FP32, rounded to nearest; the lo*hi + hi*lo
// terms, 2^-11 smaller, chain in an accumulator of their own. Each strip (32 deep;
// 8 deep when K < SHORT_K, where cuBLAS's own error is only a few roundings) is
// folded into the running total by Kahan, its accumulator starting at the negated
// compensation, which also takes back the mean loss of the truncations, TRUNCATION
// times the strip's sum: on an H100 an 8-term sum loses 3.5e-8 of its value on
// average for operands of both signs, at any shape, and 3.9e-8 for all-positive
// ones. What is left (the bias, about 5e-11 and 5e-9 relative) is gated against
// cuBLAS's in chip_smoke.py phase 3, where a kernel without the correction, or with
// twice it, fails. Sums of squares lose more than the constant takes back (the
// Gram's diagonal kept 3.5e-8 to 5e-8 of bias at every shape on an H100), so the
// Gram (LOWER) sums its diagonal entries on the CUDA cores instead, from the strips
// already in shared memory (diagonal_strip): FP32 rounded to nearest and
// Kahan-compensated, no coherent error and no extra read of A.
//
// Movement: operands go into shared memory as raw FP32 through a cp.async ring of
// STAGES strips (the copy of strip s + STAGES - 1 overlaps the products of strip s),
// in vectors of W floats (16-byte cp.async.cg, or 8- and 4-byte cp.async.ca where
// the rows are only 8- or 4-byte aligned, matmul.cuh), zero-filled past the edges.
// A is staged [row][k] and B [n][k] (NT) or [k][col] (NN), with pads that keep the
// fragment reads of a warp on 32 distinct banks.
//
// Tiles: 4 or 8 warps, each 32 x 32 outputs as 2 x 4 mma tiles; blocks of 64 x 128
// outputs, or 32 x 128. The long axis may be split across blocks (splits from the
// wrapper's planner); each writes its partial tile to a workspace and a second pass
// sums them in split order (deterministic, no atomics). Consecutive blocks differ in
// the output tile and share a split, so the blocks that read the same strips run
// together and share them in L2. LOWER (the Gram A A^T, B = A): only the tiles that
// hold an element on or below the diagonal are launched (lower_tile).
#pragma once

#include "matmul.cuh"

namespace lip_tc {

using lip_mm::split_reduce;
using lip_mm::vec_width;

constexpr int BK = 32;          // contraction strip
constexpr int STAGES = 3;       // cp.async ring depth
constexpr int KPAD = BK + 4;    // [row][k] tiles: fragment reads at stride 36 words
constexpr int MI = 2;           // a warp's mma tiles: 2 x 4 of 16 x 8 = 32 x 32 outputs
constexpr int NJ = 4;
constexpr int64_t SHORT_K = 512;      // contractions below it fold every 8-deep step
constexpr float TRUNCATION = 3.5e-8f;  // mean relative loss of a truncated 8-term sum

template <int WARPS_M, int WARPS_N, bool B_KN>
struct Tile {
  static constexpr int BM = WARPS_M * MI * 16;
  static constexpr int BN = WARPS_N * NJ * 8;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int NPAD = BN + 8;   // [k][col] tiles: fragment reads at stride BN + 8
  static constexpr int A_FLOATS = BM * KPAD;
  static constexpr int B_FLOATS = B_KN ? BK * NPAD : BN * KPAD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  // the Gram's (LOWER) diagonal accumulators, a (sum, compensation) pair a row, past the ring
  static constexpr int DIAG_BYTES = 2 * BM * 4;
};

template <typename T, bool LOWER>
constexpr int smem_bytes() {
  return T::SMEM_BYTES + (LOWER ? T::DIAG_BYTES : 0);
}

using SmallTile = Tile<1, 4, false>;   // 32 x 128 outputs, 4 warps
using LargeTile = Tile<2, 4, false>;   // 64 x 128 outputs, 8 warps
constexpr int TILE_COLS = LargeTile::BN;
static_assert(SmallTile::BN == TILE_COLS, "both tile heights share the columns");

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (sum, -comp) += y = acc + small by Kahan, with the truncation loss TRUNCATION * y
// put back into the compensation: acc holds the negated compensation on exit.
__device__ __forceinline__ void fold(float& sum, float& acc, float& small) {
  const float y = acc + small;
  const float total = sum + y;
  acc = fmaf(y, TRUNCATION, y - (total - sum));
  sum = total;
  small = 0.f;
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

// W floats from src to shared dst, or W zeros if !valid (src-size 0).
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t n = valid ? 4 * W : 0;
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of a row-major (rows, ld)
// matrix, columns limited to k < k_end, into s[r][k] (stride KPAD).
template <int ROWS, int THREADS, int W>
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ X,
                                           int64_t rows, int64_t ld, int64_t row0,
                                           int64_t k0, int64_t k_end) {
  constexpr int PER_ROW = BK / W;
  constexpr int COPIES = ROWS * PER_ROW;
  static_assert(COPIES % THREADS == 0, "copies divide among the threads");
#pragma unroll
  for (int it = 0; it < COPIES / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / PER_ROW;
    const int kv = (c % PER_ROW) * W;
    const int64_t row = row0 + r;
    const int64_t k = k0 + kv;
    const bool ok = row < rows && k < k_end;
    cp_async<W>(s + r * KPAD + kv, ok ? X + row * ld + k : X, ok);
  }
}

// Rows [k0, k0 + BK) (k < k_end) x columns [col0, col0 + BN) (col < n) of a
// row-major (K, n) matrix, as it lies: s[k][c] (stride BN + 8).
template <int BN, int THREADS, int W>
__device__ __forceinline__ void stage_cols(float* s, const float* __restrict__ X,
                                           int64_t n, int64_t k0, int64_t k_end,
                                           int64_t col0) {
  constexpr int PER_ROW = BN / W;
  constexpr int COPIES = BK * PER_ROW;
  static_assert(COPIES % THREADS == 0, "copies divide among the threads");
#pragma unroll
  for (int it = 0; it < COPIES / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int kr = c / PER_ROW;
    const int cv = (c % PER_ROW) * W;
    const int64_t k = k0 + kr;
    const int64_t col = col0 + cv;
    const bool ok = k < k_end && col < n;
    cp_async<W>(s + kr * (BN + 8) + cv, ok ? X + k * n + col : X, ok);
  }
}

// The warp's products over one staged strip, in 3xTF32, folded into sum (acc
// carries the negated compensation between strips): FOLD8, after every 8-deep
// step; else once. Fragment layouts of mma.m16n8k8.tf32, g = lane / 4, t = lane % 4:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g),
// b1 (k = t + 4, n = g).
template <bool B_KN, int NPAD, bool FOLD8>
__device__ __forceinline__ void mma_strip(float (&sum)[MI][NJ][4], float (&acc)[MI][NJ][4],
                                          const float* As, const float* Bs, int wm, int wn) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float small[MI][NJ][4];   // lo*hi + hi*lo
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = wn + 8 * j + g;
      const float x0 = B_KN ? Bs[(ks + t) * NPAD + n] : Bs[n * KPAD + ks + t];
      const float x1 = B_KN ? Bs[(ks + t + 4) * NPAD + n] : Bs[n * KPAD + ks + t + 4];
      split_tf32(x0, bh[j][0], bl[j][0]);
      split_tf32(x1, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wm + 16 * i + g;
      uint32_t ah[4], al[4];
      split_tf32(As[r * KPAD + ks + t], ah[0], al[0]);
      split_tf32(As[(r + 8) * KPAD + ks + t], ah[1], al[1]);
      split_tf32(As[r * KPAD + ks + t + 4], ah[2], al[2]);
      split_tf32(As[(r + 8) * KPAD + ks + t + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma_tf32(small[i][j], al, bh[j]);
        mma_tf32(small[i][j], ah, bl[j]);
        float hh[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(hh, ah, bh[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += hh[e];
      }
    }
    if (FOLD8 || ks + 8 == BK) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fold(sum[i][j][e], acc[i][j][e], small[i][j][e]);
    }
  }
}

// Strip `strip` of the block's operands into its slot of the ring.
template <typename T, bool B_KN, int W>
__device__ __forceinline__ void stage_strip(float* smem, const float* __restrict__ A,
                                            const float* __restrict__ B, int64_t m,
                                            int64_t n, int64_t K, int64_t row0,
                                            int64_t col0, int64_t k_begin, int64_t k_end,
                                            int64_t strip) {
  float* s = smem + (strip % STAGES) * T::STAGE_FLOATS;
  const int64_t k0 = k_begin + strip * BK;
  stage_rows<T::BM, T::THREADS, W>(s, A, m, K, row0, k0, k_end);
  if constexpr (B_KN) {
    stage_cols<T::BN, T::THREADS, W>(s + T::A_FLOATS, B, n, k0, k_end, col0);
  } else {
    stage_rows<T::BN, T::THREADS, W>(s + T::A_FLOATS, B, n, K, col0, k0, k_end);
  }
}

// The Gram's diagonal over one strip in shared memory (As: the tile's rows of A,
// [row][k]): four threads a row (THREADS = 4 BM), each the FP32 sum of 8 squares,
// joined across the four lanes and Kahan-added into diag[2 r] (sum) and
// diag[2 r + 1] (compensation) for the rows r of [lo, hi). Every operation rounds
// to nearest.
template <typename T>
__device__ __forceinline__ void diagonal_strip(const float* As, int64_t row0, int64_t lo,
                                               int64_t hi, float* diag) {
  static_assert(T::THREADS == 4 * T::BM, "four threads a row");
  const int r = threadIdx.x / 4;
  const int q = threadIdx.x % 4;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < BK / 4; ++k) {
    const float x = As[r * KPAD + (BK / 4) * q + k];
    v = fmaf(x, x, v);
  }
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (q == 0 && row0 + r >= lo && row0 + r < hi) lip_mm::kahan_add(diag[2 * r], diag[2 * r + 1], v);
}

// The rows [lo, hi) whose diagonal entry the tile at (row0, col0) holds (lo >= hi:
// none).
template <typename T>
__device__ __forceinline__ void diagonal_rows(int64_t row0, int64_t col0, int64_t m,
                                              int64_t& lo, int64_t& hi) {
  lo = row0 > col0 ? row0 : col0;
  hi = row0 + T::BM;
  if (col0 + T::BN < hi) hi = col0 + T::BN;
  if (m < hi) hi = m;
}

// The block's strips through the ring into (sum, acc); DIAG (a Gram tile that holds
// diagonal entries) also sums the diagonal rows' squares into diag. A separate
// instance, so that the other tiles' loop carries none of it.
template <typename T, bool B_KN, bool FOLD8, int W, bool DIAG>
__device__ __forceinline__ void run_strips(float (&sum)[MI][NJ][4], float (&acc)[MI][NJ][4],
                                           float* smem, const float* __restrict__ A,
                                           const float* __restrict__ B, int64_t m, int64_t n,
                                           int64_t K, int64_t row0, int64_t col0,
                                           int64_t k_begin, int64_t k_end, int wm, int wn) {
  const int64_t strips = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  int64_t lo = 0, hi = 0;
  float* diag = smem + STAGES * T::STAGE_FLOATS;
  if constexpr (DIAG) {
    diagonal_rows<T>(row0, col0, m, lo, hi);
    if (threadIdx.x < 2 * T::BM) diag[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < strips) stage_strip<T, B_KN, W>(smem, A, B, m, n, K, row0, col0, k_begin, k_end, s);
    cp_async_commit();
  }
  for (int64_t kt = 0; kt < strips; ++kt) {
    cp_async_wait<STAGES - 2>();   // strip kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and strip kt - 1 is consumed
    if (kt + STAGES - 1 < strips) {
      stage_strip<T, B_KN, W>(smem, A, B, m, n, K, row0, col0, k_begin, k_end,
                              kt + STAGES - 1);
    }
    cp_async_commit();
    const float* s = smem + (kt % STAGES) * T::STAGE_FLOATS;
    mma_strip<B_KN, T::NPAD, FOLD8>(sum, acc, s, s + T::A_FLOATS, wm, wn);
    if constexpr (DIAG) diagonal_strip<T>(s, row0, lo, hi, diag);
  }
  cp_async_wait<0>();
  if constexpr (DIAG) __syncthreads();   // the diagonal's sums are read by other threads
}

// Output tiles of BM x BN on or below the diagonal of an (m, m) Gram in row tile i:
// the columns [0, BM (i + 1)), at most n_tiles of them.
__host__ __device__ __forceinline__ int64_t lower_row_tiles(int64_t i, int64_t n_tiles,
                                                            int bm, int bn) {
  const int64_t cols = (bm * i + bm - 1) / bn + 1;
  return cols < n_tiles ? cols : n_tiles;
}

__host__ __device__ __forceinline__ int64_t lower_tiles(int64_t m, int bm, int bn) {
  const int64_t m_tiles = (m + bm - 1) / bm;
  const int64_t n_tiles = (m + bn - 1) / bn;
  int64_t count = 0;
  for (int64_t i = 0; i < m_tiles; ++i) count += lower_row_tiles(i, n_tiles, bm, bn);
  return count;
}

// Row tile i and column tile j of the t-th lower tile, row by row.
__device__ __forceinline__ void lower_tile(int64_t t, int64_t m_tiles, int64_t n_tiles,
                                           int bm, int bn, int64_t& i, int64_t& j) {
  for (i = 0; i < m_tiles - 1; ++i) {
    const int64_t cols = lower_row_tiles(i, n_tiles, bm, bn);
    if (t < cols) break;
    t -= cols;
  }
  j = t;
}

// One block: output tile (row tile, column tile) of split `split`, contracting
// [split * chunk, min((split + 1) * chunk, K)). NT: A (m, K), B (n, K); NN (B_KN):
// A (m, K), B (K, n). Block b takes row tile b % m_tiles, column tile
// (b / m_tiles) % n_tiles and split b / (m_tiles n_tiles); LOWER, the lower tile
// b % lower_tiles and split b / lower_tiles. Writes out + split * m * n; LOWER with
// `mirror` (out is C itself, no split) writes each element with row >= column and
// its mirror, and nothing else, so C is symmetric bit for bit. LOWER takes the
// diagonal entries from diagonal_strip's sums, kept past the ring.
template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W, bool LOWER>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
tiled_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ out, int64_t m, int64_t n, int64_t K, int64_t chunk,
             int mirror) {
  static_assert(!(LOWER && B_KN), "the Gram is an NT product");
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  extern __shared__ __align__(16) float smem[];
  const int64_t m_tiles = (m + T::BM - 1) / T::BM;
  const int64_t n_tiles = (n + T::BN - 1) / T::BN;
  const int64_t b = blockIdx.x;
  int64_t row0, col0, split;
  if constexpr (LOWER) {
    const int64_t tiles = lower_tiles(m, T::BM, T::BN);
    int64_t i, j;
    lower_tile(b % tiles, m_tiles, n_tiles, T::BM, T::BN, i, j);
    row0 = i * T::BM;
    col0 = j * T::BN;
    split = b / tiles;
  } else {
    row0 = (b % m_tiles) * T::BM;
    col0 = ((b / m_tiles) % n_tiles) * T::BN;
    split = b / (m_tiles * n_tiles);
  }
  const int64_t k_begin = split * chunk;
  const int64_t k_end = k_begin + chunk < K ? k_begin + chunk : K;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / WARPS_N) * 32;
  const int wn = (warp % WARPS_N) * 32;

  float sum[MI][NJ][4], acc[MI][NJ][4];   // acc: the negated compensation between strips
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = acc[i][j][e] = 0.f;

  bool has_diag = false;   // block-uniform: a Gram tile that holds diagonal entries
  if constexpr (LOWER) {
    int64_t lo, hi;
    diagonal_rows<T>(row0, col0, m, lo, hi);
    has_diag = lo < hi;
  }
  if constexpr (LOWER) {
    if (has_diag) {
      run_strips<T, B_KN, FOLD8, W, true>(sum, acc, smem, A, B, m, n, K, row0, col0, k_begin,
                                          k_end, wm, wn);
    }
  }
  if (!has_diag) {
    run_strips<T, B_KN, FOLD8, W, false>(sum, acc, smem, A, B, m, n, K, row0, col0, k_begin,
                                         k_end, wm, wn);
  }
  const float* diag = smem + STAGES * T::STAGE_FLOATS;

  // C fragment layout: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
  float* o = out + split * m * n;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = row0 + wm + 16 * i + g + 8 * (e / 2);
        const int64_t c = col0 + wn + 8 * j + 2 * t + (e % 2);
        float v = sum[i][j][e] + acc[i][j][e];
        if (has_diag && r == c && r < m) v = diag[2 * (r - row0)] - diag[2 * (r - row0) + 1];
        if (LOWER && mirror) {
          if (r < m && c <= r) {
            o[r * n + c] = v;
            o[c * n + r] = v;
          }
        } else if (r < m && c < n) {
          o[r * n + c] = v;
        }
      }
}

template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W, bool LOWER>
cudaError_t launch_instance(unsigned blocks, cudaStream_t s, const float* A, const float* B,
                            float* out, int64_t m, int64_t n, int64_t K, int64_t chunk,
                            int mirror) {
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  const auto kernel = tiled_kernel<WARPS_M, WARPS_N, B_KN, FOLD8, W, LOWER>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<T, LOWER>());
  if (err != cudaSuccess) return err;
  kernel<<<blocks, T::THREADS, smem_bytes<T, LOWER>(), s>>>(A, B, out, m, n, K, chunk, mirror);
  return cudaGetLastError();
}

// The instance for a tile height (tile_rows: 32 or 64), the vector width w and the
// fold (every 8-deep step when K < SHORT_K).
template <bool B_KN, bool LOWER>
cudaError_t launch_tiles(int64_t tile_rows, int w, unsigned blocks, cudaStream_t s,
                         const float* A, const float* B, float* out, int64_t m, int64_t n,
                         int64_t K, int64_t chunk, int mirror) {
#define LIP_TC_LAUNCH(WM, FOLD, WIDTH)                                               \
  return launch_instance<WM, 4, B_KN, FOLD, WIDTH, LOWER>(blocks, s, A, B, out, m, n, \
                                                          K, chunk, mirror)
#define LIP_TC_WIDTHS(WM, FOLD)      \
  if (w == 4) LIP_TC_LAUNCH(WM, FOLD, 4); \
  if (w == 2) LIP_TC_LAUNCH(WM, FOLD, 2); \
  LIP_TC_LAUNCH(WM, FOLD, 1)
  const bool fold8 = K < SHORT_K;
  if (tile_rows == LargeTile::BM) {
    if (fold8) { LIP_TC_WIDTHS(2, true); }
    LIP_TC_WIDTHS(2, false);
  }
  if (fold8) { LIP_TC_WIDTHS(1, true); }
  LIP_TC_WIDTHS(1, false);
#undef LIP_TC_WIDTHS
#undef LIP_TC_LAUNCH
}

// least = min(least, the blocks of this instance that one SM of the current
// device holds at once).
template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W, bool LOWER>
cudaError_t occupancy(int& least) {
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  const auto kernel = tiled_kernel<WARPS_M, WARPS_N, B_KN, FOLD8, W, LOWER>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<T, LOWER>());
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T::THREADS,
                                                        smem_bytes<T, LOWER>());
  }
  if (err == cudaSuccess && blocks < least) least = blocks;
  return err;
}

// The resident blocks per SM of a tile height and layout: the fewest over the
// instances a launch may pick (vector width, fold).
template <int WARPS_M, int WARPS_N, bool B_KN, bool LOWER>
cudaError_t resident_blocks(int64_t& out) {
  int least = 1 << 30;
  const cudaError_t errs[] = {occupancy<WARPS_M, WARPS_N, B_KN, false, 4, LOWER>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, false, 2, LOWER>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, false, 1, LOWER>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 4, LOWER>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 2, LOWER>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 1, LOWER>(least)};
  for (const cudaError_t err : errs) {
    if (err != cudaSuccess) return err;
  }
  out = least;
  return cudaSuccess;
}

// The Gram kernel's resident blocks per SM at the small and the large tile height
// (syrk.cu), for lip_matmul_geometry.
cudaError_t syrk_resident_blocks(int64_t& small, int64_t& large);

}  // namespace lip_tc
