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
// twice it, fails.
//
// Movement: operands go into shared memory as raw FP32 through a cp.async ring of
// STAGES strips (the copy of strip s + STAGES - 1 overlaps the products of strip s),
// in vectors of W floats (16-byte cp.async.cg, or 8- and 4-byte cp.async.ca where
// the rows are only 8- or 4-byte aligned, matmul.cuh), zero-filled past the edges.
// A is staged [row][k] and B [n][k] (NT) or [k][col] (NN), with pads that keep the
// fragment reads of a warp on 32 distinct banks.
//
// Tiles: 4 or 8 warps, each 32 x 32 outputs as 2 x 4 mma tiles; blocks of 64 x 128
// outputs, or 32 x 128 when m <= 32 (16 rows would waste 4x of a 64-row tile). The
// NT products have few output tiles (serving: 4 x 8 for 132 SMs), so the long axis
// is split across blocks (splits from the wrapper's planner); each writes its
// partial tile to a workspace and a second pass sums them in split order
// (deterministic, no atomics). Consecutive blocks differ in the row tile, so the
// blocks that read the same strip of B run together and share it in L2.
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
};

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

// One block: output tile (row tile, column tile) of split `split`, contracting
// [split * chunk, min((split + 1) * chunk, K)). Block b takes row tile b % m_tiles,
// column tile (b / m_tiles) % n_tiles and split b / (m_tiles n_tiles). NT: A (m, K),
// B (n, K); NN (B_KN): A (m, K), B (K, n). Writes out + split * m * n.
template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
tiled_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ out, int64_t m, int64_t n, int64_t K, int64_t chunk) {
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  extern __shared__ __align__(16) float smem[];
  const int64_t m_tiles = (m + T::BM - 1) / T::BM;
  const int64_t n_tiles = (n + T::BN - 1) / T::BN;
  const int64_t b = blockIdx.x;
  const int64_t row0 = (b % m_tiles) * T::BM;
  const int64_t col0 = ((b / m_tiles) % n_tiles) * T::BN;
  const int64_t split = b / (m_tiles * n_tiles);
  const int64_t k_begin = split * chunk;
  const int64_t k_end = k_begin + chunk < K ? k_begin + chunk : K;
  const int64_t strips = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
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
  }
  cp_async_wait<0>();

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
        if (r < m && c < n) o[r * n + c] = sum[i][j][e] + acc[i][j][e];
      }
}

template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W>
cudaError_t launch_instance(unsigned blocks, cudaStream_t s, const float* A, const float* B,
                            float* out, int64_t m, int64_t n, int64_t K, int64_t chunk) {
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  cudaError_t err = cudaFuncSetAttribute(tiled_kernel<WARPS_M, WARPS_N, B_KN, FOLD8, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  tiled_kernel<WARPS_M, WARPS_N, B_KN, FOLD8, W><<<blocks, T::THREADS, T::SMEM_BYTES, s>>>(
      A, B, out, m, n, K, chunk);
  return cudaGetLastError();
}

template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8>
cudaError_t launch_width(int w, unsigned blocks, cudaStream_t s, const float* A,
                         const float* B, float* out, int64_t m, int64_t n, int64_t K,
                         int64_t chunk) {
  if (w == 4) {
    return launch_instance<WARPS_M, WARPS_N, B_KN, FOLD8, 4>(blocks, s, A, B, out, m, n, K,
                                                            chunk);
  }
  if (w == 2) {
    return launch_instance<WARPS_M, WARPS_N, B_KN, FOLD8, 2>(blocks, s, A, B, out, m, n, K,
                                                            chunk);
  }
  return launch_instance<WARPS_M, WARPS_N, B_KN, FOLD8, 1>(blocks, s, A, B, out, m, n, K,
                                                          chunk);
}

template <int WARPS_M, int WARPS_N, bool B_KN>
cudaError_t launch_tile(int w, unsigned blocks, cudaStream_t s, const float* A,
                        const float* B, float* out, int64_t m, int64_t n, int64_t K,
                        int64_t chunk) {
  if (K < SHORT_K) {
    return launch_width<WARPS_M, WARPS_N, B_KN, true>(w, blocks, s, A, B, out, m, n, K,
                                                      chunk);
  }
  return launch_width<WARPS_M, WARPS_N, B_KN, false>(w, blocks, s, A, B, out, m, n, K, chunk);
}

// C = the product over `splits` blocks per output tile, through `part` (the
// (splits, m, n) partials; C itself when splits == 1). ld_a and ld_b are the
// leading dimensions of A and B.
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
      tile_rows == LargeTile::BM
          ? launch_tile<2, 4, B_KN>(w, blocks, s, A, B, part, m, n, K, chunk)
          : launch_tile<1, 4, B_KN>(w, blocks, s, A, B, part, m, n, K, chunk);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(split_reduce(part, C, m * n, splits, s));
}

// least = min(least, the blocks of this instance that one SM of the current
// device holds at once).
template <int WARPS_M, int WARPS_N, bool B_KN, bool FOLD8, int W>
cudaError_t occupancy(int& least) {
  using T = Tile<WARPS_M, WARPS_N, B_KN>;
  const auto kernel = tiled_kernel<WARPS_M, WARPS_N, B_KN, FOLD8, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T::THREADS,
                                                        T::SMEM_BYTES);
  }
  if (err == cudaSuccess && blocks < least) least = blocks;
  return err;
}

// The resident blocks per SM of a tile height and layout: the fewest over the
// instances a launch may pick (vector width, fold).
template <int WARPS_M, int WARPS_N, bool B_KN>
cudaError_t resident_blocks(int64_t& out) {
  int least = 1 << 30;
  const cudaError_t errs[] = {occupancy<WARPS_M, WARPS_N, B_KN, false, 4>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, false, 2>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, false, 1>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 4>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 2>(least),
                              occupancy<WARPS_M, WARPS_N, B_KN, true, 1>(least)};
  for (const cudaError_t err : errs) {
    if (err != cudaSuccess) return err;
  }
  out = least;
  return cudaSuccess;
}

}  // namespace lip_tc

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is seen.
// tile_rows is 32 or 64 (the block's output rows); the block's columns are 128.

// What the wrapper's path planner needs of the NT and NN kernels on the current
// device, into out[0..11): its SMs; the most output rows of the row paths; the
// deepest contraction of the rank path; the output columns of an NN row block; the
// output columns of a tiled block; the small and the large tiled block heights; the
// resident tiled blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// NT at the small and the large height, then of NN.
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
  const cudaError_t errs[] = {resident_blocks<1, 4, false>(out[7]),
                              resident_blocks<2, 4, false>(out[8]),
                              resident_blocks<1, 4, true>(out[9]),
                              resident_blocks<2, 4, true>(out[10])};
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
