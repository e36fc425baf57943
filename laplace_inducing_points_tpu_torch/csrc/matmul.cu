// Long-contraction FP32 matrix products of the port, for Hopper (sm_90a): the
// skinny paths (this file) and the tiled 3xTF32 tensor-core paths (matmul_tiled.cu).
// The wrapper (ops/cuda/matmul.py) picks a path from the shapes alone.
//
// B2, C (m, n) = A (m, K) B (n, K)^T, replaces _matmul_nt_pallas
// (laplace_inducing_points_tpu/ops/pallas/matmul.py:68):
//   row path, m <= 8 (lip_nt_rows_f32). The SLQ loop's Rz v, (1, 61706) x (1000,
//     61706)^T, and the dA = C^ B products of B3's backward at one row. Bound by
//     one read of B: 247 MB, 0.074 ms at 3.35 TB/s. Each block streams 4 rows of B
//     once, evict-first, and dots them with A's m rows, which every block reads
//     again from L2. D = 61,706 is 2 mod 4, so every other row starts 8 bytes off
//     a 16-byte boundary: a block takes rows 4 apart, which share one alignment,
//     peels a head of at most 3 elements and reads the rest in 16-byte vectors.
//     No tile padding: one FMA per product.
//   tiled path, m > 8 (matmul_tiled.cu). The Woodbury projection (16 | 240 rows),
//     serving's eps R^T (200) and the cross-Gram Gxz (1280): 2 m n K operations on
//     the tensor cores as three TF32 products, split-K over the long axis.
// B3, C (m, N) = A (m, z) B (z, N), A small and B long, replaces
// _matmul_nn_pallas (laplace_inducing_points_tpu/ops/pallas/matmul.py:153):
//   rank path, z <= 16 (lip_nn_rank_f32). The rank-one products of the backward
//     passes of the SLQ loop, (1000, 1) x (1, 61706). Bound by one write of C:
//     247 MB, 0.074 ms. Each thread keeps its columns of B's z rows in registers
//     and writes 8 rows of C with streaming stores.
//   row path, m <= 8 (lip_nn_rows_f32). The SLQ loop's Rz^T u, (1, 1000) x (1000,
//     61706). Bound by one read of B, 0.074 ms. Each thread owns 4 columns and
//     walks B's rows with coalesced vector loads while A's rows sit in shared
//     memory. 121 column blocks do not fill 132 SMs, so z is split across blocks
//     and a second pass sums the partials in split order (deterministic).
//   tiled path (matmul_tiled.cu): serving's (200, 1000) x (1000, 61706), the
//     Woodbury correction and the backward products (1000 rows).
//
// Precision (the contract keeps these products true FP32): every path sums fresh
// partial sums of a few terms and Kahan-adds them to a running total, and the
// reductions across lanes, warps and splits carry their rounding error (TwoSum,
// Kahan), so the error does not grow with D and no order depends on timing.
#include "matmul.cuh"

namespace lip_mm {

constexpr int ROW_B_ROWS = 4;      // NT row path: rows of B per block, j0 + 4 r
constexpr int ROW_GROUP = 4 * ROW_B_ROWS;
constexpr int ROW_UNROLL = 4;      // float4 vectors of each row per thread per strip

// Threads of an NT row block: 16 warps for one row of A (more loads in flight), 8
// for more rows (a 2-row product is slower with 16).
template <int MR>
__host__ __device__ constexpr int row_threads() {
  return MR == 1 ? 512 : 256;
}

// Element k of every row: sum[i][r] += A[i][k] B[j_r][k] (the peeled head and tail).
template <int MR>
__device__ __forceinline__ void nt_rows_element(const float* const (&a)[MR],
                                                const float* const (&b)[ROW_B_ROWS],
                                                int64_t k, float (&sum)[MR][ROW_B_ROWS],
                                                float (&comp)[MR][ROW_B_ROWS]) {
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const float x = __ldg(a[i] + k);
#pragma unroll
    for (int r = 0; r < ROW_B_ROWS; ++r) kahan_add(sum[i][r], comp[i][r], x * __ldcs(b[r] + k));
  }
}

// Vectors v .. v + (U - 1) THREADS of every row from element `head`: a strip
// summed fresh, then Kahan-added.
template <int MR, int AW, int U, int THREADS>
__device__ __forceinline__ void nt_rows_strip(const float* const (&a)[MR],
                                              const float* const (&b)[ROW_B_ROWS],
                                              int64_t head, int64_t v,
                                              float (&sum)[MR][ROW_B_ROWS],
                                              float (&comp)[MR][ROW_B_ROWS]) {
  constexpr int R = ROW_B_ROWS;
  float bv[U][R][4], av[U][MR][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r) load_stream<4>(bv[u][r], b[r] + head + (v + u * THREADS) * 4);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int q = 0; q < 4; q += AW) {
        load_cached<AW>(av[u][i] + q, a[i] + head + (v + u * THREADS) * 4 + q);
      }
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float strip = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) strip = fmaf(av[u][i][e], bv[u][r][e], strip);
      kahan_add(sum[i][r], comp[i][r], strip);
    }
}

// Block b takes rows j0 + 4 r of B, j0 = 16 (b / 4) + b % 4: rows 4 apart start at
// one alignment, so after a head of h < 4 elements every row of the block is read
// in 16-byte vectors. A's rows are read AW floats at a time (AW: what their
// alignment relative to B allows).
template <int MR, int AW>
__global__ void __launch_bounds__(row_threads<MR>())
nt_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int64_t m, int64_t n, int64_t K) {
  constexpr int R = ROW_B_ROWS;
  constexpr int THREADS = row_threads<MR>();
  constexpr int WARPS = THREADS / 32;
  __shared__ float red_hi[WARPS][MR * R];
  __shared__ float red_lo[WARPS][MR * R];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x / 4) * ROW_GROUP + blockIdx.x % 4;
  if (j0 >= n) return;
  const float* a[MR];
  const float* b[R];
#pragma unroll
  for (int i = 0; i < MR; ++i) a[i] = A + (i < m ? i : m - 1) * K;
#pragma unroll
  for (int r = 0; r < R; ++r) b[r] = B + (j0 + 4 * r < n ? j0 + 4 * r : j0) * K;
  const int64_t h = (4 - (reinterpret_cast<uintptr_t>(b[0]) / 4) % 4) % 4;
  const int64_t head = h < K ? h : K;
  const int64_t nv = (K - head) / 4;   // 16-byte vectors per row after the head
  float sum[MR][R], comp[MR][R];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) sum[i][r] = comp[i][r] = 0.f;

  for (int64_t k = threadIdx.x; k < head; k += THREADS) nt_rows_element<MR>(a, b, k, sum, comp);
  for (int64_t k = head + 4 * nv + threadIdx.x; k < K; k += THREADS) {
    nt_rows_element<MR>(a, b, k, sum, comp);
  }
  int64_t v = threadIdx.x;
  for (; v + (ROW_UNROLL - 1) * THREADS < nv; v += ROW_UNROLL * THREADS) {
    nt_rows_strip<MR, AW, ROW_UNROLL, THREADS>(a, b, head, v, sum, comp);
  }
  for (; v < nv; v += THREADS) nt_rows_strip<MR, AW, 1, THREADS>(a, b, head, v, sum, comp);

  // Compensated tree sum: lanes (shuffles), then the warps in order.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float hi = sum[i][r], lo = -comp[i][r];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        const float ohi = __shfl_down_sync(0xffffffffu, hi, off);
        const float olo = __shfl_down_sync(0xffffffffu, lo, off);
        two_sum_add(hi, lo, ohi, olo);
      }
      if (lane == 0) {
        red_hi[warp][i * R + r] = hi;
        red_lo[warp][i * R + r] = lo;
      }
    }
  __syncthreads();
  if (threadIdx.x < MR * R) {
    const int i = threadIdx.x / R;
    const int r = threadIdx.x % R;
    float hi = red_hi[0][threadIdx.x], lo = red_lo[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) two_sum_add(hi, lo, red_hi[w][threadIdx.x],
                                                    red_lo[w][threadIdx.x]);
    if (i < m && j0 + 4 * r < n) C[i * n + j0 + 4 * r] = hi + lo;
  }
}

// The width of A's loads in the NT row path: element k of A's row i and of B's row
// j differ in alignment by (A - B) + 4 (i - j) K bytes, for every i and j.
inline int nt_rows_a_width(const float* A, const float* B, int64_t K) {
  const intptr_t d = reinterpret_cast<intptr_t>(A) - reinterpret_cast<intptr_t>(B);
  if (K % 4 == 0 && d % 16 == 0) return 4;
  if (K % 2 == 0 && d % 8 == 0) return 2;
  return 1;
}

constexpr int NNR_STAGE = 256;     // rows of A's chunk staged in shared memory per pass
constexpr int NNR_STRIP = 8;       // rows of B per Kahan strip

// Column of vector g of this thread: vectors of a warp are adjacent (coalesced).
template <int W>
__device__ __forceinline__ int64_t col_of(int g) {
  return static_cast<int64_t>(blockIdx.x) * COL_BLOCK + (g * COL_THREADS + threadIdx.x) * W;
}

// One row k of B: strip[i][q] += A[i][k] B[k][col_q] for the thread's columns.
template <int MR, int W>
__device__ __forceinline__ void nn_row_fma(const float* __restrict__ row, const bool* live,
                                           const float (&As)[MR][NNR_STAGE], int k,
                                           float (&strip)[MR][COL_PER_THREAD]) {
  constexpr int G = COL_PER_THREAD / W;
  float bv[COL_PER_THREAD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (live[g]) {
      load_stream<W>(bv + g * W, row + col_of<W>(g));
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) bv[g * W + e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const float a = As[i][k];
#pragma unroll
    for (int q = 0; q < COL_PER_THREAD; ++q) strip[i][q] = fmaf(a, bv[q], strip[i][q]);
  }
}

template <int MR>
__device__ __forceinline__ void fold_strip(float (&sum)[MR][COL_PER_THREAD],
                                           float (&comp)[MR][COL_PER_THREAD],
                                           float (&strip)[MR][COL_PER_THREAD]) {
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int q = 0; q < COL_PER_THREAD; ++q) {
      kahan_add(sum[i][q], comp[i][q], strip[i][q]);
      strip[i][q] = 0.f;
    }
}

template <int MR, int W>
__global__ void __launch_bounds__(COL_THREADS)
nn_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ out, int64_t m, int64_t z, int64_t N, int64_t chunk) {
  constexpr int G = COL_PER_THREAD / W;   // vectors per thread
  __shared__ float As[MR][NNR_STAGE];
  bool live[G];
#pragma unroll
  for (int g = 0; g < G; ++g) live[g] = col_of<W>(g) < N;
  const int64_t z_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t z_end = z_begin + chunk < z ? z_begin + chunk : z;
  float sum[MR][COL_PER_THREAD], comp[MR][COL_PER_THREAD], strip[MR][COL_PER_THREAD];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int q = 0; q < COL_PER_THREAD; ++q) sum[i][q] = comp[i][q] = strip[i][q] = 0.f;

  for (int64_t zz = z_begin; zz < z_end; zz += NNR_STAGE) {
    const int zn = static_cast<int>(z_end - zz < NNR_STAGE ? z_end - zz : NNR_STAGE);
    __syncthreads();
    for (int idx = threadIdx.x; idx < MR * NNR_STAGE; idx += COL_THREADS) {
      const int i = idx / NNR_STAGE;
      const int k = idx % NNR_STAGE;
      As[i][k] = (i < m && k < zn) ? A[i * z + zz + k] : 0.f;
    }
    __syncthreads();
    int k0 = 0;
    for (; k0 + NNR_STRIP <= zn; k0 += NNR_STRIP) {
#pragma unroll
      for (int kk = 0; kk < NNR_STRIP; ++kk) {
        nn_row_fma<MR, W>(B + (zz + k0 + kk) * N, live, As, k0 + kk, strip);
      }
      fold_strip<MR>(sum, comp, strip);
    }
    for (int k = k0; k < zn; ++k) nn_row_fma<MR, W>(B + (zz + k) * N, live, As, k, strip);
    fold_strip<MR>(sum, comp, strip);
  }

  float* o = out + static_cast<int64_t>(blockIdx.y) * m * N;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i >= m) break;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!live[g]) continue;
      float v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = sum[i][g * W + e] - comp[i][g * W + e];
      store_stream<W>(o + i * N + col_of<W>(g), v);
    }
  }
}

constexpr int RANK_ROWS = 8;   // output rows per thread of the rank path

template <int ZR, int W>
__global__ void __launch_bounds__(COL_THREADS)
nn_rank_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int64_t m, int64_t z, int64_t N) {
  constexpr int G = COL_PER_THREAD / W;
  bool live[G];
  float b[ZR][COL_PER_THREAD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    live[g] = col_of<W>(g) < N;
#pragma unroll
    for (int k = 0; k < ZR; ++k) {
      if (live[g] && k < z) {
        load_cached<W>(&b[k][g * W], B + k * N + col_of<W>(g));
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) b[k][g * W + e] = 0.f;
      }
    }
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * RANK_ROWS;
  for (int r = 0; r < RANK_ROWS; ++r) {
    const int64_t i = row0 + r;
    if (i >= m) break;
    float a[ZR];
#pragma unroll
    for (int k = 0; k < ZR; ++k) a[k] = k < z ? __ldg(A + i * z + k) : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!live[g]) continue;
      float v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float acc = a[0] * b[0][g * W + e];
#pragma unroll
        for (int k = 1; k < ZR; ++k) acc = fmaf(a[k], b[k][g * W + e], acc);
        v[e] = acc;
      }
      store_stream<W>(C + i * N + col_of<W>(g), v);
    }
  }
}

// Launchers of one instance each: K<MR, W>::launch(grid, stream, arguments...).
template <int MR, int W>
struct NtRows {
  static void launch(dim3 grid, cudaStream_t s, const float* A, const float* B, float* C,
                     int64_t m, int64_t n, int64_t K) {
    nt_rows_kernel<MR, W><<<grid, row_threads<MR>(), 0, s>>>(A, B, C, m, n, K);
  }
};

template <int MR, int W>
struct NnRows {
  static void launch(dim3 grid, cudaStream_t s, const float* A, const float* B, float* out,
                     int64_t m, int64_t z, int64_t N, int64_t chunk) {
    nn_rows_kernel<MR, W><<<grid, COL_THREADS, 0, s>>>(A, B, out, m, z, N, chunk);
  }
};

template <int ZR, int W>
struct NnRank {
  static void launch(dim3 grid, cudaStream_t s, const float* A, const float* B, float* C,
                     int64_t m, int64_t z, int64_t N) {
    nn_rank_kernel<ZR, W><<<grid, COL_THREADS, 0, s>>>(A, B, C, m, z, N);
  }
};

template <template <int, int> class K, int MR, typename... Args>
void launch_width(int w, Args... args) {
  if (w == 4) {
    K<MR, 4>::launch(args...);
  } else if (w == 2) {
    K<MR, 2>::launch(args...);
  } else {
    K<MR, 1>::launch(args...);
  }
}

// The instance for `rows` rows (or depth): MR in {1, 2, 4, 8} or, with MAX = 16,
// {1, 2, 4, 8, 16}, the least that covers it; rows past `rows` are masked.
template <template <int, int> class K, int MAX, typename... Args>
void launch_skinny(int64_t rows, int w, Args... args) {
  if (rows <= 1) {
    launch_width<K, 1>(w, args...);
  } else if (rows <= 2) {
    launch_width<K, 2>(w, args...);
  } else if (rows <= 4) {
    launch_width<K, 4>(w, args...);
  } else if (MAX <= 8 || rows <= 8) {
    launch_width<K, 8>(w, args...);
  } else if constexpr (MAX >= 16) {
    launch_width<K, 16>(w, args...);
  }
}

}  // namespace lip_mm

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is seen.

// C (m, n) = A (m, K) B (n, K)^T for m <= 8.
extern "C" int lip_nt_rows_f32(const float* A, const float* B, float* C, int64_t m,
                               int64_t n, int64_t K, void* stream) {
  using namespace lip_mm;
  const int64_t blocks = 4 * ((n + ROW_GROUP - 1) / ROW_GROUP);
  if (m <= 0 || m > ROW_MAX || n <= 0 || K <= 0 || blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_skinny<NtRows, ROW_MAX>(m, nt_rows_a_width(A, B, K),
                                 dim3(static_cast<unsigned>(blocks)),
                                 static_cast<cudaStream_t>(stream), A, B, C, m, n, K);
  return static_cast<int>(cudaGetLastError());
}

// C (m, N) = A (m, z) B (z, N) for m <= 8, z split over `splits` blocks; `part`
// holds the (splits, m, N) partials and is C itself when splits == 1.
extern "C" int lip_nn_rows_f32(const float* A, const float* B, float* part, float* C,
                               int64_t m, int64_t z, int64_t N, int64_t splits,
                               void* stream) {
  using namespace lip_mm;
  const int64_t col_blocks = (N + COL_BLOCK - 1) / COL_BLOCK;
  if (m <= 0 || m > ROW_MAX || z <= 0 || N <= 0 || splits <= 0 || splits > z ||
      splits > 65535 || col_blocks > 2147483647LL || (splits == 1) != (part == C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = (z + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_skinny<NnRows, ROW_MAX>(m, vec_width(B, part, N, N),
                        dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(splits)),
                        s, A, B, part, m, z, N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(split_reduce(part, C, m * N, splits, s));
}

// C (m, N) = A (m, z) B (z, N) for z <= 16.
extern "C" int lip_nn_rank_f32(const float* A, const float* B, float* C, int64_t m,
                               int64_t z, int64_t N, void* stream) {
  using namespace lip_mm;
  const int64_t col_blocks = (N + COL_BLOCK - 1) / COL_BLOCK;
  const int64_t row_blocks = (m + RANK_ROWS - 1) / RANK_ROWS;
  if (m <= 0 || z <= 0 || z > RANK_MAX || N <= 0 || row_blocks > 65535 ||
      col_blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_skinny<NnRank, RANK_MAX>(z, vec_width(B, C, N, N),
                        dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks)),
                        static_cast<cudaStream_t>(stream), A, B, C, m, z, N);
  return static_cast<int>(cudaGetLastError());
}
