// GGN probe sweep Y (P, D) = scale * (V R^T) R at estimator precision (TF32 tensor
// cores, FP32 accumulation), for Hopper (sm_90a).
//
// Replaces ggn_sweep (laplace_inducing_points_tpu/ops/pallas/matmul.py:213), which
// runs _matmul_nt_pallas (:68) and then _matmul_nn_pallas (:153) at the estimator
// precision DEFAULT: one reduced-precision pass with f32 accumulation. On Hopper that
// pass is TF32: every operand is rounded to TF32, to nearest, and multiplied by
// wgmma.mma_async m64nNk8 into FP32 accumulators.
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
// 3.35 TB/s. R (316 MB) cannot be read once for both products: T = V R^T needs all
// of D before the first element of Y = T R, and R is six times the L2 (50 MB) and
// ten times all shared memory. So two stages, each reading R from memory once and
// bound by its bytes (R plus V, or R plus Y: 375 MB, 0.112 ms, against 0.077 ms of
// TF32 work): the floor of the design is 0.224 ms.
//
// Both stages run wgmma with both operands in shared memory as K-major core-matrix
// tiles (8 rows x 16 bytes, 128 bytes apart along K, 1,024 bytes apart along the
// rows; no swizzle), on blocks of four warpgroups: two halves of 128 rows of R (or
// columns of D) by two halves of a group of 64 or 256 probes (wgmma N = 32 or 128:
// 16 or 64 accumulators a thread). A strip of 32 is staged while the products of
// the previous one run (the wait for them is deferred by one strip).
//
// The probes' operand comes from a tiled copy: a pass (tile_kernel) lays V out as the
// operand tiles of its groups, rounded, so that a block fetches a strip's tile in one
// bulk copy by the tensor memory accelerator (cp.async.bulk, completing on an
// mbarrier); stage 1's second pass writes T's tiles the same way. R is staged by
// cp.async (16-, 8- or 4-byte copies by row alignment; D = 61,706 takes 8-byte ones)
// and rounded in shared memory. Staging every operand by cp.async left the sweep
// slower than cuBLAS TF32 on an H100, its threads stalled issuing the copies; with the
// probes' tiles by bulk copy it runs in less than cuBLAS's time (PERF.md).
//
// Stage 1, T (P, d) = V R^T, contracts D. The 10 row tiles of R at d = 1280 are too
// few for 132 SMs, so D is split across blocks by wave fill (the wrapper's planner);
// each block writes its partial tile, and a second pass sums the partials in split
// order, rounds T and writes its tiles. The blocks of one chunk run side by side and
// share V's tiles in L2; each strip of R is read by one block.
//
// Stage 2, Y (P, D) = scale * T R, contracts d. R lies N-major here and wgmma takes
// no transposed TF32 operand, so a block computes a tile of Y^T = R^T T^T: a strip of
// 128 columns of R, staged as it lies, is transposed (and rounded) into a K-major
// tile. Each block owns its columns for all P <= 256 probes, so R is read from memory
// once; P > 256 takes more groups, side by side over the same columns, which share
// R's strip in L2.
//
// Rounding: the tensor cores read the top 19 bits of an FP32 word in shared memory,
// which truncates toward zero: every product would shrink by about 2^-11 in the same
// direction, a coherent bias that gamma = 468.75 passes into the S_X trace. So every
// operand is rounded to nearest first (lip_tc::to_tf32, on the bit pattern): V and T
// as their tiles are written, R in shared memory before a proxy fence and a barrier.
// chip_smoke.py phase 9 gates the bias against cuBLAS TF32's; a truncating copy
// fails it.
#include "tiled.cuh"

namespace lip_sweep {

using lip_tc::BK;

constexpr int THREADS = 512;               // four warpgroups: 2 halves of TILE x 2 of the group
constexpr int TILE = 128;                  // R rows (stage 1) or D columns (stage 2) per block
constexpr int ANPAD = TILE + 8;            // stage 2's raw [k][col] strip of R: row stride
constexpr int SMALL_GROUP = 64;            // probes per block: twice the wgmma N
constexpr int LARGE_GROUP = 256;

// The operand rounded to TF32, to nearest (the tensor cores would truncate it).
__device__ __forceinline__ uint32_t round_operand(float x) { return lip_tc::to_tf32(x); }

constexpr int STAGES = 4;                  // slots of each ring (measured against 8 for
                                           // the small group on an H100: slower)
constexpr int AHEAD = STAGES - 2;          // strips in flight: a ring also holds the strip
                                           // being staged and the one whose products run
constexpr int RAW_STAGES = AHEAD + 1;      // stage 2's raw strips: in flight, being transposed

// Shared-memory plan of a block, in floats: rings of K-major core-matrix tiles and
// stage 2's raw strips of R, then one mbarrier per slot of the probes' tiles.
template <int N>
struct Smem {
  static constexpr int PROBES = N * BK;           // the group's tile of V (stage 1) or T
  static constexpr int ROWS = TILE * BK;          // R's tile: rows (stage 1) or columns^T
  static constexpr int RAW = BK * ANPAD;          // stage 2: R's strip as it lies
  static constexpr int FLOATS1 = STAGES * (PROBES + ROWS);
  static constexpr int FLOATS2 = STAGES * PROBES + 2 * ROWS + RAW_STAGES * RAW;
  static constexpr int BYTES1 = FLOATS1 * 4 + STAGES * 8;
  static constexpr int BYTES2 = FLOATS2 * 4 + STAGES * 8;
};

// Offset of element (r, k) of a K-major tile in core matrices of 8 rows x 4 floats.
__device__ __forceinline__ int core_offset(int r, int k) {
  return (r / 8) * (8 * BK) + (k / 4) * 32 + (r % 8) * 4 + (k % 4);
}

// The probe p and column k of element i of a matrix's operand tiles for groups of N
// probes (the tiles of group g and strip s of `strips` at (g strips + s) N BK, each
// as core_offset lays it out): the inverse of core_offset, tile by tile.
template <int N>
__device__ __forceinline__ void tile_position(int64_t i, int64_t strips, int64_t& p,
                                              int64_t& k) {
  const int64_t tile = i / (N * BK);
  const int within = static_cast<int>(i % (N * BK));
  p = (tile / strips) * N + (within / (8 * BK)) * 8 + (within % 32) / 4;
  k = (tile % strips) * BK + ((within % (8 * BK)) / 32) * 4 + within % 4;
}

// Rows [row0, row0 + ROWS) x columns [k0, k0 + BK) (row < rows, k < k_end) of a
// row-major (rows, ld) matrix into a K-major core-matrix tile; ROUND: instead round
// the copies this thread made (after they landed) in place. A warp's copies walk the
// 8 rows of a core matrix first, so they hit distinct banks.
template <int ROWS, int W, bool ROUND>
__device__ __forceinline__ void core_copies(float* s, const float* __restrict__ X,
                                            int64_t rows, int64_t ld, int64_t row0,
                                            int64_t k0, int64_t k_end) {
  constexpr int PER_ROW = BK / W;
  constexpr int COPIES = ROWS * PER_ROW;
  static_assert(COPIES % THREADS == 0, "copies divide among the threads");
#pragma unroll
  for (int it = 0; it < COPIES / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int rest = c / 8;
    const int r = (rest / PER_ROW) * 8 + c % 8;
    const int kv = (rest % PER_ROW) * W;
    float* dst = s + core_offset(r, kv);
    if constexpr (ROUND) {
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = __uint_as_float(round_operand(dst[w]));
    } else {
      const int64_t row = row0 + r;
      const int64_t k = k0 + kv;
      const bool ok = row < rows && k < k_end;
      lip_tc::cp_async<W>(dst, ok ? X + row * ld + k : X, ok);
    }
  }
}

// Stage 2: R's raw strip [k][col] (stride ANPAD), rounded, into the K-major
// core-matrix tile of R^T (row = column of R). A warp reads 8 columns x 4 k and writes
// one 8 x 4 core matrix: both on 32 distinct banks.
__device__ __forceinline__ void transpose_strip(float* core, const float* raw) {
  constexpr int ELEMENTS = TILE * BK;
  static_assert(ELEMENTS % THREADS == 0, "elements divide among the threads");
#pragma unroll
  for (int it = 0; it < ELEMENTS / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int rest = e / 32;
    const int m = (rest % (TILE / 8)) * 8 + e % 8;
    const int k = (rest / (TILE / 8)) * 4 + (e / 8) % 4;
    core[core_offset(m, k)] = __uint_as_float(round_operand(raw[k * ANPAD + m]));
  }
}

// wgmma's descriptor of a K-major core-matrix tile in shared memory, no swizzle:
// start address, LBO (the next 16 bytes along K) 128 bytes, SBO (the next 8 rows)
// 1,024 bytes, each in units of 16 bytes.
__device__ __forceinline__ uint64_t core_desc(const float* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((8 * BK * 4) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup's products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by this thread's generic stores becomes visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads of the accumulators, which an asynchronous
// wgmma still writes, across the wait.
template <int K>
__device__ __forceinline__ void hold(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes from src to shared dst by the tensor memory accelerator (16-byte aligned, a
// multiple of 16), counted against bar, whose phase completes when they have landed.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until bar's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// D (64 x N, FP32) += A (64 x 8) B (N x 8), both K-major TF32 tiles in shared memory
// at desc_a and desc_b. N is half a probe group. Accumulator fragment, g = lane / 4,
// t = lane % 4, rows counted from the warp's 16 * (warp % 4): d[4j + e] at
// (g + 8 (e / 2), 8j + 2t + e % 2).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

// This warpgroup's products over one staged strip: its 64 rows (wm) of the R tile at
// a_tile by its half (wn) of the group's tile at b_tile, four 8-deep steps; then waits
// for the previous strip's products, so that these run on while the next strip is
// staged.
template <int N>
__device__ __forceinline__ void mma_strip(float (&acc)[N / 4], const float* a_tile,
                                          const float* b_tile, int wm, int wn) {
  const float* a = a_tile + wm * 64 * BK;
  const float* b = b_tile + wn * (N / 2) * BK;
  hold(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) {
    Wgmma<N / 2>::mma(acc, core_desc(a + s * 64), core_desc(b + s * 64));
  }
  wgmma_commit();
  wgmma_wait<1>();
  hold(acc);
}

// The probes X (P, K) as their operand tiles (tile_position), rounded to TF32 and
// zero past P and K. A warp writes 512 contiguous bytes and reads 8 rows x 64 bytes.
template <int N>
__global__ void tile_kernel(const float* __restrict__ X, float* __restrict__ out, int64_t P,
                            int64_t K) {
  const int64_t strips = (K + BK - 1) / BK;
  const int64_t quads = (P + N - 1) / N * N * strips * BK / 4;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t p, k;
    tile_position<N>(4 * q, strips, p, k);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = p < P && k + j < K ? __uint_as_float(round_operand(__ldg(X + p * K + k + j))) : 0.f;
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Stage 1: part[split] (P, d) = V[:, chunk] R[:, chunk]^T, as tiles of T^T, from V's
// operand tiles Vt (tile_kernel). Block b takes probe group b % groups, R's row tile
// (b / groups) % row_tiles and split b / (groups row_tiles). The chunk is a multiple
// of BK, so its strips are whole tiles of Vt.
template <int N, int W>
__global__ void __launch_bounds__(THREADS, 1)
project_kernel(const float* __restrict__ Vt, const float* __restrict__ R,
               float* __restrict__ part, int64_t P, int64_t d, int64_t D, int64_t chunk) {
  using S = Smem<N>;
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::FLOATS1);   // Vt's tile landed
  const int64_t groups = (P + N - 1) / N;
  const int64_t row_tiles = (d + TILE - 1) / TILE;
  const int64_t b = blockIdx.x;
  const int64_t p0 = (b % groups) * N;
  const int64_t row0 = ((b / groups) % row_tiles) * TILE;
  const int64_t split = b / (groups * row_tiles);
  const int64_t k_begin = split * chunk;
  const int64_t k_end = k_begin + chunk < D ? k_begin + chunk : D;
  const int64_t strips = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const float* vt = Vt + ((b % groups) * ((D + BK - 1) / BK) + k_begin / BK) * S::PROBES;
  const int wm = (threadIdx.x / 128) % 2;   // the warpgroup's half of the R rows
  const int wn = threadIdx.x / 256;         // ... and of the probe group

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  __syncthreads();
  float acc[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) acc[i] = 0.f;
  auto stage = [&](int64_t strip) {
    float* s = smem + (strip % STAGES) * (S::PROBES + S::ROWS);
    if (threadIdx.x == 0) bulk_copy(s, vt + strip * S::PROBES, S::PROBES * 4, &full[strip % STAGES]);
    core_copies<TILE, W, false>(s + S::PROBES, R, d, D, row0,
                                k_begin + strip * BK, k_end);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < strips) stage(s);
    lip_tc::cp_async_commit();
  }
  for (int64_t kt = 0; kt < strips; ++kt) {
    lip_tc::cp_async_wait<AHEAD - 1>();   // R's strip kt has landed (this thread's copies)
    float* slot = smem + (kt % STAGES) * (S::PROBES + S::ROWS);
    core_copies<TILE, W, true>(slot + S::PROBES, R, 0, 0, 0, 0, 0);
    fence_async_shared();
    mbar_wait(&full[kt % STAGES], static_cast<uint32_t>(kt / STAGES) & 1);
    __syncthreads();                      // everyone's, rounded; strip kt - 2's products done
    if (kt + AHEAD < strips) stage(kt + AHEAD);
    lip_tc::cp_async_commit();
    mma_strip<N>(acc, slot + S::PROBES, slot, wm, wn);
  }
  wgmma_wait<0>();
  hold(acc);
  lip_tc::cp_async_wait<0>();

  const int lane = threadIdx.x % 32;
  const int m = 64 * wm + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  float* o = part + split * P * d;
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t r = row0 + m + 8 * (e / 2);
      const int64_t p = p0 + wn * (N / 2) + 8 * j + 2 * (lane % 4) + (e % 2);
      if (r < d && p < P) o[p * d + r] = acc[4 * j + e];
    }
}

// T = the sum over splits of the partials, in split order, rounded to TF32, into T
// (P, d) and into its operand tiles Tt for stage 2 (tile_position, zero past P and d).
template <int N>
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ T,
                              float* __restrict__ Tt, int64_t P, int64_t d, int64_t splits) {
  const int64_t strips = (d + BK - 1) / BK;
  const int64_t count = (P + N - 1) / N * N * strips * BK;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t p, k;
    tile_position<N>(i, strips, p, k);
    float v = 0.f;
    if (p < P && k < d) {
      for (int64_t s = 0; s < splits; ++s) v += part[(s * P + p) * d + k];
      v = __uint_as_float(round_operand(v));
      T[p * d + k] = v;
    }
    Tt[i] = v;
  }
}

// Stage 2: Y (P, D) = scale * T (P, d) R (d, D), as tiles of Y^T, from T's operand
// tiles Tt. Block b takes probe group b % groups and R's column tile b / groups.
template <int N, int W>
__global__ void __launch_bounds__(THREADS, 1)
push_kernel(const float* __restrict__ Tt, const float* __restrict__ R, float* __restrict__ Y,
            int64_t P, int64_t d, int64_t D, float scale) {
  using S = Smem<N>;
  extern __shared__ __align__(128) float smem[];
  float* probes = smem;                           // STAGES tiles of T's group
  float* cols = probes + STAGES * S::PROBES;      // 2 tiles of R^T, rounded
  float* raw = cols + 2 * S::ROWS;                // RAW_STAGES strips of R as it lies
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::FLOATS2);   // Tt's tile landed
  const int64_t groups = (P + N - 1) / N;
  const int64_t b = blockIdx.x;
  const int64_t p0 = (b % groups) * N;
  const int64_t col0 = (b / groups) * TILE;
  const int64_t strips = (d + BK - 1) / BK;
  const float* tt = Tt + (b % groups) * strips * S::PROBES;
  const int wm = (threadIdx.x / 128) % 2;   // the warpgroup's half of the columns
  const int wn = threadIdx.x / 256;         // ... and of the probe group

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  __syncthreads();
  float acc[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) acc[i] = 0.f;
  auto stage = [&](int64_t strip) {
    if (threadIdx.x == 0) {
      bulk_copy(probes + (strip % STAGES) * S::PROBES, tt + strip * S::PROBES, S::PROBES * 4,
                &full[strip % STAGES]);
    }
    lip_tc::stage_cols<TILE, THREADS, W>(raw + (strip % RAW_STAGES) * S::RAW, R,
                                         D, strip * BK, d, col0);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < strips) stage(s);
    lip_tc::cp_async_commit();
  }
  for (int64_t kt = 0; kt < strips; ++kt) {
    lip_tc::cp_async_wait<AHEAD - 1>();   // R's strip kt has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; strip kt - 2's products done
    if (kt + AHEAD < strips) stage(kt + AHEAD);
    lip_tc::cp_async_commit();
    float* a_tile = cols + (kt % 2) * S::ROWS;
    transpose_strip(a_tile, raw + (kt % RAW_STAGES) * S::RAW);
    fence_async_shared();
    mbar_wait(&full[kt % STAGES], static_cast<uint32_t>(kt / STAGES) & 1);
    __syncthreads();
    mma_strip<N>(acc, a_tile, probes + (kt % STAGES) * S::PROBES, wm, wn);
  }
  wgmma_wait<0>();
  hold(acc);
  lip_tc::cp_async_wait<0>();

  // a warp's store covers 8 consecutive columns of 4 probe rows: whole 32-byte sectors
  const int lane = threadIdx.x % 32;
  const int m = 64 * wm + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t col = col0 + m + 8 * (e / 2);
      const int64_t p = p0 + wn * (N / 2) + 8 * j + 2 * (lane % 4) + (e % 2);
      if (col < D && p < P) __stcs(Y + p * D + col, scale * acc[4 * j + e]);
    }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device, once per
// device (`ready` holds a bit per device, 32 of them): the call costs host time.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, uint32_t& ready) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint32_t bit = device < 32 ? 1u << device : 0u;
  if (ready & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready |= bit;
  return err;
}

template <int N, int W>
cudaError_t launch_project(unsigned blocks, cudaStream_t s, const float* Vt, const float* R,
                           float* part, int64_t P, int64_t d, int64_t D, int64_t chunk) {
  const auto kernel = project_kernel<N, W>;
  static uint32_t ready = 0;
  const cudaError_t err = allow_smem(kernel, Smem<N>::BYTES1, ready);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, Smem<N>::BYTES1, s>>>(Vt, R, part, P, d, D, chunk);
  return cudaGetLastError();
}

template <int N, int W>
cudaError_t launch_push(unsigned blocks, cudaStream_t s, const float* Tt, const float* R,
                        float* Y, int64_t P, int64_t d, int64_t D, float scale) {
  const auto kernel = push_kernel<N, W>;
  static uint32_t ready = 0;
  const cudaError_t err = allow_smem(kernel, Smem<N>::BYTES2, ready);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, Smem<N>::BYTES2, s>>>(Tt, R, Y, P, d, D, scale);
  return cudaGetLastError();
}

// Grid-stride passes: at most 4096 blocks of 256 threads.
inline unsigned pass_blocks(int64_t n) {
  return static_cast<unsigned>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
}

template <int N>
cudaError_t sweep(const float* V, const float* R, float* Vt, float* part, float* T, float* Tt,
                  float* Y, int64_t P, int64_t d, int64_t D, int64_t splits, float scale,
                  cudaStream_t s) {
  const int64_t groups = (P + N - 1) / N;
  const int64_t project_blocks = groups * ((d + TILE - 1) / TILE) * splits;
  const int64_t push_blocks = groups * ((D + TILE - 1) / TILE);
  if (project_blocks > 2147483647LL || push_blocks > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  tile_kernel<N><<<pass_blocks(groups * N * ((D + BK - 1) / BK) * BK / 4), 256, 0, s>>>(V, Vt, P,
                                                                                       D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t chunk = ((D + splits - 1) / splits + BK - 1) / BK * BK;
  const unsigned b1 = static_cast<unsigned>(project_blocks);
  const int w1 = lip_mm::vec_width(R, R, D, D);
  err = w1 == 4   ? launch_project<N, 4>(b1, s, Vt, R, part, P, d, D, chunk)
        : w1 == 2 ? launch_project<N, 2>(b1, s, Vt, R, part, P, d, D, chunk)
                  : launch_project<N, 1>(b1, s, Vt, R, part, P, d, D, chunk);
  if (err != cudaSuccess) return err;
  reduce_kernel<N><<<pass_blocks(groups * N * ((d + BK - 1) / BK) * BK), 256, 0, s>>>(
      part, T, Tt, P, d, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned b2 = static_cast<unsigned>(push_blocks);
  return w1 == 4   ? launch_push<N, 4>(b2, s, Tt, R, Y, P, d, D, scale)
         : w1 == 2 ? launch_push<N, 2>(b2, s, Tt, R, Y, P, d, D, scale)
                   : launch_push<N, 1>(b2, s, Tt, R, Y, P, d, D, scale);
}

// least = min(least, the stage-1 blocks of this instance one SM holds at once).
template <int N, int W>
cudaError_t project_occupancy(int& least) {
  const auto kernel = project_kernel<N, W>;
  static uint32_t ready = 0;
  cudaError_t err = allow_smem(kernel, Smem<N>::BYTES1, ready);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                        Smem<N>::BYTES1);
  }
  if (err == cudaSuccess && blocks < least) least = blocks;
  return err;
}

template <int N>
cudaError_t project_resident(int64_t& out) {
  int least = 1 << 30;
  const cudaError_t errs[] = {project_occupancy<N, 4>(least), project_occupancy<N, 2>(least),
                              project_occupancy<N, 1>(least)};
  for (const cudaError_t err : errs) {
    if (err != cudaSuccess) return err;
  }
  out = least;
  return cudaSuccess;
}

}  // namespace lip_sweep

// Plain C entry points, loaded with ctypes.

// What the wrapper's planner needs of the sweep on the current device, into
// out[0..6): its SMs; the rows of R per stage-1 block; the small and the large probe
// group; the resident stage-1 blocks per SM at each group.
extern "C" int lip_sweep_geometry(int64_t* out) {
  using namespace lip_sweep;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = project_resident<SMALL_GROUP>(out[4]);
  if (err == cudaSuccess) err = project_resident<LARGE_GROUP>(out[5]);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = sms;
  out[1] = TILE;
  out[2] = SMALL_GROUP;
  out[3] = LARGE_GROUP;
  return static_cast<int>(cudaSuccess);
}

// Y = scale * (V R^T) R with T = V R^T: probes in groups of `group` (64 or 256), D
// split over `splits` stage-1 blocks per tile. Workspaces: Vt and Tt, the operand
// tiles of V and T (group * ceil(P / group) * BK * ceil(D / BK), resp. ceil(d / BK),
// floats, 16-byte aligned); part, the (splits, P, d) partials. T (rounded to TF32) and
// Y are outputs. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int lip_ggn_sweep_tf32(const float* V, const float* R, float* Vt, float* part,
                                  float* T, float* Tt, float* Y, int64_t P, int64_t d,
                                  int64_t D, int64_t group, int64_t splits, float scale,
                                  void* stream) {
  using namespace lip_sweep;
  if (P <= 0 || d <= 0 || D <= 0 || splits <= 0 ||
      (group != SMALL_GROUP && group != LARGE_GROUP) ||
      reinterpret_cast<uintptr_t>(Vt) % 16 != 0 || reinterpret_cast<uintptr_t>(Tt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      group == LARGE_GROUP
          ? sweep<LARGE_GROUP>(V, R, Vt, part, T, Tt, Y, P, d, D, splits, scale, s)
          : sweep<SMALL_GROUP>(V, R, Vt, part, T, Tt, Y, P, d, D, splits, scale, s);
  return static_cast<int>(err);
}
