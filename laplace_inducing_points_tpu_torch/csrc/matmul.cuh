// Shared pieces of the FP32 NT and NN products (matmul.cu, matmul_tiled.cu): the
// skinny paths' limits, vector loads and stores of 1, 2 or 4 floats, the width a
// launch may use, compensated sums, and the deterministic second pass over split
// partials.
//
// Vector width: D = 61,706 is 2 mod 4, so every other row of a (rows, D) matrix
// starts 8 bytes off a 16-byte boundary. A launch takes the widest W in {4, 2, 1}
// that divides every leading dimension and to whose 4W bytes every base pointer is
// aligned; then every row and every W-aligned column of it is aligned too, and a
// ragged edge never cuts a vector (61,706 takes W = 2, an odd D takes W = 1).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lip_mm {

constexpr int64_t ROW_MAX = 8;     // output rows of the row paths at most
constexpr int64_t RANK_MAX = 16;   // contraction depth of the rank path at most
constexpr int COL_THREADS = 128;   // NN row and rank paths: 4 warps
constexpr int COL_PER_THREAD = 4;  // a block covers 512 output columns
constexpr int COL_BLOCK = COL_THREADS * COL_PER_THREAD;

inline int vec_width(const void* p, const void* q, int64_t ld_p, int64_t ld_q) {
  for (int w = 4; w > 1; w /= 2) {
    const uintptr_t bytes = 4u * static_cast<uintptr_t>(w);
    if (reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(q) % bytes == 0 && ld_p % w == 0 && ld_q % w == 0) {
      return w;
    }
  }
  return 1;
}

// W floats at p into d[0..W): read once, evict first (the long operands).
template <int W>
__device__ __forceinline__ void load_stream(float* d, const float* p) {
  if constexpr (W == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __ldcs(p);
  }
}

// W floats at p into d[0..W) through the read-only cache (the short operands,
// which every block reads again).
template <int W>
__device__ __forceinline__ void load_cached(float* d, const float* p) {
  if constexpr (W == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __ldg(p);
  }
}

// s[0..W) to p, streaming (the outputs are written once and not read here).
template <int W>
__device__ __forceinline__ void store_stream(float* p, const float* s) {
  if constexpr (W == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2], s[3]));
  } else if constexpr (W == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(s[0], s[1]));
  } else {
    __stcs(p, s[0]);
  }
}

// Kahan: sum - comp carries the running total; x is one more (partial) sum.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// (hi, lo) += (ohi, olo) with the rounding error of hi + ohi kept in lo (TwoSum):
// the compensated tree sum of the reductions across lanes and warps.
__device__ __forceinline__ void two_sum_add(float& hi, float& lo, float ohi, float olo) {
  const float s = hi + ohi;
  const float b = s - hi;
  const float e = (hi - (s - b)) + (ohi - b);
  hi = s;
  lo = lo + olo + e;
}

// out[i] = the sum over s of part[s][i], split by split in order: deterministic.
static __global__ void split_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int64_t count,
                                           int64_t splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f, comp = 0.f;
    for (int64_t k = 0; k < splits; ++k) kahan_add(sum, comp, part[k * count + i]);
    out[i] = sum - comp;
  }
}

inline cudaError_t split_reduce(const float* part, float* out, int64_t count, int64_t splits,
                                cudaStream_t stream) {
  const int64_t blocks = (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096;
  split_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, out, count,
                                                                        splits);
  return cudaGetLastError();
}

}  // namespace lip_mm
