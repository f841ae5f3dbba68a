// Shared device half of the two paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): the walk bounds, the numerics both folds keep, and
// the ordered merge of a walk split into ranges.
//
// Counterpart of the device half of repro/kernels/paged_common.py
// (effective_walk_start, reset/online_softmax_fold/
// finalize_online_softmax). The TPU walked one page per sequential grid
// step with a double-buffered DMA; here the walk is cut into ranges at
// fixed table positions, each folded by its own CTA (or warp), and the
// ranges' softmax states are merged in order.
//
// Numerics follow the reference exactly:
//   * masked scores are the FINITE sentinel -1e30, never -inf, and the
//     epilogue divides by max(l, 1e-30), so a wholly masked row (idle
//     slot, bucket dummy row, suffix pad row) stays finite;
//   * a chunk whose positions are all masked for a row that has seen a
//     valid position folds as an exact no-op (p = 0, alpha = 1), and one
//     folded before any valid position is wiped by alpha = 0 — so a fold
//     may skip chunks that are masked for all its rows without changing
//     any valid row by a bit (bucketed == single launch, chunked ==
//     single-shot prefill);
//   * a range that holds no valid key of a row keeps (m, l, acc) =
//     (-1e30, 0, 0) and adds exact zeros to the merge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

// dtype codes of the C interface (kernels/paged_common.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Shared-memory row padding (elements): keeps rows 16-byte aligned and
// the fragment loads free of bank conflicts.
template <typename T>
constexpr int row_pad() {
  return sizeof(T) == 1 ? 16 : 8;
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.0f);
}
__device__ __forceinline__ void set_zero(int8_t& x) { x = 0; }

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// First table column a depth-bounded walk visits: the slot's first live
// block, clamped so [start, start + depth) stays inside the table.
__device__ __forceinline__ int walk_start(const int* block_start, int row,
                                          int depth, int mb) {
  const int s = block_start ? block_start[row] : 0;
  return max(min(s, mb - depth), 0);
}

// out = sum over ranges r (in order) of acc_r w_r / max(sum of l_r w_r,
// 1e-30), w_r = exp(m_r - max m). acc is [count, units, hd] and ml
// [count, units, 2] (m, l). A range that saw no valid key of a row has
// m_r = -1e30 and adds exact zeros, so a row that one range holds gets
// that range's fold bit for bit.
__global__ void merge_ranges_kernel(const float* __restrict__ acc,
                                    const float* __restrict__ ml,
                                    float* __restrict__ out, size_t units,
                                    int hd, int count) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < units * hd; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t unit = i / hd;
    float m = kNegInf;
    for (int r = 0; r < count; ++r) m = fmaxf(m, ml[(r * units + unit) * 2]);
    float num = 0.0f, den = 0.0f;
    for (int r = 0; r < count; ++r) {
      const float w = exp2f((ml[(r * units + unit) * 2] - m) * kLog2e);
      num += acc[r * units * hd + i] * w;
      den += ml[(r * units + unit) * 2 + 1] * w;
    }
    out[i] = num / fmaxf(den, 1e-30f);
  }
}

// Launches merge_ranges_kernel over `units` rows of `hd`.
inline cudaError_t merge_ranges(const float* acc, const float* ml, float* out,
                                size_t units, int hd, int count,
                                cudaStream_t stream) {
  const size_t n = units * hd;
  const int blocks = static_cast<int>(
      (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  merge_ranges_kernel<<<blocks, 256, 0, stream>>>(acc, ml, out, units, hd,
                                                  count);
  return cudaGetLastError();
}

}  // namespace paged
