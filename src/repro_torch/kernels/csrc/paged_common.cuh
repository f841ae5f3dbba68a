// Shared device half of the two paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): the page walk and the online-softmax fold.
//
// Counterpart of the device half of repro/kernels/paged_common.py
// (effective_walk_start, load_kv_page, reset/online_softmax_fold/
// finalize_online_softmax). The TPU walked one page per sequential grid
// step with a double-buffered DMA; here one CTA loops over its pages and
// stages each page's K and V rows for its kv-head in shared memory.
//
// Numerics follow the reference exactly:
//   * masked scores are the FINITE sentinel -1e30, never -inf, and the
//     epilogue divides by max(l, 1e-30), so a wholly masked row (idle
//     slot, bucket dummy row, suffix pad row) stays finite;
//   * a page whose positions are all masked for a row that has seen a
//     valid position folds as an exact no-op (p = 0, alpha = 1), and one
//     folded before any valid position is wiped by alpha = 0 — so a CTA
//     may skip pages that are masked for all its rows without changing
//     any valid row by a bit (bucketed == single launch, chunked ==
//     single-shot prefill);
//   * int8 codes are dequantized code * scale[page, kv_head] in f32 right
//     after the load, as load_kv_page does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

// dtype codes of the C interface (kernels/paged_common.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// First table column a depth-bounded walk visits: the slot's first live
// block, clamped so [start, start + depth) stays inside the table.
__device__ __forceinline__ int walk_start(const int* block_start, int row,
                                          int depth, int mb) {
  const int s = block_start ? block_start[row] : 0;
  return max(min(s, mb - depth), 0);
}

// Stage one page's K and V rows of kv-head `kvh` as f32 in shared memory
// (row stride `ld`), dequantizing int8 codes with the page's scales.
template <typename KVT>
__device__ void load_kv_page(const KVT* __restrict__ kp,
                             const KVT* __restrict__ vp,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs, int page, int kvh,
                             int n_kv, int bs, int hd, float* k_s, float* v_s,
                             int ld) {
  const size_t base = static_cast<size_t>(page) * bs * n_kv * hd;
  const size_t srow = static_cast<size_t>(page) * n_kv + kvh;
  const float k_scale = ks ? ks[srow] : 1.0f;
  const float v_scale = vs ? vs[srow] : 1.0f;
  for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const size_t off = base + (static_cast<size_t>(r) * n_kv + kvh) * hd + d;
    float kx = to_f32(kp[off]);
    float vx = to_f32(vp[off]);
    if (ks) {
      kx *= k_scale;
      vx *= v_scale;
    }
    k_s[r * ld + d] = kx;
    v_s[r * ld + d] = vx;
  }
}

// Fold one page into the carried state of `n_units` query rows: s_s holds
// each row's `bs` masked scores (overwritten with the probabilities),
// m_s/l_s/alpha_s one float per row, acc_s `hd` floats per row. Ends with
// a barrier, so the caller may restage k/v right after.
__device__ void online_softmax_fold(float* s_s, int bs, float* m_s,
                                    float* l_s, float* alpha_s, float* acc_s,
                                    int hd, const float* v_s, int ld,
                                    int n_units) {
  for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
    float* s = s_s + u * bs;
    const float m_old = m_s[u];
    float m_new = m_old;
    for (int r = 0; r < bs; ++r) m_new = fmaxf(m_new, s[r]);
    float l_page = 0.0f;
    for (int r = 0; r < bs; ++r) {
      const float p = expf(s[r] - m_new);
      s[r] = p;
      l_page += p;
    }
    const float alpha = expf(m_old - m_new);
    alpha_s[u] = alpha;
    m_s[u] = m_new;
    l_s[u] = alpha * l_s[u] + l_page;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_units * hd; i += blockDim.x) {
    const int u = i / hd, d = i - u * hd;
    const float* p = s_s + u * bs;
    float pv = 0.0f;
    for (int r = 0; r < bs; ++r) pv += p[r] * v_s[r * ld + d];
    acc_s[i] = alpha_s[u] * acc_s[i] + pv;
  }
  __syncthreads();
}

// Masked scores of `n_units` query rows (f32, pre-scaled, hd per row in
// q_s) against the staged page: s_s[u * bs + r] = q.k or the sentinel.
// `visible(u, kv_pos)` is the kernel's mask.
template <typename Visible>
__device__ void page_scores(const float* q_s, const float* k_s, int ld,
                            int hd, int bs, int n_units, int first_pos,
                            Visible visible, float* s_s) {
  for (int i = threadIdx.x; i < n_units * bs; i += blockDim.x) {
    const int u = i / bs, r = i - u * bs;
    float score = kNegInf;
    if (visible(u, first_pos + r)) {
      const float* qr = q_s + u * hd;
      const float* kr = k_s + r * ld;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      score = dot;
    }
    s_s[i] = score;
  }
  __syncthreads();
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace paged
