// K2 — paged prefill attention for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/paged_prefill.py:
// _paged_prefill_kernel (pallas_call in paged_prefill_attention). T
// suffix queries per slot, row t at logical position start + t, attend
// through the block table over the cached prefix and the fresh suffix:
// kv_pos <= start + t, kv_pos < total, kv_pos > start + t - window.
// Online softmax in f32; f32 output [B, T, H, hd].
//
// Design. The TPU kernel kept all T x H x hd queries of a slot and their
// softmax state in VMEM; a 1024-token prompt would not fit in Hopper's
// shared memory, so the queries are tiled instead. One CTA per (launch
// row, kv-head, tile of tq query rows), 128 threads, tq = max(1, 32 / g):
// the tile's tq x g query heads ("units", at most 32) are staged in
// shared memory pre-scaled by hd^-0.5, with their (m, l, acc) state. The
// CTA runs the same page loop and fold as K1 (paged_common.cuh), one
// softmax row per unit, and skips every page that lies wholly outside
// the tile's causal / total / window mask — an exact no-op for every
// valid row, so a row's output does not depend on the tile it sits in
// (chunked prefill stays bit-identical to single-shot prefill, and the
// bucketed launch to the single launch).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense tensor
// cores). It must read the slot's visible pages once (pages x 2 x bs x
// hd x itemsize per kv-head) plus q and out, and do 4 x hd flops per
// visible (query head, kv position) pair. At the main path's widths (one
// slot, a 256-token cached prefix, suffixes of 64-768 tokens, 12 heads,
// hd 128) the causal pairs dominate: ~3 GFLOP against ~2-5 MB, so at
// those sizes the bound is the operations on tensor cores, a few us.
//
// What this simple design leaves on the table: scores and the PV product
// are scalar f32 FMAs from shared memory — no wgmma, so the tensor cores
// sit idle and the kernel runs far from the operations bound; each CTA
// restages every page it visits (the tiles of one kv-head re-read the
// same pages from L2); page loads are not overlapped with the fold (no
// cp.async / TMA pipeline); and the tile holds at most 32 units.
#include <algorithm>

#include "paged_common.cuh"

namespace paged {

constexpr int kMaxUnits = 32;

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ block_table,
    const int* __restrict__ start, const int* __restrict__ total,
    const int* __restrict__ block_start, float* __restrict__ out, int T,
    int n_heads, int n_kv, int hd, int bs, int mb, int depth, int window,
    float scale, int tq) {
  const int row = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * tq;
  const int g = n_heads / n_kv, ld = hd + 1;
  const int n_rows = min(tq, T - t0);
  const int n_units = n_rows * g;   // unit u = (query row t0 + u / g, head u % g)
  const int cap = tq * g;
  extern __shared__ float smem[];
  float* q_s = smem;               // [cap, hd]
  float* acc_s = q_s + cap * hd;   // [cap, hd]
  float* k_s = acc_s + cap * hd;   // [bs, ld]
  float* v_s = k_s + bs * ld;      // [bs, ld]
  float* s_s = v_s + bs * ld;      // [cap, bs]
  float* m_s = s_s + cap * bs;     // [cap]
  float* l_s = m_s + cap;          // [cap]
  float* a_s = l_s + cap;          // [cap]

  // element (unit u, dim d) of this CTA in the [B, T, H, hd] layout
  auto offset = [=](int u, int d) {
    const int t = t0 + u / g, h = kvh * g + u % g;
    return ((static_cast<size_t>(row) * T + t) * n_heads + h) * hd + d;
  };
  for (int i = threadIdx.x; i < n_units * hd; i += blockDim.x) {
    const int u = i / hd, d = i - u * hd;
    q_s[i] = to_f32(q[offset(u, d)]) * scale;
    acc_s[i] = 0.0f;
  }
  for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
    m_s[u] = kNegInf;
    l_s[u] = 0.0f;
  }
  const int st = start[row], tot = total[row];
  const int q_first = st + t0, q_last = st + t0 + n_rows - 1;
  const int kv_hi = min(q_last, tot - 1);      // last position any row sees
  const int kv_lo = q_first - window + 1;      // first position any row sees
  const int s0 = walk_start(block_start, row, depth, mb);
  const int* table = block_table + static_cast<size_t>(row) * mb;
  __syncthreads();

  auto visible = [=](int u, int kv_pos) {
    const int q_pos = q_first + u / g;
    return kv_pos <= q_pos && kv_pos < tot && kv_pos > q_pos - window;
  };
  for (int j = 0; j < depth; ++j) {
    const int col = s0 + j;
    const int first = col * bs;
    // uniform per CTA: a page no row of the tile can see is skipped
    if (first > kv_hi || first + bs - 1 < kv_lo) continue;
    load_kv_page(kp, vp, ks, vs, table[col], kvh, n_kv, bs, hd, k_s, v_s,
                 ld);
    __syncthreads();
    page_scores(q_s, k_s, ld, hd, bs, n_units, first, visible, s_s);
    online_softmax_fold(s_s, bs, m_s, l_s, a_s, acc_s, hd, v_s, ld, n_units);
  }
  for (int i = threadIdx.x; i < n_units * hd; i += blockDim.x) {
    const int u = i / hd, d = i - u * hd;
    out[offset(u, d)] = acc_s[i] / fmaxf(l_s[u], 1e-30f);
  }
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* start, const void* total,
                   const void* block_start, void* out, int B, int T, int H,
                   int KV, int hd, int bs, int mb, int depth, int window,
                   float scale, cudaStream_t stream) {
  const int g = H / KV;
  const int tq = std::max(1, kMaxUnits / g);
  const int cap = tq * g;
  const size_t smem =
      sizeof(float) * (2 * cap * hd + 2 * bs * (hd + 1) + cap * bs + 3 * cap);
  auto kernel = paged_prefill_kernel<QT, KVT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV, (T + tq - 1) / tq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<const int*>(total),
      static_cast<const int*>(block_start), static_cast<float*>(out), T, H,
      KV, hd, bs, mb, depth, window, scale, tq);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp,
                      const void* vp, const void* ks, const void* vs,
                      const void* table, const void* start,
                      const void* total, const void* block_start, void* out,
                      int B, int T, int H, int KV, int hd, int bs, int mb,
                      int depth, int window, float scale,
                      cudaStream_t stream) {
#define PAGED_PREFILL_LAUNCH(KVT)                                          \
  launch<QT, KVT>(q, kp, vp, ks, vs, table, start, total, block_start, out, \
                  B, T, H, KV, hd, bs, mb, depth, window, scale, stream)
  switch (kv_dtype) {
    case kF32: return PAGED_PREFILL_LAUNCH(float);
    case kBF16: return PAGED_PREFILL_LAUNCH(__nv_bfloat16);
    case kI8: return PAGED_PREFILL_LAUNCH(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_PREFILL_LAUNCH
}

}  // namespace paged

// C interface (kernels/paged_prefill.py). Pointers are device pointers;
// k_scales / v_scales are NULL for float pools, block_start NULL for a
// walk from column 0. Returns the cudaError_t of the launch.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* start, const void* total, const void* block_start, void* out,
    int q_dtype, int kv_dtype, int B, int T, int H, int KV, int hd, int bs,
    int mb, int depth, int window, float scale, void* stream) {
  using namespace paged;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                            v_scales, block_table, start, total, block_start,
                            out, B, T, H, KV, hd, bs, mb, depth, window,
                            scale, s);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                    v_scales, block_table, start, total,
                                    block_start, out, B, T, H, KV, hd, bs,
                                    mb, depth, window, scale, s);
  return cudaErrorInvalidValue;
}
