// K1 — paged decode attention for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:
// _paged_decode_kernel (pallas_call in paged_decode_attention). One query
// token per slot attends over its KV pages through the slot's block-table
// row; GQA with g = H / KV query heads per kv-head; online softmax in f32;
// f32 output [B, H, hd].
//
// Design. One CTA per (launch row, kv-head), 128 threads. The CTA keeps
// the g query heads of its kv-head in shared memory, pre-scaled by
// hd^-0.5 in f32 (the reference kernel scales q before the dot; its
// oracle scales after, so kernel-vs-plain is a tolerance). A loop over
// j < depth takes the place of the TPU's sequential grid axis: read
// page = table[row, s + j] with s = max(min(block_start, mb - depth), 0);
// stage that page's K and V rows for this kv-head in shared memory
// (int8 codes dequantized on load); compute the g x bs masked scores
// (kv_pos from the table COLUMN: kv_pos < len, kv_pos > len-1-window);
// fold them into f32 (m, l, acc[g, hd]). Pages wholly masked for the
// slot are skipped (an exact no-op for every valid row, see
// paged_common.cuh). The epilogue writes acc / max(l, 1e-30).
//
// Bound on an H100 SXM (3.35 TB/s HBM). K1 does ~2 flops per byte of KV
// it reads, so it is bound by memory: per slot and kv-head it must read
// its live pages once, live_pages x 2 (K, V) x bs x hd x itemsize bytes
// (+ q, out, table). At the main path's shapes (8 slots, ~700-token
// contexts, bs 16, KV 2, hd 128, bf16) that is ~5.8 MB, ~1.7 us.
//
// What this simple design leaves on the table: only B x KV CTAs run
// (16 of 132 SMs at 8 slots), each walking its pages one after another —
// splitting the walk across CTAs (flash-decoding) would fill the card;
// page loads are not overlapped with the fold (no cp.async / TMA ring);
// scores and the PV product are scalar f32 FMAs from shared memory, not
// tensor-core MMAs; and the K/V staging converts to f32, doubling the
// shared-memory footprint of bf16 pages.
#include "paged_common.cuh"

namespace paged {

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ block_table,
    const int* __restrict__ lengths, const int* __restrict__ block_start,
    float* __restrict__ out, int n_heads, int n_kv, int hd, int bs, int mb,
    int depth, int window, float scale) {
  const int row = blockIdx.x, kvh = blockIdx.y;
  const int g = n_heads / n_kv, ld = hd + 1;
  extern __shared__ float smem[];
  float* q_s = smem;               // [g, hd]
  float* acc_s = q_s + g * hd;     // [g, hd]
  float* k_s = acc_s + g * hd;     // [bs, ld]
  float* v_s = k_s + bs * ld;      // [bs, ld]
  float* s_s = v_s + bs * ld;      // [g, bs]
  float* m_s = s_s + g * bs;       // [g]
  float* l_s = m_s + g;            // [g]
  float* a_s = l_s + g;            // [g]

  const size_t base = (static_cast<size_t>(row) * n_heads + kvh * g) * hd;
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    q_s[i] = to_f32(q[base + i]) * scale;
    acc_s[i] = 0.0f;
  }
  for (int u = threadIdx.x; u < g; u += blockDim.x) {
    m_s[u] = kNegInf;
    l_s[u] = 0.0f;
  }
  const int len = lengths[row];
  const int q_pos = len - 1;
  const int s0 = walk_start(block_start, row, depth, mb);
  const int* table = block_table + static_cast<size_t>(row) * mb;
  __syncthreads();

  auto visible = [=](int, int kv_pos) {
    return kv_pos < len && kv_pos > q_pos - window;
  };
  for (int j = 0; j < depth; ++j) {
    const int col = s0 + j;
    const int first = col * bs;
    // uniform per CTA: a page with no visible position is skipped
    if (first >= len || first + bs - 1 <= q_pos - window) continue;
    load_kv_page(kp, vp, ks, vs, table[col], kvh, n_kv, bs, hd, k_s, v_s,
                 ld);
    __syncthreads();
    page_scores(q_s, k_s, ld, hd, bs, g, first, visible, s_s);
    online_softmax_fold(s_s, bs, m_s, l_s, a_s, acc_s, hd, v_s, ld, g);
  }
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    out[base + i] = acc_s[i] / fmaxf(l_s[i / hd], 1e-30f);
  }
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, const void* block_start, void* out,
                   int B, int H, int KV, int hd, int bs, int mb, int depth,
                   int window, float scale, cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem =
      sizeof(float) * (2 * g * hd + 2 * bs * (hd + 1) + g * bs + 3 * g);
  auto kernel = paged_decode_kernel<QT, KVT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths),
      static_cast<const int*>(block_start), static_cast<float*>(out), H, KV,
      hd, bs, mb, depth, window, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp,
                      const void* vp, const void* ks, const void* vs,
                      const void* table, const void* lengths,
                      const void* block_start, void* out, int B, int H,
                      int KV, int hd, int bs, int mb, int depth, int window,
                      float scale, cudaStream_t stream) {
#define PAGED_DECODE_LAUNCH(KVT)                                            \
  launch<QT, KVT>(q, kp, vp, ks, vs, table, lengths, block_start, out, B, H, \
                  KV, hd, bs, mb, depth, window, scale, stream)
  switch (kv_dtype) {
    case kF32: return PAGED_DECODE_LAUNCH(float);
    case kBF16: return PAGED_DECODE_LAUNCH(__nv_bfloat16);
    case kI8: return PAGED_DECODE_LAUNCH(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_LAUNCH
}

}  // namespace paged

// C interface (kernels/paged_attention.py). Pointers are device pointers;
// k_scales / v_scales are NULL for float pools, block_start NULL for a
// walk from column 0. Returns the cudaError_t of the launch.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, const void* block_start, void* out, int q_dtype,
    int kv_dtype, int B, int H, int KV, int hd, int bs, int mb, int depth,
    int window, float scale, void* stream) {
  using namespace paged;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                            v_scales, block_table, lengths, block_start, out,
                            B, H, KV, hd, bs, mb, depth, window, scale, s);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                    v_scales, block_table, lengths,
                                    block_start, out, B, H, KV, hd, bs, mb,
                                    depth, window, scale, s);
  return cudaErrorInvalidValue;
}
