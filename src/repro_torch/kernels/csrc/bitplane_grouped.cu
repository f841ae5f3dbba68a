// K6 — grouped bit-plane GEMV for sm_90a: K3 over an expert-sorted row
// list, one launch for every expert of a mixture-of-experts projection.
//
// Replaces no TPU kernel: the reference runs a capacity-routed expert
// stack as `jax.vmap` of `bitplane_matmul` over the experts
// (repro/models/moe.py:_expert_matmul), one K3 / K4 product per expert
// on its [C, K] block of places. Dropless routing (models/moe.py) gives
// each expert a ragged number of rows instead, and one launch per expert
// would be 64 launches per projection. K6 computes
//   out[p, m] = sum_q sum_r x_r[r, p, q] * U_e[q*8/g + r, m]     (f32)
// for every row p of x_r [8/g, P, K8], where e is the expert whose rows
// [offsets[e], offsets[e+1]) hold p, over stacked planes
// [E, n_d, K8, M] uint8. `offsets` [E+1] int32 lies on the device and is
// read by the kernel, so the launch needs nothing of the routing on the
// host and a CUDA graph can hold it. The caller (ops.bitplane_grouped_
// matmul) subtracts 2^(n-1) * sum(x) and applies each expert's scale.
//
// Bound on an H100 SXM (3.35 TB/s). At decode every expert sees about
// P / E rows (16 at 128 slots, top-8 of 64): 2 x 16 operations per plane
// byte, so like K3 it is bound by the plane bytes of the experts that
// have rows (n_d K8 M per expert: 1.65 MB for a [2304 -> 896]
// projection at 8 bits, 106 MB over 64 experts, 32 us). At a 4096-token
// prefill an expert sees ~512 rows: 1024 operations per byte, bound by
// the tensor cores.
//
// Design. Each CTA is one K3 tile (bitplane_gemv_tile.cuh: 32 columns,
// up to 64 rows) over the whole of K. The grid is fixed by P, E, K8 and
// M: x the column tiles, y the ceil(P/64) + E row tiles that bound
// sum_e ceil(n_e/64) for any routing. A CTA walks the offsets to find
// the expert and row tile its y stands for, and exits if y lies past the
// last expert's tiles. Rows of one tile never mix experts, so each
// expert's planes stream once per (row tile, column tile). K is cut into
// K3's ranges (kernels/bitplane_gemv.py:gemv_splits, a function of K8,
// M and g only), but where K3 gives each range a CTA of its own and adds
// the ranges' f32 partials in a second kernel, a K6 CTA walks the ranges
// in order, each from a fresh accumulator, and adds their sums in that
// order (the tile's SERIAL mode): the same operations on the same values,
// so K6 equals K3 on each expert's rows bit for bit, with no [splits, P,
// M] scratch. At a prefill's thousands of pairs that scratch would be
// written and read back at several times the planes' bytes.
#include <algorithm>

#include "bitplane_gemv_tile.cuh"

namespace bitplane {

template <typename XT, int G>
__global__ void __launch_bounds__(kGemvThreads) bitplane_grouped_kernel(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    const int* __restrict__ offsets, float* __restrict__ out, int P, int K8,
    int M, int nd, int E, int chunks_per_split, int bt, bool x_vec,
    bool p_vec) {
  int tile = blockIdx.y, e = 0, lo = 0, hi = 0;
  for (; e < E; ++e) {
    lo = offsets[e];
    hi = offsets[e + 1];
    const int t = (hi - lo + kGemvTileB - 1) / kGemvTileB;
    if (tile < t) break;
    tile -= t;
  }
  if (e >= E) return;  // past the last expert's row tiles: the whole CTA
  const int b0 = lo + tile * kGemvTileB;
  gemv_tile<XT, G, true>(
      x_r, planes + static_cast<size_t>(e) * nd * K8 * M, out, P, K8, M, nd,
      chunks_per_split, bt, x_vec, p_vec, blockIdx.x * kGemvTileM, b0,
      min(kGemvTileB, hi - b0), 0);
}

template <typename XT, int G>
cudaError_t launch_grouped(const void* x_r, const void* planes,
                           const int* offsets, void* out, int P, int K8,
                           int M, int nd, int E, int splits,
                           cudaStream_t stream) {
  const int n_chunks = (K8 + 8 * G - 1) / (8 * G);
  const int per = std::max(1, (n_chunks + splits - 1) / splits);
  const int bt = std::min(kGemvTileB, (P + 7) / 8 * 8);
  auto kernel = bitplane_grouped_kernel<XT, G>;
  const size_t smem = gemv_smem<XT>(bt);
  cudaError_t err = tc::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool x_vec = reinterpret_cast<uintptr_t>(x_r) % 16 == 0 &&
                     K8 % (16 / static_cast<int>(sizeof(XT))) == 0;
  const bool p_vec =
      reinterpret_cast<uintptr_t>(planes) % 16 == 0 && M % 16 == 0;
  const dim3 grid((M + kGemvTileM - 1) / kGemvTileM,
                  (P + kGemvTileB - 1) / kGemvTileB + E);
  kernel<<<grid, kGemvThreads, smem, stream>>>(
      static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes),
      offsets, static_cast<float*>(out), P, K8, M, nd, E, per, bt, x_vec,
      p_vec);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_grouped_group(int group, const void* x_r,
                                 const void* planes, const int* offsets,
                                 void* out, int P, int K8, int M, int nd,
                                 int E, int splits, cudaStream_t stream) {
  switch (group) {
    case 1: return launch_grouped<XT, 1>(x_r, planes, offsets, out, P, K8,
                                         M, nd, E, splits, stream);
    case 2: return launch_grouped<XT, 2>(x_r, planes, offsets, out, P, K8,
                                         M, nd, E, splits, stream);
    case 4: return launch_grouped<XT, 4>(x_r, planes, offsets, out, P, K8,
                                         M, nd, E, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bitplane

// C interface (kernels/bitplane_grouped.py). Pointers are device pointers:
// x_r [8/group, P, K8] (x_dtype 0 = f32, 1 = bf16), planes
// [E, n_digits, K8, M] uint8, offsets [E + 1] int32 (non-decreasing, from
// 0 to P), out [P, M] f32. `splits` >= 1: K3's ranges of whole chunks,
// walked in order inside each CTA. Returns the cudaError_t of the launch.
extern "C" int bitplane_grouped_launch(const void* x_r, const void* planes,
                                       const void* offsets, void* out,
                                       int x_dtype, int P, int K8, int M,
                                       int n_digits, int group,
                                       int n_experts, int splits,
                                       void* stream) {
  using namespace bitplane;
  if (splits < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (x_dtype == kF32)
    return launch_grouped_group<float>(group, x_r, planes, off, out, P, K8,
                                       M, n_digits, n_experts, splits, s);
  if (x_dtype == kBF16)
    return launch_grouped_group<__nv_bfloat16>(group, x_r, planes, off, out,
                                               P, K8, M, n_digits, n_experts,
                                               splits, s);
  return cudaErrorInvalidValue;
}
