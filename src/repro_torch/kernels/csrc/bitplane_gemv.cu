// K3 — bit-plane GEMV for sm_90a, K split across the card.
//
// Replaces the Pallas kernel repro/kernels/bitplane_gemv.py:_gemv_kernel
// (pallas_call in bitplane_gemv). Computes the raw contraction
//   out[b, m] = sum_q sum_r x_r[r, b, q] * U[q*8/g + r, m]      (f32)
// over the digit planes [n_d, K8, M] uint8, U being the unsigned offset
// form they store; the caller (ops.bitplane_matmul) subtracts
// 2^(n-1) * sum(x) and applies the per-channel scale. x_r [8/g, B, K8]
// is bf16 or f32; B <= 512 (ops.bitplane_kernel; K4 takes taller x).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16). 2 B K M operations
// against n_d K8 M bytes of planes: 2B operations per plane byte at
// 8-bit weights. At B = 8 decode rows that is 16, far below the ~295 at
// which the tensor cores would bind, so K3 is bound by the plane bytes
// (13.8 MB for a [1536 -> 8960] projection, 4.2 us). At a decode of 128
// slots it is 256, close to the ridge: the bound is still the plane bytes
// (0.047 ms for granite-20b's [6144 -> 24576]), but issuing the products,
// rebuilding U from its digits and moving x (one row of x per plane
// column tile) all weigh as much as the stream.
//
// Design. Two tiles (bitplane_gemv_tile.cuh), picked by the number of
// rows alone (kernels/bitplane_gemv.py:wide_tile: up to 24 rows the
// narrow one, above it the wide one), share the K walk and its numerics:
//   * K is cut into `splits` ranges of whole chunks
//     (kernels/bitplane_gemv.py:gemv_splits, a function of K8, M and g
//     only, never of B) so that every main-path projection launches
//     enough CTAs; each range writes an f32 partial [B, M] and a second
//     kernel adds the partials in split order. No atomics: repeated
//     launches are bit-identical.
//   * K is walked in chunks of 64 unpacked rows: 8g packed rows, k inside
//     a chunk ordered (r, q), the order of x_r. U is decoded once per
//     chunk for all the rows of the tile: plane words of 4 columns are
//     transposed across the planes (bitplane_common.cuh:
//     transpose_digit_words, as K4 does) and U is stored as bf16 (U < 256
//     is exact), while the tensor cores multiply the chunk before.
//   * Products: U^T is the A operand (columns of M as rows), x the B
//     operand (rows of B as columns), bf16 x bf16 -> f32 in k16 steps.
//     f32 x goes in as three bf16 terms (hi + mid + lo == x,
//     tensor_core.cuh): every product is exact.
//   * The tensor core truncates as it accumulates, so chains stay short:
//     each chunk's products (4 k-steps, x 3 terms for f32) go into a
//     fresh accumulator that is added to the f32 sum with an ordinary
//     add. A row's result depends on neither the other rows nor B nor the
//     tile: rows never mix in a product, the split points do not move
//     with B, and both tiles run every element's chain alike.
//   * The narrow tile (up to 24 rows; the decode of 8 slots): one CTA of
//     2 warps per (32 columns, up to 64 rows, range of K); a ring of 5
//     stages brings each chunk's plane rows and x_r rows into shared
//     memory by 16-byte cp.async, three chunks ahead; products on
//     mma.sync.m16n8k16, 8 rows of B per n-tile.
//   * The wide tile (above 24 rows; the decode of 128 slots, prefills):
//     one warpgroup per (64 columns, up to 128 rows, range of K). A first
//     kernel lays x out chunk by chunk as wgmma reads it
//     (bitplane_gemv_kernel_wide_x: 16 KB per chunk of 128 rows, bf16
//     terms; its name holds K3's, so a trace counts it as K3's time);
//     each chunk's x then
//     arrives in one bulk copy (the TMA unit, counted on an mbarrier),
//     its plane rows by cp.async, and wgmma.m64n128k16 multiplies a chunk
//     while the warpgroup decodes the next. At 128 rows the narrow tile
//     fetched and decoded every chunk twice and staged x as 16-byte
//     pieces (x_r scatters a row's chunk over 8/g rows of x_r), which
//     capped the card's copies near 1.5 TB/s.
//   * Any K8 and M: packed rows past K8 and columns past M are staged as
//     zero and never stored, rows past B are never stored.
#include <algorithm>

#include "bitplane_gemv_tile.cuh"

namespace bitplane {

template <typename XT, int G>
__global__ void __launch_bounds__(kGemvThreads) bitplane_gemv_kernel(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd,
    int chunks_per_split, int bt, bool x_vec, bool p_vec) {
  const int b0 = blockIdx.y * kGemvTileB;
  gemv_tile<XT, G>(x_r, planes, out, B, K8, M, nd, chunks_per_split, bt,
                   x_vec, p_vec, blockIdx.x * kGemvTileM, b0,
                   min(bt, B - b0), blockIdx.z);
}

// The wide tile's kernel: x as gemv_tile_wide takes it.
template <int G, int NX>
__global__ void __launch_bounds__(kWideThreads) bitplane_gemv_kernel_wide(
    const __nv_bfloat16* __restrict__ xt, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd,
    int chunks_per_split, bool p_vec) {
  const int b0 = blockIdx.y * kWideTB;
  gemv_tile_wide<G, NX>(xt, planes, out, B, K8, M, nd, chunks_per_split,
                        p_vec, blockIdx.x * kWideTM, b0,
                        min(kWideTB, B - b0), blockIdx.z);
}

// The wide tile's x (gemv_tile_wide's xt): xt[t][c][b/8][kg][b%8][ke] =
// term t (tc::split_pair's) of x_r's row b at chunk c's element 8 kg + ke
// in (r, q) order, zero past K8 and on the rows from B to Bp (their
// products meet no row below B, but no uninitialised value enters the
// tensor cores). One thread per 8 elements, 16 bytes of each term, in
// xt's order. Part of K3's work: its name begins with K3's kernel's, by
// which the traces find K3.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT, int G>
__global__ void bitplane_gemv_kernel_wide_x(const XT* __restrict__ x_r,
                                            __nv_bfloat16* __restrict__ xt,
                                            int B, int K8, int n_chunks,
                                            int bp) {
  constexpr int QC = 8 * G, NX = tc::Terms<XT>::n;
  const size_t pieces = static_cast<size_t>(n_chunks) * bp * 8;
  const size_t term_elems = pieces * 8;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       p < pieces; p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int br = p % 8, kg = (p / 8) % 8;
    const int b = static_cast<int>((p / 64) % (bp / 8)) * 8 + br;
    const int c = static_cast<int>(p / (8 * static_cast<size_t>(bp)));
    float v[8];
#pragma unroll
    for (int ke = 0; ke < 8; ++ke) {
      const int k = kg * 8 + ke, r = k / QC, q = c * QC + k % QC;
      v[ke] = b < B && q < K8
                  ? to_float(x_r[(static_cast<size_t>(r) * B + b) * K8 + q])
                  : 0.0f;
    }
    uint32_t w[4][NX];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tc::split_pair<NX>(v[2 * e], v[2 * e + 1], w[e]);
#pragma unroll
    for (int t = 0; t < NX; ++t)
      *reinterpret_cast<uint4*>(xt + t * term_elems + p * 8) =
          make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
  }
}

// out[i] = sum over s = 0 .. splits-1, in that order, of part[s][i].
__global__ void gemv_split_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, size_t n,
                                      int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

template <typename XT, int G>
cudaError_t launch_gemv(const void* x_r, const void* planes, void* out,
                        void* partial, void* xt, int B, int K8, int M, int nd,
                        int splits, bool wide, cudaStream_t stream) {
  const int n_chunks = (K8 + 8 * G - 1) / (8 * G);
  const int per = std::max(1, (n_chunks + splits - 1) / splits);
  const bool p_vec =
      reinterpret_cast<uintptr_t>(planes) % 16 == 0 && M % 16 == 0;
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  cudaError_t err;
  if (wide) {
    constexpr int NX = tc::Terms<XT>::n;
    const int bp = (B + kWideTB - 1) / kWideTB * kWideTB;
    const size_t pieces = static_cast<size_t>(n_chunks) * bp * 8;
    const int blocks =
        static_cast<int>(std::min<size_t>((pieces + 255) / 256, 4096));
    bitplane_gemv_kernel_wide_x<XT, G><<<blocks, 256, 0, stream>>>(
        static_cast<const XT*>(x_r), static_cast<__nv_bfloat16*>(xt), B, K8,
        n_chunks, bp);
    auto kernel = bitplane_gemv_kernel_wide<G, NX>;
    err = tc::allow_dynamic_smem(kernel, wide_smem<NX>());
    if (err != cudaSuccess) return err;
    const dim3 grid((M + kWideTM - 1) / kWideTM, bp / kWideTB, splits);
    kernel<<<grid, kWideThreads, wide_smem<NX>(), stream>>>(
        static_cast<const __nv_bfloat16*>(xt),
        static_cast<const uint8_t*>(planes), dst, B, K8, M, nd, per, p_vec);
  } else {
    const int bt = std::min(kGemvTileB, (B + 7) / 8 * 8);
    auto kernel = bitplane_gemv_kernel<XT, G>;
    const size_t smem = gemv_smem<XT>(bt);
    err = tc::allow_dynamic_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const bool x_vec = reinterpret_cast<uintptr_t>(x_r) % 16 == 0 &&
                       K8 % (16 / static_cast<int>(sizeof(XT))) == 0;
    const dim3 grid((M + kGemvTileM - 1) / kGemvTileM,
                    (B + kGemvTileB - 1) / kGemvTileB, splits);
    kernel<<<grid, kGemvThreads, smem, stream>>>(
        static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes), dst,
        B, K8, M, nd, per, bt, x_vec, p_vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * M;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  gemv_split_sum_kernel<<<blocks, 256, 0, stream>>>(
      dst, static_cast<float*>(out), n, splits);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_gemv_group(int group, const void* x_r, const void* planes,
                              void* out, void* partial, void* xt, int B,
                              int K8, int M, int nd, int splits, bool wide,
                              cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gemv<XT, 1>(x_r, planes, out, partial, xt, B, K8,
                                      M, nd, splits, wide, stream);
    case 2: return launch_gemv<XT, 2>(x_r, planes, out, partial, xt, B, K8,
                                      M, nd, splits, wide, stream);
    case 4: return launch_gemv<XT, 4>(x_r, planes, out, partial, xt, B, K8,
                                      M, nd, splits, wide, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 elements of the wide tile's x scratch: NX * C * Bp * 64 (NX = 1
// for bf16 x, 3 for f32; C = ceil(K8 / 8 group); Bp = B rounded up to
// 128), what bitplane_gemv_kernel_wide_x writes.
inline long long wide_x_elements(int x_dtype, int B, int K8, int group) {
  const long long nx = x_dtype == kF32 ? 3 : 1;
  const long long chunks = (K8 + 8 * group - 1) / (8 * group);
  const long long bp = (B + kWideTB - 1) / kWideTB * kWideTB;
  return nx * chunks * bp * kGemvChunkK;
}

}  // namespace bitplane

// C interface (kernels/bitplane_gemv.py). Pointers are device pointers:
// x_r [8/group, B, K8] (x_dtype 0 = f32, 1 = bf16), planes
// [n_digits, K8, M] uint8, out [B, M] f32. `wide` picks the wide tile; it
// then needs `xt`, bf16 scratch of `xt_elems` elements, at least
// wide_x_elements (else cudaErrorInvalidValue, before any launch).
// `splits` >= 1 ranges of whole chunks; when it is above 1, `partial` is
// f32 [splits, B, M] scratch and `out` receives their sum. Returns the
// cudaError_t of the launches.
extern "C" int bitplane_gemv_launch(const void* x_r, const void* planes,
                                    void* out, void* partial, void* xt,
                                    long long xt_elems, int x_dtype, int B,
                                    int K8, int M, int n_digits, int group,
                                    int splits, int wide, void* stream) {
  using namespace bitplane;
  if (splits < 1 || (splits > 1 && partial == nullptr) ||
      (wide && (xt == nullptr ||
                xt_elems < wide_x_elements(x_dtype, B, K8, group))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_gemv_group<float>(group, x_r, planes, out, partial, xt, B,
                                    K8, M, n_digits, splits, wide != 0, s);
  if (x_dtype == kBF16)
    return launch_gemv_group<__nv_bfloat16>(group, x_r, planes, out, partial,
                                            xt, B, K8, M, n_digits, splits,
                                            wide != 0, s);
  return cudaErrorInvalidValue;
}
