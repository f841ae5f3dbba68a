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
// Bound on an H100 SXM (3.35 TB/s). 2 B K M operations against
// n_d K8 M bytes of planes: at B = 8 decode rows and 8-bit weights that
// is 16 operations per byte, far below the ~295 at which the tensor
// cores would bind, so K3 is bound by the plane bytes (13.8 MB for a
// [1536 -> 8960] or [8960 -> 1536] projection, 4.2 us). To come near it
// the whole card must stream the planes with many loads in flight, and
// rebuilding U from its digits must keep pace with the stream.
//
// Design.
//   * One CTA of 2 warps per (32-column tile of M, tile of up to 64 rows
//     of B, range of K). K is cut into `splits` ranges of whole chunks
//     (kernels/bitplane_gemv.py:gemv_splits, a function of K8, M and g
//     only, never of B) so that every main-path projection launches 192-
//     560 CTAs at decode; each range writes an f32 partial [B, M] and a
//     second kernel adds the partials in split order. No atomics:
//     repeated launches are bit-identical.
//   * K is walked in chunks of 64 unpacked rows: 8g packed rows, k inside
//     a chunk ordered (r, q), the order of x_r, so each (row of x, r)
//     segment is 8g consecutive elements. A ring of 5 stages brings each
//     chunk's plane rows (32 bytes of each of the n_d planes) and x rows
//     into shared memory by 16-byte cp.async, three chunks ahead of the
//     products; rows that are not 16-byte aligned are staged by plain
//     loads into the same ring.
//   * One barrier per chunk. Step i multiplies chunk i while each thread,
//     before its products, decodes chunk i + 1 into the other of two U
//     buffers: plane words of 4 columns are transposed across the planes
//     (bitplane_common.cuh:transpose_digit_words, as K4 does) and U is
//     stored as bf16 [k][m] (U < 256 is exact). U is decoded once per
//     chunk for all the rows of the tile.
//   * Products run as mma.sync.m16n8k16 (bf16 x bf16 -> f32) with U^T as
//     the A operand (16 columns of M, by ldmatrix.trans from the [k][m]
//     tile) and x as the B operand (8 rows of B per n-tile, ldmatrix), so
//     8 decode rows fill an MMA and 64 rows take 8 n-tiles of one decoded
//     chunk. f32 x goes in as three bf16 terms (hi + mid + lo == x,
//     tensor_core.cuh): every product is exact.
//   * The tensor core truncates as it accumulates, so chains stay short:
//     each chunk's products (4 k-steps, x 3 terms for f32) go into a
//     fresh accumulator that is added to the f32 sum with an ordinary
//     add. A row's result depends on neither the other rows nor B: rows
//     never mix in an MMA and the split points do not move with B.
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
                        void* partial, int B, int K8, int M, int nd,
                        int splits, cudaStream_t stream) {
  const int n_chunks = (K8 + 8 * G - 1) / (8 * G);
  const int per = std::max(1, (n_chunks + splits - 1) / splits);
  const int bt = std::min(kGemvTileB, (B + 7) / 8 * 8);
  auto kernel = bitplane_gemv_kernel<XT, G>;
  const size_t smem = gemv_smem<XT>(bt);
  cudaError_t err = tc::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool x_vec = reinterpret_cast<uintptr_t>(x_r) % 16 == 0 &&
                     K8 % (16 / static_cast<int>(sizeof(XT))) == 0;
  const bool p_vec =
      reinterpret_cast<uintptr_t>(planes) % 16 == 0 && M % 16 == 0;
  const dim3 grid((M + kGemvTileM - 1) / kGemvTileM,
                  (B + kGemvTileB - 1) / kGemvTileB, splits);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  kernel<<<grid, kGemvThreads, smem, stream>>>(
      static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes), dst,
      B, K8, M, nd, per, bt, x_vec, p_vec);
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
                              void* out, void* partial, int B, int K8, int M,
                              int nd, int splits, cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gemv<XT, 1>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    case 2: return launch_gemv<XT, 2>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    case 4: return launch_gemv<XT, 4>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bitplane

// C interface (kernels/bitplane_gemv.py). Pointers are device pointers:
// x_r [8/group, B, K8] (x_dtype 0 = f32, 1 = bf16), planes
// [n_digits, K8, M] uint8, out [B, M] f32. `splits` >= 1 ranges of whole
// chunks; when it is above 1, `partial` is f32 [splits, B, M] scratch
// and `out` receives their sum. Returns the cudaError_t of the launches.
extern "C" int bitplane_gemv_launch(const void* x_r, const void* planes,
                                    void* out, void* partial, int x_dtype,
                                    int B, int K8, int M, int n_digits,
                                    int group, int splits, void* stream) {
  using namespace bitplane;
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_gemv_group<float>(group, x_r, planes, out, partial, B, K8,
                                    M, n_digits, splits, s);
  if (x_dtype == kBF16)
    return launch_gemv_group<__nv_bfloat16>(group, x_r, planes, out, partial,
                                            B, K8, M, n_digits, splits, s);
  return cudaErrorInvalidValue;
}
