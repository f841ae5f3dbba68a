// K3 — bit-plane GEMV for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/bitplane_gemv.py:_gemv_kernel
// (pallas_call in bitplane_gemv). Computes the raw contraction
//   out[b, m] = sum_q sum_r x_r[r, b, q] * U[q*8/g + r, m]      (f32)
// over the digit planes [n_d, K8, M] uint8, U being the unsigned offset
// form they store; the caller (ops.bitplane_matmul) subtracts
// 2^(n-1) * sum(x) and applies the per-channel scale. x_r [8/g, B, K8]
// is bf16 or f32.
//
// Design. The TPU kernel ran one MXU pass per (digit plane, digit row)
// and accumulated the K tiles over a sequential grid axis. Here each
// thread rebuilds U itself: it loads n_d plane words (4 neighbouring
// columns each, so a warp reads 128 contiguous bytes of every plane),
// transposes the digit matrix of each column in registers
// (bitplane_common.cuh) and spends one f32 FMA per (row, weight). A
// bf16 x times an integer U < 256 is exact in f32, so this is the
// reference's x @ U up to summation order.
//   * One CTA per (128-column tile, 8-row block of B); 8 warps, each lane
//     owning 4 columns and 8 rows of accumulators.
//   * The K loop stays inside the CTA, in chunks of 32 packed rows: the
//     chunk's x_r is staged in shared memory as f32, and warp w takes
//     rows w, w+8, ...; the 8 warps' partial sums are then added in a
//     fixed order. No atomics: repeated launches are bit-identical, and
//     a row's sum never depends on B (chunked and single-shot prefill
//     agree).
//   * Any K8 and M: rows past K8 and columns past M read as zero, rows
//     past B are never stored.
//
// Bound on an H100 SXM (3.35 TB/s). 2 B K M operations against
// n_d K8 M bytes of planes: at B = 8 decode rows and 8-bit weights that
// is 16 operations per byte, far below the ~295 at which the tensor
// cores would bind, so K3 is bound by the plane bytes (13.8 MB for a
// [1536 -> 8960] projection, ~4.1 us). What this simple design leaves on
// the table: few CTAs for narrow M (2 for M = 256), one 4-byte load per
// plane per lane with no cp.async / TMA pipeline, and for B > 8 every
// 8-row block streams the planes again (from L2).
#include "bitplane_common.cuh"

namespace bitplane {

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvTileM = 128;   // 32 lanes x 4 columns
constexpr int kGemvRows = 8;      // rows of B per CTA
constexpr int kGemvChunkQ = 32;   // packed K rows staged per chunk

template <typename XT, int G>
__global__ void __launch_bounds__(kGemvThreads) bitplane_gemv_kernel(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd, bool vec) {
  constexpr int DPB = 8 / G;
  __shared__ float x_s[DPB][kGemvRows][kGemvChunkQ];
  __shared__ float red_s[kGemvWarps][kGemvRows][kGemvTileM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile_m = blockIdx.x * kGemvTileM;
  const int m0 = tile_m + lane * 4;
  const int b0 = blockIdx.y * kGemvRows;

  float acc[kGemvRows][4];
#pragma unroll
  for (int b = 0; b < kGemvRows; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.0f;

  for (int qc = 0; qc < K8; qc += kGemvChunkQ) {
    __syncthreads();  // the previous chunk's x_s is no longer read
    for (int i = threadIdx.x; i < DPB * kGemvRows * kGemvChunkQ;
         i += kGemvThreads) {
      const int ql = i % kGemvChunkQ, b = (i / kGemvChunkQ) % kGemvRows;
      const int r = i / (kGemvChunkQ * kGemvRows);
      const int q = qc + ql, row = b0 + b;
      x_s[r][b][ql] =
          (q < K8 && row < B)
              ? to_f32(x_r[(static_cast<size_t>(r) * B + row) * K8 + q])
              : 0.0f;
    }
    __syncthreads();
    for (int ql = warp; ql < kGemvChunkQ && qc + ql < K8; ql += kGemvWarps) {
      uint32_t w[DPB];
      load_plane_words<G>(planes, qc + ql, K8, M, nd, m0, vec, w);
      uint64_t u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) u[c] = offset_weights<G>(w, c);
#pragma unroll
      for (int r = 0; r < DPB; ++r) {
        float uf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          uf[c] = static_cast<float>((u[c] >> (8 * r)) & 0xFFu);
#pragma unroll
        for (int b = 0; b < kGemvRows; ++b) {
          const float xv = x_s[r][b][ql];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][c] = fmaf(xv, uf[c], acc[b][c]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < kGemvRows; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) red_s[warp][b][lane * 4 + c] = acc[b][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kGemvRows * kGemvTileM; i += kGemvThreads) {
    const int b = i / kGemvTileM, ml = i % kGemvTileM;
    const int row = b0 + b, m = tile_m + ml;
    if (row >= B || m >= M) continue;
    float s = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kGemvWarps; ++wp) s += red_s[wp][b][ml];
    out[static_cast<size_t>(row) * M + m] = s;
  }
}

template <typename XT, int G>
cudaError_t launch_gemv(const void* x_r, const void* planes, void* out,
                        int B, int K8, int M, int nd, cudaStream_t stream) {
  const dim3 grid((M + kGemvTileM - 1) / kGemvTileM,
                  (B + kGemvRows - 1) / kGemvRows);
  bitplane_gemv_kernel<XT, G><<<grid, kGemvThreads, 0, stream>>>(
      static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes),
      static_cast<float*>(out), B, K8, M, nd, rows_aligned(planes, M));
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_gemv_group(int group, const void* x_r, const void* planes,
                              void* out, int B, int K8, int M, int nd,
                              cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gemv<XT, 1>(x_r, planes, out, B, K8, M, nd, stream);
    case 2: return launch_gemv<XT, 2>(x_r, planes, out, B, K8, M, nd, stream);
    case 4: return launch_gemv<XT, 4>(x_r, planes, out, B, K8, M, nd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bitplane

// C interface (kernels/bitplane_gemv.py). Pointers are device pointers:
// x_r [8/group, B, K8] (x_dtype 0 = f32, 1 = bf16), planes
// [n_digits, K8, M] uint8, out [B, M] f32. Returns the cudaError_t of the
// launch.
extern "C" int bitplane_gemv_launch(const void* x_r, const void* planes,
                                    void* out, int x_dtype, int B, int K8,
                                    int M, int n_digits, int group,
                                    void* stream) {
  using namespace bitplane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_gemv_group<float>(group, x_r, planes, out, B, K8, M,
                                    n_digits, s);
  if (x_dtype == kBF16)
    return launch_gemv_group<__nv_bfloat16>(group, x_r, planes, out, B, K8,
                                            M, n_digits, s);
  return cudaErrorInvalidValue;
}
