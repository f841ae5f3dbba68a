// K4 — bit-plane GEMM for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/bitplane_gemm.py:_gemm_kernel
// (pallas_call in bitplane_gemm): the same raw contraction as K3,
//   out[b, m] = sum_q sum_r x_r[r, b, q] * U[q*8/g + r, m]      (f32),
// for the tall activations of a prefill (ops.bitplane_matmul takes it
// when B > 512). x_r [8/g, B, K8] bf16 or f32, planes [n_d, K8, M] uint8.
//
// Design. A classic shared-memory tiled GEMM over (B, M) with the K loop
// inside the CTA, in place of the TPU's (B, M, K) grid whose sequential
// K axis accumulated in VMEM.
//   * CTA tile 64 rows x 128 columns, 256 threads, each owning an 8 x 4
//     register tile of accumulators.
//   * Per K chunk of 32 unpacked rows, the CTA stages x (as f32, k-major)
//     and U (as f32): threads load 4-column plane words, rebuild U in
//     registers by transposing each column's digit matrix
//     (bitplane_common.cuh) and store it, so the inner loop is plain f32
//     FMAs from shared memory. bf16 x times an integer U < 256 is exact
//     in f32: only the summation order differs from the reference.
//   * Each output is summed by one thread in a fixed k order: no
//     atomics, bit-identical repeats, and a row's result does not depend
//     on B.
//   * Any B, K8 and M: rows, packed rows and columns past the edge read
//     as zero and are never stored.
//
// Bound on an H100 SXM. 2 B K M operations: at B = 768 prefill rows
// against a [1536 -> 8960] projection that is 21 GFLOP for 13.8 MB of
// planes, ~1,500 operations per byte, so K4 is bound by operations
// (~21 us at the 989 TFLOP/s bf16 tensor-core rate). This design runs
// on the f32 CUDA cores (67 TFLOP/s peak) and re-decodes U once per
// 64-row block, so it cannot come near that bound; a wgmma kernel fed by
// decoded bf16 (or int8) tiles is the later step.
#include "bitplane_common.cuh"

namespace bitplane {

constexpr int kGemmThreads = 256;
constexpr int kGemmTileB = 64;    // 8 row groups x 8 rows
constexpr int kGemmTileM = 128;   // 32 column groups x 4 columns
constexpr int kGemmChunkK = 32;   // unpacked K rows staged per chunk
constexpr int kGemmLdX = kGemmTileB + 1;

template <typename XT, int G>
__global__ void __launch_bounds__(kGemmThreads) bitplane_gemm_kernel(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd, bool vec) {
  constexpr int DPB = 8 / G;
  constexpr int QC = kGemmChunkK / DPB;  // packed rows per chunk
  __shared__ float x_s[kGemmChunkK][kGemmLdX];          // [k][b]
  __shared__ __align__(16) float u_s[kGemmChunkK][kGemmTileM];  // [k][m]
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int b0 = blockIdx.y * kGemmTileB, m_tile = blockIdx.x * kGemmTileM;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int qc = 0; qc < K8; qc += QC) {
    __syncthreads();  // the previous chunk is no longer read
    // x: k = ql * DPB + r holds x_r[r, b0 + b, qc + ql]
    for (int i = threadIdx.x; i < kGemmChunkK * kGemmTileB;
         i += kGemmThreads) {
      const int ql = i % QC, r = (i / QC) % DPB, b = i / kGemmChunkK;
      const int q = qc + ql, row = b0 + b;
      x_s[ql * DPB + r][b] =
          (q < K8 && row < B)
              ? to_f32(x_r[(static_cast<size_t>(r) * B + row) * K8 + q])
              : 0.0f;
    }
    // U: one (packed row, 4-column group) per task
    for (int i = threadIdx.x; i < QC * (kGemmTileM / 4); i += kGemmThreads) {
      const int mg = i % (kGemmTileM / 4), ql = i / (kGemmTileM / 4);
      const int q = qc + ql;
      uint32_t w[DPB];
      if (q < K8) {
        load_plane_words<G>(planes, q, K8, M, nd, m_tile + mg * 4, vec, w);
      } else {
#pragma unroll
        for (int j = 0; j < DPB; ++j) w[j] = 0u;
      }
      uint64_t u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) u[c] = offset_weights<G>(w, c);
#pragma unroll
      for (int r = 0; r < DPB; ++r) {
        float4 v;
        v.x = static_cast<float>((u[0] >> (8 * r)) & 0xFFu);
        v.y = static_cast<float>((u[1] >> (8 * r)) & 0xFFu);
        v.z = static_cast<float>((u[2] >> (8 * r)) & 0xFFu);
        v.w = static_cast<float>((u[3] >> (8 * r)) & 0xFFu);
        *reinterpret_cast<float4*>(&u_s[ql * DPB + r][mg * 4]) = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kGemmChunkK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&u_s[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = x_s[kk][ty * 8 + i];
        acc[i][0] = fmaf(a, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a, bv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = b0 + ty * 8 + i;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m_tile + tx * 4 + c;
      if (m < M) out[static_cast<size_t>(row) * M + m] = acc[i][c];
    }
  }
}

template <typename XT, int G>
cudaError_t launch_gemm(const void* x_r, const void* planes, void* out,
                        int B, int K8, int M, int nd, cudaStream_t stream) {
  const dim3 grid((M + kGemmTileM - 1) / kGemmTileM,
                  (B + kGemmTileB - 1) / kGemmTileB);
  bitplane_gemm_kernel<XT, G><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes),
      static_cast<float*>(out), B, K8, M, nd, rows_aligned(planes, M));
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_gemm_group(int group, const void* x_r, const void* planes,
                              void* out, int B, int K8, int M, int nd,
                              cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gemm<XT, 1>(x_r, planes, out, B, K8, M, nd, stream);
    case 2: return launch_gemm<XT, 2>(x_r, planes, out, B, K8, M, nd, stream);
    case 4: return launch_gemm<XT, 4>(x_r, planes, out, B, K8, M, nd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bitplane

// C interface (kernels/bitplane_gemm.py): the same operands as
// bitplane_gemv_launch. Returns the cudaError_t of the launch.
extern "C" int bitplane_gemm_launch(const void* x_r, const void* planes,
                                    void* out, int x_dtype, int B, int K8,
                                    int M, int n_digits, int group,
                                    void* stream) {
  using namespace bitplane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_gemm_group<float>(group, x_r, planes, out, B, K8, M,
                                    n_digits, s);
  if (x_dtype == kBF16)
    return launch_gemm_group<__nv_bfloat16>(group, x_r, planes, out, B, K8,
                                            M, n_digits, s);
  return cudaErrorInvalidValue;
}
