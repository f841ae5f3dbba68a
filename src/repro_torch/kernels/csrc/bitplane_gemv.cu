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

#include "bitplane_common.cuh"
#include "tensor_core.cuh"

namespace bitplane {

constexpr int kGemvThreads = 64;  // 2 warps, each 16 columns of the tile
constexpr int kGemvTileM = 32;
constexpr int kGemvTileB = 64;    // most rows of B per CTA (8 n-tiles)
constexpr int kGemvChunkK = 64;   // unpacked K rows per chunk
constexpr int kGemvStages = 5;    // chunks in the cp.async ring
constexpr int kGemvLdX = kGemvChunkK + 8;  // elements per staged x row
constexpr int kGemvLdU = kGemvTileM + 8;   // bf16 per staged U row
// plane bytes of one chunk: (8/g planes at most) x 8g packed rows x 32
constexpr int kGemvPlaneBytes = 8 * 8 * kGemvTileM;
constexpr int kGemvUBytes = 2 * kGemvChunkK * kGemvLdU;

// Shared memory of a launch whose CTAs stage `bt` rows of x: the ring,
// then two U buffers.
template <typename XT>
inline size_t gemv_smem(int bt) {
  return kGemvStages *
             (kGemvPlaneBytes + sizeof(XT) * static_cast<size_t>(bt) *
                                    kGemvLdX) +
         2 * kGemvUBytes;
}

// Bytes c and c + 1 of x, integers < 256 and so exact in bf16, as one
// bf16x2 register: each is the f32 2^23 + v minus 2^23, whose top 16
// bits are v's bf16.
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t x, int c) {
  const float f0 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + c)) - 8388608.0f;
  const float f1 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541 + c)) - 8388608.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

template <typename XT, int G>
__global__ void __launch_bounds__(kGemvThreads) bitplane_gemv_kernel(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd,
    int chunks_per_split, int bt, bool x_vec, bool p_vec) {
  constexpr int DPB = 8 / G;   // digit rows per packed row
  constexpr int QC = 8 * G;    // packed rows per chunk
  constexpr int NX = tc::Terms<XT>::n;
  constexpr int LDX = kGemvLdX, LDU = kGemvLdU, TM = kGemvTileM;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage_bytes =
      kGemvPlaneBytes + sizeof(XT) * static_cast<size_t>(bt) * LDX;
  auto p_slot = [&](int i) { return smem + (i % kGemvStages) * stage_bytes; };
  auto x_slot = [&](int i) {
    return reinterpret_cast<XT*>(p_slot(i) + kGemvPlaneBytes);
  };
  auto u_buf = [&](int i) {
    return reinterpret_cast<uint16_t*>(smem + kGemvStages * stage_bytes) +
           (i & 1) * kGemvChunkK * LDU;
  };

  const int m0 = blockIdx.x * TM, b0 = blockIdx.y * kGemvTileB;
  const int rows = min(bt, B - b0);
  const int nb = (rows + 7) / 8;  // n-tiles of 8 rows in use
  const int n_chunks = (K8 + QC - 1) / QC;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int n = max(0, min(n_chunks, c_begin + chunks_per_split) - c_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;

  // Stage chunk i of this range: p_s[(j * QC + ql) * TM + c] = planes[j,
  // q0 + ql, m0 + c] and x_s[b * LDX + r * QC + ql] = x_r[r, b0 + b,
  // q0 + ql], zero past every edge; one cp.async group (maybe empty).
  auto stage = [&](int i) {
    if (i < n) {
      const int q0 = (c_begin + i) * QC;
      uint8_t* p_s = p_slot(i);
      if (p_vec) {
        for (int idx = threadIdx.x; idx < nd * QC * (TM / 16);
             idx += kGemvThreads) {
          const int p = idx % (TM / 16), ql = (idx / (TM / 16)) % QC;
          const int j = idx / (QC * (TM / 16));
          const int q = q0 + ql, m = m0 + p * 16;
          const bool ok = q < K8 && m < M;
          tc::cp_async16(
              p_s + (j * QC + ql) * TM + p * 16,
              ok ? planes + (static_cast<size_t>(j) * K8 + q) * M + m : planes,
              ok ? 16 : 0);
        }
      } else {
        for (int idx = threadIdx.x; idx < nd * QC * TM; idx += kGemvThreads) {
          const int c = idx % TM, ql = (idx / TM) % QC, j = idx / (TM * QC);
          const int q = q0 + ql, m = m0 + c;
          p_s[(j * QC + ql) * TM + c] =
              (q < K8 && m < M)
                  ? planes[(static_cast<size_t>(j) * K8 + q) * M + m]
                  : 0;
        }
      }
      XT* x_s = x_slot(i);
      if (x_vec) {
        constexpr int E = 16 / sizeof(XT);  // elements per 16-byte piece
        constexpr int PPS = QC / E;         // pieces per (b, r) segment
        for (int idx = threadIdx.x; idx < nb * 8 * DPB * PPS;
             idx += kGemvThreads) {
          const int p = idx % PPS, r = (idx / PPS) % DPB;
          const int b = idx / (PPS * DPB);
          const int q = q0 + p * E;
          const bool ok = b < rows && q < K8;
          tc::cp_async16(
              x_s + b * LDX + r * QC + p * E,
              ok ? x_r + (static_cast<size_t>(r) * B + b0 + b) * K8 + q : x_r,
              ok ? 16 : 0);
        }
      } else {
        for (int idx = threadIdx.x; idx < nb * 8 * kGemvChunkK;
             idx += kGemvThreads) {
          const int ql = idx % QC, r = (idx / QC) % DPB;
          const int b = idx / kGemvChunkK, q = q0 + ql;
          x_s[b * LDX + r * QC + ql] =
              (b < rows && q < K8)
                  ? x_r[(static_cast<size_t>(r) * B + b0 + b) * K8 + q]
                  : XT(0.0f);
        }
      }
    }
    tc::cp_async_commit();
  };

  // Decode chunk i into U rows r * QC + ql (bf16 [k][m]): a task is one
  // packed row ql x 4 columns, g tasks a thread; a warp's 32 tasks read
  // 4 whole 32-byte plane rows.
  auto decode = [&](int i) {
    const uint8_t* p_s = p_slot(i);
    uint16_t* u_s = u_buf(i);
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int task = threadIdx.x + t * kGemvThreads;
      const int ql = task / (TM / 4), mg = task % (TM / 4);
      uint32_t w[DPB];
#pragma unroll
      for (int j = 0; j < DPB; ++j)
        w[j] = j < nd ? *reinterpret_cast<const uint32_t*>(
                            p_s + (j * QC + ql) * TM + mg * 4)
                      : 0u;
      transpose_digit_words<G>(w);
#pragma unroll
      for (int r = 0; r < DPB; ++r) {
        uint2 v;
        v.x = bytes_to_bf16x2(w[r], 0);
        v.y = bytes_to_bf16x2(w[r], 2);
        *reinterpret_cast<uint2*>(u_s + (r * QC + ql) * LDU + mg * 4) = v;
      }
    }
  };

  float acc[8][4];  // [n-tile][fragment]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  // This warp's 16 columns x the tile's rows over chunk i: the chunk's
  // 4 k-steps go into a fresh accumulator, then into acc.
  auto multiply = [&](int i) {
    const XT* x_s = x_slot(i);
    const uint16_t* u_s = u_buf(i);
    float t[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[nt][e] = 0.0f;
#pragma unroll
    for (int kp = 0; kp < kGemvChunkK / 16; kp += 2) {
      uint32_t a[2][4];  // U^T fragments of k-steps kp and kp + 1
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        tc::ldmatrix_x4_trans(
            a[kk], u_s + ((kp + kk) * 16 + (lane >> 4) * 8 + (lane & 7)) * LDU +
                       warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nb) break;
        uint32_t b[2][2][NX];  // [k-step][b0, b1][term]
        if constexpr (NX == 1) {
          // rows nt * 8 + lane % 8, k columns (lane / 8) * 8 of the pair
          uint32_t r[4];
          tc::ldmatrix_x4(r, x_s + (nt * 8 + (lane & 7)) * LDX + kp * 16 +
                                 (lane >> 3) * 8);
          b[0][0][0] = r[0];
          b[0][1][0] = r[1];
          b[1][0][0] = r[2];
          b[1][1][0] = r[3];
        } else {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const XT* xr =
                x_s + (nt * 8 + grp) * LDX + (kp + kk) * 16 + 2 * tig;
            tc::load_pair(xr, b[kk][0]);
            tc::load_pair(xr + 8, b[kk][1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int term = 0; term < NX; ++term)
            tc::mma_bf16(t[nt], a[kk], b[kk][0][term], b[kk][1][term]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += t[nt][e];
  };

  // Step i multiplies chunk i (U buffer i % 2) after decoding chunk i + 1
  // into the other buffer; chunks i + 2 .. i + 4 are in flight. Waiting
  // for all but the newest 2 groups gives step i chunk i + 1.
  for (int s = 0; s < kGemvStages - 1; ++s) stage(s);
  tc::cp_async_wait<kGemvStages - 2>();
  __syncthreads();
  if (n > 0) decode(0);
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<kGemvStages - 3>();
    __syncthreads();  // chunk i + 1 landed for all; step i - 1 is done
    stage(i + kGemvStages - 1);  // into the slot of chunk i - 1
    if (i + 1 < n) decode(i + 1);
    multiply(i);
  }
  tc::cp_async_wait<0>();

  // D fragment: rows = columns m of this warp, columns = rows b
  float* dst = out + static_cast<size_t>(blockIdx.z) * B * M;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nb) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + warp * 16 + grp + 8 * (e >> 1);
      const int b = nt * 8 + 2 * tig + (e & 1);
      if (m < M && b < rows)
        dst[static_cast<size_t>(b0 + b) * M + m] = acc[nt][e];
    }
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
