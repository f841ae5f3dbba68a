// K4 — bit-plane GEMM on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/bitplane_gemm.py:_gemm_kernel
// (pallas_call in bitplane_gemm): the same raw contraction as K3,
//   out[b, m] = sum_q sum_r x_r[r, b, q] * U[q*8/g + r, m]      (f32),
// for the tall activations of a prefill (ops.bitplane_matmul takes it
// when B > 512). x_r [8/g, B, K8] bf16 or f32, planes [n_d, K8, M] uint8.
//
// Bound on an H100 SXM. 2 B K M operations: at B = 768 prefill rows
// against a [1536 -> 8960] projection that is 21 GFLOP for 13.8 MB of
// planes, ~1,500 operations per byte, so K4 is bound by operations:
// ~21 us at the 989 TFLOP/s bf16 tensor-core rate. What a dense bf16
// GEMM does not have to do is rebuild U from its digit planes, once per
// column tile and K chunk in every CTA. On the H100 each of the three
// parts (staging x and planes, decoding U, the MMAs) is a large share of
// the kernel's time, so the design overlaps them.
//
// Design.
//   * CTA tile 128 rows of B x 128 columns of M, 256 threads (8 warps,
//     4 along B x 2 along M, each warp 32 x 64); two CTAs share an SM
//     (106 KB of shared memory and <= 128 registers each, bf16 x).
//   * K is walked in chunks of 64 unpacked rows, two chunks to a pair.
//     Pair p covers the 16*g packed rows from p * 16g; chunk 2p takes
//     their digit rows r < 4/g, chunk 2p + 1 the rest, and k inside a
//     chunk is (r mod 4/g) * 16g + q_local, the order of x_r. A chunk
//     of x is then 16*g consecutive elements per (row, r): a whole
//     32-byte sector of bf16 x at g = 1, which 8 would only half use.
//   * One barrier per chunk. Step i multiplies chunk i while each warp,
//     before its products, decodes chunk i + 1 into the other of two U
//     buffers; x of chunks i + 1 and i + 2 (three x slots) and, at even
//     i, the next pair's planes (one slot) arrive meanwhile by 16-byte
//     cp.async. Shapes whose rows are not 16-byte aligned (a ragged K8
//     or M) are staged by plain loads into the same slots.
//   * Decoding writes U as bf16 (U < 256 is exact), row-major [k][m].
//     It uses transpose_digit_words (bitplane_common.cuh), the form of
//     transpose_digits that transposes the digit matrices of four
//     columns at once across the n_d plane words (a few shifts and
//     masks per weight, against a dozen for offset_weights' one column
//     at a time). The even chunk of a pair transposes the pair's
//     words, stores its half and keeps the other half in registers for
//     the odd chunk.
//   * Products run as mma.sync.m16n8k16 (bf16 x bf16 -> f32), A
//     fragments by ldmatrix from x and B fragments by ldmatrix.trans
//     from the U tile, rows padded so that neither conflicts on a bank.
//     mma.sync rather than wgmma: the MMAs are one of three parts of
//     like size, and the warp-level MMA needs none of wgmma's swizzled
//     descriptor layouts for a B operand that the CTA writes itself.
//   * f32 x is split in registers into three bf16 terms (hi + mid + lo
//     == x exactly, tensor_core.cuh), each multiplied against the same
//     U fragment: every product stays exact, only the summation order
//     differs from the plain f32 contraction.
//   * The tensor core truncates when it accumulates, so one chain of
//     MMAs along a deep K drifts: 1.6e-5 of max|raw| with f32's three
//     terms per k-step over K = 8960, and 3.0e-5 with bf16 x over
//     K = 21504 (gemma3-27b's w_down), against a 1e-5 bound
//     (tests/test_torch_gpu.py on the H100). Each output tile therefore
//     sums every 2 k-steps (x 3 terms for f32 x) in a fresh MMA
//     accumulator and adds that to its f32 sum with an ordinary
//     (round-to-nearest) add, whatever the type of x.
//   * Filling the card: 128 x 128 tiles give B/128 x M/128 CTAs, too
//     few for the narrow [1536 -> 256] and [8960 -> 1536] projections,
//     so the caller may split K into `splits` ranges of whole pairs
//     (kernels/bitplane_gemm.py:gemm_splits, a function of K8 and M
//     only). Each range writes its own f32 partial [B, M]; a second
//     kernel adds the partials in split order. No atomics: repeated
//     launches are bit-identical and a row's result does not depend on
//     B (rows never mix in an MMA, and the split points do not move
//     with B).
//   * Any B, K8 and M: rows, packed rows and columns past the edge are
//     staged as zero and never stored.
#include <algorithm>

#include "bitplane_common.cuh"
#include "tensor_core.cuh"

namespace bitplane {

constexpr int kGemmThreads = 256;
constexpr int kGemmTileB = 128;
constexpr int kGemmTileM = 128;
constexpr int kGemmChunkK = 64;              // unpacked K rows per chunk
constexpr int kGemmLdU = kGemmTileM + 8;     // bf16 per staged U row
constexpr int kGemmLdP = kGemmTileM + 16;    // bytes per staged plane row

// Chunks come in pairs that share their packed rows: pair p holds the
// QP = 16*g packed rows from p * QP, chunk 2p their digit rows r < 4/g
// (the lower half of the 8/g), chunk 2p + 1 the upper half. So a chunk
// still has 64 unpacked rows, k = (r mod (4/g)) * QP + q_local, but each
// (row of x, r) segment it stages is 16*g consecutive elements: a whole
// 32-byte sector of bf16 x at g = 1, where 8 would waste half of it.
template <int G>
struct Pair {
  static constexpr int DPB = 8 / G;   // digit rows per packed row
  static constexpr int RH = DPB / 2;  // ... per chunk
  static constexpr int QP = 16 * G;   // packed rows per pair
};

// Three slots of x (one chunk each), one of plane bytes (one pair) and
// two of decoded U (one chunk each): 106 KB for bf16 x, so two blocks
// share an SM.
template <typename XT>
struct GemmSmem {
  static constexpr int kLdX = kGemmChunkK + 8;  // elements per x row
  static constexpr size_t x_bytes = sizeof(XT) * kGemmTileB * kLdX;
  // n_d * QP <= (8/g) * 16g = 128 plane rows per pair
  static constexpr size_t p_bytes = 2 * kGemmChunkK * kGemmLdP;
  static constexpr size_t u_bytes = 2 * kGemmChunkK * kGemmLdU;
  static constexpr size_t total = 3 * x_bytes + p_bytes + 2 * u_bytes;
};

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.0f);
}

// Stage chunk c of x: x_s[b][rl * QP + ql] = x_r[r, b0 + b, q0 + ql] for
// r = (c % 2) * RH + rl, q0 = (c / 2) * QP; zero past every edge.
template <typename XT, int G>
__device__ void gemm_stage_x(const XT* __restrict__ x_r, int B, int K8,
                             int b0, int c, XT* x_s, bool x_vec) {
  using P = Pair<G>;
  constexpr int LDX = GemmSmem<XT>::kLdX;
  const int r0 = (c & 1) * P::RH, q0 = (c >> 1) * P::QP;
  if (x_vec) {
    constexpr int E = 16 / sizeof(XT);  // elements per 16-byte piece
    constexpr int PPS = P::QP / E;      // pieces per (b, r) segment
#pragma unroll 1
    for (int i = threadIdx.x; i < kGemmTileB * P::RH * PPS;
         i += kGemmThreads) {
      const int p = i % PPS, rl = (i / PPS) % P::RH, b = i / (PPS * P::RH);
      const int row = b0 + b, q = q0 + p * E;
      const bool ok = row < B && q < K8;
      const XT* src =
          ok ? x_r + (static_cast<size_t>(r0 + rl) * B + row) * K8 + q : x_r;
      tc::cp_async16(x_s + b * LDX + rl * P::QP + p * E, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < kGemmTileB * kGemmChunkK;
         i += kGemmThreads) {
      const int ql = i % P::QP, rl = (i / P::QP) % P::RH,
                b = i / kGemmChunkK;
      const int row = b0 + b, q = q0 + ql;
      x_s[b * LDX + rl * P::QP + ql] =
          (row < B && q < K8)
              ? x_r[(static_cast<size_t>(r0 + rl) * B + row) * K8 + q]
              : zero_of(XT());
    }
  }
}

// Stage pair p of the planes: p_s[(j * QP + ql) * kGemmLdP + c] =
// planes[j, p * QP + ql, m0 + c], zero past every edge.
template <int G>
__device__ void gemm_stage_planes(const uint8_t* __restrict__ planes,
                                  int K8, int M, int nd, int m0, int pair,
                                  uint8_t* p_s, bool p_vec) {
  constexpr int QP = Pair<G>::QP;
  const int q0 = pair * QP;
  if (p_vec) {
    constexpr int PPR = kGemmTileM / 16;  // pieces per plane row
#pragma unroll 1
    for (int i = threadIdx.x; i < nd * QP * PPR; i += kGemmThreads) {
      const int p = i % PPR, ql = (i / PPR) % QP, j = i / (PPR * QP);
      const int q = q0 + ql, m = m0 + p * 16;
      const bool ok = q < K8 && m < M;
      const uint8_t* src =
          ok ? planes + (static_cast<size_t>(j) * K8 + q) * M + m : planes;
      tc::cp_async16(p_s + (j * QP + ql) * kGemmLdP + p * 16, src,
                     ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < nd * QP * kGemmTileM; i += kGemmThreads) {
      const int c = i % kGemmTileM, ql = (i / kGemmTileM) % QP,
                j = i / (kGemmTileM * QP);
      const int q = q0 + ql, m = m0 + c;
      p_s[(j * QP + ql) * kGemmLdP + c] =
          (q < K8 && m < M)
              ? planes[(static_cast<size_t>(j) * K8 + q) * M + m]
              : 0;
    }
  }
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

// Rows rl < RH of one decode task, U^T words w[rl] (byte = column), to
// dst + rl * stride as bf16.
template <int RH>
__device__ __forceinline__ void store_u_rows(const uint32_t* w, uint16_t* dst,
                                             int stride) {
#pragma unroll
  for (int rl = 0; rl < RH; ++rl) {
    uint2 v;
    v.x = bytes_to_bf16x2(w[rl], 0);
    v.y = bytes_to_bf16x2(w[rl], 2);
    *reinterpret_cast<uint2*>(dst + rl * stride) = v;
  }
}

// Decoding is split over a pair's two chunks. A thread owns 2g tasks of
// the pair, one packed row x 4 columns each. For chunk 2p it loads each
// task's n_d plane words, transposes them (bitplane_common.cuh), stores
// the lower half of the 8/g rows as bf16, u_s[rl * QP + ql][m] =
// U[(q0 + ql) * 8/g + rl, m0 + m], and keeps the upper half (2g x 4/g =
// 8 words) in `carry`; for chunk 2p + 1 it stores `carry`.
template <int G>
struct Decode {
  using P = Pair<G>;
  static constexpr int kTasks = P::QP * (kGemmTileM / 4) / kGemmThreads;

  // a warp takes 8 packed rows x 4 column groups: no bank conflicts
  static __device__ __forceinline__ uint16_t* row0(uint16_t* u_s, int t) {
    const int i = threadIdx.x + t * kGemmThreads;
    return u_s + (i % 8 + 8 * (i / 256)) * kGemmLdU + (i / 8 % 32) * 4;
  }

  static __device__ void first(const uint8_t* p_s, int nd, uint16_t* u_s,
                               uint32_t (&carry)[8]) {
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      const int i = threadIdx.x + t * kGemmThreads;
      const int ql = i % 8 + 8 * (i / 256), mg = i / 8 % 32;
      uint32_t w[P::DPB];
#pragma unroll
      for (int j = 0; j < P::DPB; ++j)
        w[j] = j < nd ? *reinterpret_cast<const uint32_t*>(
                            p_s + (j * P::QP + ql) * kGemmLdP + mg * 4)
                      : 0u;
      transpose_digit_words<G>(w);
      store_u_rows<P::RH>(w, row0(u_s, t), P::QP * kGemmLdU);
#pragma unroll
      for (int rl = 0; rl < P::RH; ++rl) carry[t * P::RH + rl] = w[P::RH + rl];
    }
  }

  static __device__ void second(const uint32_t (&carry)[8], uint16_t* u_s) {
#pragma unroll
    for (int t = 0; t < kTasks; ++t)
      store_u_rows<P::RH>(carry + t * P::RH, row0(u_s, t), P::QP * kGemmLdU);
  }
};

// acc[mt][nt] += x tile (this warp's 32 rows) x U tile (its 64 columns)
// over the staged chunk, two k-steps at a time (one ldmatrix.trans gives
// the B fragments of both). Each (mt, nt) sums the 2 k-steps (x 3 terms
// for f32 x) in a fresh MMA accumulator, added to acc with an ordinary
// f32 add: the tensor core truncates when it accumulates, and a chain as
// long as K drifts past the bound.
template <typename XT>
__device__ __forceinline__ void gemm_mma(const XT* x_s, const uint16_t* u_s,
                                         float (&acc)[2][8][4], int wm,
                                         int wn, int lane) {
  constexpr int NX = tc::Terms<XT>::n;
  constexpr int LDX = GemmSmem<XT>::kLdX;
  const int grp = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kp = 0; kp < kGemmChunkK / 16; kp += 2) {
    uint32_t a[2][2][NX][4];  // [mt][k-step of the pair][term]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int row = wm * 32 + mt * 16, k = (kp + kk) * 16;
        if constexpr (NX == 1) {
          tc::ldmatrix_x4(a[mt][kk][0], x_s + (row + (lane & 15)) * LDX + k +
                                            (lane >> 4) * 8);
        } else {
          const XT* r0 = x_s + (row + grp) * LDX + k + 2 * tig;
          const XT* r1 = r0 + 8 * LDX;
          uint32_t t[4][NX];
          tc::load_pair(r0, t[0]);
          tc::load_pair(r1, t[1]);
          tc::load_pair(r0 + 8, t[2]);
          tc::load_pair(r1 + 8, t[3]);
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][kk][i][e] = t[e][i];
        }
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // r = {b0, b1} of k-step kp, then {b0, b1} of k-step kp + 1
      uint32_t r[4];
      tc::ldmatrix_x4_trans(
          r, u_s + (kp * 16 + (lane >> 3) * 8 + (lane & 7)) * kGemmLdU +
                 wn * 64 + nt * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          tc::mma_bf16(t, a[mt][0][i], r[0], r[1]);
          tc::mma_bf16(t, a[mt][1][i], r[2], r[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
      }
    }
  }
}

template <typename XT, int G>
__global__ void __launch_bounds__(kGemmThreads, sizeof(XT) == 2 ? 2 : 1)
    bitplane_gemm_kernel(const XT* __restrict__ x_r,
                         const uint8_t* __restrict__ planes,
                         float* __restrict__ out, int B, int K8, int M,
                         int nd, int pairs_per_split, bool x_vec,
                         bool p_vec) {
  using S = GemmSmem<XT>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto x_slot = [&](int c) {
    return reinterpret_cast<XT*>(smem + (c % 3) * S::x_bytes);
  };
  uint8_t* p_s = smem + 3 * S::x_bytes;
  auto u_buf = [&](int c) {
    return reinterpret_cast<uint16_t*>(smem + 3 * S::x_bytes + S::p_bytes +
                                       (c & 1) * S::u_bytes);
  };

  const int m0 = blockIdx.x * kGemmTileM, b0 = blockIdx.y * kGemmTileB;
  const int n_pairs = (K8 + Pair<G>::QP - 1) / Pair<G>::QP;
  const int p_begin = blockIdx.z * pairs_per_split;
  // chunks c_begin .. c_begin + n of the K walk, two per pair
  const int c_begin = 2 * p_begin;
  const int n = 2 * max(0, min(n_pairs, p_begin + pairs_per_split) - p_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4, grp = lane / 4, tig = lane % 4;
  auto stage_x = [&](int i) {
    if (i < n)
      gemm_stage_x<XT, G>(x_r, B, K8, b0, c_begin + i, x_slot(i), x_vec);
    tc::cp_async_commit();
  };
  auto stage_planes = [&](int i) {  // the pair of chunk i
    if (i < n)
      gemm_stage_planes<G>(planes, K8, M, nd, m0, (c_begin + i) >> 1, p_s,
                           p_vec);
    tc::cp_async_commit();
  };
  uint32_t carry[8];
  auto decode = [&](int i) {
    if (i & 1)
      Decode<G>::second(carry, u_buf(i));
    else
      Decode<G>::first(p_s, nd, u_buf(i), carry);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // Step i multiplies chunk i (x slot i % 3, U buffer i % 2) and decodes
  // chunk i + 1 into the other U buffer. In flight meanwhile: the x of
  // chunks i + 1 and i + 2, and at even i the planes of the next pair.
  // Each step commits its planes (maybe none) and then its x as two
  // cp.async groups, so waiting for all but the newest group gives step
  // i the x of chunk i (issued at step i - 2) and the planes that
  // chunk i + 1 may need (step i - 1). One barrier a step; past it,
  // warps overlap one chunk's decode with another's products.
  stage_planes(0);
  stage_x(0);
  stage_x(1);
  tc::cp_async_wait<1>();
  __syncthreads();
  if (n > 0) decode(0);
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<1>();
    __syncthreads();  // ... landed for all; step i - 1 is done
    stage_planes((i & 1) == 0 ? i + 2 : n);  // the pair decode(i+1) freed
    stage_x(i + 2);                           // the slot of chunk i - 1
    if (i + 1 < n) decode(i + 1);
    gemm_mma<XT>(x_slot(i), u_buf(i), acc, wm, wn, lane);
  }
  tc::cp_async_wait<0>();

  float* dst = out + static_cast<size_t>(blockIdx.z) * B * M;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = m0 + wn * 64 + nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = b0 + wm * 32 + mt * 16 + grp + 8 * h;
        if (row >= B) continue;
        float* o = dst + static_cast<size_t>(row) * M;
        if (col < M) o[col] = acc[mt][nt][2 * h];
        if (col + 1 < M) o[col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// out[i] = sum over s = 0 .. splits-1, in that order, of part[s][i].
__global__ void split_sum_kernel(const float* __restrict__ part,
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
cudaError_t launch_gemm(const void* x_r, const void* planes, void* out,
                        void* partial, int B, int K8, int M, int nd,
                        int splits, cudaStream_t stream) {
  const int n_pairs = (K8 + Pair<G>::QP - 1) / Pair<G>::QP;
  const int per = (n_pairs + splits - 1) / splits;
  auto kernel = bitplane_gemm_kernel<XT, G>;
  const size_t smem = GemmSmem<XT>::total;
  cudaError_t err = tc::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool x_vec = reinterpret_cast<uintptr_t>(x_r) % 16 == 0 &&
                     K8 % (16 / static_cast<int>(sizeof(XT))) == 0;
  const bool p_vec =
      reinterpret_cast<uintptr_t>(planes) % 16 == 0 && M % 16 == 0;
  const dim3 grid((M + kGemmTileM - 1) / kGemmTileM,
                  (B + kGemmTileB - 1) / kGemmTileB, splits);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  kernel<<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const XT*>(x_r), static_cast<const uint8_t*>(planes), dst,
      B, K8, M, nd, per, x_vec, p_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * M;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  split_sum_kernel<<<blocks, 256, 0, stream>>>(dst, static_cast<float*>(out),
                                               n, splits);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_gemm_group(int group, const void* x_r, const void* planes,
                              void* out, void* partial, int B, int K8, int M,
                              int nd, int splits, cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gemm<XT, 1>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    case 2: return launch_gemm<XT, 2>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    case 4: return launch_gemm<XT, 4>(x_r, planes, out, partial, B, K8, M,
                                      nd, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bitplane

// C interface (kernels/bitplane_gemm.py): K3's operands plus the K
// split. `splits` >= 1 ranges of whole chunks; when it is above 1,
// `partial` is f32 [splits, B, M] scratch and `out` receives their sum.
// Returns the cudaError_t of the launches.
extern "C" int bitplane_gemm_launch(const void* x_r, const void* planes,
                                    void* out, void* partial, int x_dtype,
                                    int B, int K8, int M, int n_digits,
                                    int group, int splits, void* stream) {
  using namespace bitplane;
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_gemm_group<float>(group, x_r, planes, out, partial, B, K8,
                                    M, n_digits, splits, s);
  if (x_dtype == kBF16)
    return launch_gemm_group<__nv_bfloat16>(group, x_r, planes, out, partial,
                                            B, K8, M, n_digits, splits, s);
  return cudaErrorInvalidValue;
}
