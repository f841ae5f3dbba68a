// The tile of K3 (bitplane_gemv.cu) as a device function, shared with K6
// (bitplane_grouped.cu): one CTA of 2 warps multiplies 32 columns of the
// digit planes by up to 64 rows of x over one range of K, staging plane
// rows and x rows through a cp.async ring, decoding U from the planes into
// shared memory once per chunk, and multiplying with mma.sync (design and
// numerics in bitplane_gemv.cu's header). A row's result depends only on
// its own x, the planes, and the K split: never on the other rows of the
// tile, on B, or on where the row sits in x. K6 relies on that to equal K3
// bit for bit on each expert.
#pragma once

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

// One CTA's work: the 32 columns from m0 of rows [b0, b0 + rows) of x_r
// [8/g, B, K8] against planes [n_d, K8, M]. K is cut into ranges of
// `chunks_per_split` chunks. Without SERIAL (K3) the CTA walks range
// `split` and writes its sum into out + split * B * M (the partial of
// that range, or out itself when there is one range); a second kernel
// adds the partials in order. With SERIAL (K6) the CTA walks every range
// in order, each from a fresh accumulator, and adds the ranges' sums in
// that order into out: the same operations on the same values as the
// partials and their sum, with no scratch. `bt` (>= rows) sizes the x
// ring; it moves no arithmetic.
template <typename XT, int G, bool SERIAL = false>
__device__ __forceinline__ void gemv_tile(
    const XT* __restrict__ x_r, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd,
    int chunks_per_split, int bt, bool x_vec, bool p_vec, int m0, int b0,
    int rows, int split) {
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

  const int nb = (rows + 7) / 8;  // n-tiles of 8 rows in use
  const int n_chunks = (K8 + QC - 1) / QC;
  const int c_begin = SERIAL ? 0 : split * chunks_per_split;
  const int n = SERIAL ? n_chunks
                       : max(0, min(n_chunks, c_begin + chunks_per_split) -
                                    c_begin);
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
  float total[SERIAL ? 8 : 1][4];  // SERIAL: the ranges' sums, in order
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
    if constexpr (SERIAL) {
      // the end of a range: its sum joins the total, as the split sum
      // kernel adds the partials (s = part[0]; s += part[k])
      if ((i + 1) % chunks_per_split == 0 || i + 1 == n) {
        const bool first = i < chunks_per_split;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[nt][e] = first ? acc[nt][e] : total[nt][e] + acc[nt][e];
            acc[nt][e] = 0.0f;
          }
      }
    }
  }
  tc::cp_async_wait<0>();

  // D fragment: rows = columns m of this warp, columns = rows b
  float* dst = SERIAL ? out : out + static_cast<size_t>(split) * B * M;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nb) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + warp * 16 + grp + 8 * (e >> 1);
      const int b = nt * 8 + 2 * tig + (e & 1);
      if (m < M && b < rows) {
        if constexpr (SERIAL)
          dst[static_cast<size_t>(b0 + b) * M + m] = total[nt][e];
        else
          dst[static_cast<size_t>(b0 + b) * M + m] = acc[nt][e];
      }
    }
  }
}

}  // namespace bitplane
