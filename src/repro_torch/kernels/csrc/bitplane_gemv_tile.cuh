// The two tiles of K3 (bitplane_gemv.cu) as device functions; K6
// (bitplane_grouped.cu) uses the first. Both decode U from the planes
// into shared memory once per chunk for all the rows of the tile (design
// and numerics in bitplane_gemv.cu's header).
//   * gemv_tile, the narrow tile: one CTA of 2 warps, 32 columns of the
//     digit planes by up to 64 rows of x, operands by cp.async, products
//     on mma.sync. K3 launches it for up to 24 rows
//     (kernels/bitplane_gemv.py:wide_tile), K6 for every expert.
//   * gemv_tile_wide, the wide tile: one CTA of one warpgroup (4 warps),
//     64 columns by up to 128 rows, x by bulk copies, products on wgmma.
//     K3 launches it above 24 rows, so at a decode's 128 rows each plane
//     chunk is fetched and decoded once per column tile, not once per 64
//     rows, and each x chunk feeds 64 columns, not 32.
// The two give the same bits. A row's result depends only on its own x,
// the planes, and the K split: never on the other rows of the tile, on
// B, on where the row sits in x, or on the tile. Both walk a K range in
// the same chunks, k ordered (r, q) inside a chunk; every output element
// takes, per chunk, the same chain of k16 steps from a zero accumulator
// (4 k-steps in order, each its bf16 terms in order) with the same 16
// products in each step, and adds that chain's result to its f32 sum
// with an ordinary add, chunk after chunk. A wgmma k16 step and an
// mma.sync one give an element the same bits on the card (the K3 card
// tests hold the tiles against each other). K6 relies on this to equal
// K3 bit for bit on each expert.
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

// The wide tile: one warpgroup, 64 columns x 128 rows, its products on
// wgmma and its operands brought in by bulk copies. Shared memory: a ring
// of kWideStages chunks, each the plane rows (as gemv_tile stages them,
// 64 columns wide) and the chunk's x as NX bf16 term tiles [128 rows][64
// k]; then two U buffers [64 k][64 m]; then one mbarrier per stage. x
// tiles and U are laid out as wgmma reads them: 8 x 8 core matrices of
// 16-byte rows, x's 1 KB apart along the rows and 128 bytes along k (so a
// tile is one contiguous copy of the wrapper's layout), U's 144 bytes
// apart along m (a warp's decode stores meet no bank twice) and 1152
// along k.
constexpr int kWideThreads = 128;
constexpr int kWideTM = 64;
constexpr int kWideTB = 128;
constexpr int kWideStages = 4;
constexpr int kWidePlaneBytes = 8 * 8 * kWideTM;  // 8/g planes x 8g rows
constexpr int kWideXBytes = kWideTB * kGemvChunkK * 2;  // one term tile
constexpr int kWideUM = 144;                      // U: 8 columns apart
constexpr int kWideUK = (kWideTM / 8) * kWideUM;  // U: 8 k apart
constexpr int kWideUBytes = (kGemvChunkK / 8) * kWideUK;

// Shared memory of a wide-tile CTA whose x has NX bf16 terms: 98 KB at
// bf16 x (2 CTAs an SM), 226 KB at f32.
template <int NX>
constexpr size_t wide_smem() {
  return kWideStages * (kWidePlaneBytes + NX * kWideXBytes) +
         2 * kWideUBytes + kWideStages * 8;
}

// One CTA of the wide tile: the 64 columns from m0 of rows [b0, b0 +
// rows) against the planes, over K range `split` (of `chunks_per_split`
// chunks), written into out + split * B * M as gemv_tile writes it
// without SERIAL. x comes as xt [NX][C][Bp/8][8][8][8] bf16 (Bp = B
// rounded up to 128 rows, zero past B; C = ceil(K8 / 8g) chunks, zero
// past K8): element (t, c, b / 8, kg, b % 8, ke) is term t of x at row b
// and chunk k = 8 kg + ke in (r, q) order, so chunk c of a CTA's rows is
// NX blocks of 16 KB, each one bulk copy. The terms: 1 for bf16 x; hi,
// mid and lo for f32, as tc::split_pair makes them. The plane rows come
// by cp.async, 16 bytes a copy. Step i: wgmma multiplies chunk i (4
// k-steps, each its NX terms in order, into a zeroed accumulator), and
// while the tensor cores run, the warpgroup starts the copies of chunk
// i + 3 and decodes chunk i + 1 into the other U buffer; then it adds the
// chunk's sum to acc.
template <int G, int NX>
__device__ __forceinline__ void gemv_tile_wide(
    const __nv_bfloat16* __restrict__ xt, const uint8_t* __restrict__ planes,
    float* __restrict__ out, int B, int K8, int M, int nd,
    int chunks_per_split, bool p_vec, int m0, int b0, int rows, int split) {
  constexpr int DPB = 8 / G;   // digit rows per packed row
  constexpr int QC = 8 * G;    // packed rows per chunk
  constexpr int CK = kGemvChunkK, TM = kWideTM, T = kWideThreads;
  constexpr int S = kWideStages;
  constexpr int kStage = kWidePlaneBytes + NX * kWideXBytes;
  extern __shared__ __align__(128) unsigned char wsmem[];
  auto p_slot = [&](int i) { return wsmem + (i % S) * kStage; };
  auto x_slot = [&](int i) { return p_slot(i) + kWidePlaneBytes; };
  auto u_buf = [&](int i) {
    return wsmem + S * kStage + (i & 1) * kWideUBytes;
  };
  uint64_t* full =
      reinterpret_cast<uint64_t*>(wsmem + S * kStage + 2 * kWideUBytes);

  const int n_chunks = (K8 + QC - 1) / QC;
  const int bp = (B + kWideTB - 1) / kWideTB * kWideTB;
  const int c_begin = split * chunks_per_split;
  const int n =
      max(0, min(n_chunks, c_begin + chunks_per_split) - c_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;

  // Thread 0 arms chunk i's barrier and starts the bulk copies of its x
  // tiles.
  auto issue = [&](int i) {
    if (i >= n) return;
    uint64_t* bar = &full[i % S];
    tc::mbar_expect_tx(bar, NX * kWideXBytes);
    for (int term = 0; term < NX; ++term)
      tc::bulk_copy(x_slot(i) + term * kWideXBytes,
                    xt + ((static_cast<size_t>(term) * n_chunks + c_begin +
                           i) * bp + b0) * CK,
                    kWideXBytes, bar);
  };
  // The warpgroup stages chunk i's planes as gemv_tile does,
  // p_s[(j * QC + ql) * TM + cc] = planes[j, q0 + ql, m0 + cc], zero past
  // every edge; one cp.async group (maybe empty).
  auto stage_planes = [&](int i) {
    if (i < n) {
      const int q0 = (c_begin + i) * QC;
      uint8_t* p_s = p_slot(i);
      if (p_vec) {
        for (int idx = threadIdx.x; idx < nd * QC * (TM / 16); idx += T) {
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
        for (int idx = threadIdx.x; idx < nd * QC * TM; idx += T) {
          const int cc = idx % TM, ql = (idx / TM) % QC, j = idx / (TM * QC);
          const int q = q0 + ql, m = m0 + cc;
          p_s[(j * QC + ql) * TM + cc] =
              (q < K8 && m < M)
                  ? planes[(static_cast<size_t>(j) * K8 + q) * M + m]
                  : 0;
        }
      }
    }
    tc::cp_async_commit();
  };

  // Decode chunk i into U: a task is one packed row ql x 4 columns, as in
  // gemv_tile; U[k][m] for k = r * QC + ql lands in its core matrix row.
  auto decode = [&](int i) {
    const uint8_t* p_s = p_slot(i);
    unsigned char* u_s = u_buf(i);
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int task = threadIdx.x + t * T;
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
        const int k = r * QC + ql;
        uint2 v;
        v.x = bytes_to_bf16x2(w[r], 0);
        v.y = bytes_to_bf16x2(w[r], 2);
        *reinterpret_cast<uint2*>(u_s + (k / 8) * kWideUK +
                                  (mg / 2) * kWideUM + (k % 8) * 16 +
                                  (mg % 2) * 8) = v;
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) tc::mbar_init(&full[s], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  float acc[64], t[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  for (int s = 0; s < S - 1; ++s) {
    if (threadIdx.x == 0) issue(s);
    stage_planes(s);
  }
  tc::cp_async_wait<S - 2>();
  __syncthreads();
  if (n > 0) decode(0);
  for (int i = 0; i < n; ++i) {
    tc::mbar_wait(&full[i % S], (i / S) & 1);
    tc::cp_async_wait<S - 3>();
    tc::fence_proxy_async();
    __syncthreads();  // chunk i's x and U are in place for wgmma; chunk
                      // i + 1's planes landed; step i - 1 is done
#pragma unroll
    for (int e = 0; e < 64; ++e) t[e] = 0.0f;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks)
#pragma unroll
      for (int term = 0; term < NX; ++term)
        tc::wgmma_m64n128k16(
            t, tc::smem_desc(u_buf(i) + ks * 2 * kWideUK, kWideUK, kWideUM),
            tc::smem_desc(x_slot(i) + term * kWideXBytes + ks * 256, 128,
                          1024));
    tc::wgmma_commit();
    if (threadIdx.x == 0) issue(i + S - 1);  // into chunk i - 1's slot
    stage_planes(i + S - 1);
    if (i + 1 < n) decode(i + 1);
    tc::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += t[e];
  }
  tc::cp_async_wait<0>();

  // D fragment: rows = columns m, columns = rows b
  float* dst = out + static_cast<size_t>(split) * B * M;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int m = m0 + 16 * warp + grp + 8 * ((e & 3) >> 1);
    const int b = 8 * (e >> 2) + 2 * tig + (e & 1);
    if (m < M && b < rows)
      dst[static_cast<size_t>(b0 + b) * M + m] = acc[e];
  }
}

}  // namespace bitplane
