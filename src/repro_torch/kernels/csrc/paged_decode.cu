// K1 — paged decode attention on Hopper (sm_90a): flash-decoding.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:
// _paged_decode_kernel (pallas_call in paged_decode_attention). One query
// token per slot attends over its KV pages through the slot's block-table
// row; GQA with g = H / KV query heads per kv-head; online softmax in f32;
// f32 output [B, H, hd]. Visible: kv_pos < len, kv_pos > len - 1 - window.
//
// Bound on an H100 SXM (3.35 TB/s HBM). K1 does ~2 flops per byte of KV
// it reads, so it is bound by memory: per slot and kv-head it must read
// its live pages once, live_pages x 2 (K, V) x bs x hd x itemsize bytes
// (+ q, out, table). At the main path's shapes (8 slots, 5,858 cached
// positions, bs 16, KV 2, hd 128, bf16) that is 6.0 MB, 1.8 us. The
// walk is short (a few hundred pages in all), so what keeps a kernel
// from the bound is how many loads are in flight across the card and the
// chain of dependent steps each fold takes.
//
// Design.
//   * The walk is cut into ranges of 8 chunks (16 keys each; a page of bs
//     keys is ceil(bs/16) chunks) at fixed table positions
//     (kernels/paged_attention.py:decode_ranges, from the table's width
//     and the page size alone). One CTA per (slot, kv-head, head tile,
//     range): at the main path's 68-column table, 8 x 2 x 1 x 9 = 144
//     CTAs.
//   * Head tiles. The g query heads of a kv-head are cut into
//     ceil(g / 16) tiles of 16, one CTA each (granite-20b: g = 48, three
//     tiles). Each tile's CTA stages the range's K and V rows itself;
//     its neighbours ask for the same rows at the same time, so the
//     repeats come from L2, not HBM. Folding every tile in one warp
//     instead would keep ceil(g / 16) accumulators of hd / 2 f32 per
//     thread: 192 registers at g = 48, hd = 128, past what a thread can
//     hold beside the fold's fragments, and twice that at hd = 256. A
//     tile's rows see exactly the operations they saw with g <= 16, so
//     every row's result is the one a 16-head group would give.
//   * Inside a CTA, 4 warps walk the range's chunks independently: warp
//     w folds the chunks whose absolute number is w mod 4. Each warp
//     stages its chunks' K and V rows of the kv-head, in the pool's own
//     type, into its own shared-memory ring with 16-byte cp.async (two
//     chunks in flight where they fit, one for f32 pools at hd > 128);
//     no CTA barrier stands between two folds. The range's page ids (and
//     int8 scales) are read once, one per lane, at the start.
//   * A warp folds a chunk with mma.sync.m16n8k16 (tensor_core.cuh), as
//     K2 does: the tile's <= 16 query heads are the 16 rows of one MMA
//     tile (rows past the tile's heads are zero and fully masked),
//     S = Q K^T over
//     hd, the softmax per row in the fragments' registers (two shuffles
//     for the max and two for the sum), then acc = alpha acc + P V with P
//     as bf16 hi + lo. Exact operands: bf16 and int8 values are one bf16
//     term, f32 q or pools three; hd^-0.5 and the page's k scale multiply
//     S after the MMA, its v scale multiplies P. exp is exp2(x log2 e).
//   * The 4 warps' states are merged in warp order in shared memory. With
//     one range the CTA writes acc / max(l, 1e-30); with several it writes
//     the range's unnormalised (acc, m, l) to scratch and merge_ranges
//     (paged_common.cuh, shared with K2) adds the ranges in order.
//   * Exactness. A chunk with no visible key is skipped, a range without
//     one keeps (-1e30, 0, 0), and which warp and range fold a chunk
//     depends only on its table column, never on the launch's depth or
//     its other rows. So a bucketed launch (a shorter walk from
//     block_start) gives every valid row of the single launch bit for
//     bit (paged_common.cuh).
//   * Any hd <= 256 (compiled for 64, 128 or 256 columns; unused columns
//     are zero in shared memory), bs <= 64, any g.
#include <type_traits>

#include "paged_common.cuh"
#include "tensor_core.cuh"

namespace paged {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kDecodeRows = 16;  // the MMA tile's rows: a head tile
constexpr int kDecodeKeys = 16;  // keys per fold step (a chunk)

template <typename QT, typename KVT, int HDP>
struct DecodeSmem {
  static constexpr int kLdQ = HDP + row_pad<QT>();
  static constexpr int kLdKV = HDP + row_pad<KVT>();
  static constexpr size_t q_bytes = sizeof(QT) * kDecodeRows * kLdQ;
  // the K rows, then the V rows, of one chunk
  static constexpr size_t chunk_bytes =
      sizeof(KVT) * 2 * kDecodeKeys * kLdKV;
  // chunks in flight per warp: two where four warps' rings fit in 160 KB
  static constexpr int stages =
      kDecodeWarps * 2 * chunk_bytes <= 160 * 1024 ? 2 : 1;
  static constexpr size_t ring_bytes = kDecodeWarps * stages * chunk_bytes;
  // after the walk the rings hold each warp's (acc, m, l) for the merge
  static constexpr int kLdState = HDP + 2;
  static constexpr size_t state_bytes =
      sizeof(float) * kDecodeWarps * kDecodeRows * kLdState;
  static constexpr size_t total =
      q_bytes + (ring_bytes > state_bytes ? ring_bytes : state_bytes);
};

// This warp stages keys key0 .. key0 + nk of `page` for kv-head `kvh`
// into rows 0 .. nk of k_s / v_s (zero rows past nk; columns >= hd are
// left as they are).
template <typename KVT, int HDP, int LD>
__device__ __forceinline__ void warp_stage_chunk(
    const KVT* __restrict__ kp, const KVT* __restrict__ vp, int page,
    int key0, int nk, int kvh, int n_kv, int bs, int hd, KVT* k_s,
    KVT* v_s, bool vec, int lane) {
  const size_t first = (static_cast<size_t>(page) * bs + key0) * n_kv + kvh;
  if (vec) {
    constexpr int E = 16 / sizeof(KVT), kPieces = HDP / E;
    constexpr int per = kDecodeKeys * kPieces;
#pragma unroll 4
    for (int idx = lane; idx < 2 * per; idx += 32) {
      const int is_v = idx >= per, rem = idx - is_v * per;
      const int i = rem / kPieces, p = rem % kPieces;
      if (p * E >= hd) continue;  // a zero column of the tile
      const KVT* src = is_v ? vp : kp;
      const bool ok = i < nk;
      tc::cp_async16((is_v ? v_s : k_s) + i * LD + p * E,
                     ok ? src + (first + static_cast<size_t>(i) * n_kv) * hd +
                              p * E
                        : src,
                     ok ? 16 : 0);
    }
  } else {
    const int per = kDecodeKeys * hd;
    for (int idx = lane; idx < 2 * per; idx += 32) {
      const int is_v = idx >= per, rem = idx - is_v * per;
      const int i = rem / hd, d = rem - i * hd;
      KVT* dst = (is_v ? v_s : k_s) + i * LD + d;
      if (i < nk)
        *dst = (is_v ? vp : kp)[(first + static_cast<size_t>(i) * n_kv) * hd +
                                d];
      else
        set_zero(*dst);
    }
  }
}

template <typename QT, typename KVT, int HDP>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ block_table,
    const int* __restrict__ lengths, const int* __restrict__ block_start,
    float* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int n_heads, int n_kv, int hd, int bs,
    int mb, int depth, int window, int n_ranges, int range_chunks,
    float scale, bool kv_vec) {
  using S = DecodeSmem<QT, KVT, HDP>;
  constexpr int NQ = tc::Terms<QT>::n, NK = tc::Terms<KVT>::n, NP = 2;
  constexpr int LDQ = S::kLdQ, LD = S::kLdKV, NT = HDP / 8;
  constexpr int kStages = S::stages;
  constexpr bool kBF16Pool = std::is_same<KVT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  QT* q_s = reinterpret_cast<QT*>(smem);
  unsigned char* ring = smem + S::q_bytes;

  const int g = n_heads / n_kv, n_tiles = (g + kDecodeRows - 1) / kDecodeRows;
  const int row = blockIdx.x, range = blockIdx.z;
  const int kvh = blockIdx.y / n_tiles;
  // this CTA's heads: kvh * g + h0 .. + gt - 1 (gt <= 16)
  const int h0 = blockIdx.y % n_tiles * kDecodeRows;
  const int gt = min(kDecodeRows, g - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int cpp = (bs + kDecodeKeys - 1) / kDecodeKeys;  // chunks per page
  // Chunk n (absolute) is chunk n % cpp of table column n / cpp. This
  // range holds chunks r_lo .. r_hi - 1, columns col0 .. col0 + ncols - 1
  // (ncols <= 32); lane l reads the page id of column col0 + l first.
  const int r_lo = range * range_chunks, r_hi = r_lo + range_chunks;
  const int col0 = r_lo / cpp;
  const int ncols = min((r_hi - 1) / cpp, mb - 1) - col0 + 1;
  const int* table = block_table + static_cast<size_t>(row) * mb;
  const int pg = lane < ncols ? table[col0 + lane] : 0;
  const int len = lengths[row];
  const int s0 = walk_start(block_start, row, depth, mb);

  // The chunks that hold a visible key are one run (positions grow with
  // n); only its first and last page can hold chunks outside it.
  const int kv_hi = len - 1, kv_lo = len - min(window, len);
  const int j_lo = max(s0, floor_div(kv_lo, bs));
  const int j_hi = min(s0 + depth - 1, floor_div(kv_hi, bs));
  auto chunk_visible = [&](int n) {
    const int c = n % cpp;
    const int first = (n / cpp) * bs + c * kDecodeKeys;
    const int last = first + min(kDecodeKeys, bs - c * kDecodeKeys) - 1;
    return first <= kv_hi && last >= kv_lo;
  };
  int n_lo = j_lo * cpp, n_hi = j_hi >= j_lo ? (j_hi + 1) * cpp : n_lo;
  while (n_lo < n_hi && !chunk_visible(n_lo)) ++n_lo;
  while (n_hi > n_lo && !chunk_visible(n_hi - 1)) --n_hi;
  n_lo = max(n_lo, r_lo);
  n_hi = max(n_lo, min(n_hi, r_hi));
  // int8 scales of the visible columns, one per lane like the page ids
  float ksc = 1.0f, vsc = 1.0f;
  const int lane_col = col0 + lane;
  if (ks && lane < ncols && lane_col >= n_lo / cpp &&
      lane_col <= (n_hi - 1) / cpp && n_lo < n_hi) {
    ksc = ks[static_cast<size_t>(pg) * n_kv + kvh];
    vsc = vs[static_cast<size_t>(pg) * n_kv + kvh];
  }

  for (int i = threadIdx.x; i < static_cast<int>(S::total / 16);
       i += kDecodeThreads)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  // the tile's gt query heads, rows 0 .. gt - 1 of q_s (one cp.async
  // group, the oldest of every thread)
  const QT* q_head =
      q + (static_cast<size_t>(row) * n_heads + kvh * g + h0) * hd;
  if ((hd * sizeof(QT)) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    constexpr int E = 16 / sizeof(QT), kPieces = HDP / E;
    for (int i = threadIdx.x; i < gt * kPieces; i += kDecodeThreads) {
      const int u = i / kPieces, p = i % kPieces;
      if (p * E < hd)
        tc::cp_async16(q_s + u * LDQ + p * E, q_head + u * hd + p * E, 16);
    }
  } else {
    for (int i = threadIdx.x; i < gt * hd; i += kDecodeThreads) {
      const int u = i / hd, d = i - u * hd;
      q_s[u * LDQ + d] = q_head[u * hd + d];
    }
  }
  tc::cp_async_commit();

  // this warp's chunks: n in [n_lo, n_hi) with n % kDecodeWarps == warp
  KVT* my_ring =
      reinterpret_cast<KVT*>(ring + warp * kStages * S::chunk_bytes);
  auto k_slot = [&](int b) { return my_ring + b * 2 * kDecodeKeys * LD; };
  const int n_first =
      n_lo + ((warp - n_lo % kDecodeWarps) + kDecodeWarps) % kDecodeWarps;
  auto stage = [&](int n, int b) {  // n is warp-uniform
    if (n < n_hi) {
      const int c = n % cpp;
      const int page = __shfl_sync(0xffffffffu, pg, n / cpp - col0);
      warp_stage_chunk<KVT, HDP, LD>(
          kp, vp, page, c * kDecodeKeys, min(kDecodeKeys, bs - c * kDecodeKeys),
          kvh, n_kv, bs, hd, k_slot(b), k_slot(b) + kDecodeKeys * LD, kv_vec,
          lane);
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int b = 0; b < kStages; ++b) stage(n_first + b * kDecodeWarps, b);
  tc::cp_async_wait<kStages>();  // q has landed, for every thread ...
  __syncthreads();               // ... and is visible to all

  // this thread's two rows: head grp + 8h of the tile; -1 = no query
  // (all positions masked)
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) q_pos[h] = grp + 8 * h < gt ? len - 1 : -1;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  const QT* q0 = q_s + grp * LDQ + 2 * tig;
  const QT* q1 = q0 + 8 * LDQ;

  for (int it = 0, n = n_first; n < n_hi; ++it, n += kDecodeWarps) {
    tc::cp_async_wait<kStages - 1>();  // chunk n has landed ...
    __syncwarp();                      // ... for every lane
    const int b = it % kStages;
    const KVT* k_c = k_slot(b);
    const KVT* v_c = k_c + kDecodeKeys * LD;
    const int c = n % cpp, col = n / cpp;
    const int first = col * bs + c * kDecodeKeys;
    const int nk = min(kDecodeKeys, bs - c * kDecodeKeys);
    const float k_scale = __shfl_sync(0xffffffffu, ksc, col - col0);
    const float v_scale = __shfl_sync(0xffffffffu, vsc, col - col0);

    // S = Q K^T, 16 rows x the chunk's 16 keys, the k-steps alternating
    // between two accumulator chains
    float s2[2][2][4];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s2[ch][nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (kk * 16 >= hd) break;
      uint32_t a[NQ][4];
      if constexpr (NQ == 1) {
        tc::ldmatrix_x4(a[0], q_s + (lane & 15) * LDQ + kk * 16 +
                                  (lane >> 4) * 8);
      } else {
        uint32_t t[4][NQ];
        tc::load_pair(q0 + kk * 16, t[0]);
        tc::load_pair(q1 + kk * 16, t[1]);
        tc::load_pair(q0 + kk * 16 + 8, t[2]);
        tc::load_pair(q1 + kk * 16 + 8, t[3]);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = t[e][i];
      }
      uint32_t b0[2][NK], b1[2][NK];  // [nt][term]
      if constexpr (kBF16Pool) {
        // keys (lane >> 4) * 8 + lane % 8, columns +8 for odd lane / 8
        uint32_t r[4];
        tc::ldmatrix_x4(r, k_c + ((lane >> 4) * 8 + (lane & 7)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        b0[0][0] = r[0];
        b1[0][0] = r[1];
        b0[1][0] = r[2];
        b1[1][0] = r[3];
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const KVT* kr = k_c + (nt * 8 + grp) * LD + kk * 16 + 2 * tig;
          tc::load_pair(kr, b0[nt]);
          tc::load_pair(kr + 8, b1[nt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        tc::mma_terms<NQ, NK>(s2[kk & 1][nt], a, b0[nt], b1[nt]);
    }
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s2[0][nt][e] + s2[1][nt][e];

    // mask, scale and fold into (m, l)
    const float s_scale = ks ? scale * k_scale : scale;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = nt * 8 + 2 * tig + (e & 1);
        const int kv_pos = first + key, qp = q_pos[h];
        float v;
        if (key >= nk)
          v = -INFINITY;
        else if (kv_pos <= qp && kv_pos < len && qp - kv_pos < window)
          v = s[nt][e] * s_scale;
        else
          v = kNegInf;
        s[nt][e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    float alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nt][e] - mx[e >> 1]) * kLog2e);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
      alpha[h] = exp2f((m_r[h] - mx[h]) * kLog2e);
      l_r[h] = alpha[h] * l_r[h] + lsum[h];
      m_r[h] = mx[h];
    }

    // acc = alpha * acc + P V, P as hi + lo bf16 terms
    uint32_t pa[NP][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t t[NP];
        tc::split_pair<NP>(s[nt][2 * h] * v_scale, s[nt][2 * h + 1] * v_scale,
                           t);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][nt * 2 + h] = t[i];
      }
#pragma unroll
    for (int nd = 0; nd < NT; nd += 2) {
      if (nd * 8 >= hd) break;
      uint32_t b0[2][NK], b1[2][NK];  // [n-tile of the pair][term]
      if constexpr (kBF16Pool) {
        // keys (lane / 8 odd) * 8 + lane % 8, columns of n-tile
        // nd + lane / 16
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, v_c + (((lane >> 3) & 1) * 8 + (lane & 7)) *
                                           LD + (nd + (lane >> 4)) * 8);
        b0[0][0] = r[0];
        b1[0][0] = r[1];
        b0[1][0] = r[2];
        b1[1][0] = r[3];
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const KVT* vc = v_c + (2 * tig) * LD + (nd + j) * 8 + grp;
          tc::load_pair(vc, vc + LD, b0[j]);
          tc::load_pair(vc + 8 * LD, vc + 9 * LD, b1[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[nd + j][0] *= alpha[0];
        acc[nd + j][1] *= alpha[0];
        acc[nd + j][2] *= alpha[1];
        acc[nd + j][3] *= alpha[1];
        tc::mma_terms<NP, NK>(acc[nd + j], pa, b0[j], b1[j]);
      }
    }
    __syncwarp();  // every lane is done with this slot
    stage(n + kStages * kDecodeWarps, b);
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // each warp's state, rows < gt: acc [hd], then m, l
  constexpr int LS = S::kLdState;
  float* st = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = grp + 8 * h;
    if (u >= gt) continue;
    float* r = st + (warp * kDecodeRows + u) * LS;
#pragma unroll
    for (int nd = 0; nd < NT; ++nd) {
      const int d = nd * 8 + 2 * tig;
      if (d < hd) r[d] = acc[nd][2 * h];
      if (d + 1 < hd) r[d + 1] = acc[nd][2 * h + 1];
    }
    if (tig == 0) {
      r[HDP] = m_r[h];
      r[HDP + 1] = l_r[h];
    }
  }
  __syncthreads();

  // merge the warps in order; one range: the output, several: this
  // range's unnormalised state
  const size_t units = static_cast<size_t>(gridDim.x) * n_heads;
  for (int i = threadIdx.x; i < gt * hd; i += kDecodeThreads) {
    const int u = i / hd, d = i - u * hd;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      m = fmaxf(m, st[(w * kDecodeRows + u) * LS + HDP]);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* r = st + (w * kDecodeRows + u) * LS;
      const float wt = exp2f((r[HDP] - m) * kLog2e);
      num += r[d] * wt;
      den += r[HDP + 1] * wt;
    }
    const size_t unit =
        static_cast<size_t>(row) * n_heads + kvh * g + h0 + u;
    if (n_ranges == 1) {
      out[unit * hd + d] = num / fmaxf(den, 1e-30f);
    } else {
      part_acc[(range * units + unit) * hd + d] = num;
      if (d == 0) {
        part_ml[(range * units + unit) * 2] = m;
        part_ml[(range * units + unit) * 2 + 1] = den;
      }
    }
  }
}

template <typename QT, typename KVT, int HDP>
cudaError_t launch_hdp(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* table,
                       const void* lengths, const void* block_start,
                       void* out, void* part_acc, void* part_ml, int B, int H,
                       int KV, int hd, int bs, int mb, int depth, int window,
                       int n_ranges, int range_chunks, float scale,
                       cudaStream_t stream) {
  const size_t smem = DecodeSmem<QT, KVT, HDP>::total;
  auto kernel = paged_decode_kernel<QT, KVT, HDP>;
  cudaError_t err = tc::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool kv_vec = (hd * sizeof(KVT)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const int n_tiles = (H / KV + kDecodeRows - 1) / kDecodeRows;
  kernel<<<dim3(B, KV * n_tiles, n_ranges), kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths),
      static_cast<const int*>(block_start), static_cast<float*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, KV, hd,
      bs, mb, depth, window, n_ranges, range_chunks, scale, kv_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return err;
  return merge_ranges(static_cast<const float*>(part_acc),
                      static_cast<const float*>(part_ml),
                      static_cast<float*>(out), static_cast<size_t>(B) * H,
                      hd, n_ranges, stream);
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, const void* block_start, void* out,
                   void* part_acc, void* part_ml, int B, int H, int KV,
                   int hd, int bs, int mb, int depth, int window,
                   int n_ranges, int range_chunks, float scale,
                   cudaStream_t stream) {
#define PAGED_DECODE_HDP(HDP)                                               \
  launch_hdp<QT, KVT, HDP>(q, kp, vp, ks, vs, table, lengths, block_start,  \
                           out, part_acc, part_ml, B, H, KV, hd, bs, mb,    \
                           depth, window, n_ranges, range_chunks, scale,    \
                           stream)
  if (hd <= 64) return PAGED_DECODE_HDP(64);
  if (hd <= 128) return PAGED_DECODE_HDP(128);
  if (hd <= 256) return PAGED_DECODE_HDP(256);
  return cudaErrorInvalidValue;
#undef PAGED_DECODE_HDP
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp,
                      const void* vp, const void* ks, const void* vs,
                      const void* table, const void* lengths,
                      const void* block_start, void* out, void* part_acc,
                      void* part_ml, int B, int H, int KV, int hd, int bs,
                      int mb, int depth, int window, int n_ranges,
                      int range_chunks, float scale, cudaStream_t stream) {
#define PAGED_DECODE_LAUNCH(KVT)                                             \
  launch<QT, KVT>(q, kp, vp, ks, vs, table, lengths, block_start, out,       \
                  part_acc, part_ml, B, H, KV, hd, bs, mb, depth, window,    \
                  n_ranges, range_chunks, scale, stream)
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
// walk from column 0. The walk is split into n_ranges ranges of
// range_chunks (<= 32) chunks; with n_ranges > 1, part_acc (f32
// [n_ranges, B, H, hd]) and part_ml (f32 [n_ranges, B, H, 2]) are
// scratch. Returns the cudaError_t of the launches.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, const void* block_start, void* out, void* part_acc,
    void* part_ml, int q_dtype, int kv_dtype, int B, int H, int KV, int hd,
    int bs, int mb, int depth, int window, int n_ranges, int range_chunks,
    float scale, void* stream) {
  using namespace paged;
  if (n_ranges < 1 || range_chunks < 1 || range_chunks > 32 ||
      (n_ranges > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                            v_scales, block_table, lengths, block_start, out,
                            part_acc, part_ml, B, H, KV, hd, bs, mb, depth,
                            window, n_ranges, range_chunks, scale, s);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(
        kv_dtype, q, k_pages, v_pages, k_scales, v_scales, block_table,
        lengths, block_start, out, part_acc, part_ml, B, H, KV, hd, bs, mb,
        depth, window, n_ranges, range_chunks, scale, s);
  return cudaErrorInvalidValue;
}
