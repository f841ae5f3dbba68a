// K2 — paged prefill attention on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/paged_prefill.py:
// _paged_prefill_kernel (pallas_call in paged_prefill_attention). T
// suffix queries per slot, row t at logical position start + t, attend
// through the block table over the cached prefix and the fresh suffix:
// kv_pos <= start + t, kv_pos < total, kv_pos > start + t - window.
// Online softmax in f32; f32 output [B, T, H, hd].
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense tensor
// cores). It must read the slot's visible pages once (pages x 2 x bs x
// hd x itemsize per kv-head) plus q and out, and do 4 x hd flops per
// visible (query head, kv position) pair. At the main path's widths (one
// slot, a 256-token cached prefix, suffixes of 64-768 tokens, 12 heads,
// hd 128) the causal pairs dominate: ~3 GFLOP against ~2-5 MB, so the
// bound is the operations on the tensor cores, a few us. What keeps a
// kernel from it is latency: a CTA folds its pages one after another,
// each step a chain of dependent MMAs, shuffles and exponentials, and
// the tiles that see the whole prefix walk every page.
//
// Design.
//   * One CTA per (launch row, kv-head, tile of 64 query units, range of
//     the walk), 4 warps of 16 units each. A unit is one (position,
//     head) of the kv-head's group, units ordered position-major, so the
//     g query heads that share a kv-head share every staged page (qwen2:
//     g = 6, a 768-token suffix is 2 x 72 tiles). Any g: a tile spans the
//     positions of its first to its last unit (granite-20b, g = 48: 1 1/3
//     positions a tile, so a tile may start and end inside a position's
//     heads), and every unit masks by its own position. The tile's
//     queries are staged once, as stored (bf16 or f32).
//   * The walk is cut into at most 4 ranges of whole 16-key chunks at
//     fixed table positions (kernels/paged_prefill.py:walk_ranges, from
//     the table's width and the page size alone; 3 ranges of 23 pages
//     at the main path's 68), each folded by its own CTA. A second
//     kernel merges each row's range states in order. This cuts the
//     longest chain of dependent steps to a third, which halves the
//     kernel's time on the H100. A range that holds no valid key of a
//     row adds exact zeros to its merge, so the split moves no bit of a
//     row's output between launches that batch, chunk or bucket rows
//     differently.
//   * The walk folds 16 keys at a time ("chunks", a page of bs keys is
//     ceil(bs/16) of them, at fixed offsets inside the page), in table
//     order, skipping every chunk that lies wholly outside the tile's
//     causal / total / window range. Each chunk's K and V rows of the
//     kv-head are brought into a 3-stage shared-memory ring with 16-byte
//     cp.async two chunks ahead of the fold (plain loads into the same
//     ring when rows are not 16-byte aligned), once per CTA; the page id
//     of a chunk is read from the block table one step before its copy
//     is issued, so no step waits on that read. The queries arrive by
//     cp.async with the first chunk.
//   * S = Q K^T and P V run as mma.sync.m16n8k16, bf16 operands and f32
//     accumulators; the (m, l, acc) state of each row stays in
//     registers (acc as the P V accumulator). bf16 fragments come by
//     ldmatrix (ldmatrix.trans for V), the others by paired loads that
//     convert or split as they go. S alternates its k-steps between two
//     accumulator chains, which halves its dependent-MMA latency. The
//     walk is a chain of dependent steps, so latency, not the MMA rate,
//     bounds a CTA. mma.sync rather than wgmma: a 16-key chunk is one
//     k-step of P V and two n-tiles of S, and the warp-level fold keeps
//     each row's softmax state in the fragments' own registers.
//   * Exact operands (tensor_core.cuh): bf16 and int8 values are one
//     bf16 term each (|code| <= 127 is exact), f32 q or pools are split
//     into hi + mid + lo in registers as fragments are loaded, and the
//     term products are summed in the f32 accumulator. hd^-0.5 and the
//     page's k scale multiply S after the MMA; the page's v scale
//     multiplies P before P V, which equals scaling the chunk's P V.
//   * P is fed to P V as two bf16 terms, hi = bf16(p) and
//     lo = bf16(p - hi): one bf16 rounding of p (2^-9) would break the
//     1e-4 bound on rows with few visible keys; two leave ~2^-17.
//   * Numerics of paged_common.cuh: masked scores are the finite -1e30,
//     keys past the end of a page -inf (p = 0 always), the epilogue
//     divides by max(l, 1e-30); exp(x) is taken as exp2(x log2 e), which
//     keeps exp(0) = 1 and exp(-1e30 - m) = 0 exact. A chunk fully masked for a row
//     that has seen a valid key folds as an exact no-op (p = 0,
//     alpha = 1), one folded before is wiped (alpha = 0), and a row's
//     MMA results do not depend on the other rows of its tile: a row's
//     output is the same bits whatever tile it sits in and whatever
//     chunks its tile skips (chunked prefill == single-shot, bucketed
//     launch == single launch).
//   * Any hd <= 256 (the tile is compiled for 64, 128 or 256 columns;
//     unused columns are zero in shared memory), bs <= 64 and T.
#include <type_traits>

#include "paged_common.cuh"
#include "tensor_core.cuh"

namespace paged {

constexpr int kTileUnits = 64;        // query units per CTA
constexpr int kChunkKeys = 16;        // keys per fold step
constexpr int kPrefillThreads = 128;  // warp w folds units 16w .. 16w + 15
constexpr int kStages = 3;            // chunks in the shared-memory ring

template <typename QT, typename KVT, int HDP>
struct PrefillSmem {
  static constexpr int kLdQ = HDP + row_pad<QT>();
  static constexpr int kLdKV = HDP + row_pad<KVT>();
  static constexpr size_t q_bytes = sizeof(QT) * kTileUnits * kLdQ;
  // one chunk of K (or V) rows
  static constexpr size_t kv_bytes = sizeof(KVT) * kChunkKeys * kLdKV;
  static constexpr size_t total = q_bytes + kStages * 2 * kv_bytes;
};

// The walk split into ranges of `chunks` chunks at fixed table positions
// (chunk c of column col is number col * ceil(bs/16) + c), one CTA per
// (tile, range). With count > 1 each CTA writes its rows' unnormalised
// state, acc [count, B, T, H, hd] and (m, l) [count, B, T, H, 2], and
// merge_ranges (paged_common.cuh, shared with K1) adds them in order.
struct Ranges {
  float* acc;
  float* ml;
  int count, chunks;
};

// Stage keys key0 .. key0 + nk of `page` for kv-head `kvh` into rows
// 0 .. nk of k_s / v_s (zero rows past nk; columns >= hd are untouched).
template <typename KVT, int HDP, int LD>
__device__ void stage_chunk(const KVT* __restrict__ kp,
                            const KVT* __restrict__ vp, int page, int key0,
                            int nk, int kvh, int n_kv, int bs, int hd,
                            KVT* k_s, KVT* v_s, bool vec) {
  // row (key0 + i) of the page for this head starts at element
  // (first + i * n_kv) * hd
  const size_t first = (static_cast<size_t>(page) * bs + key0) * n_kv + kvh;
  if (vec) {
    constexpr int E = 16 / sizeof(KVT), kPieces = HDP / E;
    constexpr int per = kChunkKeys * kPieces;
#pragma unroll
    for (int idx = threadIdx.x; idx < 2 * per; idx += kPrefillThreads) {
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
    const int per = kChunkKeys * hd;
    for (int idx = threadIdx.x; idx < 2 * per; idx += kPrefillThreads) {
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
__global__ void __launch_bounds__(kPrefillThreads) paged_prefill_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ block_table,
    const int* __restrict__ start, const int* __restrict__ total,
    const int* __restrict__ block_start, float* __restrict__ out, int T,
    int n_heads, int n_kv, int hd, int bs, int mb, int depth, int window,
    float scale, bool kv_vec, Ranges rg) {
  using S = PrefillSmem<QT, KVT, HDP>;
  constexpr int NQ = tc::Terms<QT>::n, NK = tc::Terms<KVT>::n, NP = 2;
  constexpr int LDQ = S::kLdQ, LD = S::kLdKV;
  constexpr bool kBF16Pool = std::is_same<KVT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  QT* q_s = reinterpret_cast<QT*>(smem);
  KVT* kv_s = reinterpret_cast<KVT*>(smem + S::q_bytes);
  // stage b: K rows at kv_s + 2 b * kChunkKeys * LD, V rows after them
  auto k_stage = [&](int b) { return kv_s + 2 * b * kChunkKeys * LD; };

  const int row = blockIdx.x, kvh = blockIdx.y;
  const int u0 = blockIdx.z / rg.count * kTileUnits, range = blockIdx.z % rg.count;
  const int g = n_heads / n_kv;
  const int n_units = min(kTileUnits, T * g - u0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NT = HDP / 8;  // P V n-tiles
  const int grp = lane / 4, tig = lane % 4;

  for (int i = threadIdx.x; i < static_cast<int>(S::total / 16);
       i += kPrefillThreads)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  // unit u = (position (u0 + u) / g, head kvh * g + (u0 + u) % g), a
  // row of hd elements; staged with the first chunk's cp.async group
  auto q_row = [&](int u) {
    const int t = (u0 + u) / g, h = kvh * g + (u0 + u) % g;
    return q + ((static_cast<size_t>(row) * T + t) * n_heads + h) * hd;
  };
  if ((hd * sizeof(QT)) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    constexpr int E = 16 / sizeof(QT), kPieces = HDP / E;
    for (int i = threadIdx.x; i < n_units * kPieces; i += kPrefillThreads) {
      const int u = i / kPieces, p = i % kPieces;
      if (p * E < hd) tc::cp_async16(q_s + u * LDQ + p * E, q_row(u) + p * E, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n_units * hd; i += kPrefillThreads) {
      const int u = i / hd, d = i - u * hd;
      q_s[u * LDQ + d] = q_row(u)[d];
    }
  }

  const int st = start[row], tot = total[row];
  const int q_first = st + u0 / g, q_last = st + (u0 + n_units - 1) / g;
  const int kv_hi = min(q_last, tot - 1);  // last position any row sees
  // first position any row sees (positions are >= 0)
  const int kv_lo = q_first - min(window, q_first + 1) + 1;
  const int s0 = walk_start(block_start, row, depth, mb);
  const int* table = block_table + static_cast<size_t>(row) * mb;
  const int cpp = (bs + kChunkKeys - 1) / kChunkKeys;  // chunks per page
  // walk chunk n is chunk n % cpp of table column s0 + n / cpp
  const int j_lo = max(s0, floor_div(kv_lo, bs));
  const int j_hi = min(s0 + depth - 1, floor_div(kv_hi, bs));
  const int n_begin = (j_lo - s0) * cpp;
  const int n_end = j_hi >= j_lo ? (j_hi - s0 + 1) * cpp : n_begin;
  auto chunk_visible = [&](int n) {
    const int c = n % cpp;
    const int first = (s0 + n / cpp) * bs + c * kChunkKeys;
    const int last = first + min(kChunkKeys, bs - c * kChunkKeys) - 1;
    return first <= kv_hi && last >= kv_lo;
  };
  // Positions grow with n, so the chunks that some row of the tile can
  // see are one run n_lo .. n_hi - 1: only its first and last page can
  // hold chunks outside it.
  int n_lo = n_begin, n_hi = n_end;
  while (n_lo < n_hi && !chunk_visible(n_lo)) ++n_lo;
  while (n_hi > n_lo && !chunk_visible(n_hi - 1)) --n_hi;
  if (rg.count > 1) {  // this CTA's range of the walk
    n_lo = max(n_lo, range * rg.chunks - s0 * cpp);
    n_hi = max(n_lo, min(n_hi, (range + 1) * rg.chunks - s0 * cpp));
  }
  // a walk position: chunk n is chunk c of table column col
  struct Cursor {
    int n, col, c;
  };
  auto advance = [&](Cursor& p) {
    ++p.n;
    if (++p.c == cpp) {
      p.c = 0;
      ++p.col;
    }
  };
  auto page_of = [&](const Cursor& p) { return p.n < n_hi ? table[p.col] : 0; };
  // page ids of the staged chunks, by buffer (the fold reads its
  // scales with them)
  __shared__ int page_s[kStages];
  auto stage = [&](const Cursor& p, int b, int page) {
    stage_chunk<KVT, HDP, LD>(kp, vp, page, p.c * kChunkKeys,
                              min(kChunkKeys, bs - p.c * kChunkKeys), kvh,
                              n_kv, bs, hd, k_stage(b),
                              k_stage(b) + kChunkKeys * LD, kv_vec);
    if (threadIdx.x == 0) page_s[b] = page;
  };

  // this thread's two rows: unit warp*16 + grp + 8h; -1 = no query (all
  // positions masked)
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = warp * 16 + grp + 8 * h;
    q_pos[h] = u < n_units ? st + (u0 + u) / g : -1;
  }
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  const QT* q0 = q_s + (warp * 16 + grp) * LDQ + 2 * tig;
  const QT* q1 = q0 + 8 * LDQ;
  // `cur` is folded at step it from buffer it % kStages; `ahead`, the
  // next chunk to stage, goes kStages - 1 steps ahead of it, and its page
  // id is read from the table one step before it is staged (so no step
  // waits for that read)
  Cursor cur{n_lo, s0 + n_lo / cpp, n_lo % cpp}, ahead = cur;
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    if (ahead.n < n_hi) {
      stage(ahead, b, page_of(ahead));
      advance(ahead);
    }
    tc::cp_async_commit();
  }
  int ahead_page = page_of(ahead);
  for (int it = 0; cur.n < n_hi; ++it) {
    if (ahead.n < n_hi) {
      stage(ahead, (it + kStages - 1) % kStages, ahead_page);  // it-1's
      advance(ahead);
      ahead_page = page_of(ahead);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();  // chunk `cur` has landed
    __syncthreads();

    const KVT* k_c = k_stage(it % kStages);
    const KVT* v_c = k_c + kChunkKeys * LD;
    const int c = cur.c, col = cur.col;
    const int first = col * bs + c * kChunkKeys;
    const int nk = min(kChunkKeys, bs - c * kChunkKeys);

    // S = Q K^T for this warp's 16 rows x the chunk's 16 keys, the
    // k-steps alternating between two accumulator chains
    float s2[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s2[c][nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (kk * 16 >= hd) break;
      uint32_t a[NQ][4];
      if constexpr (NQ == 1) {
        tc::ldmatrix_x4(a[0], q_s + (warp * 16 + (lane & 15)) * LDQ +
                                  kk * 16 + (lane >> 4) * 8);
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
    const int page = page_s[it % kStages];
    const float s_scale = ks ? scale * ks[page * n_kv + kvh] : scale;
    const float v_scale = vs ? vs[page * n_kv + kvh] : 1.0f;
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
        else if (kv_pos <= qp && kv_pos < tot && qp - kv_pos < window)
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
    __syncthreads();  // every warp is done with this stage
    advance(cur);
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = warp * 16 + grp + 8 * h;
    if (u >= n_units) continue;
    const int t = (u0 + u) / g, head = kvh * g + (u0 + u) % g;
    const size_t unit = (static_cast<size_t>(row) * T + t) * n_heads + head;
    const size_t units = static_cast<size_t>(gridDim.x) * T * n_heads;
    // one range: the output; several: this range's unnormalised state
    float* o = (rg.count > 1 ? rg.acc + range * units * hd : out) + unit * hd;
    const float den = rg.count > 1 ? 1.0f : fmaxf(l_r[h], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < NT; ++nd) {
      const int d = nd * 8 + 2 * tig;
      if (d < hd) o[d] = acc[nd][2 * h] / den;
      if (d + 1 < hd) o[d + 1] = acc[nd][2 * h + 1] / den;
    }
    if (rg.count > 1 && tig == 0) {
      float* ml = rg.ml + (range * units + unit) * 2;
      ml[0] = m_r[h];
      ml[1] = l_r[h];
    }
  }
}

template <typename QT, typename KVT, int HDP>
cudaError_t launch_hdp(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* table,
                       const void* start, const void* total,
                       const void* block_start, void* out, int B, int T,
                       int H, int KV, int hd, int bs, int mb, int depth,
                       int window, float scale, Ranges rg,
                       cudaStream_t stream) {
  const size_t smem = PrefillSmem<QT, KVT, HDP>::total;
  auto kernel = paged_prefill_kernel<QT, KVT, HDP>;
  cudaError_t err = tc::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool kv_vec = (hd * sizeof(KVT)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const int g = H / KV;
  const dim3 grid(B, KV, (T * g + kTileUnits - 1) / kTileUnits * rg.count);
  kernel<<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<const int*>(total),
      static_cast<const int*>(block_start), static_cast<float*>(out), T, H,
      KV, hd, bs, mb, depth, window, scale, kv_vec, rg);
  err = cudaGetLastError();
  if (err != cudaSuccess || rg.count == 1) return err;
  return merge_ranges(rg.acc, rg.ml, static_cast<float*>(out),
                      static_cast<size_t>(B) * T * H, hd, rg.count, stream);
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* start, const void* total,
                   const void* block_start, void* out, int B, int T, int H,
                   int KV, int hd, int bs, int mb, int depth, int window,
                   float scale, Ranges rg, cudaStream_t stream) {
#define PAGED_PREFILL_HDP(HDP)                                             \
  launch_hdp<QT, KVT, HDP>(q, kp, vp, ks, vs, table, start, total,         \
                           block_start, out, B, T, H, KV, hd, bs, mb, depth, \
                           window, scale, rg, stream)
  if (hd <= 64) return PAGED_PREFILL_HDP(64);
  if (hd <= 128) return PAGED_PREFILL_HDP(128);
  if (hd <= 256) return PAGED_PREFILL_HDP(256);
  return cudaErrorInvalidValue;
#undef PAGED_PREFILL_HDP
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp,
                      const void* vp, const void* ks, const void* vs,
                      const void* table, const void* start,
                      const void* total, const void* block_start, void* out,
                      int B, int T, int H, int KV, int hd, int bs, int mb,
                      int depth, int window, float scale, Ranges rg,
                      cudaStream_t stream) {
#define PAGED_PREFILL_LAUNCH(KVT)                                          \
  launch<QT, KVT>(q, kp, vp, ks, vs, table, start, total, block_start, out, \
                  B, T, H, KV, hd, bs, mb, depth, window, scale, rg, stream)
  switch (kv_dtype) {
    case kF32: return PAGED_PREFILL_LAUNCH(float);
    case kBF16: return PAGED_PREFILL_LAUNCH(__nv_bfloat16);
    case kI8: return PAGED_PREFILL_LAUNCH(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_PREFILL_LAUNCH
}

}  // namespace paged

// C interface (kernels/paged_prefill.py). Pointers are device pointers;
// k_scales / v_scales are NULL for float pools, block_start NULL for a
// walk from column 0. With n_ranges > 1 the walk is split into ranges of
// range_chunks chunks, and part_acc (f32 [n_ranges, B, T, H, hd]) and
// part_ml (f32 [n_ranges, B, T, H, 2]) are scratch. Returns the
// cudaError_t of the launches.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* start, const void* total, const void* block_start, void* out,
    void* part_acc, void* part_ml, int q_dtype, int kv_dtype, int B, int T,
    int H, int KV, int hd, int bs, int mb, int depth, int window,
    int n_ranges, int range_chunks, float scale, void* stream) {
  using namespace paged;
  if (n_ranges < 1 || range_chunks < 1 ||
      (n_ranges > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const Ranges rg{static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                  n_ranges, range_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                            v_scales, block_table, start, total, block_start,
                            out, B, T, H, KV, hd, bs, mb, depth, window,
                            scale, rg, s);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                    v_scales, block_table, start, total,
                                    block_start, out, B, T, H, KV, hd, bs,
                                    mb, depth, window, scale, rg, s);
  return cudaErrorInvalidValue;
}
