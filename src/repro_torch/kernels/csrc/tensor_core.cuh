// Shared device half of the tensor-core kernels (paged_decode.cu,
// paged_prefill.cu, bitplane_gemv.cu, bitplane_gemm.cu, bitplane_grouped.cu):
// the warp-level bf16 MMA, the warpgroup MMA of K3's wide tile,
// asynchronous copies into shared memory, and the exact split of an
// operand into bf16 terms.
//
// All four run their products as mma.sync.m16n8k16 with bf16
// operands and f32 accumulators. Fragment layout (PTX ISA, "Matrix
// fragments for mma.m16n8k16"), lane = 4 * grp + tig:
//   A (16 x 16, row-major): a[0] = (row grp,     cols 2 tig, +1)
//                           a[1] = (row grp + 8, cols 2 tig, +1)
//                           a[2] = (row grp,     cols 2 tig + 8, +9)
//                           a[3] = (row grp + 8, cols 2 tig + 8, +9)
//   B (16 x 8, "col"):      b[0] = (rows 2 tig, +1;     col grp)
//                           b[1] = (rows 2 tig + 8, +9; col grp)
//   C/D (16 x 8, f32):      c[0], c[1] = (row grp,     cols 2 tig, +1)
//                           c[2], c[3] = (row grp + 8, cols 2 tig, +1)
// Each 32-bit register holds two bf16, the lower column (or row) in the
// low half.
//
// Exact operands. A bf16 or int8 value (|code| <= 127) is one bf16 term.
// An f32 value x is three: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), each residual exact in f32, and
// hi + mid + lo == x (24 significand bits in three 8-bit pieces). A
// product of two such operands is the sum of the term products with
// i + j < max(n_a, n_b): every pair when one side is a single term
// (exact), and all but the three smallest (~2^-24 relative) when both
// are f32. Each term product is exact in the tensor core's f32
// accumulate; only the summation order differs from a plain f32 loop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// D += A * B on one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes); register i receives
// matrix i in the A/C fragment layout (row grp, cols 2 tig, +1), or,
// with .trans, transposed (rows 2 tig, +1 of col grp): a B fragment
// read from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two floats as one bf16x2 register (lo in the low half), round to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Number of bf16 terms that hold a value of type T exactly.
template <typename T> struct Terms { static constexpr int n = 3; };
template <> struct Terms<__nv_bfloat16> { static constexpr int n = 1; };
template <> struct Terms<int8_t> { static constexpr int n = 1; };

// Splits two floats into N bf16x2 registers o[0..N) whose sum is the
// pair (exact for N = 3, or for N = 1 when the pair is bf16-exact).
template <int N>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* o) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    o[i] = *reinterpret_cast<const uint32_t*>(&v);
    x0 -= __low2float(v);
    x1 -= __high2float(v);
  }
}

// The terms of the pair p[0], p[1] (contiguous, p 2-element aligned).
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p,
                                          uint32_t* o) {
  o[0] = *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void load_pair(const int8_t* p, uint32_t* o) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  o[0] = pack_bf16(static_cast<float>(c.x), static_cast<float>(c.y));
}
__device__ __forceinline__ void load_pair(const float* p, uint32_t* o) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  split_pair<3>(f.x, f.y, o);
}

// The terms of the pair *p0, *p1 (anywhere).
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p0,
                                          const __nv_bfloat16* p1,
                                          uint32_t* o) {
  o[0] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p0)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p1))
          << 16);
}
__device__ __forceinline__ void load_pair(const int8_t* p0, const int8_t* p1,
                                          uint32_t* o) {
  o[0] = pack_bf16(static_cast<float>(*p0), static_cast<float>(*p1));
}
__device__ __forceinline__ void load_pair(const float* p0, const float* p1,
                                          uint32_t* o) {
  split_pair<3>(*p0, *p1, o);
}

// acc += sum over term pairs (i, j), i + j < max(NA, NB), of a[i] * b[j].
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&acc)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b0)[NB],
                                          const uint32_t (&b1)[NB]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kMax) mma_bf16(acc, a[i], b0[j], b1[j]);
}

// 16-byte asynchronous copy global -> shared; `bytes` < 16 zero-fills
// the rest (0 writes zeros and reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Hopper's warpgroup MMA (sm_90a), for the wide tile of K3: the four warps
// of a warpgroup issue D[64 x 128] += A[64 x 16] * B[16 x 128] together,
// bf16 in, f32 accumulate, both operands read from shared memory through
// descriptors. Each element of D takes one k16 step as mma_bf16 takes it:
// on the card the two give the same bits for the same operands and
// accumulator (held bit for bit by the K3 tests on the card). D fragment of
// warp w, lane = 4 grp + tig: d[4 j + e] = (row 16 w + grp + 8 (e >> 1),
// column 8 j + 2 tig + (e & 1)), mma_bf16's C fragment for each 8 columns.

// Descriptor of an operand in shared memory without swizzle: 8 x 8 core
// matrices (8 rows of 16 contiguous bytes), `lbo` bytes apart along K and
// `sbo` bytes apart along M (or N).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D += A * B over one k16 step. A is [k][m] in shared memory (M
// contiguous in each core matrix row: the transposed form), B is [n][k]
// (K contiguous).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// Orders this thread's writes to its accumulator registers before the
// next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's earlier shared-memory writes (stores and completed
// cp.async copies) visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers and bulk copies (sm_90a), for the wide tile of K3: one
// thread arms a barrier with the bytes a ring stage will receive, bulk
// copies (the TMA unit, not the threads, moves the data) count them down,
// and every thread waits for the stage's phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes initialised barriers visible to the bulk copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives on `bar` and adds `bytes` to the transfers its phase awaits.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// to shared memory, counted down on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB).
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tc
