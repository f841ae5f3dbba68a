// Shared device half of the four tensor-core kernels (paged_decode.cu,
// paged_prefill.cu, bitplane_gemv.cu, bitplane_gemm.cu): the warp-level
// bf16 MMA, asynchronous copies into shared memory, and the exact split
// of an operand into bf16 terms.
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

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB).
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tc
