// Shared device half of the three bit-plane kernels (bitplane_gemv.cu,
// bitplane_gemm.cu, bitplane_pack.cu): digit extraction.
//
// Format (kernels/ref.py): an n-bit weight is kept in its unsigned offset
// form U = W_q + 2^(n-1), split into n_d = ceil(n/g) digits of g bits;
// planes[j, q, m] packs digit j of the 8/g weights U[q*8/g + r, m],
// r = 0..8/g-1, at bits [g*r, g*r + g).
//
// Seen one column m and one packed row q at a time, the n_d plane bytes
// (byte j = plane j, digit r = row r) and the 8/g offset weights (byte
// r = U[q*8/g + r], digit j = digit j of that weight) are the same
// (8/g) x (8/g) matrix of g-bit digits, transposed. `transpose_digits`
// turns one into the other with three (g = 1), two (g = 2) or one
// (g = 4) delta swaps on a 64-bit word — integer shifts and masks in
// registers — so K5 builds the planes from U with it; K3 and K4 use
// transpose_digit_words, the same transpose done for four columns at
// once across the plane words, to rebuild U from the planes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitplane {

// dtype codes of the C interface (kernels/paged_common.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

// Swap the bits of `x` selected by `mask` with those `d` places above.
__device__ __forceinline__ uint64_t delta_swap(uint64_t x, uint64_t mask,
                                               int d) {
  const uint64_t t = (x ^ (x >> d)) & mask;
  return x ^ t ^ (t << d);
}

// Byte a of `x` holds 8/G digits of G bits, digit b at bits [G*b, G*b+G)
// (bytes a >= 8/G are zero). Returns the word whose byte b holds digit b
// of byte a at bits [G*a, G*a+G): the transpose of the digit matrix.
template <int G>
__device__ __forceinline__ uint64_t transpose_digits(uint64_t x);

template <>
__device__ __forceinline__ uint64_t transpose_digits<1>(uint64_t x) {
  x = delta_swap(x, 0x00AA00AA00AA00AAull, 7);
  x = delta_swap(x, 0x0000CCCC0000CCCCull, 14);
  return delta_swap(x, 0x00000000F0F0F0F0ull, 28);
}

template <>
__device__ __forceinline__ uint64_t transpose_digits<2>(uint64_t x) {
  x = delta_swap(x, 0x00CC00CCull, 6);
  return delta_swap(x, 0x0000F0F0ull, 12);
}

template <>
__device__ __forceinline__ uint64_t transpose_digits<4>(uint64_t x) {
  return delta_swap(x, 0x00F0ull, 4);
}

// Digit positions p (0 .. 8/G) of a byte whose bit h is clear, in every
// byte of a word: the lower half of each 2h-digit block.
template <int G>
__host__ __device__ constexpr uint32_t lower_digits_mask(int h) {
  uint32_t m = 0;
  for (int p = 0; p < 8 / G; ++p)
    if ((p & h) == 0) m |= ((1u << G) - 1u) << (G * p);
  return m * 0x01010101u;
}

// transpose_digits on four columns at once, across words instead of
// within one: w[j] (j < 8/G) holds the plane-j bytes of four columns
// (byte c = column c), and on return byte c of w[r] is the offset
// weight U[q*8/G + r, column c]. log2(8/G) stages of block swaps
// between word pairs, each a few shifts and masks for 4 x 8/G weights
// (K3 and K4 decode whole column tiles with it).
template <int G>
__device__ __forceinline__ void transpose_digit_words(uint32_t* w) {
  constexpr int DPB = 8 / G;
  constexpr int kStages = G == 1 ? 3 : G == 2 ? 2 : 1;  // log2(8/G)
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int h = (DPB / 2) >> s;
    const uint32_t mask = lower_digits_mask<G>(h);
#pragma unroll
    for (int j = 0; j < DPB; ++j) {
      if (j & h) continue;
      const uint32_t t = ((w[j] >> (G * h)) ^ w[j + h]) & mask;
      w[j + h] ^= t;
      w[j] ^= t << (G * h);
    }
  }
}

}  // namespace bitplane
