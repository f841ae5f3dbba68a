// K5 — bit-plane pack for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/pack.py:_pack_kernel
// (pallas_call in pack_bitplanes):
//   planes[j, q, m] = OR_r (digit_j(u_r[r, q, m]) << g*r)
// over pre-strided offset weights u_r [8/g, K8, M] uint8, j < n_d. It runs
// at load time, once per [K, M] weight slice (quant/bitplane.py).
//
// Design. One thread per (q, m) column entry, grid-stride: it reads the
// 8/g offset weights u_r[:, q, m] (neighbouring threads on neighbouring
// m, so each load is coalesced), transposes their digit matrix in
// registers (bitplane_common.cuh, the same function K3/K4 use to undo
// it) and writes the n_d plane bytes. Digits above n_d are dropped, as
// the reference does; the output is byte-identical to ref.pack_ref.
//
// Bound on an H100 SXM (3.35 TB/s). A few integer operations per byte:
// bound by bytes, 8/g K8 M in and n_d K8 M out (27.5 MB, ~8.2 us, for a
// [1536, 8960] weight at 8 bits). One byte per load and store leaves
// bandwidth on the table; at load time that does not matter.
#include "bitplane_common.cuh"

namespace bitplane {

constexpr int kPackThreads = 256;

template <int G>
__global__ void __launch_bounds__(kPackThreads) bitplane_pack_kernel(
    const uint8_t* __restrict__ u_r, uint8_t* __restrict__ planes, int K8,
    int M, int nd) {
  constexpr int DPB = 8 / G;
  const size_t n = static_cast<size_t>(K8) * M;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    uint64_t x = 0;
#pragma unroll
    for (int r = 0; r < DPB; ++r)
      x |= static_cast<uint64_t>(u_r[r * n + i]) << (8 * r);
    const uint64_t p = transpose_digits<G>(x);
#pragma unroll
    for (int j = 0; j < DPB; ++j)
      if (j < nd) planes[j * n + i] = static_cast<uint8_t>(p >> (8 * j));
  }
}

template <int G>
cudaError_t launch_pack(const void* u_r, void* planes, int K8, int M, int nd,
                        cudaStream_t stream) {
  const size_t n = static_cast<size_t>(K8) * M;
  const size_t want = (n + kPackThreads - 1) / kPackThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  bitplane_pack_kernel<G><<<blocks, kPackThreads, 0, stream>>>(
      static_cast<const uint8_t*>(u_r), static_cast<uint8_t*>(planes), K8, M,
      nd);
  return cudaGetLastError();
}

}  // namespace bitplane

// C interface (kernels/pack.py). Pointers are device pointers: u_r
// [8/group, K8, M] uint8, planes [n_digits, K8, M] uint8. Returns the
// cudaError_t of the launch.
extern "C" int bitplane_pack_launch(const void* u_r, void* planes, int K8,
                                    int M, int n_digits, int group,
                                    void* stream) {
  using namespace bitplane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch_pack<1>(u_r, planes, K8, M, n_digits, s);
    case 2: return launch_pack<2>(u_r, planes, K8, M, n_digits, s);
    case 4: return launch_pack<4>(u_r, planes, K8, M, n_digits, s);
    default: return cudaErrorInvalidValue;
  }
}
