"""Hand-written Hopper kernels of the port, with their plain versions.

paged_attention   K1, paged decode attention (csrc/paged_decode.cu)
paged_prefill     K2, paged prefill attention (csrc/paged_prefill.cu)
bitplane_gemv     K3, bit-plane GEMV (csrc/bitplane_gemv.cu)
bitplane_gemm     K4, bit-plane GEMM (csrc/bitplane_gemm.cu)
bitplane_grouped  K6, grouped bit-plane GEMV over expert-sorted rows
                  (csrc/bitplane_grouped.cu)
pack              K5, bit-plane pack (csrc/bitplane_pack.cu)
paged_common      int8 page codec, bucketed dispatch scaffold, the
                  wrappers' operand checks
ops               impl dispatch (`auto` | `cuda` | `ref`), the
                  length-bucketed dispatch planner, and the bit-plane ops
                  (`quantize_and_pack`, `bitplane_matmul`)
ref               plain PyTorch versions of K1-K5 and the bit-plane
                  format
_build            nvcc build at first use, ctypes loading

Only the modules are exported — `kernels.paged_attention` is the K1
module (with its `LAUNCHES` counter), never a function of the same
name. Importing this package needs neither nvcc nor a GPU.
"""

from . import (
    bitplane_gemm,
    bitplane_gemv,
    bitplane_grouped,
    ops,
    pack,
    paged_attention,
    paged_common,
    paged_prefill,
    ref,
)

__all__ = ["bitplane_gemm", "bitplane_gemv", "bitplane_grouped", "ops", "pack",
           "paged_attention", "paged_common", "paged_prefill", "ref"]
