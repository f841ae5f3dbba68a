"""Hand-written Hopper kernels of the port, with their plain versions.

paged_attention   K1, paged decode attention (csrc/paged_decode.cu)
paged_prefill     K2, paged prefill attention (csrc/paged_prefill.cu)
paged_common      int8 page codec, bucketed dispatch scaffold, the
                  wrappers' operand checks
ops               impl dispatch (`auto` | `cuda` | `ref`) and the
                  length-bucketed dispatch planner
ref               plain PyTorch versions of K1 and K2
_build            nvcc build at first use, ctypes loading

Only the modules are exported — `kernels.paged_attention` is the K1
module (with its `LAUNCHES` counter), never a function of the same
name. Importing this package needs neither nvcc nor a GPU.
"""

from . import ops, paged_attention, paged_common, paged_prefill, ref

__all__ = ["ops", "paged_attention", "paged_common", "paged_prefill", "ref"]
