"""Carry the reference's parameters across: JAX `init_lm` tree -> the
port's parameter tree.

The caller converts the JAX tree to numpy arrays (`np.asarray` on every
leaf); this module never sees a JAX array. Layer stacks stay stacked as
`[L, ...]`. Weights, biases and embeddings are cast once to the compute
dtype — bit-equivalent, because every use in the reference casts them
to the activation dtype first — while the leaves the reference applies
in f32 stay f32: rmsnorm gains (`g`), MoE routers (`router`; one
rounded to bf16 would route tokens differently), Mamba2's `conv_w`,
`conv_b`, `A_log`, `D` and `dt_bias` (decode's conv is an f32
contraction with the raw `conv_w`), and the sLSTM's `r_gates` and
`b_gates`. Encoder-decoder trees (`enc_layers`, `dec_layers`, `xattn`,
`enc_norm`, `dec_norm`) and zamba2's `shared` block cross by the same
rule.

Quantized trees cross too: a reference `PimWeight` whose planes and
scale the caller has turned into numpy (`jax.tree.map(np.asarray, ...)`
keeps the object and its `n_bits`/`group`) becomes the port's
`PimWeight`, planes kept uint8 and scales f32, bit for bit — with its
leading stack dims, `[L, K, M]` layer stacks and `[L, E, K, M]` MoE
expert stacks alike. Note what
that does and does not make equal: the port's own `init_lm` stores
weights in the compute dtype (bf16 at full width), the reference keeps
f32 masters, so quantizing the port's params and quantizing the
reference's agree only when both start from the same f32 array — which
is what the tests do (f32 configs, params carried across here).

The PIM simulator's state crosses too: `pim_array_from_reference` takes
a reference `PimArray` (its state is numpy already) and gives the
port's `PimArray` in the same state on a given device, so both
simulators can start from one random register file.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.pim_array import ArrayGeometry, PimArray
from .models.common import compute_dtype, resolve_device
from .quant.bitplane import PimWeight

#: the fields of a reference `PimWeight` (a bit-plane quantized leaf)
_PIM_FIELDS = ("planes", "scale", "n_bits", "group")
#: leaves the reference keeps and applies in f32 (`b_gates` is cast at
#: use, so either dtype is exact; f32 is kept, as the reference's)
_F32_LEAVES = ("g", "router", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "r_gates", "b_gates")


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None):
    """Convert a numpy-leaved reference parameter tree. `dtype` defaults
    to the config's compute dtype."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype) if dtype is None else dtype

    def convert(node, name: str):
        if isinstance(node, Mapping):
            return {k: convert(v, k) for k, v in node.items()}
        if all(hasattr(node, a) for a in _PIM_FIELDS):
            planes = np.array(node.planes, dtype=np.uint8)
            scale = np.array(node.scale, dtype=np.float32)
            return PimWeight(torch.from_numpy(planes).to(dev),
                             torch.from_numpy(scale).to(dev),
                             int(node.n_bits), int(node.group))
        arr = np.asarray(node)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
        return t.to(device=dev,
                    dtype=torch.float32 if name in _F32_LEAVES else dt)

    return convert(tree, "")


def pim_array_from_reference(ref, device) -> PimArray:
    """A port `PimArray` on `device` holding a reference array's state:
    `rf`, `enable`, `ptr`, `n_bits`, `acc_bits`, `cycles`,
    `instr_count` and the words already shifted out."""
    g = ref.geom
    arr = PimArray(ArrayGeometry(g.rows, g.cols, g.lanes, g.depth), device)
    arr.rf.copy_(torch.from_numpy(np.array(ref.rf, dtype=np.uint8)))
    arr.enable.copy_(torch.from_numpy(np.array(ref.enable, dtype=bool)))
    arr.ptr, arr.n_bits, arr.acc_bits = (int(ref.ptr), int(ref.n_bits),
                                         int(ref.acc_bits))
    arr.cycles, arr.instr_count = int(ref.cycles), int(ref.instr_count)
    arr.out_buffer = [torch.from_numpy(np.array(v, dtype=np.int64)).to(
        arr.device) for v in ref.out_buffer]
    return arr


def spec_from_jax(spec) -> tuple:
    """A reference `PartitionSpec` (or a `NamedSharding`'s `.spec`) as
    the port's spec: a tuple of axis names, tuples of names or None,
    trailing Nones dropped."""
    out = [None if e is None else e if isinstance(e, str)
           else e[0] if len(e) == 1 else tuple(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def specs_from_jax(tree) -> Any:
    """A reference spec tree — dicts, and `PimWeight`s whose planes and
    scale are specs — in the port's form, `PimWeight`s kept (the port's
    `params_partition_specs` gives the same structure)."""
    from .quant.bitplane import PimWeight

    if isinstance(tree, Mapping):
        return {k: specs_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "planes") and hasattr(tree, "scale"):
        return PimWeight(spec_from_jax(tree.planes), spec_from_jax(tree.scale),
                         tree.n_bits, tree.group)
    return spec_from_jax(tree)
