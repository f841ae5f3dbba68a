"""PIM-resident weights: bit-plane quantized linear layers. Counterpart
of `repro.quant.bitplane`.

Any projection of the model can hold its weight as packed digit planes
(`PimWeight`) instead of a dense tensor; `pim_linear` then runs it
through `kernels.ops.bitplane_matmul` — K3/K4 on the card, the plain
version on the CPU. A PIM-resident weight moves n_bits/16 of the
device bytes of its bf16 twin, the paper's "use all of the memory
bandwidth for useful operand bits".

Differences from the reference, none of which changes a result:
  * `PimWeight` is a plain class, not a pytree; a stacked weight's layer
    view is `w[l]` (`models.transformer.layer_params` slices it).
  * `from_dense` packs every [K, M] slice of a stacked weight through
    `ops.quantize_and_pack` with the config's impl, so on the card each
    slice is one K5 launch (196 for qwen2-1.5b's 28 layers x 7
    projections). The reference packs stacked weights with its jnp
    `pack_ref`; the planes are byte-identical.
  * `pim_linear` takes the serving step's `impl` (see its docstring).

Under a mesh a `PimWeight` is cut by its planes' and scale's specs
(`launch.specs.param_shardings`, `dist.sharding.place_tree`): a column
block of M is what quantizing and packing those columns gives (the scale
is per column); a block of K8 holds whole rows, since a byte packs 8 / g
consecutive rows, with the whole weight's scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..kernels import ops as kops
from ..kernels import ref


@dataclasses.dataclass(frozen=True)
class PimQuantConfig:
    """Per-model quantization policy."""

    n_bits: int = 8
    group: int = 1          # 1 = bit-serial (radix-2), 2 = slice4 analogue
    impl: str = "auto"      # auto | cuda | ref (kernels.ops.resolve_impl)
    min_features: int = 1024  # skip tiny matrices (norm gains, small heads)

    @property
    def n_digits(self) -> int:
        return -(-self.n_bits // self.group)


class PimWeight:
    """A quantized weight: packed digit planes + dequant scale.

    `planes` is [..., n_digits, K*g//8, M] uint8 and `scale` [..., M] f32,
    with the same leading stack dims ([L] for a layer stack)."""

    def __init__(self, planes: torch.Tensor, scale: torch.Tensor,
                 n_bits: int, group: int):
        self.planes = planes
        self.scale = scale
        self.n_bits = n_bits
        self.group = group

    def __getitem__(self, l) -> "PimWeight":
        """The view of stack entry `l` (planes[l], scale[l])."""
        return PimWeight(self.planes[l], self.scale[l], self.n_bits,
                         self.group)

    @property
    def shape(self):
        """Logical dense [K, M] (leading stack dims dropped)."""
        nd, k8, m = self.planes.shape[-3:]
        return (k8 * 8 // self.group, m)

    @property
    def n_stack(self) -> int:
        return math.prod(self.planes.shape[:-3])

    @property
    def packed_bytes(self) -> int:
        k, m = self.shape
        return self.n_stack * kops.packed_bytes(k, m, self.n_bits, self.group)

    @classmethod
    def from_dense(cls, w: torch.Tensor, cfg: PimQuantConfig) -> "PimWeight":
        """w: [K, M] with any leading stack dims ([L, K, M] layer stacks);
        leading axes are kept, each [K, M] slice quantized on its own."""
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        k, m = flat.shape[1:]
        nd = cfg.n_digits
        planes = torch.empty((flat.shape[0], nd, k * cfg.group // 8, m),
                             dtype=torch.uint8, device=w.device)
        scale = torch.empty((flat.shape[0], m), dtype=torch.float32,
                            device=w.device)
        for i in range(flat.shape[0]):
            planes[i], scale[i] = kops.quantize_and_pack(
                flat[i], cfg.n_bits, cfg.group, cfg.impl)
        return cls(planes=planes.reshape(lead + planes.shape[1:]),
                   scale=scale.reshape(lead + (m,)), n_bits=cfg.n_bits,
                   group=cfg.group)

    def dequantize(self) -> torch.Tensor:
        return ref.dequantize_ref(self.planes, self.scale, self.n_bits,
                                  self.group)


def pim_linear(x: torch.Tensor, w: Any, impl: str = "auto") -> torch.Tensor:
    """Linear dispatch: dense matmul in x's dtype, or the bit-plane op.

    `w` is a dense tensor [K, M] or a PimWeight. `impl` is the serving
    step's kernel impl, passed down so that `kernel_impl="ref"` selects
    every plain version at once — this is the one difference from the
    reference, whose callers leave `pim_linear` at `auto`; it exists so
    that a whole drain can be compared kernels-versus-plain on the card
    (`chip_smoke.py`). A dense weight ignores it: its product runs
    outside any kernel of the repo, in the reference too."""
    if isinstance(w, PimWeight):
        return kops.bitplane_matmul(x, w.planes, w.scale, n_bits=w.n_bits,
                                    group=w.group, impl=impl)
    return x @ w.to(x.dtype)


def quantize_tree(
    params: Dict[str, Any],
    cfg: PimQuantConfig,
    path: str = "",
) -> Dict[str, Any]:
    """Convert every eligible weight in a param tree to PimWeight.

    Eligible = a float tensor with 2-4 dims whose last two dims are both
    >= cfg.min_features, whose K is a multiple of 8/g, and whose leaf
    name starts with 'w' (projection kernels by convention; embeddings,
    norms, biases stay dense)."""
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        sub = f"{path}/{name}"
        if isinstance(leaf, dict):
            out[name] = quantize_tree(leaf, cfg, sub)
        elif (
            isinstance(leaf, torch.Tensor)
            and 2 <= leaf.dim() <= 4
            and name.startswith("w")
            and leaf.shape[-2] >= cfg.min_features
            and leaf.shape[-1] >= cfg.min_features
            and (leaf.shape[-2] * cfg.group) % 8 == 0
            and leaf.is_floating_point()
        ):
            out[name] = PimWeight.from_dense(leaf, cfg)
        else:
            out[name] = leaf
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tree_packed_fraction(params: Dict[str, Any]) -> float:
    """Fraction of parameter bytes that are PIM-resident (packed). Bytes
    are those of the tree as stored: the port keeps dense leaves in the
    compute dtype, the reference its f32 masters, so the fraction of a
    bf16 model differs from the reference's for the same config."""
    packed = 0
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PimWeight):
            packed += leaf.packed_bytes
            total += leaf.packed_bytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return packed / total if total else 0.0
