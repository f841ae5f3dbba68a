"""Bit-plane quantization containers (the PIM-resident weight format)."""

from .bitplane import (
    PimQuantConfig,
    PimWeight,
    pim_linear,
    quantize_tree,
    tree_packed_fraction,
)

__all__ = ["PimQuantConfig", "PimWeight", "pim_linear", "quantize_tree",
           "tree_packed_fraction"]
