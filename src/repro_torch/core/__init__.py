"""Core: the paper's primary contribution — Gold Standard + IMAGine.

Counterpart of `repro.core`: the ISA, the bit-exact PIM array and the
IMAGine GEMV engine (register file on a torch device, the card by
default), the Gold Standard, the latency models, the FPGA registries,
the roofline helpers with the H100 as the port's chip (`H100_SXM` in
place of the reference's TPU spec), and the step models of
`reduction.py` (its mesh collectives wait for the distribution layer).
"""

from .gold_standard import (
    GoldRange,
    GoldScore,
    ReductionFit,
    array_reduction_gold,
    fit_reduction_model,
    inblock_reduction_gold,
    score_published,
)
from .fpga_devices import DEVICES, PUBLISHED, FpgaDevice, PublishedPim, peak_tops
from .gemv_engine import ImagineConfig, ImagineGemv, reduction_model_cycles
from .isa import Instr, Op, assemble, cycle_cost
from .pim_array import ArrayGeometry, PimArray
from .tpu_gold import H100_SXM, ChipSpec, RooflineTerms, roofline_terms

__all__ = [
    "GoldRange", "GoldScore", "ReductionFit", "array_reduction_gold",
    "fit_reduction_model", "inblock_reduction_gold", "score_published",
    "DEVICES", "PUBLISHED", "FpgaDevice", "PublishedPim", "peak_tops",
    "ImagineConfig", "ImagineGemv", "reduction_model_cycles",
    "Instr", "Op", "assemble", "cycle_cost",
    "ArrayGeometry", "PimArray",
    "H100_SXM", "ChipSpec", "RooflineTerms", "roofline_terms",
]
