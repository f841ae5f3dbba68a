"""Roofline constants and term math: the `ChipSpec` / `RooflineTerms` /
`roofline_terms` part of `repro.core.tpu_gold`, for the port's card.

The reference's "gold standard" reads: the roofline term of the limiting
hardware unit is the step-time lower bound, and nothing else may
dominate it. For the bandwidth-bound paged decode walk and the GEMVs the
limit is HBM; for large prefill GEMMs it is the tensor cores.

Terms (seconds):

    compute    = flops            / peak_flops_bf16
    memory     = bytes            / hbm_bandwidth
    collective = collective_bytes / (ici_bandwidth * ici_links)

The field names are the reference's, so code that reads them ports
unchanged. On an H100 they mean:

  peak_flops_bf16  dense bf16 tensor-core peak (no sparsity)
  hbm_bandwidth    HBM3 bandwidth
  hbm_capacity     device memory
  ici_bandwidth    one NVLink 4 link (both directions)
  ici_links        NVLink 4 links per card (18, 900 GB/s in all)
  vmem_bytes       shared memory per SM (the on-chip scratch a kernel
                   stages tiles in, the role VMEM plays on a TPU)

`H100_SXM` holds the data-sheet figures of one H100 SXM5 80 GB and is
the port's default chip. The reference's TPU spec is not copied: no
TPU figure prices anything here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware constants of one accelerator card."""

    name: str
    peak_flops_bf16: float  # FLOP/s
    hbm_bandwidth: float    # bytes/s
    hbm_capacity: float     # bytes
    ici_bandwidth: float    # bytes/s per link
    ici_links: int          # usable links per card
    vmem_bytes: float = 228 * 1024  # shared memory per SM

    @property
    def flops_per_byte(self) -> float:
        """Machine balance: arithmetic intensity at the roofline ridge."""
        return self.peak_flops_bf16 / self.hbm_bandwidth


#: one H100 SXM5 80 GB, from the data sheet
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80e9,
    ici_bandwidth=50e9,
    ici_links=18,
    vmem_bytes=228 * 1024,
)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one (arch x shape x mesh) cell."""

    cell: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float  # summed operand bytes of all collectives
    model_flops: float       # 6*N*D (train) or 2*N_active*tokens (serve)
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: float = 0.0
    #: the peak `roofline_fraction` prices useful work at (the spec's)
    peak_flops: float = H100_SXM.peak_flops_bf16

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """model_flops / flops: the share of the counted compute that is
        algorithmically necessary."""
        if self.hlo_flops <= 0:
            return float("nan")
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """(time of the per-device model_flops at peak) / (largest term):
        1.0 when the dominant term is all useful compute."""
        if self.bound_s <= 0:
            return float("nan")
        return self.model_flops / self.peak_flops / self.bound_s

    @property
    def gold_memory_fraction(self) -> float:
        """memory term / bound: 1.0 when HBM is the limit."""
        if self.bound_s <= 0:
            return float("nan")
        return self.memory_s / self.bound_s

    def as_dict(self) -> Dict[str, object]:
        return {
            "cell": self.cell,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "bound_s": self.bound_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
        }


def roofline_terms(
    cell: str,
    chips: int,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    model_flops: float,
    chip: ChipSpec = H100_SXM,
    bytes_per_device: float = 0.0,
) -> RooflineTerms:
    """Build the three-term roofline from per-device flop, byte and
    collective counts (the names keep the reference's `hlo_` prefix;
    the port has no compiler cost analysis, so the caller counts them)."""
    compute_s = hlo_flops / chip.peak_flops_bf16
    memory_s = hlo_bytes / chip.hbm_bandwidth
    collective_s = collective_bytes / (chip.ici_bandwidth * chip.ici_links)
    return RooflineTerms(
        cell=cell,
        chips=chips,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops / max(chips, 1),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bytes_per_device=bytes_per_device,
        peak_flops=chip.peak_flops_bf16,
    )
