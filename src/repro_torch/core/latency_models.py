"""Analytical cycle-latency models of the compared PIM designs: a copy
of `repro.core.latency_models`.

Reproduces the paper's Table IV (reduction/accumulation latency) and the
modelling behind Fig. 7 (GEMV cycle latency + execution time). The paper
models block-level latencies of CCB, CoMeFa, BRAMAC and SPAR-2 from their
published analytical models and IMAGine from its cycle-accurate simulator;
we do the same, with every constant documented here.

Conventions
-----------
N  operand precision (bits)
k  PE columns accumulated inside one PIM block
P  partial sums entering the array-level reduction network
D  square-matrix dimension for GEMV (y = W @ x, W: DxD)

Calibration notes (documented deviations / inferences):
  * IMAGine in-block: PiCaSO binary-hop (N+4)*log2(k); k=16 and N=32 give
    144 cycles — exactly the paper's stated in-block latency (Table IX
    discussion, c ~ 143).
  * CCB/CoMeFa in-block: 2N*log2(k)+log2(k)^2 with k=8 gives 201 cycles at
    N=32; +2 pipeline setup = 203 — the paper's c = 203.1.
  * Bit-serial MAC: 4N(N+1) cycles calibrated so IMAGine @8-bit on U55
    yields the paper's 0.33 TOPS (see fpga_devices.mac_cycles_radix2).
  * BRAMAC MAC latency is linear in N (hybrid bit-serial/parallel MAC2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

from .fpga_devices import (
    DEVICES,
    FpgaDevice,
    mac_cycles_radix2,
    mac_cycles_radix4,
)

LOG2 = math.log2


# ---------------------------------------------------------------------------
# Table IV — reduction/accumulation latency models
# ---------------------------------------------------------------------------

def spar2_linear_block(n: int, k: int) -> float:
    return 3.0 * n * (k - 1)


def spar2_linear_array(n: int, p: int) -> float:
    return 3.0 * n * (p - 1)


def spar2_binary_block(n: int, k: int) -> float:
    return 2.0 * n * LOG2(k) + n * (k - 1)


def spar2_binary_array(n: int, p: int) -> float:
    return 2.0 * n * LOG2(p) + n * (p - 1)


def ccb_block(n: int, k: int = 8) -> float:
    return 2.0 * n * LOG2(k) + LOG2(k) ** 2


def ccb_array(n: int, p: int) -> float:
    return LOG2(p) + 2.0


def binary_hopping_block(n: int, k: int) -> float:
    return (n + 4.0) * LOG2(k)


def binary_hopping_array(n: int, p: int) -> float:
    return (n + 4.0) * LOG2(p) + (p - 1)


TABLE_IV: Dict[str, Dict[str, Callable[..., float]]] = {
    "spar2-linear": {"block": spar2_linear_block, "array": spar2_linear_array},
    "spar2-binary": {"block": spar2_binary_block, "array": spar2_binary_array},
    "ccb-comefa": {"block": ccb_block, "array": ccb_array},
    "binary-hopping": {"block": binary_hopping_block, "array": binary_hopping_array},
}


def total_reduction_cycles(design: str, n: int, p: int, k: int = 16) -> float:
    """In-block + array-level reduction cycles — the quantity eqn (1) is
    curve-fitted against (the paper folds eqn (2) into `c`)."""
    m = TABLE_IV[design]
    if design == "ccb-comefa":
        return m["block"](n, 8) + m["array"](n, p)
    return m["block"](n, k) + m["array"](n, p)


# ---------------------------------------------------------------------------
# Per-design MAC models (Fig. 7 building block)
# ---------------------------------------------------------------------------

def mac_imagine(n: int) -> float:
    return float(mac_cycles_radix2(n))


def mac_imagine_slice4(n: int) -> float:
    return float(mac_cycles_radix4(n))


def mac_spar2(n: int) -> float:
    # Same bit-serial PE lineage as PiCaSO (2 cycles/bit basis).
    return float(mac_cycles_radix2(n))


def mac_ccb_comefa(n: int) -> float:
    # Neural-Cache-style bit-serial multiply: N^2 + 3N - 2 ops, at 2 cycles
    # per op in the GEMV system context (SA cycling / time-multiplexing
    # latches, paper SS II-A).
    return float(2 * (n * n + 3 * n - 2))


def mac_bramac(n: int) -> float:
    # Hybrid bit-serial & bit-parallel MAC2: linear in N (paper §V-F).
    return float(3 * n + 10)


# ---------------------------------------------------------------------------
# GEMV latency model (Fig. 7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PimDesignModel:
    """Analytical model of one design for the Fig. 7 comparison."""

    name: str
    mac: Callable[[int], float]
    block_reduce: Callable[[int, int], float]
    array_reduce: Callable[[int, int], float]
    k: int                      # PE columns per block
    f_sys_mhz: Optional[float]  # system clock (Table VIII); None = unreported
    lanes_per_row: int = 512    # PE lanes in one block-row (U55: 32 blks x 16)
    broadcast_overlapped: bool = False
    movement_slice: int = 1     # bit-sliced accumulation width (slice4 -> 4)

    def gemv_cycles(self, d: int, n: int, n_pe: int) -> float:
        """Cycle latency of y = W @ x with W (d x d), weights at n bits.

        Mapping (max-parallelism striping, matching the IMAGine engine):
        one output row is striped across one block-row's `lanes_per_row`
        lanes (`e = ceil(d / lanes_per_row)` weights per lane); in-block
        reduction folds the k lanes of each block, array-level reduction
        accumulates the `P = ceil(s / k)` block partials (eqn 1 dataflow);
        `n_pe / s` output rows run concurrently per pass. Weights are
        assumed PIM-resident (streamed in ahead of time, as in Fig. 7).
        """
        s = min(d, self.lanes_per_row)        # lanes striping one row
        e = math.ceil(d / s)                  # weights per lane
        rows_per_pass = max(1, n_pe // (s * e))
        passes = math.ceil(d / rows_per_pass)
        broadcast = 0.0 if self.broadcast_overlapped else float(n)
        mult = passes * e * (self.mac(n) + broadcast)
        # Reduction: in-block over k lanes, array-level over P block columns
        p_blocks = max(1, math.ceil(s / self.k))
        red = self.block_reduce(n, self.k)
        if p_blocks > 1:
            red += self.array_reduce(n, p_blocks)
        if self.movement_slice > 1:
            # bit-sliced accumulation network moves slice bits per cycle
            red = red / self.movement_slice + LOG2(self.k)
        readout = float(d)  # column shift-register readout, 1 elem/cycle
        return mult + red * passes + readout

    def gemv_time_us(self, d: int, n: int, n_pe: int) -> Optional[float]:
        if self.f_sys_mhz is None:
            return None
        return self.gemv_cycles(d, n, n_pe) / self.f_sys_mhz


DESIGN_MODELS: Dict[str, PimDesignModel] = {
    m.name: m
    for m in [
        PimDesignModel(
            "IMAGine", mac_imagine, binary_hopping_block, binary_hopping_array,
            k=16, f_sys_mhz=737.0,
        ),
        PimDesignModel(
            "IMAGine-slice4", mac_imagine_slice4, binary_hopping_block,
            binary_hopping_array, k=16, f_sys_mhz=737.0, movement_slice=4,
        ),
        PimDesignModel(
            "SPAR-2", mac_spar2, spar2_binary_block, spar2_binary_array,
            k=16, f_sys_mhz=200.0,
        ),
        PimDesignModel(
            "SPAR-2-linear", mac_spar2, spar2_linear_block, spar2_linear_array,
            k=16, f_sys_mhz=200.0,
        ),
        PimDesignModel(
            "CCB", mac_ccb_comefa, lambda n, k: ccb_block(n, 8), ccb_array,
            k=16, f_sys_mhz=231.0, broadcast_overlapped=True,
        ),
        PimDesignModel(
            "CoMeFa-D", mac_ccb_comefa, lambda n, k: ccb_block(n, 8), ccb_array,
            k=16, f_sys_mhz=267.0, broadcast_overlapped=True,
        ),
        PimDesignModel(
            "BRAMAC", mac_bramac, lambda n, k: ccb_block(n, 8), ccb_array,
            k=16, f_sys_mhz=None, broadcast_overlapped=True,
        ),
    ]
}


def reduction_cycles_for_fit(design: str) -> Callable[[int, int], float]:
    """latency_fn(n, p) used by gold_standard.fit_reduction_model — the
    'any cycle outside the multiplication stage' definition of §V-G."""
    mdl = DESIGN_MODELS[design]

    def fn(n: int, p: int) -> float:
        return mdl.block_reduce(n, mdl.k) + mdl.array_reduce(n, p)

    return fn
