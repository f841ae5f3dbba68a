"""FPGA device + published-design registries (paper Tables I, II, VII, VIII):
a copy of `repro.core.fpga_devices`, the paper's published data.

These are the paper's raw data, kept as structured constants so the
benchmarks can reproduce every table/figure and the Gold Standard math can
score any design absolutely (relative frequency, ideal scaling, max PEs).

PE accounting (paper §V-C / Table VII): one PiCaSO block uses one RAMB18
(half a RAMB36) and provides 16 bit-serial PEs, so

    max_pe = BRAM36_count * 32
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

PES_PER_RAMB36 = 32  # 2 x RAMB18 x 16 bitline PEs


@dataclasses.dataclass(frozen=True)
class FpgaDevice:
    """One device row of Table VII (+ BRAM Fmax from vendor datasheets)."""

    part: str
    family: str          # "US+", "V7", "Stratix10", "Arria10"
    bram36: int          # RAMB36-equivalent count (M20K for Intel)
    lut_bram_ratio: int
    bram_fmax_mhz: float
    short_id: str
    luts: Optional[int] = None

    @property
    def max_pe(self) -> int:
        return self.bram36 * PES_PER_RAMB36

    @property
    def bram_period_ns(self) -> float:
        return 1e3 / self.bram_fmax_mhz

    @property
    def total_luts(self) -> int:
        return self.luts if self.luts is not None else self.bram36 * self.lut_bram_ratio


# Table VII (paper) + BRAM Fmax: US+ -2/-3 = 737 MHz [DS923], V7 -2 = 601 MHz
# [DS183], Stratix10 = 1000 MHz, Arria10 = 730 MHz (paper Table I).
DEVICES: Dict[str, FpgaDevice] = {
    d.short_id: d
    for d in [
        FpgaDevice("xcu55c-fsvh-2", "US+", 2016, 646, 737.0, "U55"),
        FpgaDevice("xc7vx330tffg-2", "V7", 750, 272, 601.0, "V7-a"),
        FpgaDevice("xc7vx485tffg-2", "V7", 1030, 295, 601.0, "V7-b"),
        FpgaDevice("xc7v2000tfhg-2", "V7", 1292, 946, 601.0, "V7-c"),
        FpgaDevice("xc7vx1140tflg-2", "V7", 1880, 379, 601.0, "V7-d"),
        FpgaDevice("xcvu3p-ffvc-3", "US+", 720, 547, 737.0, "US-a"),
        FpgaDevice("xcvu23p-vsva-3", "US+", 2112, 488, 737.0, "US-b"),
        FpgaDevice("xcvu19p-fsvb-2", "US+", 2160, 1892, 737.0, "US-c"),
        FpgaDevice("xcvu29p-figd-3", "US+", 2688, 643, 737.0, "US-d"),
        # Evaluation platforms of the compared designs (Tables I/VIII).
        FpgaDevice("stratix10-gx2800", "Stratix10", 11721, 161, 1000.0, "S10"),
        FpgaDevice("arria10-gx900", "Arria10", 2423, 140, 730.0, "A10"),
    ]
}


@dataclasses.dataclass(frozen=True)
class PublishedPim:
    """One row of Table I / Table VIII: a published PIM design."""

    name: str
    kind: str                    # "custom" | "overlay"
    device_id: str               # key into DEVICES
    f_pim_mhz: Optional[float]   # PIM tile/block Fmax (Table I)
    f_sys_mhz: Optional[float]   # system Fmax (Tables I/VIII)
    bram_util: Optional[float]   # fraction of BRAMs used as PIM (Table VIII)
    lut_util: Optional[float] = None
    dsp_util: Optional[float] = None

    @property
    def device(self) -> FpgaDevice:
        return DEVICES[self.device_id]

    @property
    def rel_f_pim(self) -> Optional[float]:
        if self.f_pim_mhz is None:
            return None
        return self.f_pim_mhz / self.device.bram_fmax_mhz

    @property
    def rel_f_sys(self) -> Optional[float]:
        if self.f_sys_mhz is None:
            return None
        return self.f_sys_mhz / self.device.bram_fmax_mhz


# Table I (block + system frequencies) merged with Table VIII (utilization).
PUBLISHED: Dict[str, PublishedPim] = {
    p.name: p
    for p in [
        PublishedPim("CCB", "custom", "S10", 624.0, 455.0, 0.55, lut_util=0.60, dsp_util=0.50),
        PublishedPim("CoMeFa-A", "custom", "A10", 294.0, 288.0, 0.918, lut_util=0.279, dsp_util=0.901),
        PublishedPim("CoMeFa-D", "custom", "A10", 588.0, 292.0, 0.867, lut_util=0.255, dsp_util=0.924),
        PublishedPim("BRAMAC-2SA", "custom", "A10", 586.0, None, None),
        PublishedPim("BRAMAC-1DA", "custom", "A10", 500.0, None, None),
        PublishedPim("M4BRAM", "custom", "A10", 553.0, None, None),
        PublishedPim("SPAR-2", "overlay", "U55", 445.0, 200.0, 0.145, lut_util=0.113, dsp_util=0.0),
        PublishedPim("SPAR-2-V7", "overlay", "V7-b", None, 130.0, 0.304, lut_util=0.285, dsp_util=0.0),
        PublishedPim("PiMulator", "overlay", "U55", None, 333.0, None),
        PublishedPim("PiCaSO", "overlay", "U55", 737.0, None, None),
        PublishedPim("RIMA-Fast", "custom", "S10", 624.0, 455.0, 0.55, lut_util=0.60, dsp_util=0.50),
        PublishedPim("RIMA-Large", "custom", "S10", 624.0, 278.0, 0.93, lut_util=0.89, dsp_util=0.50),
        # Table VIII GEMV/GEMM engines (evaluated on Arria 10 GX900)
        PublishedPim("CCB-GEMV", "custom", "A10", 624.0, 231.0, 0.918, lut_util=0.279, dsp_util=0.901),
        PublishedPim("CoMeFa-A-GEMV", "custom", "A10", 294.0, 242.0, 0.918, lut_util=0.279, dsp_util=0.901),
        PublishedPim("CoMeFa-D-GEMM", "custom", "A10", 588.0, 267.0, 0.867, lut_util=0.255, dsp_util=0.924),
        PublishedPim("IMAGine", "overlay", "U55", 737.0, 737.0, 1.0, lut_util=0.356, dsp_util=0.0),
        PublishedPim("IMAGine-CB", "custom", "U55", 737.0, 737.0, 1.0, lut_util=0.101, dsp_util=0.0),
    ]
}


# Table II: 1-level logic-path delay budget (ns). V7 BRAM period from DS183.
DELAY_BUDGET_NS = {
    "V7": {"ff_c2q": 0.290, "lut": 0.34, "ff_setup": 0.255, "bram_period": 1.664,
           "net_budget": 0.954, "min_net": 0.272},
    "US+": {"ff_c2q": 0.087, "lut": 0.15, "ff_setup": 0.098, "bram_period": 1.356,
            "net_budget": 1.021, "min_net": 0.102},
}


def logic_levels_at_bram_fmax(family: str) -> int:
    """How many LUT levels fit in the BRAM period (paper §III-A argues >=2)."""
    d = DELAY_BUDGET_NS[family]
    cell = d["ff_c2q"] + d["ff_setup"]
    budget = d["bram_period"] - cell
    per_level = d["lut"] + d["min_net"]
    return int(budget // per_level)


# ---------------------------------------------------------------------------
# Peak-performance / scaling model (Fig. 1, §V-D)
# ---------------------------------------------------------------------------

def mac_cycles_radix2(nbits: int) -> int:
    """Bit-serial Booth radix-2 MAC latency (cycles) for the PiCaSO-style
    overlay PE. Calibrated so IMAGine on U55 @ 8-bit yields the paper's
    0.33 TOPS: 64512 PEs * 737 MHz * 2 ops / (4*8*9) = 0.330 TOPS."""
    return 4 * nbits * (nbits + 1)


def mac_cycles_radix4(nbits: int) -> int:
    """Booth radix-4 halves the number of partial-product steps (§V-G)."""
    return 2 * nbits * (nbits // 2 + 1)


def peak_tops(
    n_pe: int, f_mhz: float, nbits: int = 8, radix: int = 2
) -> float:
    """Peak TOPS of a bit-serial PIM array (2 ops per MAC)."""
    cycles = mac_cycles_radix2(nbits) if radix == 2 else mac_cycles_radix4(nbits)
    return n_pe * f_mhz * 1e6 * 2.0 / cycles / 1e12


def ideal_scaling_tops(
    device_id: str, bram_fraction: float, nbits: int = 8, f_mhz: Optional[float] = None
) -> float:
    """Gold Standard ideal-scaling line (Fig. 1): TOPS grows linearly with
    the BRAM count at the (ideally, BRAM-Fmax) clock."""
    dev = DEVICES[device_id]
    f = f_mhz if f_mhz is not None else dev.bram_fmax_mhz
    n_pe = int(dev.max_pe * bram_fraction)
    return peak_tops(n_pe, f, nbits=nbits)


# RIMA actual TOPS points (Fig. 1, derived from Table II of the RIMA paper:
# BRAM utilization fraction -> (f_sys MHz, achieved TOPS @ int8)).
RIMA_SCALING_POINTS: List[dict] = [
    {"bram_fraction": 0.23, "f_sys_mhz": 455.0},
    {"bram_fraction": 0.42, "f_sys_mhz": 428.0},
    {"bram_fraction": 0.55, "f_sys_mhz": 455.0},
    {"bram_fraction": 0.76, "f_sys_mhz": 366.0},
    {"bram_fraction": 0.93, "f_sys_mhz": 278.0},
]


@dataclasses.dataclass(frozen=True)
class UtilizationEstimate:
    """IMAGine resource model (Tables V/VI, Fig. 5).

    Per PiCaSO-IM block (half RAMB36): 85 LUTs, 125 FFs (Table V).
    Controller per 12x2-block tile: 167 LUTs, 155 FFs; fanout 615 FFs
    (Table VI). We scale these to full-device 100%-BRAM overlays.
    """

    device_id: str
    n_blocks: int
    luts: int
    ffs: int
    lut_fraction: float
    n_pe: int


LUT_PER_BLOCK = 85
FF_PER_BLOCK = 125
CTRL_LUT_PER_TILE = 167
CTRL_FF_PER_TILE = 155 + 615
BLOCKS_PER_TILE = 24  # 12 x 2


def estimate_utilization(device_id: str, bram_fraction: float = 1.0) -> UtilizationEstimate:
    dev = DEVICES[device_id]
    n_blocks = int(dev.bram36 * 2 * bram_fraction)  # RAMB18-based blocks
    n_tiles = max(1, n_blocks // BLOCKS_PER_TILE)
    luts = n_blocks * LUT_PER_BLOCK + n_tiles * CTRL_LUT_PER_TILE
    ffs = n_blocks * FF_PER_BLOCK + n_tiles * CTRL_FF_PER_TILE
    return UtilizationEstimate(
        device_id=device_id,
        n_blocks=n_blocks,
        luts=luts,
        ffs=ffs,
        lut_fraction=luts / dev.total_luts,
        n_pe=n_blocks * 16,
    )
