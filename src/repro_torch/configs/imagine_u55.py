"""The paper's own accelerator configuration: IMAGine on Alveo U55 (a
copy of `repro.configs.imagine_u55`).

Not an LM — the FPGA-side config consumed by the simulator and the
paper-table computations. 2016 RAMB36 -> 4032 PiCaSO-IM blocks -> 64512
bit-serial PEs @ 737 MHz (100% BRAM, Gold Standard clocking; the paper's
figures).
"""

from ..core.gemv_engine import ImagineConfig


def config() -> ImagineConfig:
    # full-device logical array: 126 block-rows x 32 block-cols x 16 lanes
    # = 64512 PEs (4032 RAMB18 = 2016 RAMB36, 100% of U55). The physical
    # 12x2-block tiles (Fig. 6) are a floorplanning grouping of this array;
    # the hop network needs a power-of-two column count.
    return ImagineConfig(rows=126, cols=32, lanes=16, depth=1024, n_bits=8)


def smoke() -> ImagineConfig:
    return ImagineConfig(rows=2, cols=4, lanes=4, depth=256, n_bits=8, acc_bits=24)
