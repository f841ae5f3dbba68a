"""Quickstart on the PyTorch port: the paper's two layers in a few
minutes, as examples/quickstart.py shows them on the reference.

1. The FPGA side — IMAGine, bit-exact: run a GEMV on the cycle-accurate
   PIM-array simulator, check it against numpy, fit the Gold Standard
   reduction model (paper Table IX).
2. The GPU side — the adapted technique: bit-plane quantize a weight
   matrix (K5 packs it on the card), run the bit-plane GEMV (K3 on the
   card; the plain PyTorch versions on the CPU), and see the bandwidth
   amplification that makes a decode GEMV faster.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      (on the card; add --device cpu to run the plain versions on the CPU)
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    DEVICES,
    ImagineConfig,
    ImagineGemv,
    fit_reduction_model,
    peak_tops,
    reduction_model_cycles,
)
from repro_torch.kernels import bitplane_gemv, ops, pack
from repro_torch.models.common import resolve_device


def fpga_side(device):
    print("=== 1. IMAGine (FPGA PIM simulator, bit-exact) ===")
    eng = ImagineGemv(ImagineConfig(rows=4, cols=8, lanes=8, depth=512,
                                    n_bits=8, acc_bits=24), device=device)
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, size=(16, 64))
    x = rng.integers(-128, 128, size=(64,))
    y, cycles = eng.run_gemv(w, x)
    assert np.array_equal(np.asarray(y.cpu()), w @ x)
    print(f"GEMV 16x64 int8: bit-exact vs numpy, {cycles} cycles "
          f"(analytic model: {eng.analytic_cycles(16, 64)})")
    u55 = DEVICES["U55"]
    print(f"U55 @ 737 MHz, 100% BRAMs: {u55.max_pe} PEs, "
          f"{peak_tops(u55.max_pe, 737.0, 8):.2f} TOPS @ int8 (paper: 0.33)")
    fit = fit_reduction_model(lambda n, p: reduction_model_cycles(n, p), 32)
    print(f"Gold Standard fit (Table IX): a={fit.a:.2f} b={fit.b:.2f} "
          f"c={fit.c:.0f}  (paper: 1.2 / 0.9 / 143) -> "
          f"{fit.interpretation()}")


def gpu_side(device):
    print("\n=== 2. Bit-plane GEMV (the H100 adaptation) ===")
    rng = np.random.default_rng(1)
    K, M, B = 1024, 1024, 4
    w = torch.tensor(rng.normal(size=(K, M)), dtype=torch.float32,
                     device=device)
    x = torch.tensor(rng.normal(size=(B, K)), dtype=torch.float32,
                     device=device)
    pack.LAUNCHES = bitplane_gemv.LAUNCHES = 0
    for n_bits, group in [(8, 1), (4, 1), (8, 2)]:
        planes, scale = ops.quantize_and_pack(w, n_bits, group)
        y = ops.bitplane_matmul(x, planes, scale, n_bits=n_bits, group=group)
        ref = x @ w
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        amp = (K * M * 2) / ops.packed_bytes(K, M, n_bits, group)
        tag = "bit-serial" if group == 1 else f"slice{2*group} (radix-4)"
        print(f"n_bits={n_bits} group={group} ({tag}): HBM amplification "
              f"{amp:.1f}x vs bf16, rel err {rel:.4f}")
    print(f"kernel launches on {device}: K5 pack {pack.LAUNCHES}, "
          f"K3 GEMV {bitplane_gemv.LAUNCHES}")
    print("decode GEMV is HBM-bound: fewer weight bytes == faster tokens —")
    print("the paper's 'BRAM is the limit' objective, on the GPU memory "
          "system.")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    fpga_side(device)
    gpu_side(device)


if __name__ == "__main__":
    main()
