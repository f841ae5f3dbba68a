"""Serving example on the PyTorch port, as examples/serve_pim_gemv.py
serves on the reference: continuous-batching decode with PIM-resident
(bit-plane quantized) weights — the paper's GEMV engine as a serving
feature.

Compares dense vs 8-bit bit-serial (group=1) vs 8-bit slice4-style
(group=2, Booth-radix-4 analogue) serving: the packed fraction of the
parameter bytes, the token agreement with the dense run, and then a
paged continuous-batching drain over ragged prompts with prefix sharing
on, whose greedy tokens equal those of the same drain without it.

On the card the bit-plane projections run K3 (decode rows) and K4
(prefill rows above 512), packed by K5, and the paged drain runs K1 and
K2; on the CPU (`--device cpu`) the plain PyTorch versions stand in.

Run:  PYTHONPATH=src python examples/serve_pim_gemv_torch.py
      (on the card; add --device cpu for the CPU)

Paged serving and prefix sharing take the same arguments as the
reference's (`ServeConfig(paged=True, block_size=16)`,
`ContinuousBatcher(..., paged=True, block_size=16, prefix=True)`), plus
`device=`; telemetry attaches as there (`obs.ServeTelemetry`).
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (bitplane_gemm, bitplane_gemv, pack,
                                 paged_attention, paged_prefill)
from repro_torch.models import init_lm
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import count_params
from repro_torch.quant.bitplane import PimQuantConfig
from repro_torch.serve import (ContinuousBatcher, Request, ServeConfig,
                               ServeEngine)

KERNELS = {"K1": paged_attention, "K2": paged_prefill, "K3": bitplane_gemv,
           "K4": bitplane_gemm, "K5": pack}


def launches() -> str:
    return " ".join(f"{k}={m.LAUNCHES}" for k, m in KERNELS.items())


def drain(cfg, params, prompts, device, prefix: bool):
    """Six ragged requests through 2 paged slots; returns the tokens."""
    cb = ContinuousBatcher(cfg, params, n_slots=2, cache_len=48, paged=True,
                           block_size=8, prefix=prefix, device=device)
    for uid, t in enumerate([8, 5, 11, 3, 8, 6]):
        cb.submit(Request(uid=uid, prompt=prompts[uid % 4][:t],
                          max_new_tokens=4))
    return cb.run_until_drained()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    for m in KERNELS.values():
        m.LAUNCHES = 0

    cfg = get_config("qwen2-1.5b", smoke=True)
    # f32 leaves, as the reference's init keeps them (the packed fraction
    # is of these bytes); the model computes in the config's bf16
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(cfg, gen, device, param_dtype=torch.float32)
    print(f"model: {cfg.name} (smoke), {count_params(params)/1e3:.0f}K "
          f"params, on {device}")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 11)).astype(np.int32)

    sc = ServeConfig(max_cache_len=48, max_new_tokens=8, device=str(device))
    dense = ServeEngine(cfg, params, sc).generate(prompts[:, :8])
    print("dense tokens      :", dense[0].tolist())

    for n_bits, group, tag in [(8, 1, "bit-serial r2"), (8, 2, "slice4 / r4")]:
        e = ServeEngine(cfg, params, sc)
        frac = e.quantize(PimQuantConfig(n_bits=n_bits, group=group,
                                         min_features=16))
        out = e.generate(prompts[:, :8])
        agree = float((out == dense).float().mean())
        print(f"{tag:14s} int{n_bits}: packed {frac:.0%} of param bytes, "
              f"token agreement {agree:.0%} -> {out[0].tolist()}")

    # paged continuous batching with prefix sharing, ragged prompts, in
    # f32 with 8-bit weights: greedy tokens compare exactly only in f32
    # (bf16 argmax near-ties flip between differently shaped launches)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    e32 = ServeEngine(cfg32, init_lm(
        cfg32, torch.Generator(device=device).manual_seed(0), device,
        param_dtype=torch.float32), sc)
    e32.quantize(PimQuantConfig(n_bits=8, min_features=16))
    t0 = time.perf_counter()
    shared = drain(cfg32, e32.params, prompts, device, prefix=True)
    dt = time.perf_counter() - t0
    plain = drain(cfg32, e32.params, prompts, device, prefix=False)
    n_tok = sum(len(v) for v in shared.values())
    print(f"\ncontinuous batching (paged, prefix sharing): {len(shared)} "
          f"ragged requests, {n_tok} tokens, {dt:.1f}s (2 slots, "
          "PIM-resident weights)")
    print(f"prefix drain: same tokens as without prefix sharing: "
          f"{shared == plain}")
    print(f"kernel launches on {device}: {launches()}")


if __name__ == "__main__":
    main()
