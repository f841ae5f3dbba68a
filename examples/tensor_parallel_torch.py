"""Tensor parallelism on the PyTorch port: one model of any family run on
a (data, model) mesh of ranks, against the same model on one rank.

Every rank draws the same whole parameters from a seed, keeps the blocks
`launch.specs.param_shardings` gives it (`dist.sharding.place_tree`) and
its rows of the batch, and runs `prefill` and greedy `decode_step`s
(`prefill_encdec` / `decode_step_encdec` for whisper) under
`sharding_rules`: column-parallel products on its columns, row-parallel
partial sums all-reduced, recurrent states gathered from the cache's
blocks, the MoE routing every rank's rows together. Rank 0 then runs
the whole model without a mesh and compares the tokens.

Run (ranks are processes: gloo on the CPU; on the card the ranks share
it, also over gloo):
  PYTHONPATH=src python examples/tensor_parallel_torch.py --arch zamba2-1.2b \\
      --model 4 --device cpu
  PYTHONPATH=src python examples/tensor_parallel_torch.py --arch whisper-medium \\
      --data 2 --model 2 --device cpu
Without --device cpu the ranks run on the card. The smoke config is the
default; --full takes the published width at --layers layers.
"""

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.dist import collectives, spawn
from repro_torch.dist.sharding import (
    SERVE_RULES,
    local_block,
    place_tree,
    sharding_rules,
)
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import (
    decode_step,
    decode_step_encdec,
    init_encdec,
    init_lm,
    prefill,
    prefill_encdec,
)
from repro_torch.models.common import resolve_device


def _config(args):
    cfg = get_config(args.arch, smoke=not args.full)
    if args.full and args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers, **(
            {"n_encoder_layers": args.layers}
            if cfg.is_encoder_decoder else {}))
    return dataclasses.replace(cfg, dtype="float32")


def generate(cfg, params, tokens, frames, new_tokens):
    """Greedy tokens [B, new_tokens] after a prefill of `tokens`."""
    cache_len = tokens.shape[1] + new_tokens
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            out, cache = prefill_encdec(params, frames, tokens, cfg,
                                        cache_len)
        else:
            out, cache = prefill(params, tokens, cfg, cache_len)
        greedy = [out[:, -1].argmax(-1)]
        for _ in range(new_tokens - 1):
            tok = greedy[-1][:, None]
            out, cache = (decode_step_encdec(params, tok, cache, cfg)
                          if cfg.is_encoder_decoder
                          else decode_step(params, tok, cache, cfg))
            greedy.append(out[:, -1].argmax(-1))
    return torch.stack(greedy, 1)


def rank(args):
    """What every rank runs; returns its tokens, the one-rank tokens
    (rank 0) and its collectives."""
    dev = resolve_device(args.device)
    cfg = _config(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = (init_encdec if cfg.is_encoder_decoder else init_lm)(cfg, gen,
                                                                 dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    frames = torch.from_numpy((0.02 * rng.standard_normal(
        (args.batch, args.frames, cfg.d_model))).astype(np.float32)).to(dev)
    mesh = Mesh((args.data, args.model), ("data", "model"))
    params = place_tree(whole, specs.param_shardings(whole, mesh), mesh)
    rows = specs.batch_rows(mesh, args.batch)
    spec = specs._spec(rows)
    collectives.reset_counts()
    with sharding_rules(mesh, SERVE_RULES, rows=rows):
        got = generate(cfg, params, local_block(tokens, spec, mesh),
                       local_block(frames, spec, mesh), args.new_tokens)
    counts = collectives.read_counts()
    one = (generate(cfg, whole, tokens, frames, args.new_tokens).cpu()
           if mesh.rank == 0 else None)
    return {"tokens": got.cpu(), "one": one, "rows": rows,
            "counts": {k: v for k, v in counts.items() if v["calls"]}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    resolve_device(args.device)   # no card: raise here, not in the ranks
    world = args.data * args.model
    here = os.path.dirname(os.path.abspath(__file__))
    ranks = spawn.run("tensor_parallel_torch:rank", world, args=(args,),
                      timeout=600, paths=[here])
    cfg = _config(args)
    print(f"{cfg.name}: (data, model) = ({args.data}, {args.model}), "
          f"{world} ranks, f32")
    print(f"rank 0 collectives: " + ", ".join(
        f"{k} {v['calls']} calls {v['bytes']} B"
        for k, v in ranks[0]["counts"].items()))
    # the rows were split over data (each data rank's first model rank
    # holds them), or every rank holds them all
    tokens = torch.cat([ranks[r * args.model]["tokens"]
                        for r in range(args.data)]) \
        if ranks[0]["rows"] else ranks[0]["tokens"]
    print(f"tokens: {tokens.tolist()}")
    equal = torch.equal(tokens, ranks[0]["one"])
    print(f"same tokens as one rank: {equal}")
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
