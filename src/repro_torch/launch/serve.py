"""Serving launcher: ``python -m repro_torch.launch.serve --paged [...]``.

Counterpart of `repro.launch.serve`, with the same flags plus
`--kernel-impl auto|cuda|ref` and `--device` (default `cuda`). Like the
reference launcher it runs the continuous-batching scheduler over the
arch's smoke config with random weights; prompts are ragged (4 ..
--prompt-len tokens), and with --prefix every prompt opens with a shared
--shared-prefix-len system prompt whose KV pages are prefilled once.

With `--arch gemma3-27b` the stack has a global and a windowed layer
group; `--prefill-chunk` and `--group-pool auto` bound the windowed
group's pages, and the summary prints each group's drawn and
window-retired pages.

--quantize converts the projection weights to PIM bit-plane weights
(--bits, --group) before serving, as the reference launcher does, and
prints the packed fraction of the parameter bytes.

--metrics attaches the serving telemetry (`obs.ServeTelemetry`) and
prints the reference launcher's telemetry block after the run: TTFT,
TPOT and queue-delay percentiles, streamed bytes, the perf model's
per-phase attribution priced at the H100, step-signature counts and a
Prometheus-style snapshot. --events-out PATH streams the JSON-lines
event log to PATH (ending in `run_end`); --profile-annotations wraps the
serve steps and bucket launches in `torch.profiler.record_function`
ranges. Both imply --metrics.

Only the paged cache is ported: running without --paged raises "not
ported yet".
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import init_lm
from ..models.common import resolve_device
from ..obs import ServeTelemetry
from ..quant.bitplane import PimQuantConfig
from ..serve import ContinuousBatcher, Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--quantize", action="store_true",
                    help="PIM bit-plane weights: every projection packed "
                         "into --bits-bit digit planes of --group bits")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--group", type=int, default=1, choices=[1, 2, 4])
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache (required: the only cache "
                         "the port has)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--prefix", action="store_true",
                    help="shared-prefix radix index over KV pages")
    ap.add_argument("--shared-prefix-len", type=int, default=32,
                    help="tokens of common system prompt prepended to "
                         "every request (--prefix)")
    ap.add_argument("--eos", type=int, default=-1,
                    help="EOS token id (-1 = never stop early)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="paged KV page-pool storage")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "cuda", "ref"],
                    help="kernel path (paged attention, bit-plane "
                         "projections and packing): 'auto' follows the "
                         "device, 'cuda' is strict (raises off the "
                         "card), 'ref' is the plain PyTorch version")
    ap.add_argument("--device", default="cuda",
                    help="where the model and pools live (default the "
                         "card; raises when none is present)")
    ap.add_argument("--bucket-strategy", default="pow2",
                    choices=["pow2", "none"])
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width (0 = single-shot)")
    ap.add_argument("--group-pool-slack", type=int, default=None)
    ap.add_argument("--group-pool", default="uniform",
                    choices=["uniform", "auto"])
    ap.add_argument("--no-window-retirement", action="store_true")
    ap.add_argument("--metrics", action="store_true",
                    help="attach the serving telemetry: request-lifecycle "
                         "traces, per-tick pool/kernel gauges, TTFT/TPOT "
                         "percentiles; prints the run summary and a "
                         "Prometheus-style snapshot")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="stream the structured JSON-lines event log to "
                         "PATH (implies --metrics)")
    ap.add_argument("--profile-annotations", action="store_true",
                    help="wrap the serve steps and bucket launches in "
                         "torch.profiler.record_function ranges (implies "
                         "--metrics)")
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("the dense cache is not ported yet: pass --paged")
    if args.group_pool == "auto" and not args.prefill_chunk:
        ap.error("--group-pool auto requires --prefill-chunk > 0")

    cfg = get_config(args.arch, smoke=True)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(cfg, gen, device)
    if args.quantize:
        eng = ServeEngine(cfg, params, ServeConfig(paged=True,
                                                   device=str(device)))
        frac = eng.quantize(PimQuantConfig(
            n_bits=args.bits, group=args.group, impl=args.kernel_impl,
            min_features=1))
        params = eng.params
        print(f"PIM-quantized: {frac:.1%} of param bytes packed "
              f"({args.bits}-bit, group={args.group})")

    telemetry = None
    if args.metrics or args.events_out or args.profile_annotations:
        telemetry = ServeTelemetry(
            events_path=args.events_out,
            profile=args.profile_annotations,
        )

    shared_len = args.shared_prefix_len if args.prefix else 0
    cache_len = shared_len + args.prompt_len + args.new_tokens + 8
    batcher = ContinuousBatcher(
        cfg, params, n_slots=args.slots, cache_len=cache_len, paged=True,
        block_size=args.block_size, prefix=args.prefix, eos_token=args.eos,
        kernel_impl=args.kernel_impl, bucket_strategy=args.bucket_strategy,
        window_retirement=not args.no_window_retirement,
        kv_dtype=args.kv_dtype, prefill_chunk=args.prefill_chunk,
        group_pool_slack=args.group_pool_slack,
        group_blocks="auto" if args.group_pool == "auto" else None,
        telemetry=telemetry, device=device,
    )
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, shared_len, dtype=np.int32)
    for uid in range(args.requests):
        t = 4 + int(rng.integers(0, max(args.prompt_len - 3, 1)))
        prompt = rng.integers(0, cfg.vocab_size, t, dtype=np.int32)
        batcher.submit(Request(uid=uid,
                               prompt=np.concatenate([shared, prompt]),
                               max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    results = batcher.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"served {len(results)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, paged cache, "
          f"smoke config, {where})")
    pc = batcher.pcache
    print(f"  prefill tokens processed: {batcher.prefill_tokens}, "
          f"pages allocated: {pc.pages_allocated}, COW: {pc.cow_events}, "
          f"window-retired: {pc.pages_retired}")
    print(f"  kv pool dtype: {pc.kv_dtype}, "
          f"page-layer bytes: {pc.page_layer_bytes}")
    if len(pc.pools) > 1:            # layer groups by attention pattern
        for p in pc.pools:
            kind = "global" if p.window is None else f"window={p.window}"
            bound = ("" if p.live_bound is None
                     else f", live-bound {p.live_bound} blocks/slot")
            print(f"  group {p.gid} ({kind}, {len(p.layers)} layers, "
                  f"pool {p.n_blocks - 1} pages{bound}): "
                  f"{p.pages_allocated} pages drawn, "
                  f"window-retired {p.pages_retired}, {p.cow_events} COW")
        print(f"  page bytes: peak resident "
              f"{pc.peak_resident_page_bytes()}, provisioned "
              f"{pc.provisioned_page_bytes()}")
    if args.prefix:
        ix = batcher.prefix
        print(f"  prefix index: {ix.hits}/{ix.lookups} hits, "
              f"{ix.cached_tokens_served} prompt tokens served from cache, "
              f"{len(ix)} pages indexed")
    for uid in sorted(results)[:3]:
        print(f"  req {uid}: {results[uid]}")
    if telemetry is not None:
        print_telemetry(telemetry)
        telemetry.close()
        if args.events_out:
            print(f"  events written to {args.events_out}")


def print_telemetry(telemetry: ServeTelemetry) -> None:
    """The reference launcher's telemetry block."""
    lat = telemetry.latency_summary()
    print("  telemetry:")
    for k in ("ttft_s", "tpot_s", "queue_delay_s"):
        s = lat[k]
        if s["n"]:
            print(f"    {k}: p50={s['p50']:.4f} p90={s['p90']:.4f} "
                  f"p99={s['p99']:.4f} (n={s['n']})")
    print(f"    kernel streamed bytes: {telemetry.streamed_bytes_total} "
          f"({len(telemetry.tick_streamed_bytes)} ticks sampled), "
          f"{len(telemetry.events)} events")
    if telemetry.perf.phases:
        perf = telemetry.perf.summary()
        print(f"  perf attribution (chip={perf['chip']}):")
        for phase, st in sorted(perf["phases"].items()):
            print(f"    {phase}: {st['launches']} launches, "
                  f"predicted={st['predicted_bytes']}B "
                  f"measured={st['measured_bytes']}B "
                  f"err_max={st['model_error_max']:g} "
                  f"roofline_frac={st['roofline_fraction']:.2f} "
                  f"bucketing_savings={st['bucketing_savings']:.2f}")
    w = telemetry.compile_watcher()
    if w.total:
        steps = ";".join(f"{k}={v}" for k, v in sorted(w.by_step().items()))
        print(f"    recompiles: {w.total} total ({steps})")
    print("  --- prometheus snapshot ---")
    print("  " + telemetry.registry.prometheus().rstrip()
          .replace("\n", "\n  "))


if __name__ == "__main__":
    main()
