"""Full-width drains of two checkouts on one card, in turns:
``python3 chip_ab.py ROOT_A ROOT_B [--profile] [--arch gemma3-27b]``.

Each ROOT is a checkout of this repository (its `chip_smoke.py` and
`src/`). In the order A, B, B, A a fresh process imports that checkout's
`chip_smoke` and drives its three full-width drains of qwen2-1.5b — bf16
weights with bf16 KV, with int8 KV, and 8-bit g = 1 PIM bit-plane
weights with bf16 KV, the trace of chip_smoke's serving phases — or,
with `--arch gemma3-27b` (both checkouts must have chip_smoke's gemma3
phases), its two gemma3-27b drains at 62 layers, bf16 and int8 KV, and
prints one JSON line: for each drain its wall seconds (host clock
around a drain that ends in `torch.cuda.synchronize()`), ticks, prefill
tokens and kernel launches; and that checkout's paged decode kernel's
device time on bf16 and on int8 pools at chip_smoke's decode shape (8
slots, 5,858 cached positions). Comparing two versions inside one
call, on one card, keeps the host's and the card's drift out of the
difference.

With --profile, B drives its drains once more under `torch.profiler`
and reports each one's device time: the sum of the durations of
everything the card ran (kernels, copies, fills), the share of it by
kernel name, and the busy share of B's unprofiled wall time, whose rest
is the card waiting for the host. A profiled pair of gemma3-27b drains
outlasts the child's 900 s (and, tracing the card's activity alone, had
not ended after 540 s), so for gemma3-27b --profile traces a window of
ticks instead (`tick_window`): the same ticks of each drain run once
unprofiled and once traced (the card's activity only), and the busy
share is the traced device time over the unprofiled window's wall.

Needs one CUDA device; both checkouts build their kernels at first use.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def _device_events(prof):
    """(name, microseconds) of every event the card ran."""
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        yield e.name, us


def _profile_summary(prof) -> dict:
    by_name = {}
    for name, us in _device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + us
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_s=total / 1e6, top=[
        dict(name=n[:90], device_s=us / 1e6, share=us / total)
        for n, us in top])


#: the gemma3 profile window: ticks [first, first + count) of a drain,
#: where prefill chunks and full decode batches interleave
WINDOW_FIRST, WINDOW_TICKS = 40, 16


def tick_window(cs, cfg, params, prompts, new_tokens, cache_len, dev,
                traced, **kw) -> dict:
    """Wall seconds of ticks [WINDOW_FIRST, +WINDOW_TICKS) of one drain
    (host clock, ending in a synchronize), or, `traced`, the device time
    of the card's activity in those ticks."""
    import time
    from torch.profiler import ProfilerActivity
    from repro_torch.serve import ContinuousBatcher, Request

    cb = ContinuousBatcher(cfg, params, n_slots=8, cache_len=cache_len,
                           paged=True, block_size=cs.BS, device=dev, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=new_tokens))
    while cb.ticks < WINDOW_FIRST:
        cb.step()
    torch.cuda.synchronize()
    if traced:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WINDOW_TICKS):
                cb.step()
            torch.cuda.synchronize()
        return _profile_summary(prof)
    t0 = time.perf_counter()
    for _ in range(WINDOW_TICKS):
        cb.step()
    torch.cuda.synchronize()
    return dict(window_wall_s=time.perf_counter() - t0)


def decode_ms(cs, dev) -> dict:
    """Device ms of one paged decode launch at chip_smoke's decode
    timing shape, bf16 q over bf16 and over int8 pools."""
    import numpy as np
    from repro_torch.kernels.paged_attention import paged_decode_attention

    rng = np.random.default_rng(cs.SEED + 1)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    b, mb = 8, 68
    n_blocks = 1 + b * mb
    table = torch.tensor(
        rng.permutation(np.arange(1, n_blocks))[: b * mb].reshape(b, mb),
        dtype=torch.int32, device=dev)
    lengths = torch.tensor([340, 420, 560, 700, 810, 930, 1010, 1088],
                           dtype=torch.int32, device=dev)
    q = torch.randn((b, cs.H, cs.HD), generator=gen, device=dev).to(
        torch.bfloat16)
    out = {}
    for kind in ("bf16", "int8"):
        kp, vp, ks, vs, _ = cs.make_pools(gen, n_blocks, kind, dev)
        out[kind] = cs.cuda_ms(lambda: paged_decode_attention(
            q, kp, vp, table, lengths, mb * cs.BS, k_scales=ks,
            v_scales=vs))
    return out


def one(root: Path, profile: bool, arch: str) -> None:
    """The drains of checkout `root` for `arch`, in this process."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg = get_config(arch)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                     dev)
    if arch == "gemma3-27b":
        prompts = cs.serving_trace(cfg.vocab_size, 16, cs.G3_SHARED,
                                   *cs.G3_SUFFIX, cs.SEED)
        new_tokens, cache_len = cs.G3_NEW, cs.G3_CACHE_LEN
        extra = dict(prefill_chunk=cs.G3_CHUNK, group_blocks="auto")
    else:
        prompts = cs.serving_trace(cfg.vocab_size, 16, 256, 64, 768, cs.SEED)
        new_tokens, cache_len, extra = 64, 256 + 768 + 64, {}
    out = {}

    def run(tag, weights, kv_dtype, traced):
        kw = dict(prefix=True, bucket_strategy="pow2", kernel_impl="auto",
                  kv_dtype=kv_dtype, **extra)
        if traced and arch == "gemma3-27b":
            plain = tick_window(cs, cfg, weights, prompts, new_tokens,
                                cache_len, dev, False, **kw)
            prof = tick_window(cs, cfg, weights, prompts, new_tokens,
                               cache_len, dev, True, **kw)
            out[tag] = dict(
                ticks=[WINDOW_FIRST, WINDOW_FIRST + WINDOW_TICKS], **plain,
                **prof, busy_share=prof["device_s"] / plain["window_wall_s"])
            return
        if traced:
            from torch.profiler import ProfilerActivity
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, stats, _ = cs.drain(cfg, weights, prompts, new_tokens, 8,
                                       cache_len, dev, **kw)
            out[tag] = dict(profiled_wall_s=stats["wall_s"],
                            **_profile_summary(prof))
            return
        _, stats, launches = cs.drain(cfg, weights, prompts, new_tokens, 8,
                                      cache_len, dev, **kw)
        out[tag] = dict(wall_s=stats["wall_s"], ticks=stats["ticks"],
                        prefill_tokens=stats["prefill_tokens"],
                        launches={k: v for k, v in launches.items() if v})

    run("bf16", params, "bf16", profile)
    run("int8", params, "int8", profile)
    if arch != "gemma3-27b":
        qparams = cs.quantize_params(cfg, params)[0]
        del params
        torch.cuda.empty_cache()
        run("pim8", qparams, "bf16", profile)
    res = {"root": str(root), "arch": arch, "profile": profile,
           "drains": out}
    if not profile:
        res["decode_ms"] = decode_ms(cs, dev)
    print(json.dumps(res), flush=True)


def _run_child(root: Path, profile: bool, arch: str) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", str(root),
           "--arch", arch]
    if profile:
        cmd.append("--profile")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                       cwd=str(root))
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise SystemExit(f"chip_ab: run of {root} failed ({r.returncode})")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(json.dumps(res), flush=True)
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 2
    arch = "qwen2-1.5b"
    if "--arch" in argv:
        i = argv.index("--arch")
        arch = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve(), "--profile" in argv[2:], arch)
        return 0
    roots = [Path(a).resolve() for a in argv if not a.startswith("--")]
    if len(roots) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = roots
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    reads = {str(a): [], str(b): []}
    for root in (a, b, b, a):
        res = _run_child(root, False, arch)
        reads[str(root)].append({k: v["wall_s"]
                                 for k, v in res["drains"].items()})
        reads[str(root)][-1].update(
            {f"decode_{k}_ms": v for k, v in res["decode_ms"].items()})
    summary = {}
    for root, runs in reads.items():
        summary[root] = {k: statistics.mean(r[k] for r in runs)
                         for k in runs[0]}
    print(json.dumps({"mean": summary}), flush=True)
    if "--profile" in argv:
        res = _run_child(b, True, arch)
        busy = {k: v.get("busy_share", v["device_s"] / summary[str(b)][k])
                for k, v in res["drains"].items()}
        print(json.dumps({"device_busy_share": busy}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
