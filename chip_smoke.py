"""Chip smoke test of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the
port's main paths through `ServeEngine.quantize` and
`ContinuousBatcher`, the entry points the launcher drives, with random
weights from a seed: paged continuous-batching serving of qwen2-1.5b at
full width (28 layers, d 1536, 12 heads, 2 kv-heads, d_ff 8960, vocab
151936), with dense and with PIM bit-plane weights, then gemma3-27b at
its published width (62 layers, d 5376, 32 heads, 16 kv-heads, hd 128,
d_ff 21504, vocab 262144; 5:1 local:global layers with a 1024-token
window), whose paged cache splits into a global and a windowed layer
group that retires pages. Phases, one line each:

  1. card      nvidia-smi name and power limit, torch and CUDA versions;
               TF32 off for matmuls and cuDNN
  2. build     nvcc for sm_90a, one process per kernel (K1-K5), all at
               once; ptxas's register report, and the count of
               tensor-core instructions (HMMA / HGMMA) in each library's
               SASS by cuobjdump ("unavailable" without it), which must
               be above 0 for K1-K4
  3. kernels   K1 (paged decode) and K2 (paged prefill) at qwen2's head
               shapes (H 12, KV 2, hd 128, bs 16, 8 slots, ragged
               lengths 0..2048, windows {capacity, 256}, a COW-fragmented
               table) and at gemma3's (H 32, KV 16, 212 columns, lengths
               0..3392, windows {capacity, 1024}), walks starting at each
               slot's first live block, for bf16, f32 and int8 pools: max
               abs error vs the plain version <= 1e-4 on valid rows, the
               bucketed launch bit-identical to the single launch
  4. bitplane  K3 (GEMV), K4 (GEMM) and K5 (pack) against their plain
               versions for (n_bits, g) in {(8,1), (4,2), (8,4), (3,1)}
               and x in {bf16, f32}, on qwen2's projections
               [1536->256], [1536->1536], [1536->8960], [8960->1536]
               (K8 = 192 and 1120) and a ragged [200->101], and in 8-bit
               g = 1 on gemma3's five projections (K8 = 672, 512, 2688;
               M up to 21504) at B {8, 512, 1024}; B in
               {1, 8, 512} must launch K3 and {513, 1024} K4. K5 planes
               byte-identical to ref.pack_ref, K3/K4 raw within
               1e-5 * max|raw| (exact products, another summation order),
               `bitplane_matmul` within the reference's own tolerance of
               its oracle (2e-3 f32, 2e-2 bf16, of max|y|)
  5. timing    each kernel at qwen2's shapes beside its plain version,
               its bound and a library call: device time (ms: 10 calls
               in a CUDA graph, replayed between CUDA events, median /
               10) and, for the kernel and the library call, the time of
               one call from the host (call_ms: events around the call,
               host dispatch included, as PR 11 and PR 12 timed);
               K1 also on int8 pools, K2 also on a first request with
               no cached prefix, K3 and K4 on all four of qwen2-1.5b's
               projection shapes; then at gemma3-27b's shapes: K1 at
               q [8, 32, 128] over a windowed and a global walk, K2 at
               q [1, 512, 32, 128] from start 1024 with the window, K3
               at [8, 5376] -> 21504 and [8, 21504] -> 5376, K4 at
               [768, 5376] -> 21504
     init      qwen2-1.5b at full width, after a sync (the wait is
               printed): the process's first meta-device shape pass timed
               alone (and the modules it imports), then `init_lm`
  6. serve     qwen2-1.5b, bf16: 8 slots, 16 requests, each a shared
               256-token system prompt plus a 64..768-token suffix, 64
               new tokens, prefix index on; the K1/K2 launch counts of
               this run must be > 0, and with no telemetry attached the
               drain must not touch a metric (`obs.mutation_count()`)
     telemetry the same drain once more with an `obs.ServeTelemetry` on
               the host clock: tokens, ticks, prefill tokens and pages
               equal the telemetry-off drain's; `serve_ticks` and
               `serve_prefill_tokens` equal them, 16 requests finished,
               first tokens plus `serve_decode_tokens` equal the tokens
               out, the perf model's error is 0 with bucketed plans among
               the launches, and the watcher saw every new step
               signature; TTFT, TPOT and queue-delay percentiles,
               streamed bytes, the roofline time at the H100 and the
               walls with telemetry on and off
     annotations  a short qwen2 drain (4 requests, 8 new tokens) with
               `profile=True` under `torch.profiler`: one
               `serve/paged_decode` range per decode launch, one
               `serve/paged_prefill` range per prefill launch,
               `paged_bucket_d*x*` ranges, and every K1 / K2 kernel the
               card ran launched from inside a decode / prefill range
  7. serve     the same trace with int8 KV pools
  8. serve     the --quantize path: `ServeEngine.quantize` to 8-bit,
               g = 1 PIM bit-plane weights (K5 packs every projection
               slice on the card), then the bf16-KV trace of phase 6;
               K1-K5 must each have launched in that path
  9. parity    qwen2-1.5b in f32 with 4 layers: greedy tokens with the
               CUDA kernels equal those with the plain versions on the
               card, and chunked prefill (64) equals single-shot
 10. parity    phase 9 with 8-bit g = 1 bit-plane weights
 11. init      gemma3-27b, all 62 layers in bf16 (the qwen2 weights
               freed first): parameters, seconds, peak device memory
 12. serve     gemma3-27b: 8 slots, 16 requests, each a shared 256-token
               system prompt plus a 768..2816-token suffix (every prompt
               crosses the window), 64 new tokens, prefix index, pow2
               bucketing, 512-token prefill chunks, groups sized "auto";
               K1/K2 launched, pages retired in the windowed group only,
               every group's pool whole again, prefix hits > 0
 13. serve     the same with int8 KV pools
     telemetry the bf16-KV drain once more with telemetry: tokens and
               schedule equal phase 12's, `pool_pages_retired` 0 / 832 by
               group, the tick peak of `pool_resident_bytes` and of
               `pool_lockstep_equiv_bytes` equal phase 12's per-tick
               peaks, the perf model's error 0 with both groups' plans
 14. parity    gemma3-27b in f32 with 6 layers (one whole 5:1 pattern),
               prompts of 1100..1300 tokens: kernels == plain versions
               and 512-token chunks (auto-sized groups) == single-shot
 15. serve     gemma3-27b with 12 layers through `ServeEngine.quantize`
               (K5 launched 7 x 12 times) and a drain with 1024-token
               chunks: K1-K5 must each have launched
 16. a JSON line {"kernels": [...]} with each kernel's launches (those
     of the qwen2 paths, and per path), error, times and bound, then the
     last line {"ok": true, "device": {"platform": "gpu", ...}}

Any failed check ends the script with a non-zero exit and no "ok" line.
It exits non-zero at once when no CUDA device is present, or when the
port's sources are not beside it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def call_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median time of one call of `fn` from the host: CUDA events around
    the call, so the host's dispatch counts where the card waits for it
    (how PR 11 and PR 12 timed every kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms(fn, warmup: int = 3, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph, the graph replayed between CUDA events, the median over `reps`
    replays divided by `calls`. No host dispatch is counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def time_kernel(fn, plain, library=None) -> dict:
    """A kernel's device time beside its plain version's and one library
    call's (None where there is none), and the per-call times of the
    kernel and the library call."""
    return dict(ms=cuda_ms(fn), call_ms=call_ms(fn), plain_ms=cuda_ms(plain),
                library_ms=None if library is None else cuda_ms(library),
                library_call_ms=None if library is None else call_ms(library))


def say_timing(name: str, r: dict) -> None:
    say("timing", kernel=name, shape=repr(r["shape"]), ms=r["ms"],
        call_ms=r["call_ms"], plain_ms=r["plain_ms"],
        library_ms=r["library_ms"], library_call_ms=r["library_call_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"])


def kernel_modules():
    """name -> the wrapper module holding the kernel's LAUNCHES count."""
    from repro_torch.kernels import (bitplane_gemm, bitplane_gemv, pack,
                                     paged_attention, paged_prefill)
    return {"paged_decode": paged_attention, "paged_prefill": paged_prefill,
            "bitplane_gemv": bitplane_gemv, "bitplane_gemm": bitplane_gemm,
            "bitplane_pack": pack}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


#: libraries whose products must run on the tensor cores
TENSOR_CORE_KERNELS = ("paged_decode", "paged_prefill", "bitplane_gemv",
                       "bitplane_gemm")


def tensor_core_counts(libs) -> dict:
    """name -> the number of tensor-core instructions (HMMA / HGMMA) in
    the library's SASS, by `cuobjdump -sass`; "unavailable" where the
    toolkit has no cuobjdump or it fails."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name, path in libs.items():
        if not os.path.exists(tool):
            counts[name] = "unavailable"
            continue
        r = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                           text=True, timeout=300)
        counts[name] = (len(re.findall(r"\bHG?MMA\.", r.stdout))
                        if r.returncode == 0 else "unavailable")
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

H, KV, HD, BS = 12, 2, 128, 16


def make_pools(gen, n_blocks, kind, dev, kv=KV):
    shape = (n_blocks, BS, kv, HD)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    if kind == "int8":
        from repro_torch.kernels.paged_common import quantize_pages
        (kq, ks), (vq, vs) = quantize_pages(k), quantize_pages(v)
        return kq, vq, ks, vs, torch.bfloat16
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dt), v.to(dt), None, None, dt


def fragmented_table(rng, b, mb, n_blocks, dev):
    """A COW-world table: pages drawn with replacement from a pool half
    the table's size, so slots share pages and repeat them."""
    t = rng.integers(1, n_blocks, (b, mb))
    t[1, :8] = t[0, :8]                       # a shared 8-page prefix
    return torch.tensor(t, dtype=torch.int32, device=dev)


#: the paged kernels' check cases: (model, heads, kv-heads, table width,
#: decode lengths, prefill totals, the second window); the first window
#: is always the table's capacity
ATTN_CASES = (
    ("qwen2-1.5b", H, KV, 128, [0, 1, 17, 300, 777, 1024, 1500, 2048],
     [1, 17, 64, 300, 777, 1024, 1500, 2048], 256),
    ("gemma3-27b", 32, 16, 212, [0, 1, 17, 1023, 1024, 1025, 2500, 3392],
     [1, 17, 64, 1023, 1100, 2048, 2500, 3392], 1024),
)


def kernel_checks(dev):
    """K1 and K2 against their plain versions at the head shapes of both
    models' main paths, bf16, f32 and int8 pools. With the short window
    each slot's walk starts at its first live block, as a windowed layer
    group's does once it has retired the blocks behind the window."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_bucketed)
    from repro_torch.kernels.paged_prefill import (
        paged_prefill_attention, paged_prefill_attention_bucketed)

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"paged_decode": 0.0, "paged_prefill": 0.0}
    for model, h, kv, mb, lens, tots, short in ATTN_CASES:
        b, t = 8, 64
        n_blocks = b * mb // 2 + 1
        capacity = mb * BS
        table = fragmented_table(rng, b, mb, n_blocks, dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        total = torch.tensor(tots, dtype=torch.int32, device=dev)
        n_new = torch.tensor([1, 17, 40, 64, 13, 64, 50, 64],
                             dtype=torch.int32, device=dev)
        start = torch.clamp(total - n_new, min=0)
        dvalid = lengths > 0
        pvalid = (start[:, None] + torch.arange(t, device=dev)[None, :]
                  < total[:, None])
        for kind in ("bf16", "f32", "int8"):
            kp, vp, ks, vs, qdt = make_pools(gen, n_blocks, kind, dev, kv=kv)
            q = torch.randn((b, h, HD), generator=gen, device=dev).to(qdt)
            qp = torch.randn((b, t, h, HD), generator=gen,
                             device=dev).to(qdt)
            sc = dict(k_scales=ks, v_scales=vs)
            for window in (capacity, short):
                # first live blocks: dead behind the decode query (at
                # length - 1) and behind the chunk's first query (start)
                dblk = torch.clamp(lengths - window, min=0) // BS
                pblk = torch.clamp(start - window + 1, min=0) // BS
                dneeds = (-(-lengths.clamp(min=1) // BS) - dblk).clamp(min=1)
                pneeds = (-(-total // BS) - pblk).clamp(min=1)
                dplan, dperm = ops.make_bucket_plan(
                    lengths.cpu().numpy(), BS, mb, needs=dneeds.cpu().numpy())
                pplan, pperm = ops.make_bucket_plan(
                    total.cpu().numpy(), BS, mb, needs=pneeds.cpu().numpy())
                check(dplan is not None and pplan is not None,
                      "no bucket plan")
                dperm = torch.tensor(dperm, dtype=torch.int64, device=dev)
                pperm = torch.tensor(pperm, dtype=torch.int64, device=dev)
                tag = f"{model} {kind} w={window}"

                out = paged_decode_attention(q, kp, vp, table, lengths,
                                             window, block_start=dblk, **sc)
                buck = paged_decode_attention_bucketed(
                    q, kp, vp, table, lengths, window, dplan, dperm,
                    block_start=dblk, **sc)
                plain = ref.paged_attention_ref(q, kp, vp, table, lengths,
                                                window, **sc)
                torch.cuda.synchronize()
                err = float((out - plain).abs()[dvalid].max())
                check(torch.isfinite(out).all(), f"decode {tag}: non-finite")
                check(err <= 1e-4, f"decode {tag}: err {err}")
                check(torch.equal(buck[dvalid], out[dvalid]),
                      f"decode {tag}: bucketed != single")
                errs["paged_decode"] = max(errs["paged_decode"], err)

                out = paged_prefill_attention(qp, kp, vp, table, start,
                                              total, window, block_start=pblk,
                                              **sc)
                buck = paged_prefill_attention_bucketed(
                    qp, kp, vp, table, start, total, window, pplan, pperm,
                    block_start=pblk, **sc)
                plain = ref.paged_prefill_ref(qp, kp, vp, table, start,
                                              total, window, **sc)
                torch.cuda.synchronize()
                err = float((out - plain).abs()[pvalid].max())
                check(torch.isfinite(out).all(),
                      f"prefill {tag}: non-finite")
                check(err <= 1e-4, f"prefill {tag}: err {err}")
                check(torch.equal(buck[pvalid], out[pvalid]),
                      f"prefill {tag}: bucketed != single")
                errs["paged_prefill"] = max(errs["paged_prefill"], err)
            say("kernels", model=model, heads=f"{h}/{kv}", pools=kind,
                windows=f"{capacity},{short}",
                decode_err=errs["paged_decode"],
                prefill_err=errs["paged_prefill"], bucketed="bit-identical")
    return errs


def sdpa_inputs(kp, vp, table, n_cols, h=H, col0=None):
    """K/V gathered dense and expanded to all `h` query heads,
    [B, h, S, hd] (outside the timed region: only the library call is
    timed): table columns [0, n_cols), or [col0[b], col0[b] + n_cols) of
    each row b when `col0` is given."""
    if col0 is None:
        pages = table[:, :n_cols].long()
    else:
        cols = (col0[:, None] + torch.arange(n_cols, device=table.device)
                ).clamp(max=table.shape[1] - 1)
        pages = table.gather(1, cols).long()
    b = pages.shape[0]
    _, bs, kv, hd = kp.shape
    k = kp[pages].reshape(b, n_cols * bs, kv, hd).transpose(1, 2)
    v = vp[pages].reshape(b, n_cols * bs, kv, hd).transpose(1, 2)
    g = h // kv
    return (k.repeat_interleave(g, dim=1).contiguous(),
            v.repeat_interleave(g, dim=1).contiguous())


def kernel_timings(dev):
    """Times at the main path's shapes: K1 over the 8 decode slots of
    the serving trace (bf16 pools, the JSON row, then int8 pools), K2
    over one slot's 768-token suffix after the 256-token shared prefix
    (the JSON row) and over a 1024-token first request with no cached
    prefix. bf16 q, table width 68 (1088 tokens of capacity)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    F = torch.nn.functional

    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    mb = 68
    capacity = mb * BS
    b = 8
    n_blocks = 1 + b * mb
    kp, vp, _, _, dt = make_pools(gen, n_blocks, "bf16", dev)
    table = torch.tensor(
        rng.permutation(np.arange(1, n_blocks))[: b * mb].reshape(b, mb),
        dtype=torch.int32, device=dev)
    item = kp.element_size()
    out = {}

    lens_host = [340, 420, 560, 700, 810, 930, 1010, 1088]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    q = torch.randn((b, H, HD), generator=gen, device=dev).to(dt)
    k_all, v_all = sdpa_inputs(kp, vp, table, mb)
    mask = (torch.arange(capacity, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    kv_pos = sum(lens_host)
    nbytes = (2 * kv_pos * KV * HD * item + q.numel() * item
              + b * H * HD * 4 + table.numel() * 4 + b * 4)
    ops = 4 * HD * H * kv_pos
    out["paged_decode"] = dict(
        **time_kernel(
            lambda: paged_decode_attention(q, kp, vp, table, lengths,
                                           capacity),
            lambda: ref.paged_attention_ref(q, kp, vp, table, lengths,
                                            capacity),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k_all, v_all, attn_mask=mask)),
        **bound(nbytes, ops, dt), shape=f"q[{b},{H},{HD}] lens {lens_host}")

    # the same decode over int8 pools; the library call attends over the
    # pools dequantized to bf16 beforehand
    from repro_torch.kernels.paged_common import dequantize_pages
    kq, vq, ks, vs, _ = make_pools(gen, n_blocks, "int8", dev)
    k8_all, v8_all = sdpa_inputs(dequantize_pages(kq, ks).to(dt),
                                 dequantize_pages(vq, vs).to(dt), table, mb)
    live_pages = sum(-(-n // BS) for n in lens_host)
    nbytes8 = (2 * kv_pos * KV * HD + 2 * live_pages * KV * 4
               + q.numel() * item + b * H * HD * 4 + table.numel() * 4 + b * 4)
    r = dict(
        **time_kernel(
            lambda: paged_decode_attention(q, kq, vq, table, lengths,
                                           capacity, k_scales=ks,
                                           v_scales=vs),
            lambda: ref.paged_attention_ref(q, kq, vq, table, lengths,
                                            capacity, k_scales=ks,
                                            v_scales=vs),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k8_all, v8_all, attn_mask=mask)),
        **bound(nbytes8, ops, dt),
        shape=f"q[{b},{H},{HD}] int8 pools lens {lens_host}")
    say_timing("paged_decode", r)

    # one slot's 768-token suffix after the cached 256-token prefix (the
    # JSON row), then a first request with no cached prefix
    for st_, tot in ((256, 1024), (0, 1024)):
        t = tot - st_
        q1 = torch.randn((1, t, H, HD), generator=gen, device=dev).to(dt)
        start = torch.tensor([st_], dtype=torch.int32, device=dev)
        total = torch.tensor([tot], dtype=torch.int32, device=dev)
        bt1 = table[:1].contiguous()
        k1, v1 = sdpa_inputs(kp, vp, bt1, tot // BS)
        qpos = st_ + torch.arange(t, device=dev)
        pmask = (torch.arange(tot, device=dev)[None, :]
                 <= qpos[:, None])[None, None]
        pairs = sum(st_ + i + 1 for i in range(t))
        nbytes = (2 * tot * KV * HD * item + q1.numel() * item
                  + q1.numel() * 4 + bt1.numel() * 4 + 8)
        ops = 4 * HD * H * pairs
        r = dict(
            **time_kernel(
                lambda: paged_prefill_attention(q1, kp, vp, bt1, start,
                                                total, capacity),
                lambda: ref.paged_prefill_ref(q1, kp, vp, bt1, start, total,
                                              capacity),
                lambda: F.scaled_dot_product_attention(
                    q1.transpose(1, 2), k1, v1, attn_mask=pmask)),
            **bound(nbytes, ops, dt),
            shape=f"q[1,{t},{H},{HD}] start {st_} total {tot}")
        out.setdefault("paged_prefill", r)
        if st_ == 0:
            say_timing("paged_prefill", r)
    for name, r in out.items():
        say_timing(name, r)
    return out


#: gemma3-27b's attention: 32 query heads over 16 KV heads, the drains'
#: 212-column tables (3392 tokens) and a 1024-token window
G3_H, G3_KV, G3_MB, G3_WINDOW = 32, 16, 212, 1024


def gemma3_kernel_timings(dev):
    """K1 and K2 at gemma3-27b's shapes, bf16: K1 over 8 decode slots of
    1300..3136 tokens on a windowed layer (each walk from the slot's
    first live block) and on a global layer; K2 over a 512-token chunk
    at start 1024 with the 1024-token window. The library call attends
    over the same visible keys, gathered dense beforehand."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    F = torch.nn.functional

    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    mb, b = G3_MB, 8
    capacity = mb * BS
    n_blocks = 1 + b * mb
    kp, vp, _, _, dt = make_pools(gen, n_blocks, "bf16", dev, kv=G3_KV)
    table = torch.tensor(
        rng.permutation(np.arange(1, n_blocks))[: b * mb].reshape(b, mb),
        dtype=torch.int32, device=dev)
    item = kp.element_size()
    lens_host = [1300, 1800, 2200, 2500, 2700, 2900, 3000, 3136]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    q = torch.randn((b, G3_H, HD), generator=gen, device=dev).to(dt)
    out = {}
    for walk, window in (("windowed", G3_WINDOW), ("global", capacity)):
        # the windowed group has retired every block behind the window
        first = [max(n - window, 0) // BS for n in lens_host]
        blk = torch.tensor(first, dtype=torch.int32, device=dev)
        n_cols = max(-(-n // BS) - f for n, f in zip(lens_host, first))
        k_all, v_all = sdpa_inputs(kp, vp, table, n_cols, h=G3_H, col0=blk)
        pos = (blk[:, None] * BS
               + torch.arange(n_cols * BS, device=dev)[None, :])
        mask = ((pos < lengths[:, None])
                & (pos > lengths[:, None] - 1 - window))[:, None, None, :]
        kv_pos = sum(min(n, window) for n in lens_host)
        nbytes = (2 * kv_pos * G3_KV * HD * item + q.numel() * item
                  + b * G3_H * HD * 4 + table.numel() * 4 + 2 * b * 4)
        r = dict(
            **time_kernel(
                lambda: paged_decode_attention(q, kp, vp, table, lengths,
                                               window, block_start=blk),
                lambda: ref.paged_attention_ref(q, kp, vp, table, lengths,
                                                window),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None, :], k_all, v_all, attn_mask=mask)),
            **bound(nbytes, 4 * HD * G3_H * kv_pos, dt),
            shape=f"gemma3 q[{b},{G3_H},{HD}] kv {G3_KV} {walk} walk "
                  f"(window {window}) lens {lens_host}")
        say_timing("paged_decode", r)
        out[f"paged_decode {walk}"] = r

    st_, t = 1024, 512
    tot = st_ + t
    q1 = torch.randn((1, t, G3_H, HD), generator=gen, device=dev).to(dt)
    start = torch.tensor([st_], dtype=torch.int32, device=dev)
    total = torch.tensor([tot], dtype=torch.int32, device=dev)
    bt1 = table[:1].contiguous()
    blk = torch.tensor([max(st_ - G3_WINDOW + 1, 0) // BS],
                       dtype=torch.int32, device=dev)
    k1, v1 = sdpa_inputs(kp, vp, bt1, -(-tot // BS), h=G3_H)
    qpos = st_ + torch.arange(t, device=dev)
    kpos = torch.arange(tot, device=dev)[None, :]
    pmask = ((kpos <= qpos[:, None])
             & (kpos > qpos[:, None] - G3_WINDOW))[None, None]
    pairs = int(pmask.sum())
    keys = tot - max(st_ - G3_WINDOW + 1, 0)
    nbytes = (2 * keys * G3_KV * HD * item + q1.numel() * item
              + q1.numel() * 4 + bt1.numel() * 4 + 12)
    r = dict(
        **time_kernel(
            lambda: paged_prefill_attention(q1, kp, vp, bt1, start, total,
                                            G3_WINDOW, block_start=blk),
            lambda: ref.paged_prefill_ref(q1, kp, vp, bt1, start, total,
                                          G3_WINDOW),
            lambda: F.scaled_dot_product_attention(
                q1.transpose(1, 2), k1, v1, attn_mask=pmask)),
        **bound(nbytes, 4 * HD * G3_H * pairs, dt),
        shape=f"gemma3 q[1,{t},{G3_H},{HD}] kv {G3_KV} start {st_} "
              f"total {tot} window {G3_WINDOW}")
    say_timing("paged_prefill", r)
    out["paged_prefill"] = r
    return out


def bound(nbytes: int, ops: int, dtype) -> dict:
    """Least time for the work: bytes each input read / output written
    once over HBM, or its operations over the tensor-core peak of the
    input type — whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


# ---------------------------------------------------------------------------
# phase 7: bit-plane kernels against their plain versions
# ---------------------------------------------------------------------------

BITPLANE_FORMATS = ((8, 1), (4, 2), (8, 4), (3, 1))
#: qwen2-1.5b's projections (wk/wv, wq/wo, w_gate/w_up, w_down) and one
#: matrix ragged for every tile of the kernels
BITPLANE_MATRICES = ((1536, 256), (1536, 1536), (1536, 8960), (8960, 1536),
                     (200, 101))
GEMV_ROWS, GEMM_ROWS = (1, 8, 512), (513, 1024)


#: gemma3-27b's projections (wk/wv, wq, wo, w_gate/w_up, w_down: K8 =
#: 672, 512 and 2688 at 8 bits, g = 1), checked in the format its
#: --quantize path runs, at a decode tick's 8 rows, a 512-row chunk (K3)
#: and a 1024-row chunk (K4)
G3_BITPLANE_MATRICES = ((5376, 2048), (5376, 4096), (4096, 5376),
                        (5376, 21504), (21504, 5376))
G3_BITPLANE_ROWS = (8, 512, 1024)


def bitplane_checks(dev):
    """K5 byte-identical to the plain pack; K3/K4 raw within 1e-5 of
    max|raw| of the plain contraction; `bitplane_matmul` (kernel, offset,
    scale) within the reference's tolerance of its oracle. The counts
    must show B <= 512 on K3 and B > 512 on K4. qwen2-1.5b's shapes in
    four formats, then gemma3-27b's in 8-bit g = 1."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    abs_err = {"bitplane_gemv": 0.0, "bitplane_gemm": 0.0,
               "bitplane_pack": 0.0}
    for model, formats, matrices, rows in (
            ("qwen2-1.5b", BITPLANE_FORMATS, BITPLANE_MATRICES,
             GEMV_ROWS + GEMM_ROWS),
            ("gemma3-27b", ((8, 1),), G3_BITPLANE_MATRICES,
             G3_BITPLANE_ROWS)):
        for n_bits, group in formats:
            rel_err = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                                     "matmul_bf16", "matmul_f32"), 0.0)
            for k, m in matrices:
                check_bitplane_matrix(dev, gen, n_bits, group, k, m, rows,
                                      abs_err, rel_err)
            say("bitplane", model=model, format=f"({n_bits},{group})",
                matrices=len(matrices), rows=",".join(map(str, rows)),
                pack="byte-identical",
                gemv_rel_err=rel_err["bitplane_gemv"],
                gemm_rel_err=rel_err["bitplane_gemm"],
                matmul_rel_err_bf16=rel_err["matmul_bf16"],
                matmul_rel_err_f32=rel_err["matmul_f32"])
    return abs_err


def check_bitplane_matrix(dev, gen, n_bits, group, k, m, rows, abs_err,
                          rel_err):
    """One [k -> m] weight: K5 against the plain pack, then K3 or K4 (by
    row count) and `bitplane_matmul` for bf16 and f32 x of each of
    `rows` rows; the worst errors go into `abs_err` / `rel_err`."""
    from repro_torch.kernels import ops, ref

    tag = f"({n_bits},{group}) [{k}->{m}]"
    w = torch.randn((k, m), generator=gen, device=dev)
    w_q, scale = ref.quantize_ref(w, n_bits)
    plain_planes = ref.pack_ref(w_q, n_bits, group)
    reset_launches()
    planes, got_scale = ops.quantize_and_pack(w, n_bits, group, "cuda")
    torch.cuda.synchronize()
    check(read_launches()["bitplane_pack"] == 1, f"{tag}: no K5")
    check(torch.equal(planes, plain_planes)
          and torch.equal(got_scale, scale),
          f"{tag}: K5 planes differ from ref.pack_ref")
    del w, w_q, plain_planes
    u = ref.offset_form_ref(planes, group).float()
    for dt in (torch.bfloat16, torch.float32):
        for b in rows:
            name = "bitplane_gemv" if b <= 512 else "bitplane_gemm"
            x = torch.randn((b, k), generator=gen, device=dev).to(dt)
            x_r = ref.prepare_x_ref(x, group).contiguous()
            reset_launches()
            raw = ops.bitplane_kernel(b)(x_r, planes, n_bits=n_bits,
                                         group=group)
            y = ops.bitplane_matmul(x, planes, scale, n_bits=n_bits,
                                    group=group, impl="cuda")
            launched = read_launches()
            plain = x.float() @ u
            y_ref = ref.bitplane_matmul_ref(x, planes, scale, n_bits,
                                            group).float()
            torch.cuda.synchronize()
            check(launched[name] == 2 and sum(launched.values()) == 2,
                  f"{tag} B={b}: expected 2 launches of {name}, got "
                  f"{launched}")
            check(bool(torch.isfinite(raw).all())
                  and bool(torch.isfinite(y).all()),
                  f"{tag} B={b}: non-finite output")
            err = float((raw - plain).abs().max())
            rel = err / (float(plain.abs().max()) + 1e-30)
            check(rel <= 1e-5, f"{tag} {dt} B={b}: raw rel err {rel}")
            yerr = float((y.float() - y_ref).abs().max()) / (
                float(y_ref.abs().max()) + 1e-6)
            tol = 2e-2 if dt == torch.bfloat16 else 2e-3
            check(yerr < tol, f"{tag} {dt} B={b}: matmul rel err "
                              f"{yerr} >= {tol}")
            abs_err[name] = max(abs_err[name], err)
            rel_err[name] = max(rel_err[name], rel)
            key = "matmul_bf16" if dt == torch.bfloat16 else "matmul_f32"
            rel_err[key] = max(rel_err[key], yerr)


def bitplane_row(dev, gen, name, b, k, m, model="qwen2-1.5b") -> dict:
    """One K3 or K4 timing, 8-bit g = 1, bf16 x of `b` rows against a
    [k -> m] weight; the library yardstick is one `x @ W` with W
    dequantized dense in x's dtype beforehand (the port never calls
    it)."""
    from repro_torch.kernels import bitplane_gemm, bitplane_gemv, ops, ref

    fn = {"bitplane_gemv": bitplane_gemv.bitplane_gemv,
          "bitplane_gemm": bitplane_gemm.bitplane_gemm}[name]
    dt = torch.bfloat16
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, scale = ops.quantize_and_pack(w, 8, 1, "cuda")
    del w
    x = torch.randn((b, k), generator=gen, device=dev).to(dt)
    x_r = ref.prepare_x_ref(x, 1).contiguous()
    w_dense = ref.dequantize_ref(planes, scale, 8, 1).to(dt)
    r = dict(
        **time_kernel(
            lambda: fn(x_r, planes, n_bits=8, group=1),
            lambda: ref.bitplane_raw_ref(x_r, planes, 1),
            lambda: x @ w_dense),
        **bound(planes.numel() + x_r.numel() * x_r.element_size()
                + b * m * 4, 2 * b * k * m, dt),
        shape=f"{model} x[{b},{k}] planes[8,{k // 8},{m}] bf16")
    say_timing(name, r)
    return r


def bitplane_timings(dev):
    """Times at the main path's shapes, 8-bit g = 1 bf16: K3 at B = 8
    (a decode tick's 8 slots) on [1536->8960] (w_gate/w_up, the row the
    JSON line carries), [8960->1536] (w_down), [1536->1536] (wq/wo) and
    [1536->256] (wk/wv); K4 at B = 768 (one slot's suffix) on those two
    and on [1536->256] (wk/wv) and [1536->1536] (wq/wo); K5 packing one
    [1536, 8960] slice; then K3 and K4 at gemma3-27b's widest shapes:
    K3 [5376->21504] (w_gate/w_up) and [21504->5376] (w_down) at B = 8,
    K4 [5376->21504] at B = 768. K5 has no library call."""
    from repro_torch.kernels import pack, ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    dt = torch.bfloat16
    out = {}
    for name, b, shapes in (
            ("bitplane_gemv", 8,
             ((1536, 8960), (8960, 1536), (1536, 1536), (1536, 256))),
            ("bitplane_gemm", 768,
             ((1536, 8960), (8960, 1536), (1536, 256), (1536, 1536)))):
        for k, m in shapes:
            out.setdefault(name, bitplane_row(dev, gen, name, b, k, m))
    k, m = 1536, 8960
    w_q = torch.randint(-128, 128, (k, m), generator=gen, device=dev)
    u_r = (w_q + 128).to(torch.uint8).reshape(k // 8, 8, m).permute(
        1, 0, 2).contiguous()
    r = dict(**time_kernel(lambda: pack.pack_bitplanes(u_r, 8, 1),
                           lambda: ref.pack_bitplanes_ref(u_r, 8, 1)),
             **bound(2 * u_r.numel(), 0, dt),
             shape=f"u_r[8,{k // 8},{m}] -> planes[8,{k // 8},{m}]")
    say_timing("bitplane_pack", r)
    out["bitplane_pack"] = r
    for name, b, k, m in (("bitplane_gemv", 8, 5376, 21504),
                          ("bitplane_gemv", 8, 21504, 5376),
                          ("bitplane_gemm", 768, 5376, 21504)):
        bitplane_row(dev, gen, name, b, k, m, model="gemma3-27b")
    return out


# ---------------------------------------------------------------------------
# phases 6-10: the qwen2-1.5b paths
# ---------------------------------------------------------------------------

def serving_trace(vocab, n_requests, shared_len, suffix_lo, suffix_hi, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len, dtype=np.int32)
    return [
        np.concatenate([shared, rng.integers(
            0, vocab, int(rng.integers(suffix_lo, suffix_hi + 1)),
            dtype=np.int32)])
        for _ in range(n_requests)
    ]


def drain(cfg, params, prompts, new_tokens, n_slots, cache_len, dev,
          reset=True, **kw):
    """One drain through `ContinuousBatcher`; every launch count is set
    to 0 just before it (unless `reset=False`: the caller did, before
    earlier work of the same path) and read just after. Besides the
    schedule it reports, per layer group, the pages retired and whether
    the pool is whole again (every page free or held by the prefix
    index), and the cache's page-byte accounting: the draw-time peak of
    resident bytes, the provisioned bytes, and the per-tick peaks of
    resident and lockstep-equivalent bytes."""
    from repro_torch.serve import ContinuousBatcher, Request

    cb = ContinuousBatcher(cfg, params, n_slots=n_slots, cache_len=cache_len,
                           paged=True, block_size=BS, device=dev, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=new_tokens))
    peaks = {"resident": 0, "lockstep": 0}

    def on_tick(b):
        pc = b.pcache
        peaks["resident"] = max(peaks["resident"], pc.resident_page_bytes())
        peaks["lockstep"] = max(peaks["lockstep"],
                                pc.lockstep_equiv_page_bytes())

    from repro_torch.obs import mutation_count

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if reset:
        reset_launches()
    mutations = mutation_count()
    t0 = time.perf_counter()
    results = cb.run_until_drained(on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mutations = mutation_count() - mutations
    launches = read_launches()
    pc = cb.pcache
    index_refs = {} if cb.prefix is None else cb.prefix.page_refs()
    pc.check_invariants(None if cb.prefix is None else index_refs)
    n_tok = sum(len(v) for v in results.values())
    stats = dict(
        layers=cfg.n_layers, requests=len(results), tokens=n_tok,
        wall_s=wall, tokens_per_s=n_tok / wall, ticks=cb.ticks,
        prefill_tokens=cb.prefill_tokens,
        pages_allocated=pc.pages_allocated,
        prefix_hits=None if cb.prefix is None else cb.prefix.hits,
        retired_by_group=[p.pages_retired for p in pc.pools],
        windows=[p.window for p in pc.pools],
        pools_whole=all(
            p.n_free + len(index_refs.get(p.gid, {})) == p.n_blocks - 1
            for p in pc.pools),
        peak_resident_page_bytes=pc.peak_resident_page_bytes(),
        provisioned_page_bytes=pc.provisioned_page_bytes(),
        tick_peak_resident_page_bytes=peaks["resident"],
        tick_peak_lockstep_equiv_page_bytes=peaks["lockstep"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        metric_mutations=mutations,
        **{f"launches_{k}": v for k, v in launches.items() if v},
    )
    return results, stats, launches


def serve_full_width(cfg, params, dev, kv_dtype, weights="bf16",
                     required=("paged_decode", "paged_prefill"), reset=True,
                     **extra):
    prompts = serving_trace(cfg.vocab_size, 16, 256, 64, 768, SEED)
    new_tokens = 64
    tag = f"{kv_dtype} KV, {weights} weights"
    results, stats, launches = drain(
        cfg, params, prompts, new_tokens, 8, 256 + 768 + new_tokens, dev,
        reset=reset, prefix=True, bucket_strategy="pow2", kernel_impl="auto",
        kv_dtype=kv_dtype)
    check(stats["requests"] == 16, f"{tag}: not every request finished")
    check(all(len(v) == new_tokens for v in results.values()),
          f"{tag}: a request stopped short")
    check(all(0 <= x < cfg.vocab_size for v in results.values() for x in v),
          f"{tag}: token outside the vocab")
    check(all(launches[k] > 0 for k in required),
          f"{tag}: main path did not launch every kernel of {required}: "
          f"{launches}")
    check(stats["prefix_hits"] > 0, f"{tag}: no prefix hit")
    check(stats["pools_whole"], f"{tag}: a page is still held after the "
                                "drain")
    check(stats["metric_mutations"] == 0,
          f"{tag}: the telemetry-off drain touched a metric")
    say("serve", model=cfg.name, kv_dtype=kv_dtype, weights=weights,
        **extra, **stats)
    return launches, results, stats


def quantize_params(cfg, params, n_bits=8, group=1):
    """`ServeEngine.quantize`, as `launch/serve.py --quantize` calls it:
    every projection becomes a PimWeight packed by K5 on the card."""
    from repro_torch.quant import PimQuantConfig, tree_packed_fraction
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, ServeConfig(paged=True, device="cuda"))
    frac = eng.quantize(PimQuantConfig(n_bits=n_bits, group=group,
                                       min_features=1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(frac == tree_packed_fraction(eng.params),
          f"packed fraction {frac} != tree_packed_fraction")
    return eng.params, frac, seconds


def serve_quantized(cfg, qparams, frac, seconds, dev):
    """The rest of the --quantize path at full width, after
    `quantize_params` ran with the counts set to 0 (K5 launched once per
    projection slice): the bf16-KV drain, which must launch K1-K4. The
    counts are read after the drain. The caller has dropped the dense
    weights, so the drain's peak memory is the quantized model's."""
    k5 = read_launches()["bitplane_pack"]
    check(k5 == 7 * cfg.n_layers,
          f"K5 launches {k5} != {7 * cfg.n_layers} (one per projection "
          "slice)")
    return serve_full_width(
        cfg, qparams, dev, "bf16", weights="pim8", reset=False,
        required=tuple(kernel_modules()), packed_fraction=frac,
        quantize_s=seconds)[0]


def telemetry_drain(cfg, params, dev, off_results, off_stats, tag, **kw):
    """The drain of `off_results` once more with an `obs.ServeTelemetry`
    on the host clock (the counts set to 0 before it, read after). The
    tokens and the schedule must equal the telemetry-off drain's, K1/K2
    must launch, the perf model must predict every launch exactly, and
    the watcher must see every new step signature. Returns the telemetry
    and the drain's stats."""
    from repro_torch.obs import ServeTelemetry
    from repro_torch.serve.compiled import trace_count

    tel = ServeTelemetry()
    signatures = trace_count()
    results, stats, launches = drain(cfg, params, dev=dev, telemetry=tel,
                                     **kw)
    signatures = trace_count() - signatures
    tel.close()
    r = tel.registry
    perf = tel.perf.summary()
    n_tok = sum(len(v) for v in results.values())
    check(results == off_results,
          f"{tag}: tokens with telemetry differ from tokens without")
    for key in ("ticks", "prefill_tokens", "pages_allocated",
                "retired_by_group"):
        check(stats[key] == off_stats[key],
              f"{tag}: {key} {stats[key]} != {off_stats[key]} without "
              "telemetry")
    check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
          f"{tag}: K1/K2 not launched: {launches}")
    check(r.counter("serve_requests_finished").value == len(off_results),
          f"{tag}: finished {r.counter('serve_requests_finished').value}")
    check(r.counter("serve_prefill_tokens").value == stats["prefill_tokens"],
          f"{tag}: serve_prefill_tokens != prefill tokens")
    check(len(tel.events.of("first_token"))
          + r.counter("serve_decode_tokens").value == n_tok,
          f"{tag}: first tokens + decode tokens != tokens out")
    check(perf["model_error_max"] == 0.0,
          f"{tag}: perf model error {perf['model_error_max']}")
    check(any(plans is not None for _, plans, _, _ in tel.perf.launch_log),
          f"{tag}: no bucketed plan was accounted")
    check(tel.compile_watcher().total == signatures,
          f"{tag}: watcher saw {tel.compile_watcher().total} signatures, "
          f"trace_count moved {signatures}")
    check(sum(tel.tick_streamed_bytes) == tel.streamed_bytes_total,
          f"{tag}: per-tick streamed bytes do not sum to the total")
    return tel, stats


def latency_fields(tel) -> dict:
    out = {}
    for key, s in tel.latency_summary().items():
        if key == "e2e_s":
            continue
        for q in ("p50", "p90", "p99"):
            out[f"{key[:-2]}_{q}_s"] = s[q]
    return out


def qwen2_telemetry(cfg, params, dev, off_results, off_stats):
    """The full-width bf16-KV trace of phase 6 with telemetry attached."""
    prompts = serving_trace(cfg.vocab_size, 16, 256, 64, 768, SEED)
    tag = "qwen2 telemetry"
    tel, stats = telemetry_drain(
        cfg, params, dev, off_results, off_stats, tag, prompts=prompts,
        new_tokens=64, n_slots=8, cache_len=256 + 768 + 64,
        prefix=True, bucket_strategy="pow2", kernel_impl="auto",
        kv_dtype="bf16")
    r = tel.registry
    check(r.counter("serve_ticks").value == stats["ticks"],
          f"{tag}: serve_ticks {r.counter('serve_ticks').value} != "
          f"{stats['ticks']}")
    check(r.counter("serve_requests_finished").value == 16,
          f"{tag}: not 16 requests finished")
    perf = tel.perf.summary()
    say("telemetry", model=cfg.name, layers=cfg.n_layers,
        requests=r.counter("serve_requests_finished").value,
        ticks=r.counter("serve_ticks").value,
        **latency_fields(tel),
        streamed_bytes=tel.streamed_bytes_total,
        roofline_total_s=perf["roofline_total_s"], chip=perf["chip"],
        model_error_max=perf["model_error_max"],
        recompiles=tel.compile_watcher().total,
        events=len(tel.events), wall_on_s=stats["wall_s"],
        wall_off_s=off_stats["wall_s"],
        launches_on=f"{stats.get('launches_paged_decode')}/"
                    f"{stats.get('launches_paged_prefill')}")


def qwen2_annotations(cfg, params, dev):
    """A short drain with `profile=True` under `torch.profiler`: the step
    and bucket ranges are in the trace, one step range per launch, and
    every K1 / K2 kernel was launched from inside a decode / prefill
    range (matched through the launch's correlation id)."""
    from repro_torch.obs import ServeTelemetry
    from repro_torch.serve import ContinuousBatcher, Request
    from torch.profiler import ProfilerActivity

    prompts = serving_trace(cfg.vocab_size, 4, 256, 64, 768, SEED + 7)
    tel = ServeTelemetry(profile=True)
    cb = ContinuousBatcher(cfg, params, n_slots=8, cache_len=256 + 768 + 8,
                           paged=True, block_size=BS, prefix=True,
                           telemetry=tel, device=dev)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
    torch.cuda.synchronize()
    reset_launches()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        cb.run_until_drained()
        torch.cuda.synchronize()
    launched = read_launches()
    path = ROOT / "build" / "annotations_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges, launches, kernels = {}, {}, {"paged_decode": [],
                                         "paged_prefill": []}
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            ranges.setdefault(name, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = float(e["ts"])
        elif cat == "kernel":
            for k in kernels:
                if f"{k}_kernel" in name:
                    kernels[k].append(corr)
    count = tel.registry.counter
    n_decode = count("kernel_launches", {"kind": "decode"}).value
    n_prefill = count("kernel_launches", {"kind": "prefill"}).value
    buckets = {n: len(v) for n, v in ranges.items()
               if n.startswith("paged_bucket_d")}

    def inside(corr, names):
        ts = launches.get(corr)
        return ts is not None and any(
            lo <= ts <= hi for n in names for lo, hi in ranges.get(n, ()))

    check(len(ranges.get("serve/paged_decode", ())) == n_decode > 0,
          f"annotations: {len(ranges.get('serve/paged_decode', ()))} "
          f"serve/paged_decode ranges for {n_decode} decode launches")
    check(len(ranges.get("serve/paged_prefill", ())) == n_prefill > 0,
          f"annotations: {len(ranges.get('serve/paged_prefill', ()))} "
          f"serve/paged_prefill ranges for {n_prefill} prefill launches")
    check(sum(buckets.values()) > 0, "annotations: no paged_bucket range")
    for k, step in (("paged_decode", "serve/paged_decode"),
                    ("paged_prefill", "serve/paged_prefill")):
        check(len(kernels[k]) == launched[k] > 0,
              f"annotations: {len(kernels[k])} {k} kernels in the trace, "
              f"{launched[k]} launches counted")
        check(all(inside(c, (step,)) for c in kernels[k]),
              f"annotations: a {k} kernel was launched outside {step}")
    in_bucket = sum(inside(c, tuple(buckets)) for k in kernels
                    for c in kernels[k])
    check(in_bucket > 0, "annotations: no kernel launched inside a bucket "
                         "range")
    say("annotations", model=cfg.name, requests=len(prompts),
        decode_ranges=n_decode, prefill_ranges=n_prefill,
        bucket_ranges=json.dumps(buckets, sort_keys=True).replace(" ", ""),
        k1_kernels=len(kernels["paged_decode"]),
        k2_kernels=len(kernels["paged_prefill"]),
        kernels_in_bucket_ranges=in_bucket)


def token_parity(dev, cfg, prompts, new_tokens, cache_len, chunk,
                 quantize=False, chunk_kw=None):
    """Greedy f32 tokens of one trace three ways: the CUDA kernels, the
    plain versions on the card (no kernel may launch), and chunked
    prefill (with `chunk_kw` besides) with the kernels; all three must
    agree. Returns the kernel run's drain stats."""
    from repro_torch.models import init_lm

    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED + 2),
                     dev)
    if quantize:
        params = quantize_params(cfg, params)[0]
    runs, stats = {}, None
    for name, extra in (("kernel", dict(kernel_impl="auto")),
                        ("plain", dict(kernel_impl="ref")),
                        ("chunked", dict(kernel_impl="auto",
                                         prefill_chunk=chunk,
                                         **(chunk_kw or {})))):
        runs[name], st, launches = drain(cfg, params, prompts, new_tokens, 4,
                                         cache_len, dev, prefix=True,
                                         **extra)
        stats = stats or st
        want = ("paged_decode", "paged_prefill") + (
            ("bitplane_gemv",) if quantize else ())
        if name == "plain":
            check(not any(launches.values()),
                  f"parity: the plain run launched kernels: {launches}")
        else:
            check(all(launches[k] > 0 for k in want),
                  f"parity {name}: kernels of {want} not launched: "
                  f"{launches}")
    check(runs["kernel"] == runs["plain"],
          f"{cfg.name}: f32 tokens differ between the CUDA kernels and the "
          "plain versions")
    check(runs["chunked"] == runs["kernel"],
          f"{cfg.name}: chunked-prefill tokens differ from single-shot")
    say("parity", model=f"{cfg.name}[f32,{cfg.n_layers}L]",
        weights="pim8" if quantize else "f32", requests=len(runs["kernel"]),
        tokens=sum(len(v) for v in runs["kernel"].values()),
        prompt_lens=f"{min(map(len, prompts))}..{max(map(len, prompts))}",
        chunk=chunk, retired_by_group=stats["retired_by_group"],
        kernel_eq_plain=True, chunked_eq_single=True)
    return stats


def qwen2_parity(dev, quantize=False):
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), dtype="float32",
                              n_layers=4)
    prompts = serving_trace(cfg.vocab_size, 6, 128, 16, 256, SEED + 2)
    token_parity(dev, cfg, prompts, 16, 128 + 256 + 16, 64,
                 quantize=quantize)


# ---------------------------------------------------------------------------
# phases 11-15: gemma3-27b, two layer groups at full width
# ---------------------------------------------------------------------------

#: the gemma3 drains: a 256-token shared system prompt plus a
#: 768..2816-token suffix, so every prompt (1024..3072 tokens) crosses
#: the 1024-token window; 64 new tokens; 256 tokens of slack make the
#: table 212 columns wide
G3_SHARED, G3_SUFFIX, G3_NEW, G3_CHUNK = 256, (768, 2816), 64, 512
G3_CACHE_LEN = G3_SHARED + G3_SUFFIX[1] + G3_NEW + 256


def gemma3_serve(cfg, params, dev, kv_dtype, **kw):
    """One full-width gemma3 drain: 16 requests, 8 slots, prefix index,
    pow2 bucketing, chunked prefill with auto-sized groups. K1 and K2
    must launch, pages must retire in the windowed group and nowhere
    else, every pool must be whole again and the index must hit."""
    prompts = serving_trace(cfg.vocab_size, 16, G3_SHARED, *G3_SUFFIX, SEED)
    tag = f"gemma3 {kv_dtype} KV"
    results, stats, launches = drain(
        cfg, params, prompts, G3_NEW, 8, G3_CACHE_LEN, dev, prefix=True,
        bucket_strategy="pow2", kernel_impl="auto", kv_dtype=kv_dtype,
        prefill_chunk=G3_CHUNK, group_blocks="auto", **kw)
    check(stats["requests"] == 16, f"{tag}: not every request finished")
    check(all(len(v) == G3_NEW for v in results.values()),
          f"{tag}: a request stopped short")
    check(all(0 <= x < cfg.vocab_size for v in results.values() for x in v),
          f"{tag}: token outside the vocab")
    check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
          f"{tag}: K1/K2 not launched: {launches}")
    windows, retired = stats["windows"], stats["retired_by_group"]
    check(len(windows) == 2 and sum(retired) > 0
          and all(r == 0 for w, r in zip(windows, retired) if w is None),
          f"{tag}: pages must retire in the windowed group only: "
          f"{list(zip(windows, retired))}")
    check(stats["pools_whole"], f"{tag}: a page is still held after the "
                                "drain")
    check(stats["prefix_hits"] > 0, f"{tag}: no prefix hit")
    check(stats["metric_mutations"] == 0,
          f"{tag}: the telemetry-off drain touched a metric")
    say("serve", model=cfg.name, kv_dtype=kv_dtype, weights="bf16",
        prompt_lens=f"{min(map(len, prompts))}..{max(map(len, prompts))}",
        chunk=G3_CHUNK, **stats)
    return launches, results, stats


def gemma3_full_width(dev):
    """Init at 62 layers and published width with the repaired init_lm,
    then the bf16-KV and int8-KV drains. Returns each drain's counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = get_config("gemma3-27b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    say("init", model=cfg.name, layers=cfg.n_layers, params=n_params,
        param_bytes=param_bytes, seconds=time.perf_counter() - t0,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    check(cfg.n_layers == 62 and cfg.d_model == 5376, "gemma3 cut in width")
    out, off = {}, {}
    for kv_dtype in ("bf16", "int8"):
        out[kv_dtype], *off[kv_dtype] = gemma3_serve(cfg, params, dev,
                                                     kv_dtype)
    gemma3_telemetry(cfg, params, dev, *off["bf16"])
    del params
    torch.cuda.empty_cache()
    return out


def gemma3_telemetry(cfg, params, dev, off_results, off_stats):
    """The 62-layer bf16-KV drain of phase 12 with telemetry attached:
    per-group retirement and residency gauges against phase 12's
    readings, the perf model exact with both groups' plans."""
    prompts = serving_trace(cfg.vocab_size, 16, G3_SHARED, *G3_SUFFIX, SEED)
    tag = "gemma3 telemetry"
    tel, stats = telemetry_drain(
        cfg, params, dev, off_results, off_stats, tag, prompts=prompts,
        new_tokens=G3_NEW, n_slots=8, cache_len=G3_CACHE_LEN,
        prefix=True, bucket_strategy="pow2", kernel_impl="auto",
        kv_dtype="bf16", prefill_chunk=G3_CHUNK, group_blocks="auto")
    r = tel.registry
    retired = [r.gauge("pool_pages_retired", {"group": g}).value
               for g in (0, 1)]
    resident = r.gauge("pool_resident_bytes").max
    lockstep = r.gauge("pool_lockstep_equiv_bytes").max
    check(retired == off_stats["retired_by_group"] == [0, 832],
          f"{tag}: pages retired by group {retired}, "
          f"{off_stats['retired_by_group']} without telemetry")
    check(resident == off_stats["tick_peak_resident_page_bytes"],
          f"{tag}: tick peak of pool_resident_bytes {resident} != "
          f"{off_stats['tick_peak_resident_page_bytes']}")
    check(lockstep == off_stats["tick_peak_lockstep_equiv_page_bytes"],
          f"{tag}: tick peak of pool_lockstep_equiv_bytes {lockstep} != "
          f"{off_stats['tick_peak_lockstep_equiv_page_bytes']}")
    check(any(plans is not None and len(plans) == 2
              and all(p is not None for p in plans)
              for _, plans, _, _ in tel.perf.launch_log),
          f"{tag}: no launch with both groups' plans")
    perf = tel.perf.summary()
    say("telemetry", model=cfg.name, layers=cfg.n_layers,
        requests=r.counter("serve_requests_finished").value,
        ticks=r.counter("serve_ticks").value, **latency_fields(tel),
        streamed_bytes=tel.streamed_bytes_total,
        roofline_total_s=perf["roofline_total_s"], chip=perf["chip"],
        model_error_max=perf["model_error_max"],
        retired_by_group=retired, tick_peak_resident_bytes=resident,
        tick_peak_lockstep_equiv_bytes=lockstep,
        recompiles=tel.compile_watcher().total, events=len(tel.events),
        wall_on_s=stats["wall_s"], wall_off_s=off_stats["wall_s"])


def gemma3_parity(dev):
    """f32 at published width and 6 layers (one whole 5:1 pattern):
    prompts of 1100..1300 tokens cross the window; 16 new tokens."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-27b"), dtype="float32",
                              n_layers=6)
    prompts = serving_trace(cfg.vocab_size, 6, 128, 972, 1172, SEED + 2)
    stats = token_parity(dev, cfg, prompts, 16, 128 + 1172 + 16 + 28, 512,
                         chunk_kw=dict(group_blocks="auto"))
    check(stats["retired_by_group"][1] > 0 and
          stats["retired_by_group"][0] == 0,
          f"gemma3 parity: retirement {stats['retired_by_group']}")
    torch.cuda.empty_cache()


def gemma3_quantized(dev):
    """The --quantize path at published width and 12 layers (two 5:1
    patterns; the dense and the packed trees must fit together):
    `ServeEngine.quantize` packs 7 x 12 slices by K5, then a drain with
    1024-token chunks runs K3 on decode ticks and K4 on the chunks. The
    counts are set to 0 before the quantize and read after the drain."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=12)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED + 5),
                     dev)
    reset_launches()
    qparams, frac, seconds = quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    k5 = read_launches()["bitplane_pack"]
    check(k5 == 7 * cfg.n_layers,
          f"gemma3 K5 launches {k5} != {7 * cfg.n_layers}")
    prompts = serving_trace(cfg.vocab_size, 8, G3_SHARED, 768, 1792,
                            SEED + 5)
    results, stats, launches = drain(
        cfg, qparams, prompts, 16, 8, G3_SHARED + 1792 + 16 + 240, dev,
        reset=False, prefix=True, bucket_strategy="pow2",
        kernel_impl="auto", prefill_chunk=1024, group_blocks="auto")
    check(stats["requests"] == 8 and all(len(v) == 16
                                         for v in results.values()),
          "gemma3 pim8: a request stopped short")
    check(all(launches[k] > 0 for k in kernel_modules()),
          f"gemma3 pim8: not every kernel launched: {launches}")
    check(stats["pools_whole"], "gemma3 pim8: a page is still held")
    say("serve", model=cfg.name, kv_dtype="bf16", weights="pim8",
        packed_fraction=frac, quantize_s=seconds, chunk=1024, **stats)
    del qparams
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm

    dev = torch.device("cuda")
    started = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card", name=repr(torch.cuda.get_device_name(0)),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    libs = _build.build()
    say("build", seconds=time.perf_counter() - t0,
        libs=",".join(p.name for p in libs.values()))
    for name in libs:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    sass = tensor_core_counts(libs)
    say("sass", **{name: n for name, n in sass.items()})
    for name in TENSOR_CORE_KERNELS:
        check(sass[name] == "unavailable" or sass[name] > 0,
              f"{name}: no tensor-core instruction in its SASS")

    errs = kernel_checks(dev)
    errs.update(bitplane_checks(dev))
    times = kernel_timings(dev)
    gemma3_kernel_timings(dev)
    times.update(bitplane_timings(dev))

    cfg = get_config("qwen2-1.5b")
    # the timings' queued work is not init's: wait for it first, and say
    # how long that took
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    queued_s = time.perf_counter() - t0
    # init_lm's shape pass on the meta device, timed alone: the first
    # meta-device op of a process is where the init's time goes
    from repro_torch.models.common import compute_dtype
    from repro_torch.models.transformer import init_layer
    modules = len(sys.modules)
    t0 = time.perf_counter()
    init_layer(cfg, None, torch.device("meta"), compute_dtype(cfg.dtype))
    meta_s = time.perf_counter() - t0
    modules = len(sys.modules) - modules
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    say("init", model=cfg.name, params=n_params,
        seconds=time.perf_counter() - t0, queued_before_s=queued_s,
        first_meta_pass_s=meta_s, modules_imported_by_it=modules)
    by_path = {}
    launches, off_results, off_stats = serve_full_width(cfg, params, dev,
                                                        "bf16")
    by_path["qwen2-1.5b bf16 KV"] = launches
    qwen2_telemetry(cfg, params, dev, off_results, off_stats)
    qwen2_annotations(cfg, params, dev)
    by_path["qwen2-1.5b int8 KV"] = serve_full_width(cfg, params, dev,
                                                     "int8")[0]
    reset_launches()
    qparams, frac, seconds = quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    q_launches = by_path["qwen2-1.5b pim8"] = serve_quantized(
        cfg, qparams, frac, seconds, dev)
    launches = dict(launches)
    for name in ("bitplane_gemv", "bitplane_gemm", "bitplane_pack"):
        launches[name] = q_launches[name]
    del qparams
    torch.cuda.empty_cache()
    qwen2_parity(dev)
    qwen2_parity(dev, quantize=True)

    g3 = gemma3_full_width(dev)
    by_path["gemma3-27b bf16 KV"] = g3["bf16"]
    by_path["gemma3-27b int8 KV"] = g3["int8"]
    gemma3_parity(dev)
    by_path["gemma3-27b[12L] pim8"] = gemma3_quantized(dev)

    csrc = "src/repro_torch/kernels/csrc"
    sources = {
        "paged_decode": (f"{csrc}/paged_decode.cu",
                         "src/repro/kernels/paged_attention.py:60"),
        "paged_prefill": (f"{csrc}/paged_prefill.cu",
                          "src/repro/kernels/paged_prefill.py:70"),
        "bitplane_gemv": (f"{csrc}/bitplane_gemv.cu",
                          "src/repro/kernels/bitplane_gemv.py:34"),
        "bitplane_gemm": (f"{csrc}/bitplane_gemm.cu",
                          "src/repro/kernels/bitplane_gemm.py:23"),
        "bitplane_pack": (f"{csrc}/bitplane_pack.cu",
                          "src/repro/kernels/pack.py:22"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_by_path={path: n[name] for path, n in by_path.items()}))
    say("done", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
