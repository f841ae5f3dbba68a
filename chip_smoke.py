"""Chip smoke test of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the
port's main paths through `ServeEngine.quantize`, `ServeEngine.generate`
and `ContinuousBatcher`, the entry points the launcher drives, with
random weights from a seed: paged and dense-cache serving of qwen2-1.5b
at full width (28 layers, d 1536, 12 heads, 2 kv-heads, d_ff 8960, vocab
151936), with bf16 and with PIM bit-plane weights, then gemma3-27b at
its published width (62 layers, d 5376, 32 heads, 16 kv-heads, hd 128,
d_ff 21504, vocab 262144; 5:1 local:global layers with a 1024-token
window), whose paged cache splits into a global and a windowed layer
group that retires pages, then the rest of the attention model zoo at
published width: qwen2.5-14b and granite-20b (MQA, GQA group 48, plain
GELU MLP) at full depth, phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e
(mixtures of experts) cut in depth to fit the card, then the other
families at published width and depth: zamba2-1.2b (Mamba2 with a
shared attention block), xlstm-350m (mLSTM / sLSTM), whisper-medium
(encoder-decoder over stub frames) and llava-next-34b (stub patch
embeddings, GQA group 7), then training through `make_train_step`
and `Trainer`: qwen2-1.5b at full width, and the example model with
checkpoints and a bit-exact resume, then the distribution layer:
qwen2-1.5b tensor-parallel (TP = 2) serving and data-parallel (DP = 2)
training at full width on ranks that share the card, the paper's
reduction networks as collectives, the int8 error-feedback all-reduce,
an elastic restore, and the MoE, recurrent and encoder-decoder stacks
tensor-parallel, and last the tools: the dispatch lint, the
static analysis, the roofline, the dry run and the two examples.
Phases, one line each:

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
               0..3392, windows {capacity, 1024}) and at granite-20b's
               (H 48, KV 1: a GQA group of 48; 68 columns, window 256)
               and llava-next-34b's (H 56, KV 8: g = 7),
               walks starting at each slot's first live block, for bf16,
               f32 and int8 pools: max abs error vs the plain version
               <= 1e-4 on valid rows, the bucketed launch bit-identical
               to the single launch; then K2 at granite's q
               [1, 512, 48, 128] and llava's [1, 512, 56, 128] from
               start 256, within 1e-4
  4. bitplane  K3 (GEMV), K4 (GEMM) and K5 (pack) against their plain
               versions for (n_bits, g) in {(8,1), (4,2), (8,4), (3,1)}
               and x in {bf16, f32}, on qwen2's projections
               [1536->256], [1536->1536], [1536->8960], [8960->1536]
               (K8 = 192 and 1120) and a ragged [200->101], and in 8-bit
               g = 1 on gemma3's five projections (K8 = 672, 512, 2688;
               M up to 21504) at B {8, 512, 1024} and granite-20b's four
               (K8 = 768, 3072; M 128 to 24576) at B {128, 187}; B in
               {1, 8, 128, 187, 512} must launch K3 and {513, 1024} K4,
               and each K3 launch above 24 rows count as one on its wide
               tile (`python3 chip_smoke.py --bitplane` runs the build,
               this phase and the bit-plane timings alone). K5 planes
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
               [768, 5376] -> 21504; K3 at granite-20b's four
               projections at 128 rows on its wide and its narrow tile,
               at 187 rows, f32 x at 32 and 128 rows on each tile, and
               K4 at 128 rows; then K1 at granite-20b's q
               [8, 48, 128] (KV 1), K2 at its [1, 512, 48, 128] from
               start 256, the same two at llava's 56 heads over 8 KV
               heads, K3 at zamba2's [8, 2048] -> 8352 and xlstm's
               [8, 1024] -> 4; K3 at phi3.5-moe's expert projections is
               timed after its drain
     init      qwen2-1.5b at full width, after a sync (the wait is
               printed): `init_lm` alone (and the modules it imports)
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
     dense     `ServeEngine.generate` on the dense cache (`paged=False`,
               the launcher's default): 8 prompts of 2048 tokens (chunked
               prefill), 64 new tokens, max_cache_len 2120; wall,
               tokens/s, 63 decode calls, the cache's 486,277,120 bytes
               and the peak device memory
     dense     `ContinuousBatcher(paged=False)`: 16 requests of 2048
               tokens, 8 slots, 64 new tokens: exactly 126 ticks, 32,768
               prefill tokens, 1,024 tokens out, the global position 126
               after the drain, and no metric touched
  8. serve     the --quantize path: `ServeEngine.quantize` to 8-bit,
               g = 1 PIM bit-plane weights (K5 packs every projection
               slice on the card), then the bf16-KV trace of phase 6;
               K1-K5 must each have launched in that path
     dense     the dense `generate` with those weights: K3 (decode) and
               K4 (prefill) must launch; the tokens' agreement with the
               bf16 run
  9. parity    qwen2-1.5b in f32 with 4 layers: greedy tokens with the
               CUDA kernels equal those with the plain versions on the
               card, and chunked prefill (64) equals single-shot
 10. parity    phase 9 with 8-bit g = 1 bit-plane weights
     dense parity  qwen2-1.5b in f32 with 4 layers, 4 prompts of 1600
               tokens: dense `generate` with 8-bit g = 1 weights gives
               the same tokens with the kernels as with the plain
               versions, and with dense weights the same tokens as the
               paged engine
     ckpt      qwen2-1.5b's serving params at full width (28 layers, bf16
               weights) saved by `CheckpointManager.save` and by
               `save_async` + `wait`, each into a temp dir of its own,
               restored onto the card with every leaf equal, and once
               into an f32 target, the bf16 values widened exactly;
               bytes, save, snapshot, write and restore seconds
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
     dense     `ServeEngine.generate` on the dense cache at 62 layers: 8
               prompts of 1536 tokens (chunked prefill, kv blocks halved
               to 512, local layers windowed), 32 new tokens,
               max_cache_len 1576; the cache's 6,403,653,632 bytes and
               the peak device memory
 14. parity    gemma3-27b in f32 with 6 layers (one whole 5:1 pattern),
               prompts of 1100..1300 tokens: kernels == plain versions
               and 512-token chunks (auto-sized groups) == single-shot
 15. serve     gemma3-27b with 12 layers through `ServeEngine.quantize`
               (K5 launched 7 x 12 times) and a drain with 1024-token
               chunks: K1-K5 must each have launched
 16. imagine  the paper's own engine: `ImagineGemv` at the full U55 array
               (126 x 32 blocks of 16 lanes, depth 1024: a 66,060,288-byte
               register file on the card), int8 GEMVs of 1024 x 1024 and
               2048 x 2048 walked bit-serially: y equal to the host's
               int64 W @ x, cycles equal to `analytic_cycles` and to the
               reference's 10,249 and 29,187, 144 and 306 instructions,
               no K1-K5 launch; wall (synchronised), passes, full-adder
               steps per pass, peak device memory. Then the three Fig. 7
               validation GEMVs (4 x 8 x 8, depth 512) on the card, and
               Table IX's and Table VIII's values pinned to the
               reference's
 17. zoo      the rest of the attention model zoo at published width,
               random weights from the seed, each drain 8 requests of a
               shared 256-token prompt plus a 256..768-token suffix, 32
               new tokens, 8 slots, block 16, prefix index, pow2
               buckets (the `[serve]` fields, plus the MoE layers'
               dropped fraction and load-balance loss on decode steps
               and prefill chunks):
               qwen2.5-14b at 24 of 48 layers (bf16 KV), granite-20b at 26
               of 52
               (bf16 and int8 KV; K1/K2 at g = 48), phi3.5-moe at 24 of
               32 layers (bf16 KV), llama4-scout at 8 of 48 (bf16 KV);
               then phi3.5-moe's --quantize path at 8 layers
               (`ServeEngine.quantize`: K5 packs every attention
               projection and expert slice, 416 launches; its drain
               launches K1-K5, K3 once per expert projection; the
               tree's packed fraction). Then f32 parity at published
               width, 4 layers (qwen2.5, granite) or 2 (the MoE models):
               greedy tokens with the kernels equal those with the plain
               versions; chunked prefill equal to single-shot for the
               dense two (a MoE chunk's rows compete for the experts'
               places, so another chunking routes differently, in the
               reference as well)
 18. families the rest of the zoo at published width, random weights
               from the seed (the `[families]` lines carry the `[serve]` /
               `[dense]` fields): zamba2-1.2b (38 Mamba2 layers, a shared
               attention block after every 6th) and xlstm-350m (24
               layers, the sLSTM at every 6th), each with dense
               `generate` (8 x 1024 tokens, 64 new; xlstm 8 x 256, its
               prefill being a Python loop over time), the dense batcher
               (16 requests, 8 slots, 32 new: exactly 62 ticks and the
               global position 62) and the --quantize path (K5 once per
               projection slice, then `generate` launching K3 and K4;
               xlstm's [1024 -> 4] gates on K3); whisper-medium (24 + 24
               layers) `prefill_encdec` over 1500 stub frames and a
               4-token prompt, 8 rows, 63 greedy `decode_step_encdec`s,
               then the same with 8-bit weights (K4 on the encoder's
               12,000 rows, K3 on decode); llava-next-34b at 60 layers
               (68.8 GB of bf16 weights): `prefill` of 2880 stub patch
               positions and 64 text tokens, 2 rows, 31 `decode_step`s,
               then the launcher's paged drain (K1/K2 at g = 7). After
               each pim8 run K3-K5 are held against their plain versions
               at every [K -> M] and row count it ran. Then f32 parity at
               published width: zamba2 and xlstm at 6 layers (the
               teacher-forcing property of tests/test_models.py, and pim8
               dense `generate` kernels == plain versions), whisper at 2
               + 2 (pim8 kernels == plain), llava at 4 (K1/K2 drain ==
               plain, chunked == single-shot)
 18'. mellum   K6 (the grouped bit-plane GEMV of dropless expert stacks)
               against its plain version (within 1e-5 of the largest
               |plain|) and K3 on each expert's rows (exactly equal),
               timed beside its plain version at mellum2-12b-a2.5b's
               expert shapes ([2304 -> 896], [896 -> 2304], 64 experts,
               8-bit g = 1) at 1024 and 11,080 pairs; then the whole
               model (28 layers, 64 experts each, vocab 98,304) packed
               and drained: K6 launches 3 x 28 per decode step.
               `python3 chip_smoke.py --mellum` runs the build and this
               phase alone
 19. train    the training path (`make_train_step`, `Trainer`; no
               serving kernel launches in it): (a) qwen2-1.5b at
               published width and depth (28 L, d 1536, vocab 151936),
               remat on, f32 master weights, bf16 compute, batch 8 x 512,
               6 steps: step seconds (median of steps 2-6, each ended by
               a sync), tokens/s, matmul TFLOP/s, peak memory (< 60 GB),
               loss and grad_norm, all finite; (b) one f32 step of
               qwen2-1.5b at published width, 2 layers, batch 2 x 64, on
               the card (TF32 off) and on the CPU from the same params:
               params within a tenth of the lr, m and v within 1e-4 of
               their largest value; (c) in a child process under
               `torch.use_deterministic_algorithms(True)` and
               CUBLAS_WORKSPACE_CONFIG=:4096:8, the example model of
               examples/train_lm_torch.py (8 L, d 512, vocab 8192,
               35.7M params) through `Trainer` with checkpoints in a temp
               dir: 300 steps, loss and accuracy first to last (the loss
               must fall), then 40 steps straight against 20 and a new
               `Trainer` resuming to 40, params, m and v equal bit for bit
 20. dist     the distribution layer (`repro_torch.dist`), its ranks
               processes on this one card that talk over gloo (NCCL
               refuses two ranks on one device; all-gather, reduce-scatter
               and send / recv of CUDA tensors are staged through pinned
               host memory, and counted): K3/K4/K5 first held against their
               plain versions at the TP = 2 shard shapes of qwen2-1.5b;
               then two ranks run (a) TP = 2 dense `generate` of qwen2-1.5b
               at 28 layers, 8 x 512 prompts, 32 new tokens, bf16 (6 heads,
               1 kv head, d_ff 4480 and half of `embed`'s d_model a rank;
               wall, prefill / decode split, tokens/s, peak bytes a rank,
               all-reduce calls and bytes a decode step, staged bytes), and
               (a'') the same with 8-bit g = 1 weights (the whole tree
               packed by K5, then cut by the specs; K5 on a rank's column
               block must give the cut planes; K3/K4 launch at the shard
               shapes); (a') at f32 and 4 layers TP = 2 against the one
               rank: prefill logits within 1e-4, greedy tokens equal, with
               dense and with 8-bit weights; (e) those TP = 2 params, and
               a bf16 copy of them, saved whole by rank 0, restored onto
               one rank and back onto TP = 2, every leaf bit for bit;
               (b) DP = 2 training of
               qwen2-1.5b at 28 layers, f32 masters, remat, 2 steps of
               2 x 4 x 512 (step s, tokens/s, peak a rank, the gradient
               all-reduce's bytes and seconds), then one DP = 2 f32 step
               at 2 layers against the one-rank step (loss within 1e-6
               relative, params within 0.1 x lr); (d) `compressed_psum`
               over the tied embedding's gradient [151936, 1536] f32:
               within 5% of the exact mean, residual nonzero. Then four
               ranks run (c) every reduction schedule of `SCHEDULES` and
               `reduce_to_zero_binary_hopping` over 16 MiB f32 shards of
               integers: results equal to `allreduce_tree`'s (rank 0's
               for reduce-to-zero), seconds, bytes a rank equal to the
               model — Table IV's networks on gloo's host path, not NVLink.
               Last, (f) the MoE, recurrent and encoder-decoder stacks at
               TP = 2 and published width on two more ranks: phi3.5-moe
               at 8 of 32 layers (bf16 and 8-bit), llama4-scout at 4 of
               48, zamba2-1.2b (bf16 and 8-bit) and xlstm-350m at full
               depth, dense `generate` of 4 x 256 tokens and 16 new, and
               whisper-medium's 24 + 24 layers over 1500 stub frames,
               `prefill_encdec` and 16 `decode_step_encdec`s: tokens,
               walls split at the prefill's end, collectives by kind,
               staged bytes, peaks, K3/K4/K5 launches (K3-K5 held
               against their plain versions at every shape and row count
               the pim8 runs gave them, and at whisper's shard shapes);
               (f') each in f32 at 2 layers against one rank: prefill
               logits within 1e-4, greedy tokens equal; (g) phi3.5-moe's
               f32 training at 2 layers (d_ff cut to 1600) on (data,
               model) = (2, 1) in 2 microbatches at capacity factor 0.5,
               2 steps: metrics within 1e-5 and params within 1e-4 of
               rank 0's steps on one rank over the whole batch
 21. tools    the port's tools on the card: [lint] the dispatch lint
               (`analysis.dispatch_lint`) of the real paged decode and
               prefill steps of `serve/compiled.py` at qwen2-1.5b's full
               width (8 slots over 5,858 cached positions; a 768-token
               chunk after 256 cached) with bf16 KV, int8 KV and 8-bit
               weights, and of gemma3-27b at 6 layers (two layer groups),
               through K1-K4 under `set_sync_debug_mode("error")`: 0
               findings; [analysis] the repo and kernel layers over the
               tree through `python -m repro_torch.analysis --gate`, and
               `obs.regress.make_record` reading its findings JSON;
               [roofline] qwen2-1.5b 28 L, one decode step, one 768-token
               chunk, the pim8 decode step and one 8 x 512 training step:
               counted FLOPs and kernel bytes equal on impl="cuda" and
               impl="ref", the step's median over 10 calls between CUDA
               events, and bound / measured <= 1; [dryrun] the dry run of
               qwen2-1.5b decode_32k on 2 x 16 x 16 and train_4k on 16 x
               16, of phi3.5-moe, llama4-scout, zamba2, xlstm and whisper
               decode_32k on 2 x 16 x 16, zamba2's and xlstm-350m's
               train_4k and llava-next-34b's prefill_32k on 16 x 16 (the
               last two's argument bytes held to the reference's specs),
               in a child process (started after the build, one CPU
               thread; its fake world of 512 / 256 ranks never meets the
               [dist] phase's): status ok, per-rank bytes, collectives
               by kind, roofline terms; [examples] both port examples as
               children on the card: the bit-exact GEMV, the prefix
               drain's tokens equal to the unshared drain's, and their
               kernel launches
 22. a JSON line {"kernels": [...]} with each kernel's launches (those
     of the qwen2 paths and of the TP = 2 paths, and per path), error,
     times and bound, then the last line {"ok": true, "device":
     {"platform": "gpu", ...}}

Any failed check ends the script with a non-zero exit and no "ok" line.
It exits non-zero at once when no CUDA device is present, or when the
port's sources are not beside it.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import json
import math
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


class Laps:
    """Host seconds of each phase: `lap(name)` prints the time since the
    previous lap (or since the clock was made) as `[lap]`."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        say("lap", name=name, seconds=now - self.t)
        self.t = now


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
    from repro_torch.kernels import (bitplane_gemm, bitplane_gemv,
                                     bitplane_grouped, pack,
                                     paged_attention, paged_prefill)
    return {"paged_decode": paged_attention, "paged_prefill": paged_prefill,
            "bitplane_gemv": bitplane_gemv, "bitplane_gemm": bitplane_gemm,
            "bitplane_pack": pack, "bitplane_grouped": bitplane_grouped}


#: the kernels every pim8 stack without dropless experts launches (K1-K5);
#: K6 runs only under dropless routing (phase `mellum`)
DENSE_KERNELS = ("paged_decode", "paged_prefill", "bitplane_gemv",
                 "bitplane_gemm", "bitplane_pack")


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0
    kernel_modules()["bitplane_gemv"].LAUNCHES_WIDE = 0


def wide_launches() -> int:
    """K3 launches on its wide tile (of `LAUNCHES`, replays included)."""
    return kernel_modules()["bitplane_gemv"].LAUNCHES_WIDE


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


#: libraries whose products must run on the tensor cores
TENSOR_CORE_KERNELS = ("paged_decode", "paged_prefill", "bitplane_gemv",
                       "bitplane_gemm", "bitplane_grouped")


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
    # granite-20b: MQA, a GQA group of 48 (three K1 head tiles)
    ("granite-20b", 48, 1, 68, [0, 1, 17, 129, 300, 700, 1000, 1088],
     [1, 17, 64, 300, 700, 1000, 1050, 1088], 256),
    # qwen2.5-14b and llama4-scout: g = 5
    ("qwen2.5-14b/llama4-scout", 40, 8, 68,
     [0, 1, 17, 129, 300, 700, 1000, 1088],
     [1, 17, 64, 300, 700, 1000, 1050, 1088], 256),
    # phi3.5-moe: g = 4
    ("phi3.5-moe", 32, 8, 68, [0, 1, 17, 129, 300, 700, 1000, 1088],
     [1, 17, 64, 300, 700, 1000, 1050, 1088], 256),
    # llava-next-34b: g = 7
    ("llava-next-34b", 56, 8, 68, [0, 1, 17, 129, 300, 700, 1000, 1088],
     [1, 17, 64, 300, 700, 1000, 1050, 1088], 256),
)


def kernel_checks(dev):
    """K1 and K2 against their plain versions at the head shapes of
    every model's main path, bf16, f32 and int8 pools. With the short window
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
#: granite-20b's projections (q / o, k / v, up, down at 8 bits, g = 1) at
#: a decode tick's 128 rows and a 187-row prompt (padded to 256 in K3's
#: wide tile), where K3 takes its wide tile
GR_BITPLANE_MATRICES = ((6144, 6144), (6144, 128), (6144, 24576),
                        (24576, 6144))
GR_BITPLANE_ROWS = (128, 187)


def bitplane_checks(dev):
    """K5 byte-identical to the plain pack; K3/K4 raw within 1e-5 of
    max|raw| of the plain contraction; `bitplane_matmul` (kernel, offset,
    scale) within the reference's tolerance of its oracle. The counts
    must show B <= 512 on K3 and B > 512 on K4. qwen2-1.5b's shapes in
    four formats; its four projections again at the dense pim8 prefill's
    8 x 2048 rows in the format that phase runs (8-bit g = 1); then
    gemma3-27b's and granite-20b's in 8-bit g = 1. Every K3 launch above
    24 rows must count as a wide-tile launch, and no other."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    abs_err = {"bitplane_gemv": 0.0, "bitplane_gemm": 0.0,
               "bitplane_pack": 0.0}
    for model, formats, matrices, rows in (
            ("qwen2-1.5b", BITPLANE_FORMATS, BITPLANE_MATRICES,
             GEMV_ROWS + GEMM_ROWS),
            ("qwen2-1.5b", ((8, 1),), BITPLANE_MATRICES[:4],
             (8 * Q2_DENSE_T,)),
            ("gemma3-27b", ((8, 1),), G3_BITPLANE_MATRICES,
             G3_BITPLANE_ROWS),
            ("granite-20b", ((8, 1),), GR_BITPLANE_MATRICES,
             GR_BITPLANE_ROWS)):
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
    from repro_torch.kernels import bitplane_gemv, ops, ref

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
            launched, wide = read_launches(), wide_launches()
            plain = x.float() @ u
            y_ref = ref.bitplane_matmul_ref(x, planes, scale, n_bits,
                                            group).float()
            torch.cuda.synchronize()
            check(launched[name] == 2 and sum(launched.values()) == 2,
                  f"{tag} B={b}: expected 2 launches of {name}, got "
                  f"{launched}")
            want = launched[name] if (name == "bitplane_gemv"
                                      and bitplane_gemv.wide_tile(b)) else 0
            check(wide == want, f"{tag} B={b}: {wide} wide-tile launches, "
                                f"expected {want}")
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


def bitplane_row(dev, gen, name, b, k, m, model="qwen2-1.5b",
                 dt=torch.bfloat16, narrow=False) -> dict:
    """One K3 or K4 timing, 8-bit g = 1, x of `b` rows in `dt` against a
    [k -> m] weight; the library yardstick is one `x @ W` with W
    dequantized dense in x's dtype beforehand (the port never calls it).
    `narrow` times K3 on its narrow tile at rows the tile rule gives the
    wide one (the old tile, for the comparison; the same bits). The
    bound's operations are the bf16 tensor cores' (f32 x: three bf16
    terms), whatever x's dtype."""
    from unittest import mock

    from repro_torch.kernels import bitplane_gemm, bitplane_gemv, ops, ref

    fn = {"bitplane_gemv": bitplane_gemv.bitplane_gemv,
          "bitplane_gemm": bitplane_gemm.bitplane_gemm}[name]
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, scale = ops.quantize_and_pack(w, 8, 1, "cuda")
    del w
    x = torch.randn((b, k), generator=gen, device=dev).to(dt)
    x_r = ref.prepare_x_ref(x, 1).contiguous()
    w_dense = ref.dequantize_ref(planes, scale, 8, 1).to(dt)
    terms = 1 if dt == torch.bfloat16 else 3
    tile = (" narrow tile" if narrow else " wide tile"
            if name == "bitplane_gemv" and bitplane_gemv.wide_tile(b) else "")
    with mock.patch.object(bitplane_gemv, "wide_tile",
                           (lambda _: False) if narrow
                           else bitplane_gemv.wide_tile):
        r = dict(
            **time_kernel(
                lambda: fn(x_r, planes, n_bits=8, group=1),
                lambda: ref.bitplane_raw_ref(x_r, planes, 1),
                lambda: x @ w_dense),
            **bound(planes.numel() + x_r.numel() * x_r.element_size()
                    + b * m * 4, 2 * b * k * m * terms, torch.bfloat16),
            shape=f"{model} x[{b},{k}] planes[8,{k // 8},{m}] "
                  f"{'bf16' if dt == torch.bfloat16 else 'f32'}{tile}")
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
    K4 [5376->21504] at B = 768; then at granite-20b's four projections
    ([6144->6144] q / o, [6144->128] k / v, [6144->24576] up,
    [24576->6144] down): K3 at a decode tick's 128 rows on its wide tile
    and on its narrow one, at a 187-row prompt, f32 x at 32 and 128 rows
    on each tile, and K4 at 128 rows (a yardstick; no path sends it 128
    rows). K5 has no library call."""
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
    for k, m in GR_BITPLANE_MATRICES:
        for name, b, dt, narrow in (
                ("bitplane_gemv", 128, torch.bfloat16, False),
                ("bitplane_gemv", 128, torch.bfloat16, True),
                ("bitplane_gemv", 187, torch.bfloat16, False),
                ("bitplane_gemv", 32, torch.float32, False),
                ("bitplane_gemv", 32, torch.float32, True),
                ("bitplane_gemv", 128, torch.float32, False),
                ("bitplane_gemv", 128, torch.float32, True),
                ("bitplane_gemm", 128, torch.bfloat16, False)):
            bitplane_row(dev, gen, name, b, k, m, model="granite-20b",
                         dt=dt, narrow=narrow)
    return out


# ---------------------------------------------------------------------------
# phase: mellum2-12b-a2.5b's dropless experts on K6
# ---------------------------------------------------------------------------

#: mellum2-12b-a2.5b's expert projections: [2304 -> 896] (gate / up) and
#: [896 -> 2304] (down), 64 experts, 8-bit g = 1 planes
MELLUM_EXPERT_SHAPES = ((2304, 896), (896, 2304))
#: a decode tick's 128 slots x top-8, and a 1385-token prompt's x 8
MELLUM_PAIRS = (1024, 11080)


def k6_row(dev, gen, k, m, pairs, e=64) -> tuple:
    """One K6 launch at [k -> m] over `pairs` bf16 rows routed uniformly
    at random to `e` experts' random planes: its largest difference from
    the plain version (held within 1e-5 of the largest |plain|, and 1e-5
    of each, as the card test holds it), its largest difference from K3
    on each expert's rows (0: the same tile), and its timing beside the
    plain version (no library call computes it; the plain version runs
    every expert over every row, E times the work)."""
    from repro_torch.kernels import bitplane_gemv, bitplane_grouped, ref
    from repro_torch.kernels import work as kwork

    planes = torch.randint(0, 256, (e, 8, k // 8, m), generator=gen,
                           device=dev, dtype=torch.uint8)
    expert = torch.sort(torch.randint(0, e, (pairs,), generator=gen,
                                      device=dev)).values
    counts = torch.bincount(expert, minlength=e)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    x = torch.randn((pairs, k), generator=gen, device=dev).bfloat16()
    x_r = ref.prepare_x_ref(x, 1).contiguous()

    def run():
        return bitplane_grouped.bitplane_grouped(x_r, planes, offsets,
                                                 n_bits=8)

    def plain_run():
        return bitplane_grouped.bitplane_grouped_ref(x_r, planes, offsets)
    raw = run()
    plain = plain_run()
    diff = (raw - plain).abs()
    plain_err = float(diff.max())
    top = float(plain.abs().max())
    check(bool((diff <= 1e-5 * (plain.abs() + top)).all()),
          f"K6 [{k}->{m}] x {pairs} differs from its plain version by "
          f"{plain_err} (largest |plain| {top})")
    del plain, diff
    offs = offsets.tolist()
    k3_err = 0.0
    for i in range(e):
        a, b = offs[i], offs[i + 1]
        if a < b:
            want = bitplane_gemv.bitplane_gemv(
                ref.prepare_x_ref(x[a:b], 1).contiguous(), planes[i],
                n_bits=8)
            k3_err = max(k3_err, float((raw[a:b] - want).abs().max()))
    flops, nbytes = kwork.k6_work(pairs, k, m, n_experts=e)
    r = dict(ms=cuda_ms(run), call_ms=call_ms(run),
             plain_ms=call_ms(plain_run),
             library_ms=None, library_call_ms=None,
             **bound(int(nbytes), int(flops), torch.bfloat16),
             shape=f"mellum2 x[{pairs},{k}] planes[{e},8,{k // 8},{m}] bf16",
             max_abs_err=plain_err, plain_max_abs=top, k3_max_abs_err=k3_err)
    say_timing("bitplane_grouped", r)
    say("k6", shape=repr(r["shape"]), max_abs_err=plain_err,
        plain_max_abs=top, k3_max_abs_err=k3_err)
    torch.cuda.empty_cache()
    return plain_err, k3_err, r


def mellum_decode_launches(dev) -> dict:
    """mellum2-12b-a2.5b whole (28 layers, 64 experts each, the whole
    vocabulary) on 8-bit planes: a short paged drain with telemetry, each
    decode step's launches counted: K6 launches 3 per layer, 84 a step,
    replayed or not; the MoE's device counters give top_k x layers x
    every row routed (no pair dropped); the decode is captured once and
    replayed after; the host waits once a decode tick and once an
    admission, as for any stack."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.obs import ServeTelemetry
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = get_config("mellum2-12b-a2.5b")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    qparams, frac, q_s = quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    tel = ServeTelemetry()
    cb = ContinuousBatcher(cfg, qparams, n_slots=8, cache_len=1200,
                           paged=True, block_size=16, device=dev,
                           telemetry=tel)
    step, per_step = cb._decode_paged, []

    def counted(*args, **kw):
        before = read_launches()
        out = step(*args, **kw)
        after = read_launches()
        per_step.append({n: after[n] - before[n] for n in after})
        return out
    cb._decode_paged = counted
    rng = np.random.default_rng(SEED)
    reset_launches()
    for uid, n in enumerate((1100, 40, 300)):
        cb.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    cb.run_until_drained()
    torch.cuda.synchronize()
    k6 = [d["bitplane_grouped"] for d in per_step]
    check(all(n == 3 * cfg.n_layers for n in k6),
          f"K6 launches per decode step {k6}, not 3 x {cfg.n_layers}")
    check(all(d["bitplane_gemv"] == 4 * cfg.n_layers for d in per_step),
          "K3 launches per decode step: not 4 projections x layers")
    launches = read_launches()
    counts = {m.name: m.value for name in (
        "moe_pairs", "moe_layer_calls", "moe_expert_rows_max",
        "serve_decode_graph_captures", "serve_decode_graph_replays")
        for m in tel.registry.find(name)}
    spans = [r.name for r in tel.span_records()]
    ticks, admits = spans.count("serve/tick"), spans.count("serve/admit")
    syncs = spans.count("serve/sync") + spans.count("serve/first_token")
    routed = len(per_step) * cb.n_slots + cb.prefill_tokens
    check(counts["moe_pairs"] == cfg.top_k * cfg.n_layers * routed,
          f"moe_pairs {counts['moe_pairs']} != top_k x layers x {routed}")
    check(counts.get("serve_decode_graph_captures") == 1 and counts.get(
        "serve_decode_graph_replays") == len(per_step) - 2,
        f"decode graphs: {counts}")
    check(syncs == len(per_step) + admits,
          f"{syncs} host waits for {len(per_step)} decodes and {admits} "
          "admissions")
    say("mellum", model=cfg.name, packed_fraction=frac, init_s=init_s,
        quantize_s=q_s, drain_s=time.perf_counter() - t0,
        decode_steps=len(per_step), k6_launches_per_decode_step=k6[0],
        k6_launches=launches["bitplane_grouped"], rows_routed=routed,
        ticks=ticks, host_waits=syncs, **counts,
        peak=torch.cuda.max_memory_allocated())
    del cb, qparams
    torch.cuda.empty_cache()
    return launches


def mellum(dev, errs, times) -> dict:
    """K6 against its plain version and K3, and timed, at the cell's
    shapes, then the whole model's decode launches; fills `errs` (the
    largest difference from the plain version) / `times` for K6's row of
    the kernel table and returns the drain's launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    err = k3_err = 0.0
    for pairs in MELLUM_PAIRS:
        for k, m in MELLUM_EXPERT_SHAPES:
            e, e3, r = k6_row(dev, gen, k, m, pairs)
            err, k3_err = max(err, e), max(k3_err, e3)
            times.setdefault("bitplane_grouped", r)
    check(k3_err == 0.0, f"K6 differs from K3 by {k3_err}")
    errs["bitplane_grouped"] = err
    return mellum_decode_launches(dev)


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
        launches_bitplane_gemv_wide=wide_launches(),
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
        required=DENSE_KERNELS, packed_fraction=frac,
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
    agree. `chunk=None` leaves the chunked run out. Returns the kernel
    run's drain stats."""
    from repro_torch.models import init_lm

    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED + 2),
                     dev)
    if quantize:
        params = quantize_params(cfg, params)[0]
    runs, stats = {}, None
    variants = [("kernel", dict(kernel_impl="auto")),
                ("plain", dict(kernel_impl="ref"))]
    if chunk is not None:
        variants.append(("chunked", dict(kernel_impl="auto",
                                         prefill_chunk=chunk,
                                         **(chunk_kw or {}))))
    for name, extra in variants:
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
    check(chunk is None or runs["chunked"] == runs["kernel"],
          f"{cfg.name}: chunked-prefill tokens differ from single-shot")
    say("parity", model=f"{cfg.name}[f32,{cfg.n_layers}L]",
        weights="pim8" if quantize else "f32", requests=len(runs["kernel"]),
        tokens=sum(len(v) for v in runs["kernel"].values()),
        prompt_lens=f"{min(map(len, prompts))}..{max(map(len, prompts))}",
        chunk=chunk, retired_by_group=stats["retired_by_group"],
        kernel_eq_plain=True,
        chunked_eq_single=None if chunk is None else True)
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
# the dense (non-paged) cache: ServeEngine.generate and the batcher
# ---------------------------------------------------------------------------

def dense_cache_bytes(cfg, batch, cache_len) -> int:
    """The bytes of `models.init_cache` (K/V [L, B, S, KV, hd], or the
    recurrent states and zamba2's shared-block K/V), counted on the meta
    device."""
    from repro_torch.models import init_cache
    cache = init_cache(cfg, batch, cache_len, "meta")
    return sum(v.numel() * v.element_size() for k, v in cache.items()
               if k != "position")


def dense_generate(cfg, params, prompts, new_tokens, cache_len, dev,
                   **sc):
    """`ServeEngine.generate` on the dense cache, its launch counts set to
    0 just before and read just after. Returns the tokens on the host and
    the run's stats: decode calls counted at the engine's decode step,
    and the wall split at a CUDA event recorded when the prefill step
    returns (no added sync): `prefill_s` from the start to the prefill's
    end on the device's clock, `decode_s` the rest."""
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, params, ServeConfig(
        max_cache_len=cache_len, max_new_tokens=new_tokens, device=str(dev),
        **sc))
    prefill, decode, calls = eng._prefill, eng._decode, [0]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def prefill_then_mark(*args, **kw):
        out = prefill(*args, **kw)
        events[1].record()
        return out

    def counted(*args, **kw):
        calls[0] += 1
        return decode(*args, **kw)

    eng._prefill, eng._decode = prefill_then_mark, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    out = eng.generate(prompts)
    events[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tokens = out.cpu().numpy()
    b, t = prompts.shape
    check(tokens.shape == (b, new_tokens),
          f"dense generate: tokens {tokens.shape}, want {(b, new_tokens)}")
    check(((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          "dense generate: token outside the vocab")
    check(calls[0] == new_tokens - 1,
          f"dense generate: {calls[0]} decode calls, want {new_tokens - 1}")
    stats = dict(layers=cfg.n_layers, batch=b, prompt_len=t,
                 new_tokens=new_tokens, wall_s=wall,
                 tokens_per_s=tokens.size / wall,
                 prefill_s=events[0].elapsed_time(events[1]) / 1e3,
                 decode_s=events[1].elapsed_time(events[2]) / 1e3,
                 decode_calls=calls[0],
                 dense_cache_bytes=dense_cache_bytes(cfg, b, cache_len),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 **{f"launches_{k}": v for k, v in launches.items() if v})
    return tokens, stats, launches


#: the qwen2 dense phases: 8 prompts of 2048 tokens (T * S = 4.19M score
#: elements > 2^21, so prefill takes the chunked path), 64 new tokens
Q2_DENSE_T, Q2_DENSE_NEW, Q2_DENSE_CACHE = 2048, 64, 2120


def dense_prompts(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def qwen2_dense(cfg, params, dev):
    """`ServeEngine.generate` with `paged=False` at full width, bf16.
    Returns its tokens and launch counts."""
    prompts = dense_prompts(cfg.vocab_size, 8, Q2_DENSE_T, SEED + 11)
    tokens, stats, launches = dense_generate(
        cfg, params, prompts, Q2_DENSE_NEW, Q2_DENSE_CACHE, dev)
    check(stats["dense_cache_bytes"] == 486_277_120,
          f"qwen2 dense cache bytes {stats['dense_cache_bytes']}")
    say("dense", model=cfg.name, weights="bf16", **stats)
    return tokens, launches


def dense_batcher(cfg, params, dev, n_requests, prompt_len, n_slots,
                  new_tokens, cache_len, seed, phase="dense"):
    """`ContinuousBatcher(paged=False)` over `n_requests` prompts of
    `prompt_len` tokens, twice as many as `n_slots`: two waves, each
    prefilled at once and decoded `new_tokens - 1` ticks. The dense
    batcher keeps one global write position, as the reference's does,
    so the position after the drain equals the ticks, 2 (new - 1). With
    no telemetry attached the drain must not touch a metric. The counts
    are set to 0 just before the drain and read just after; returns
    them."""
    from repro_torch.obs import mutation_count
    from repro_torch.serve import ContinuousBatcher, Request

    prompts = dense_prompts(cfg.vocab_size, n_requests, prompt_len, seed)
    cb = ContinuousBatcher(cfg, params, n_slots=n_slots, cache_len=cache_len,
                           prompt_len=prompt_len, device=dev)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mutations = mutation_count()
    t0 = time.perf_counter()
    results = cb.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mutations = mutation_count() - mutations
    launches = read_launches()
    n_tok = sum(len(v) for v in results.values())
    ticks = 2 * (new_tokens - 1)
    want = (ticks, n_requests * prompt_len, n_requests * new_tokens, ticks)
    got = (cb.ticks, cb.prefill_tokens, n_tok, cb.cache["position"])
    check(n_requests == 2 * n_slots and got == want,
          f"{cfg.name} dense batcher: (ticks, prefill tokens, tokens out, "
          f"position) {got} != {want}")
    check(all(len(v) == new_tokens for v in results.values()),
          f"{cfg.name} dense batcher: a request stopped short")
    check(mutations == 0, f"{cfg.name} dense batcher: the telemetry-off "
                          "drain touched a metric")
    say(phase, model=cfg.name, path="batcher", layers=cfg.n_layers,
        requests=len(results), prompt_len=prompt_len, tokens=n_tok,
        ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
        position=cb.cache["position"], wall_s=wall,
        tokens_per_s=n_tok / wall,
        dense_cache_bytes=dense_cache_bytes(cfg, n_slots, cache_len),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        metric_mutations=mutations,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    return launches


def qwen2_dense_batcher(cfg, params, dev):
    """`ContinuousBatcher(paged=False)`: 16 requests of 2048 tokens, 8
    slots, 64 new tokens each: exactly 126 ticks, the global position
    126. Returns the launch counts of the drain."""
    return dense_batcher(cfg, params, dev, 16, Q2_DENSE_T, 8, Q2_DENSE_NEW,
                         Q2_DENSE_CACHE, SEED + 12)


def qwen2_dense_quantized(cfg, qparams, bf16_tokens, dev):
    """The dense `generate` of `qwen2_dense` with the --quantize phase's
    8-bit g = 1 weights: prefill (8 x 2048 rows) runs K4, decode (8 rows)
    K3. Prints the tokens' agreement with the bf16 run."""
    prompts = dense_prompts(cfg.vocab_size, 8, Q2_DENSE_T, SEED + 11)
    tokens, stats, launches = dense_generate(
        cfg, qparams, prompts, Q2_DENSE_NEW, Q2_DENSE_CACHE, dev)
    check(launches["bitplane_gemv"] > 0 and launches["bitplane_gemm"] > 0,
          f"qwen2 dense pim8: K3/K4 not launched: {launches}")
    say("dense", model=cfg.name, weights="pim8",
        agreement_with_bf16=float((tokens == bf16_tokens).mean()),
        first_token_agreement=float((tokens[:, 0] == bf16_tokens[:, 0])
                                    .mean()),
        **stats)
    return launches


def dense_parity(dev):
    """qwen2-1.5b in f32 with 4 layers at full width: dense `generate`
    with 8-bit g = 1 PIM weights gives the same tokens with the kernels
    (K3 on decode, K4 on the 4 x 1600-row prefill) as with the plain
    versions; and with dense weights, dense `generate` gives the paged
    engine's tokens. T = 1600: T * T > 2^21, so the dense prefill takes
    the chunked path, with 64-token kv blocks (`_pick_block` halves 1024
    down to 64)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), dtype="float32",
                              n_layers=4)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED + 3),
                     dev)
    prompts = dense_prompts(cfg.vocab_size, 4, 1600, SEED + 13)
    new, cache_len = 16, 1600 + 16
    qparams = quantize_params(cfg, params)[0]
    runs = {}
    for impl in ("cuda", "ref"):
        runs[impl], _, launches = dense_generate(
            cfg, qparams, prompts, new, cache_len, dev, kernel_impl=impl)
        fired = launches["bitplane_gemv"] > 0 and launches["bitplane_gemm"] > 0
        check(fired if impl == "cuda" else not any(launches.values()),
              f"dense parity {impl}: launches {launches}")
    check((runs["cuda"] == runs["ref"]).all(),
          "dense parity: pim8 tokens differ between the kernels and the "
          "plain versions")
    del qparams
    dense, _, _ = dense_generate(cfg, params, prompts, new, cache_len, dev)
    eng = ServeEngine(cfg, params, ServeConfig(
        max_cache_len=cache_len, max_new_tokens=new, paged=True,
        block_size=BS, device=str(dev)))
    paged = eng.generate(prompts).cpu().numpy()
    check((dense == paged).all(),
          "dense parity: dense-cache tokens differ from paged-cache tokens")
    say("dense parity", model=f"{cfg.name}[f32,{cfg.n_layers}L]",
        batch=4, prompt_len=1600, new_tokens=new,
        pim8_cuda_eq_ref=True, dense_eq_paged=True)
    del params
    torch.cuda.empty_cache()


#: the gemma3 dense phase: 8 prompts of 1536 tokens (chunked prefill,
#: kv blocks halved to 512; local layers windowed at 1024), 32 new tokens
G3_DENSE_T, G3_DENSE_NEW, G3_DENSE_CACHE = 1536, 32, 1576


def gemma3_dense(cfg, params, dev):
    """`ServeEngine.generate` on the dense cache at 62 layers and
    published width, bf16. Returns its launch counts."""
    torch.cuda.empty_cache()
    prompts = dense_prompts(cfg.vocab_size, 8, G3_DENSE_T, SEED + 14)
    _, stats, launches = dense_generate(
        cfg, params, prompts, G3_DENSE_NEW, G3_DENSE_CACHE, dev)
    check(stats["dense_cache_bytes"] == 6_403_653_632,
          f"gemma3 dense cache bytes {stats['dense_cache_bytes']}")
    say("dense", model=cfg.name, weights="bf16", **stats)
    return launches


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
    """Init at 62 layers and published width, then the bf16-KV and
    int8-KV drains, the telemetry drain, and dense `generate`. Returns
    each path's counts."""
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
    out["dense"] = gemma3_dense(cfg, params, dev)
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
    check(all(launches[k] > 0 for k in DENSE_KERNELS),
          f"gemma3 pim8: not every kernel launched: {launches}")
    check(stats["pools_whole"], "gemma3 pim8: a page is still held")
    say("serve", model=cfg.name, kv_dtype="bf16", weights="pim8",
        packed_fraction=frac, quantize_s=seconds, chunk=1024, **stats)
    del qparams
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 17: the rest of the attention model zoo
# ---------------------------------------------------------------------------

#: the zoo drains: 8 requests of a shared 256-token prompt plus a
#: 256..768-token suffix, 32 new tokens, 8 slots
ZOO_SHARED, ZOO_SUFFIX, ZOO_NEW = 256, (256, 768), 32
ZOO_CACHE_LEN = ZOO_SHARED + ZOO_SUFFIX[1] + ZOO_NEW
#: (arch, layers run at published width — None: all —, KV dtypes); the
#: MoE models are cut in depth to fit one card's 80 GB in bf16, and
#: qwen2.5-14b (48 L) and granite-20b (52 L) to half their depth to keep
#: the script's time as `[dist]` joined it
ZOO_RUNS = (("qwen2.5-14b", 24, ("bf16",)),
            ("granite-20b", 26, ("bf16", "int8")),
            ("phi3.5-moe-42b-a6.6b", 24, ("bf16",)),
            ("llama4-scout-17b-a16e", 8, ("bf16",)))
#: the f32 kernel-vs-plain parity depth of each model
ZOO_PARITY_LAYERS = {"qwen2.5-14b": 4, "granite-20b": 4,
                     "phi3.5-moe-42b-a6.6b": 2, "llama4-scout-17b-a16e": 2}
#: granite-20b's attention: 48 query heads over one KV head (g = 48)
GR_H, GR_KV = 48, 1


class MoeRouting:
    """Reads the MoE layers' routing during a drain, by wrapping
    `models.transformer.moe_forward`: per call its dropped fraction of
    (token, expert) assignments and its load-balance loss (E * sum f p:
    1 for a uniform router, up to E when every token picks the same
    experts), kept on the card until `summary`, split into decode steps
    (one row a slot) and prefill chunks; and on the host each call's
    rows and each expert's places C (the rows of its expert products).

    The wrapper takes effect only because `transformer._ffn` looks
    `moe_forward` up as a module global at each call; the drains check
    that it saw the decode calls. It reads each call through
    `serve.graphs.each_run`, so a decode step replayed from its CUDA
    graphs, which never calls the wrapper, is read all the same."""

    def __init__(self):
        from repro_torch.models import transformer
        self.mod, self.inner = transformer, transformer.moe_forward
        self.calls = {"decode": [], "prefill": []}
        self.shapes = {"decode": [], "prefill": []}

    def __enter__(self):
        from repro_torch.models.moe import MOE_CHUNK, expert_capacity
        from repro_torch.serve.graphs import each_run

        def counted(params, x, **kw):
            y, aux = self.inner(params, x, **kw)
            kind = "decode" if x.shape[1] == 1 else "prefill"
            n = x.shape[0] * x.shape[1]
            cap = expert_capacity(min(kw.get("chunk", MOE_CHUNK), n),
                                  kw["top_k"], params["router"].shape[-1],
                                  kw["capacity_factor"])

            def read():
                self.calls[kind].append(torch.stack(
                    [aux["dropped_fraction"], aux["load_balance_loss"]]))
                self.shapes[kind].append((n, cap))
            each_run(read)
            return y, aux
        self.mod.moe_forward = counted
        return self

    def __exit__(self, *exc):
        self.mod.moe_forward = self.inner

    def summary(self) -> dict:
        out = {}
        for kind, vals in self.calls.items():
            r = torch.stack(vals).float().cpu() if vals else torch.zeros(0, 2)
            out[f"moe_{kind}_calls"] = len(vals)
            out[f"moe_{kind}_calls_with_drops"] = int((r[:, 0] > 0).sum())
            for j, name in enumerate(("dropped", "lb_loss")):
                out[f"moe_{kind}_{name}_mean"] = (float(r[:, j].mean())
                                                  if len(r) else 0.0)
        return out


def zoo_drain(cfg, params, dev, kv_dtype, weights="bf16", reset=True,
              required=("paged_decode", "paged_prefill"), **extra):
    """One zoo drain: 8 requests, 8 slots, prefix index, pow2 buckets,
    32 new tokens. The required kernels must launch, the index must hit,
    every pool must be whole again and no metric may move. Returns the
    counts and the `MoeRouting` readings."""
    prompts = serving_trace(cfg.vocab_size, 8, ZOO_SHARED, *ZOO_SUFFIX,
                            SEED)
    tag = f"{cfg.name}[{cfg.n_layers}L] {kv_dtype} KV {weights}"
    with MoeRouting() as routing:
        results, stats, launches = drain(
            cfg, params, prompts, ZOO_NEW, 8, ZOO_CACHE_LEN, dev,
            reset=reset, prefix=True, bucket_strategy="pow2",
            kernel_impl="auto", kv_dtype=kv_dtype)
    check(stats["requests"] == 8 and all(len(v) == ZOO_NEW
                                         for v in results.values()),
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
    moe = routing.summary() if cfg.n_experts else {}
    check(not cfg.n_experts or moe["moe_decode_calls"] > 0,
          f"{tag}: no MoE layer ran")
    say("zoo", model=cfg.name, kv_dtype=kv_dtype, weights=weights,
        prompt_lens=f"{min(map(len, prompts))}..{max(map(len, prompts))}",
        **extra, **moe, **stats)
    return launches, routing


def zoo_init(arch, layers, dev):
    """`init_lm` of `arch` at its published width, cut to `layers`
    (None: all); prints the parameters, their bytes, the seconds and the
    peak device memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    check(all(getattr(cfg, k) == getattr(full, k) for k in (
        "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
        "n_experts", "top_k", "n_shared_experts")),
          f"{arch}: cut in width")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    say("init", model=cfg.name, layers=cfg.n_layers,
        published_layers=full.n_layers,
        params=sum(x.numel() for x in _leaves(params)),
        param_bytes=sum(x.numel() * x.element_size()
                        for x in _leaves(params)),
        seconds=time.perf_counter() - t0,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return cfg, params


def zoo_full_width(dev, errs) -> dict:
    """The four models' drains at published width (phi3.5-moe at 24 of
    32 layers, llama4-scout at 8 of 48), then phi3.5-moe's --quantize
    path at 8 layers, whose bit-plane checks raise `errs`. Returns each
    path's counts."""
    by_path = {}
    for arch, layers, kv_dtypes in ZOO_RUNS:
        cfg, params = zoo_init(arch, layers, dev)
        for kv_dtype in kv_dtypes:
            by_path[f"{arch}[{cfg.n_layers}L] {kv_dtype} KV"] = zoo_drain(
                cfg, params, dev, kv_dtype)[0]
        del params
        torch.cuda.empty_cache()
    by_path["phi3.5-moe-42b-a6.6b[8L] pim8"] = zoo_quantized(dev, errs)
    return by_path


def zoo_quantized(dev, errs) -> dict:
    """phi3.5-moe's --quantize path at published width and 8 layers (the
    dense and the packed trees must fit together): `ServeEngine.quantize`
    packs the four attention projections and the [8, 16, 4096, 6400] /
    [8, 16, 6400, 4096] expert stacks slice by slice with K5, then the
    drain runs K3 per expert on every step and K4 on the attention
    projections of prefill chunks above 512 rows. The counts are set to
    0 before the quantize and read after the drain. Then K3-K5 are held
    against their plain versions at the shapes this drain gave them and
    K3 is timed at its expert shapes (`zoo_bitplane`)."""
    from repro_torch.quant import PimWeight

    cfg, params = zoo_init("phi3.5-moe-42b-a6.6b", 8, dev)
    reset_launches()
    qparams, frac, seconds = quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    moe = qparams["layers"]["moe"]
    check(all(isinstance(moe[k], PimWeight) for k in
              ("we_gate", "we_up", "we_down"))
          and tuple(moe["we_gate"].planes.shape[:2]) == (8, cfg.n_experts),
          "phi3.5 pim8: the expert stacks were not packed")
    check(moe["router"].dtype == torch.float32,
          "phi3.5 pim8: the router left f32")
    k5 = read_launches()["bitplane_pack"]
    slices = (4 + 3 * cfg.n_experts) * cfg.n_layers
    check(k5 == slices, f"phi3.5 pim8: K5 launches {k5} != {slices}")
    launches, routing = zoo_drain(
        cfg, qparams, dev, "bf16", weights="pim8", reset=False,
        required=DENSE_KERNELS, tree_packed_fraction=frac,
        quantize_s=seconds, k5_slices=slices)
    del qparams
    torch.cuda.empty_cache()
    zoo_bitplane(dev, cfg, routing, launches, errs)
    return launches


def zoo_bitplane(dev, cfg, routing, launches, errs):
    """phi3.5-moe's pim8 drain's bit-plane products, at the rows it gave
    them, 8-bit g = 1, in the tolerances of `bitplane_checks`: the
    expert projections [4096 -> 6400] and [6400 -> 4096] at every
    expert capacity C the drain's MoE calls had (K3), and the attention
    projections [4096 -> 4096] (wq/wo) and [4096 -> 1024] (wk/wv) at a
    decode step's 8 rows and at every prefill step's rows (K3 up to
    512, K4 above). The K3 launches of the drain are split by rows: 3 E
    expert products a MoE call, at that call's C, and the attention
    projections' 4 a layer and step. K3 is then timed at the decode C
    and at the largest prefill C."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kv_width = cfg.n_kv_heads * cfg.hd
    caps = sorted({c for kind in routing.shapes
                   for _, c in routing.shapes[kind]})
    step_rows = sorted({n for n, _ in routing.shapes["prefill"]})
    by_rows = {}
    for kind in ("decode", "prefill"):
        for n, c in routing.shapes[kind]:
            by_rows[c] = by_rows.get(c, 0) + 3 * e
            if n <= 512:
                by_rows[n] = by_rows.get(n, 0) + 4
    check(sum(by_rows.values()) == launches["bitplane_gemv"],
          f"phi3.5 pim8: K3 launches {launches['bitplane_gemv']} != "
          f"{sum(by_rows.values())} counted by rows {by_rows}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rel_err = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                             "matmul_bf16", "matmul_f32"), 0.0)
    for k, m, rows in ((d, f, caps), (f, d, caps),
                       (d, d, [8] + step_rows), (d, kv_width,
                                                 [8] + step_rows)):
        check_bitplane_matrix(dev, gen, 8, 1, k, m, rows, errs, rel_err)
    say("bitplane", model="phi3.5-moe pim8 drain", format="(8,1)",
        expert_rows=",".join(map(str, caps)),
        attention_rows=",".join(map(str, [8] + step_rows)),
        pack="byte-identical", gemv_rel_err=rel_err["bitplane_gemv"],
        gemm_rel_err=rel_err["bitplane_gemm"],
        matmul_rel_err_bf16=rel_err["matmul_bf16"],
        matmul_rel_err_f32=rel_err["matmul_f32"],
        k3_launches_by_rows=json.dumps(dict(sorted(by_rows.items())))
        .replace(" ", ""))
    dec_c = max(c for _, c in routing.shapes["decode"])
    pre_c = max(c for _, c in routing.shapes["prefill"])
    for rows in (pre_c, dec_c):
        bitplane_row(dev, gen, "bitplane_gemv", rows, d, f,
                     model=f"phi3.5-moe expert C={rows}")


def zoo_parity(dev):
    """Each model in f32 at published width and 2-4 layers: a drain's
    greedy tokens with the CUDA kernels equal those with the plain
    versions on the card; phi3.5-moe also with 8-bit g = 1 bit-plane
    weights (K3 per expert). The dense models also hold chunked prefill
    (64) equal to single-shot; the MoE models do not, in the reference
    either: a chunk's rows compete for the experts' places, so another
    chunking routes (and drops) differently."""
    import dataclasses
    from repro_torch.configs import get_config

    runs = [(arch, layers, False)
            for arch, layers in ZOO_PARITY_LAYERS.items()]
    runs.append(("phi3.5-moe-42b-a6.6b",
                 ZOO_PARITY_LAYERS["phi3.5-moe-42b-a6.6b"], True))
    for arch, layers, quantize in runs:
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=layers)
        prompts = serving_trace(cfg.vocab_size, 6, 128, 16, 256, SEED + 2)
        token_parity(dev, cfg, prompts, 16, 128 + 256 + 16,
                     None if cfg.n_experts else 64, quantize=quantize)
        torch.cuda.empty_cache()


def zoo_kernel_checks(dev, h=GR_H, kv=GR_KV, model="granite-20b"):
    """K1 at granite's q [8, 48, 128] (and llava's [8, 56, 128]) is in
    `kernel_checks`; here K2 at the model's [1, 512, h, 128] (granite's
    48 heads over 1 KV head by default) from start 256 (a 512-token
    chunk after a 256-token prefix), full and 256-token window, bf16,
    f32 and int8 pools, against the plain version on every row (all
    valid)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill import paged_prefill_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    mb, st_, t = 68, 256, 512
    n_blocks = mb + 1
    table = torch.tensor(rng.permutation(np.arange(1, n_blocks))[None],
                         dtype=torch.int32, device=dev)
    start = torch.tensor([st_], dtype=torch.int32, device=dev)
    total = torch.tensor([st_ + t], dtype=torch.int32, device=dev)
    err = 0.0
    for kind in ("bf16", "f32", "int8"):
        kp, vp, ks, vs, qdt = make_pools(gen, n_blocks, kind, dev, kv=kv)
        q = torch.randn((1, t, h, HD), generator=gen, device=dev).to(qdt)
        for window in (mb * BS, 256):
            out = paged_prefill_attention(q, kp, vp, table, start, total,
                                          window, k_scales=ks, v_scales=vs)
            plain = ref.paged_prefill_ref(q, kp, vp, table, start, total,
                                          window, k_scales=ks, v_scales=vs)
            torch.cuda.synchronize()
            e = float((out - plain).abs().max())
            check(torch.isfinite(out).all() and e <= 1e-4,
                  f"prefill {model} {kind} w={window}: err {e}")
            err = max(err, e)
    say("kernels", model=model, heads=f"{h}/{kv}",
        q=f"[1,{t},{h},{HD}]", start=st_, pools="bf16,f32,int8",
        prefill_err=err)
    return err


def zoo_kernel_timings(dev, h=GR_H, kv=GR_KV, model="granite"):
    """K1 at the model's q [8, h, 128] (granite's 48 heads over 1 KV head
    by default) over the 8 decode slots of `kernel_timings` (bf16), K2
    at its [1, 512, h, 128] from start 256, each beside SDPA over the
    same keys expanded to h heads. Returns the rows, keyed "paged_decode
    g{h // kv}" and "paged_prefill g{h // kv}".
    K3 at phi3.5-moe's expert shapes is timed after its drain, at the
    rows the drain gave it (`zoo_bitplane`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    F = torch.nn.functional

    g = h // kv
    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    mb, b = 68, 8
    capacity = mb * BS
    n_blocks = 1 + b * mb
    kp, vp, _, _, dt = make_pools(gen, n_blocks, "bf16", dev, kv=kv)
    table = torch.tensor(
        rng.permutation(np.arange(1, n_blocks))[: b * mb].reshape(b, mb),
        dtype=torch.int32, device=dev)
    item = kp.element_size()
    lens_host = [340, 420, 560, 700, 810, 930, 1010, 1088]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, HD), generator=gen, device=dev).to(dt)
    k_all, v_all = sdpa_inputs(kp, vp, table, mb, h=h)
    mask = (torch.arange(capacity, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    kv_pos = sum(lens_host)
    nbytes = (2 * kv_pos * kv * HD * item + q.numel() * item
              + b * h * HD * 4 + table.numel() * 4 + b * 4)
    out = {}
    r = dict(
        **time_kernel(
            lambda: paged_decode_attention(q, kp, vp, table, lengths,
                                           capacity),
            lambda: ref.paged_attention_ref(q, kp, vp, table, lengths,
                                            capacity),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k_all, v_all, attn_mask=mask)),
        **bound(nbytes, 4 * HD * h * kv_pos, dt),
        shape=f"{model} q[{b},{h},{HD}] kv {kv} lens {lens_host}")
    say_timing("paged_decode", r)
    out[f"paged_decode g{g}"] = r
    del k_all, v_all

    st_, t = 256, 512
    tot = st_ + t
    q1 = torch.randn((1, t, h, HD), generator=gen, device=dev).to(dt)
    start = torch.tensor([st_], dtype=torch.int32, device=dev)
    total = torch.tensor([tot], dtype=torch.int32, device=dev)
    bt1 = table[:1].contiguous()
    k1, v1 = sdpa_inputs(kp, vp, bt1, tot // BS, h=h)
    qpos = st_ + torch.arange(t, device=dev)
    pmask = (torch.arange(tot, device=dev)[None, :]
             <= qpos[:, None])[None, None]
    pairs = sum(st_ + i + 1 for i in range(t))
    nbytes = (2 * tot * kv * HD * item + q1.numel() * item
              + q1.numel() * 4 + bt1.numel() * 4 + 8)
    r = dict(
        **time_kernel(
            lambda: paged_prefill_attention(q1, kp, vp, bt1, start, total,
                                            capacity),
            lambda: ref.paged_prefill_ref(q1, kp, vp, bt1, start, total,
                                          capacity),
            lambda: F.scaled_dot_product_attention(
                q1.transpose(1, 2), k1, v1, attn_mask=pmask)),
        **bound(nbytes, 4 * HD * h * pairs, dt),
        shape=f"{model} q[1,{t},{h},{HD}] kv {kv} start {st_} "
              f"total {tot}")
    say_timing("paged_prefill", r)
    out[f"paged_prefill g{g}"] = r
    del k1, v1
    return out


# ---------------------------------------------------------------------------
# phase 18: the rest of the model zoo — recurrent, encoder-decoder, vision
# ---------------------------------------------------------------------------

#: llava-next-34b's attention: 56 query heads over 8 KV heads (g = 7)
LL_H, LL_KV = 56, 8
#: llava's depth at published width: all 60 layers (68.8 GB in bf16)
LL_LAYERS = None
#: the f32 kernel-vs-plain parity depths: zamba2 and xlstm at 6 layers,
#: one whole group each (a shared-block site; an sLSTM layer), llava at
#: 4, whisper at 2 encoder + 2 decoder layers
FAM_PARITY_LAYERS = {"zamba2-1.2b": 6, "xlstm-350m": 6,
                     "llava-next-34b": 4, "whisper-medium": 2}
#: the dense runs of the recurrent stacks: (prompts, prompt length, new
#: tokens) of `generate`, then (requests, prompt length, slots, new
#: tokens) of the dense batcher. xlstm's prompts are short: its prefill
#: is a Python loop over time, ~12 torch ops a token and layer
FAM_DENSE = {"zamba2-1.2b": ((8, 1024, 64), (16, 512, 8, 32)),
             "xlstm-350m": ((8, 256, 64), (16, 128, 8, 32))}
#: whisper: 1500 stub frames (its 30 s window), a 4-token decoder
#: prompt, 8 rows, 64 new tokens, a 448-row decoder cache (its limit)
WH_FRAMES, WH_PROMPT, WH_BATCH, WH_NEW, WH_CACHE = 1500, 4, 8, 64, 448
#: llava's dense run: 2 rows of the 2880 stub patch positions and 64 text
#: tokens, 32 new
LL_BATCH, LL_TEXT, LL_NEW = 2, 64, 32


class BitplaneShapes:
    """Reads the bit-plane products of a path by wrapping
    `kernels.ops.bitplane_kernel`, which `ops.bitplane_matmul` looks up
    as a module global at each call: `rows[(kernel, K, M)]` lists the
    row count of each launch."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.inner = ops, ops.bitplane_kernel
        self.rows = {}

    def __enter__(self):
        def pick(b):
            fn = self.inner(b)

            def counted(x_r, planes, *, n_bits, group):
                key = (fn.__name__, x_r.shape[2] * 8 // group,
                       planes.shape[2])
                self.rows.setdefault(key, []).append(b)
                return fn(x_r, planes, n_bits=n_bits, group=group)
            return counted
        self.ops.bitplane_kernel = pick
        return self

    def __exit__(self, *exc):
        self.ops.bitplane_kernel = self.inner

    def launches(self, name, m=None) -> int:
        return sum(len(r) for (n, _, mm), r in self.rows.items()
                   if n == name and m in (None, mm))


def family_bitplane(dev, model, shapes, errs):
    """K5, K3 and K4 against their plain versions at every [K -> M] the
    model's pim8 path ran, at the row counts it gave them (K3 up to 512
    rows, K4 above), 8-bit g = 1, in the bars of `bitplane_checks`; the
    worst errors raise `errs`."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rel_err = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                             "matmul_bf16", "matmul_f32"), 0.0)
    by_km = {}
    for (_, k, m), rows in shapes.rows.items():
        by_km.setdefault((k, m), set()).update(rows)
    for (k, m), rows in sorted(by_km.items()):
        check_bitplane_matrix(dev, gen, 8, 1, k, m, sorted(rows), errs,
                              rel_err)
    say("bitplane", model=f"{model} pim8", format="(8,1)",
        shapes=";".join(f"{k}->{m}@{','.join(map(str, sorted(r)))}"
                        for (k, m), r in sorted(by_km.items())),
        pack="byte-identical", gemv_rel_err=rel_err["bitplane_gemv"],
        gemm_rel_err=rel_err["bitplane_gemm"],
        matmul_rel_err_bf16=rel_err["matmul_bf16"],
        matmul_rel_err_f32=rel_err["matmul_f32"])


def quantize_counted(cfg, params, quantize):
    """`quantize(params)` with the counts set to 0 just before: every
    projection slice packed by K5 on the card, one launch each. Returns
    the tree, its packed fraction, the seconds and the K5 launches."""
    from repro_torch.quant import PimWeight, tree_packed_fraction

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k5 = read_launches()["bitplane_pack"]
    slices = sum(w.n_stack for w in _leaves(qparams)
                 if isinstance(w, PimWeight))
    check(k5 == slices, f"{cfg.name} pim8: K5 launches {k5} != {slices} "
                        "projection slices")
    return qparams, tree_packed_fraction(qparams), seconds, k5


def count_ops(fn) -> int:
    """The aten ops one call of `fn` dispatches, counted under a
    `TorchDispatchMode` (each view, copy and kernel call one op; the
    bit-plane kernels' ctypes launches are not torch ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def host_cost(cfg, params, dev, t=16, b=8):
    """The host's cost of the stack's Python loops, in bf16 at `b` rows:
    `prefill` of t and of 2t tokens and one `decode_step` after it, each
    timed alone (host clock to a sync, after a warm call) and then
    counted (`count_ops`). The prefill difference gives the ops and
    seconds a prompt token; the ratio of wall to ops, the host's time
    per dispatched op."""
    from repro_torch.models import decode_step, prefill

    toks = torch.tensor(dense_prompts(cfg.vocab_size, b, 2 * t, SEED + 23),
                        device=dev)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {}
    for n in (t, 2 * t):
        def pre(n=n):
            return prefill(params, toks[:, :n], cfg, 2 * t + 2)
        runs[n] = (count_ops(pre), wall(pre))
    cache = prefill(params, toks, cfg, 2 * t + 2)[1]

    def step():
        return decode_step(params, toks[:, :1], cache, cfg)
    d_ops, d_wall = count_ops(step), wall(step)
    p_ops = (runs[2 * t][0] - runs[t][0]) / t
    p_wall = (runs[2 * t][1] - runs[t][1]) / t
    say("families", model=cfg.name, path="host ops", batch=b,
        prefill_tokens=f"{t},{2 * t}",
        prefill_ops=f"{runs[t][0]},{runs[2 * t][0]}",
        prefill_s=f"{runs[t][1]},{runs[2 * t][1]}",
        ops_per_prompt_token=p_ops,
        ops_per_prompt_token_and_layer=p_ops / cfg.n_layers,
        s_per_prompt_token=p_wall,
        prefill_us_per_op=(p_wall / p_ops * 1e6 if p_ops > 0 else None),
        decode_ops=d_ops, decode_s=d_wall,
        decode_us_per_op=d_wall / d_ops * 1e6)


def recurrent_family(dev, arch, errs) -> dict:
    """zamba2-1.2b or xlstm-350m at published width and depth: dense
    `generate` in bf16, the dense batcher (exact ticks and global
    position), then the --quantize path (`ServeEngine.quantize`, K5 per
    slice) and the same `generate` with 8-bit g = 1 weights, which must
    launch K3 (decode) and K4 (prefill) — for xlstm K3 also at its
    [1024 -> 4] gates. K3-K5 are then held against their plain
    versions at the shapes and rows that run gave them. Returns each
    path's counts."""
    (b, t, new), (nreq, bt, slots, bnew) = FAM_DENSE[arch]
    cfg, params = zoo_init(arch, None, dev)
    prompts = dense_prompts(cfg.vocab_size, b, t, SEED + 20)
    tokens, stats, launches = dense_generate(cfg, params, prompts, new,
                                             t + new, dev)
    say("families", model=cfg.name, path="dense generate", weights="bf16",
        **stats)
    out = {f"{arch} dense bf16": launches}
    host_cost(cfg, params, dev)
    out[f"{arch} dense batcher"] = dense_batcher(
        cfg, params, dev, nreq, bt, slots, bnew, bt + bnew, SEED + 22,
        phase="families")
    qparams, frac, seconds, k5 = quantize_counted(
        cfg, params, lambda p: quantize_params(cfg, p)[0])
    del params
    torch.cuda.empty_cache()
    with BitplaneShapes() as shapes:
        qtokens, qstats, qlaunches = dense_generate(cfg, qparams, prompts,
                                                    new, t + new, dev)
    qlaunches["bitplane_pack"] = k5
    check(all(qlaunches[k] > 0 for k in DENSE_KERNELS
              if k.startswith("bitplane")),
          f"{arch} pim8: K3/K4/K5 not all launched: {qlaunches}")
    gates = shapes.launches("bitplane_gemv", m=cfg.n_heads)
    check(arch != "xlstm-350m" or gates > 0,
          f"{arch} pim8: K3 never ran the [{cfg.d_model} -> {cfg.n_heads}] "
          "gates")
    say("families", model=cfg.name, path="dense generate", weights="pim8",
        packed_fraction=frac, quantize_s=seconds, k5_slices=k5,
        k3_launches_at_m_heads=gates,
        agreement_with_bf16=float((qtokens == tokens).mean()),
        first_token_agreement=float((qtokens[:, 0] == tokens[:, 0]).mean()),
        **{k: v for k, v in qstats.items() if not k.startswith("launches")},
        **{f"launches_{k}": v for k, v in qlaunches.items() if v})
    out[f"{arch} dense pim8"] = qlaunches
    del qparams
    torch.cuda.empty_cache()
    family_bitplane(dev, cfg.name, shapes, errs)
    return out


def encdec_generate(cfg, params, frames, prompt, new_tokens, cache_len,
                    dev, impl="auto"):
    """whisper's serving path: `prefill_encdec` over the stub frames and
    the decoder prompt, then greedy `decode_step_encdec`s, the counts
    set to 0 just before and read just after. Returns the tokens on the
    host, the run's stats (the wall split at a CUDA event recorded when
    the prefill returns) and the counts."""
    from repro_torch.models import (decode_step_encdec, init_encdec_cache,
                                    prefill_encdec)

    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    logits, cache = prefill_encdec(params, frames, prompt, cfg, cache_len,
                                   impl=impl)
    events[1].record()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(new_tokens - 1):
        logits, cache = decode_step_encdec(params, tok, cache, cfg,
                                           impl=impl)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    events[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tokens = torch.cat(out, dim=1).cpu().numpy()
    b, s = frames.shape[:2]
    check(tokens.shape == (b, new_tokens)
          and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          f"{cfg.name}: tokens {tokens.shape} outside [0, vocab)")
    check(cache["position"] == prompt.shape[1] + new_tokens - 1,
          f"{cfg.name}: decoder position {cache['position']}")
    meta = init_encdec_cache(cfg, b, cache_len, s, "meta")
    stats = dict(layers=f"{cfg.n_encoder_layers}+{cfg.n_layers}", batch=b,
                 enc_frames=s, prompt_len=prompt.shape[1],
                 new_tokens=new_tokens, wall_s=wall,
                 tokens_per_s=tokens.size / wall,
                 prefill_s=events[0].elapsed_time(events[1]) / 1e3,
                 decode_s=events[1].elapsed_time(events[2]) / 1e3,
                 cache_bytes=sum(v.numel() * v.element_size()
                                 for k, v in meta.items()
                                 if k != "position"),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 **{f"launches_{k}": v for k, v in launches.items() if v})
    return tokens, stats, launches


def whisper_inputs(cfg, dev, b, frames, seed):
    from repro_torch.models.frontend_stub import make_stub_embeddings
    emb = make_stub_embeddings(cfg, b, frames, seed=seed, device=dev)
    prompt = torch.tensor(dense_prompts(cfg.vocab_size, b, WH_PROMPT, seed),
                          device=dev)
    return emb, prompt


def whisper_family(dev, errs) -> dict:
    """whisper-medium's encoder-decoder at published width and depth (24
    + 24 layers): `prefill_encdec` over 1500 stub frames and a 4-token
    prompt, 8 rows, then 63 greedy decode steps; then the same run with
    8-bit g = 1 bit-plane weights (`quantize_tree`, K5 per slice): K4 on
    the encoder's 12,000 rows, K3 on decode. Returns each path's
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_encdec
    from repro_torch.quant import PimQuantConfig, quantize_tree

    cfg = get_config("whisper-medium")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_encdec(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    say("init", model=cfg.name,
        layers=f"{cfg.n_encoder_layers}+{cfg.n_layers}",
        params=sum(x.numel() for x in _leaves(params)),
        param_bytes=sum(x.numel() * x.element_size()
                        for x in _leaves(params)),
        seconds=time.perf_counter() - t0,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    frames, prompt = whisper_inputs(cfg, dev, WH_BATCH, WH_FRAMES, SEED + 23)
    tokens, stats, launches = encdec_generate(
        cfg, params, frames, prompt, WH_NEW, WH_CACHE, dev)
    say("families", model=cfg.name, path="encdec", weights="bf16", **stats)
    out = {"whisper-medium encdec bf16": launches}
    qparams, frac, seconds, k5 = quantize_counted(
        cfg, params, lambda p: quantize_tree(
            p, PimQuantConfig(n_bits=8, group=1, min_features=1)))
    del params
    torch.cuda.empty_cache()
    with BitplaneShapes() as shapes:
        qtokens, qstats, qlaunches = encdec_generate(
            cfg, qparams, frames, prompt, WH_NEW, WH_CACHE, dev)
    qlaunches["bitplane_pack"] = k5
    enc_rows = WH_BATCH * WH_FRAMES
    check(any(n == "bitplane_gemm" and enc_rows in r
              for (n, _, _), r in shapes.rows.items())
          and qlaunches["bitplane_gemv"] > 0,
          f"whisper pim8: K4 at {enc_rows} rows / K3 not launched: "
          f"{qlaunches}")
    say("families", model=cfg.name, path="encdec", weights="pim8",
        packed_fraction=frac, quantize_s=seconds, k5_slices=k5,
        agreement_with_bf16=float((qtokens == tokens).mean()),
        first_token_agreement=float((qtokens[:, 0] == tokens[:, 0]).mean()),
        **{k: v for k, v in qstats.items() if not k.startswith("launches")},
        **{f"launches_{k}": v for k, v in qlaunches.items() if v})
    out["whisper-medium encdec pim8"] = qlaunches
    del qparams
    torch.cuda.empty_cache()
    family_bitplane(dev, cfg.name, shapes, errs)
    return out


def llava_family(dev) -> dict:
    """llava-next-34b at published width, all 60 layers (68.8 GB of bf16
    weights): `prefill` of the 2880 stub patch positions and 64 text
    tokens for 2 rows, then 31 greedy `decode_step`s on the dense cache;
    then the paged drain the launcher runs (text only: the reference's
    `prefill_paged` has no `extra_embeds`), K1 and K2 at g = 7. Returns
    each path's counts."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.frontend_stub import make_stub_embeddings

    cfg, params = zoo_init("llava-next-34b", LL_LAYERS, dev)
    check(cfg.n_heads // cfg.n_kv_heads == LL_H // LL_KV, "llava: g != 7")
    emb = make_stub_embeddings(cfg, LL_BATCH, cfg.frontend_tokens,
                               seed=SEED + 24, device=dev)
    text = torch.tensor(dense_prompts(cfg.vocab_size, LL_BATCH, LL_TEXT,
                                      SEED + 24), device=dev)
    t = cfg.frontend_tokens + LL_TEXT
    cache_len = t + LL_NEW
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    logits, cache = prefill(params, text, cfg, cache_len, extra_embeds=emb)
    events[1].record()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    toks = [tok]
    for _ in range(LL_NEW - 1):
        logits, cache = decode_step(params, tok, cache, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        toks.append(tok)
    events[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tokens = torch.cat(toks, dim=1).cpu().numpy()
    check(cache["position"] == t + LL_NEW - 1
          and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          f"llava dense: position {cache['position']}, tokens {tokens}")
    del cache
    say("families", model=cfg.name, path="dense prefill+decode",
        weights="bf16", layers=cfg.n_layers, batch=LL_BATCH,
        stub_positions=cfg.frontend_tokens, text_tokens=LL_TEXT,
        new_tokens=LL_NEW, wall_s=wall, tokens_per_s=tokens.size / wall,
        prefill_s=events[0].elapsed_time(events[1]) / 1e3,
        decode_s=events[1].elapsed_time(events[2]) / 1e3,
        dense_cache_bytes=dense_cache_bytes(cfg, LL_BATCH, cache_len),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        **{f"launches_{k}": v for k, v in launches.items() if v})
    out = {"llava-next-34b dense bf16": launches}
    torch.cuda.empty_cache()
    out[f"llava-next-34b[{cfg.n_layers}L] bf16 KV"] = zoo_drain(
        cfg, params, dev, "bf16")[0]
    del params
    torch.cuda.empty_cache()
    return out


def teacher_forcing_err(cfg, params, dev) -> float:
    """The reference's property (tests/test_models.py), at its tolerance
    (rtol = atol = 3e-2): prefill half of 64 tokens, feed the rest one
    by one; every step's logits equal `forward`'s at that position.
    Returns the largest difference."""
    from repro_torch.models import decode_step, forward, prefill

    toks = torch.tensor(dense_prompts(cfg.vocab_size, 2, 64, SEED + 25),
                        device=dev)
    full = forward(params, toks, cfg)[0]
    lp, cache = prefill(params, toks[:, :32], cfg, 66)
    steps = [(lp[:, -1], full[:, 31])]
    for i in range(32, 64):
        ld, cache = decode_step(params, toks[:, i: i + 1], cache, cfg)
        steps.append((ld[:, 0], full[:, i]))
    for got, want in steps:
        check(torch.allclose(got, want, rtol=3e-2, atol=3e-2),
              f"{cfg.name}: teacher-forced decode differs from forward")
    return max(float((got - want).abs().max()) for got, want in steps)


def family_parity(dev):
    """f32 at published width and 2-6 layers (FAM_PARITY_LAYERS): zamba2
    and xlstm hold the teacher-forcing property, and their dense
    `generate` with 8-bit g = 1 weights gives the same greedy tokens
    with the kernels (K3 decode, K4 prefill) as with the plain versions;
    whisper's encoder-decoder the same with its pim8 weights; llava's
    paged drain with K1/K2 the same as with the plain versions, and
    64-token chunks the same as single-shot."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_encdec, init_lm
    from repro_torch.quant import PimQuantConfig, quantize_tree

    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=FAM_PARITY_LAYERS[arch])
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(
            SEED + 2), dev)
        tf_err = teacher_forcing_err(cfg, params, dev)
        qparams = quantize_params(cfg, params)[0]
        del params
        # 4 x t prefill rows above 512, so K4 runs prefill, K3 decode
        t = 300 if arch == "zamba2-1.2b" else 160
        prompts = dense_prompts(cfg.vocab_size, 4, t, SEED + 26)
        runs = {}
        for impl in ("cuda", "ref"):
            runs[impl], _, launches = dense_generate(
                cfg, qparams, prompts, 16, t + 16, dev, kernel_impl=impl)
            fired = (launches["bitplane_gemv"] > 0
                     and launches["bitplane_gemm"] > 0)
            check(fired if impl == "cuda" else not any(launches.values()),
                  f"{arch} parity {impl}: launches {launches}")
        check((runs["cuda"] == runs["ref"]).all(),
              f"{arch}: pim8 tokens differ between the kernels and the "
              "plain versions")
        say("parity", model=f"{cfg.name}[f32,{cfg.n_layers}L]",
            weights="pim8", batch=4, prompt_len=t, new_tokens=16,
            kernel_eq_plain=True, teacher_forcing_max_err=tf_err)
        del qparams
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("whisper-medium"), dtype="float32",
                              n_layers=2, n_encoder_layers=2)
    params = init_encdec(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 2), dev)
    qparams = quantize_tree(params, PimQuantConfig(8, 1, min_features=1))
    del params
    frames, prompt = whisper_inputs(cfg, dev, 4, WH_FRAMES, SEED + 27)
    runs = {}
    for impl in ("cuda", "ref"):
        runs[impl], _, launches = encdec_generate(
            cfg, qparams, frames, prompt, 16, 64, dev, impl=impl)
        fired = (launches["bitplane_gemv"] > 0
                 and launches["bitplane_gemm"] > 0)
        check(fired if impl == "cuda" else not any(launches.values()),
              f"whisper parity {impl}: launches {launches}")
    check((runs["cuda"] == runs["ref"]).all(),
          "whisper: pim8 tokens differ between the kernels and the plain "
          "versions")
    say("parity", model=f"{cfg.name}[f32,2+2L]", weights="pim8", batch=4,
        enc_frames=WH_FRAMES, new_tokens=16, kernel_eq_plain=True)
    del qparams
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("llava-next-34b"), dtype="float32",
                              n_layers=FAM_PARITY_LAYERS["llava-next-34b"])
    prompts = serving_trace(cfg.vocab_size, 6, 128, 16, 256, SEED + 2)
    token_parity(dev, cfg, prompts, 16, 128 + 256 + 16, 64)
    torch.cuda.empty_cache()


def family_kernel_timings(dev):
    """K1 and K2 at llava's g = 7 (q [8, 56, 128] and [1, 512, 56, 128],
    KV 8) beside SDPA; K3 at zamba2's `w_in` [8, 2048] -> 8352 and
    xlstm's gates [8, 1024] -> 4 beside the dense GEMV. Returns the
    rows."""
    out = zoo_kernel_timings(dev, LL_H, LL_KV, "llava")
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    out["bitplane_gemv zamba2 w_in"] = bitplane_row(
        dev, gen, "bitplane_gemv", 8, 2048, 8352, model="zamba2-1.2b w_in")
    out["bitplane_gemv xlstm gates"] = bitplane_row(
        dev, gen, "bitplane_gemv", 8, 1024, 4, model="xlstm-350m wi/wf")
    return out


def families(dev, errs, laps) -> dict:
    """The `[families]` phase: the four families' runs, then their
    parity, each timed by `laps`. Returns each path's counts."""
    by_path = {}
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        by_path.update(recurrent_family(dev, arch, errs))
        laps.lap(arch)
    by_path.update(whisper_family(dev, errs))
    laps.lap("whisper-medium")
    by_path.update(llava_family(dev))
    laps.lap("llava-next-34b")
    family_parity(dev)
    laps.lap("families parity")
    return by_path


# ---------------------------------------------------------------------------
# phase 16: the IMAGine simulator at the full U55 array
# ---------------------------------------------------------------------------

#: (M = D, cycles, instructions) of the U55 GEMVs: the reference's numpy
#: simulator's counts at the same array
U55_GEMVS = ((1024, 10249, 144), (2048, 29187, 306))
U55_RF_BYTES = 126 * 32 * 16 * 1024

#: the reference's rows (benchmarks/paper_tables.py) the card must give
PAPER_ROWS = {
    "fig7sim/gemv_8x32": "cycles=1062;analytic=1062;exact=True",
    "fig7sim/gemv_16x64": "cycles=2116;analytic=2116;exact=True",
    "fig7sim/gemv_4x128": "cycles=832;analytic=832;exact=True",
    "table9/IMAGine":
        "a=1.16;b=1.00;c=147.0;add=Standard;move=Standard;gold=True",
    "table9/CCB-CoMeFa": "a=0.03;b=0.00;c=203.0;add=Fast;move=Fast;gold=True",
    "table8/IMAGine": "clock=100.0%;bram=100.0%;bandwidth=100.0%;gold=True",
    "table8/RIMA-Large": "clock=27.8%;bram=93.0%;bandwidth=25.9%;gold=False",
}


def imagine(dev):
    """The bit-exact IMAGine engine on the card at the paper's U55 array,
    then the paper-table rows. Counts of K1-K5 are set to 0 before and
    read after: the simulator runs plain torch ops only."""
    from repro_torch.configs import imagine_u55
    from repro_torch.core import pim_array
    from repro_torch.core.gemv_engine import ImagineGemv
    from repro_torch.launch import paper_tables

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rng = np.random.default_rng(SEED)
    eng = ImagineGemv(imagine_u55.config(), dev)
    rf = eng.array.rf
    check(rf.device.type == "cuda" and rf.dtype == torch.uint8
          and rf.numel() == U55_RF_BYTES,
          f"imagine: register file {rf.dtype} {tuple(rf.shape)} on {rf.device}")
    steps = [0]
    ripple = pim_array._ripple

    def counted(out, a, b, carry):
        steps[0] += a.shape[0]
        ripple(out, a, b, carry)

    pim_array._ripple = counted
    try:
        for m, want_cycles, want_instrs in U55_GEMVS:
            w = rng.integers(-128, 128, size=(m, m))
            x = rng.integers(-128, 128, size=(m,))
            want = w @ x
            plan = eng.plan(m, m)
            steps[0], instrs = 0, eng.array.instr_count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, cycles = eng.run_gemv(w, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            instrs = eng.array.instr_count - instrs
            y = y.cpu().numpy()
            check(y.dtype == np.int64 and y.shape == (m,)
                  and np.array_equal(y, want),
                  f"imagine {m}x{m}: y != W @ x "
                  f"({int((y != want).sum())} of {m} differ)")
            check(cycles == eng.analytic_cycles(m, m) == want_cycles,
                  f"imagine {m}x{m}: {cycles} cycles, analytic "
                  f"{eng.analytic_cycles(m, m)}, reference {want_cycles}")
            check(instrs == want_instrs,
                  f"imagine {m}x{m}: {instrs} instructions != {want_instrs}")
            say("imagine", gemv=f"{m}x{m}", bits=8, passes=plan.passes,
                e=plan.e, cycles=cycles, instructions=instrs, exact=True,
                full_adder_steps_per_pass=steps[0] // plan.passes,
                wall_s=wall, lanes=eng.cfg.geometry.n_pe, rf_bytes=rf.numel(),
                peak_bytes=torch.cuda.max_memory_allocated())
    finally:
        pim_array._ripple = ripple
    launches = read_launches()
    check(not any(launches.values()),
          f"imagine: the simulator launched a kernel: {launches}")
    del eng
    t0 = time.perf_counter()
    rows = (paper_tables.fig7_simulator_validation(dev)
            + paper_tables.table9_curvefit() + paper_tables.table8_systems())
    derived = {name: d for name, _, d in rows}
    for name, want in PAPER_ROWS.items():
        check(derived.get(name) == want,
              f"imagine: {name} gave {derived.get(name)!r}, want {want!r}")
    say("imagine", paper_rows=len(PAPER_ROWS), held=True,
        fig7sim_us=",".join(f"{us:.0f}" for name, us, _ in rows
                            if name.startswith("fig7sim/")),
        seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: training
# ---------------------------------------------------------------------------

#: (a) the full-width step: qwen2-1.5b at published width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
TRAIN_PEAK_LIMIT = 60e9
#: (b) one f32 step on the card and on the CPU from the same params:
#: qwen2-1.5b at published width cut to 2 layers, batch 2 x 64
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 64
TRAIN_PARITY_LR = 1e-3
#: m and v within this share of their largest |value| on the CPU; params
#: within this share of the lr (the first AdamW update is ~lr * sign(g),
#: so an element moves by at most a part of the lr where the two
#: devices' gradients differ in their last bits)
TRAIN_STATE_RTOL, TRAIN_PARAM_LR_SHARE = 1e-4, 0.1
#: (c) the example model (examples/train_lm_torch.py at its defaults)
EXAMPLE_STEPS, EXAMPLE_SEQ, EXAMPLE_BATCH = 300, 128, 8
RESUME_STEPS = 40


def train_batch(cfg, step, batch, seq, dev):
    from repro_torch.data import DataConfig, batch_at
    tokens, targets = batch_at(DataConfig(cfg.vocab_size, seq, batch,
                                          seed=SEED), step)
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "targets": torch.from_numpy(targets).to(dev)}


def train_step_flop(cfg, batch, seq) -> float:
    """Matmul FLOP of one `make_train_step` with remat: the layers' weight
    products 2 (forward) + 2 (recompute) + 4 (backward) per parameter
    and token, the head's 6, and the dense attention's QK^T and PV
    (the full [T, T] square: the einsum computes masked scores too) 4 x
    B T^2 H hd per layer forward, x 4 with recompute and backward."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    layer = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * f
    tokens = batch * seq
    attn = 4 * batch * seq * seq * cfg.n_heads * hd
    return (8 * layer * tokens + 4 * attn) * cfg.n_layers \
        + 6 * d * cfg.vocab_size * tokens


def train_full_width(dev):
    """(a) `make_train_step` on qwen2-1.5b at published width and depth,
    remat on, f32 masters, bf16 compute, batch 8 x 512, 6 steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    cfg = get_config("qwen2-1.5b")
    check(cfg.remat and cfg.dtype == "bfloat16", "qwen2-1.5b: remat, bf16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                     param_dtype=torch.float32)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(x.dtype == torch.float32 for x in _leaves(params)),
          "f32 masters")
    step = make_train_step(cfg, AdamWConfig(), warmup_steps=2,
                           total_steps=TRAIN_STEPS)
    times, rows = [], []
    for s in range(TRAIN_STEPS):
        batch = train_batch(cfg, s, TRAIN_BATCH, TRAIN_SEQ, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                              "accuracy")})
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all())
                 for tree in (params, opt.m, opt.v) for x in _leaves(tree))
    step_s = statistics.median(times[1:])
    flop = train_step_flop(cfg, TRAIN_BATCH, TRAIN_SEQ)
    say("train", run="full width", model=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, params=count_params(params),
        remat=cfg.remat, masters="f32", compute=cfg.dtype,
        batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", steps=TRAIN_STEPS, init_s=init_s,
        step_s=step_s, first_step_s=times[0],
        step_s_all=",".join(f"{t:.4f}" for t in times),
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
        matmul_flop_per_step=flop, matmul_tflop_per_s=flop / step_s / 1e12,
        max_memory_allocated=peak, allocated_before=base,
        loss=",".join(f"{r['loss']:.5f}" for r in rows),
        grad_norm=",".join(f"{r['grad_norm']:.5f}" for r in rows),
        lr=",".join(f"{r['lr']:.3g}" for r in rows))
    check(finite and all(math.isfinite(v) for r in rows for v in r.values()),
          "full-width training step gave a non-finite value")
    check(peak < TRAIN_PEAK_LIMIT,
          f"full-width training peaked at {peak} B (limit {TRAIN_PEAK_LIMIT})")
    check(int(opt.step) == TRAIN_STEPS, "optimizer step count")
    del params, opt, m
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev):
    """(b) one f32 step of qwen2-1.5b at published width, 2 layers,
    batch 2 x 64, on the card (TF32 off) and on the CPU from the same
    params: params, m and v held within the pinned tolerances."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_items, tree_map
    from repro_torch.train import make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              n_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    cpu = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu",
                  param_dtype=torch.float32)
    card = tree_map(lambda x: x.to(dev, copy=True), cpu)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_PARITY_LR),
                           warmup_steps=0, total_steps=10)
    out, secs = {}, {}
    for name, params in (("card", card), ("cpu", cpu)):
        batch = train_batch(cfg, 0, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ,
                            params["embed"].device)
        t0 = time.perf_counter()
        out[name] = step(params, adamw_init(params), batch)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    (pc, sc, mc), (pp, sp, mp) = out["card"], out["cpu"]
    errs = {}
    for what, got, want in (("params", pc, pp), ("m", sc.m, sp.m),
                            ("v", sc.v, sp.v)):
        want_d = dict(tree_items(want))
        err, scale = 0.0, 0.0
        for path, x in tree_items(got):
            w = want_d[path]
            err = max(err, float((x.cpu() - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
        errs[what] = (err, scale)
    say("train", run="card vs cpu", model=cfg.name, layers=cfg.n_layers,
        dtype=cfg.dtype, batch=f"{TRAIN_PARITY_BATCH}x{TRAIN_PARITY_SEQ}",
        lr=TRAIN_PARITY_LR, card_s=secs["card"], cpu_s=secs["cpu"],
        loss_card=float(mc["loss"]), loss_cpu=float(mp["loss"]),
        grad_norm_card=float(mc["grad_norm"]),
        grad_norm_cpu=float(mp["grad_norm"]),
        params_max_abs_err=errs["params"][0],
        m_max_abs_err=errs["m"][0], m_max_abs=errs["m"][1],
        v_max_abs_err=errs["v"][0], v_max_abs=errs["v"][1])
    check(abs(float(mc["loss"]) - float(mp["loss"]))
          <= 1e-5 * abs(float(mp["loss"])), "card vs cpu: loss")
    check(abs(float(mc["grad_norm"]) - float(mp["grad_norm"]))
          <= 1e-4 * float(mp["grad_norm"]), "card vs cpu: grad_norm")
    check(errs["params"][0] <= TRAIN_PARAM_LR_SHARE * TRAIN_PARITY_LR,
          f"card vs cpu: params differ by {errs['params'][0]}")
    for what in ("m", "v"):
        err, scale = errs[what]
        check(err <= TRAIN_STATE_RTOL * scale,
              f"card vs cpu: {what} differs by {err} (max |{what}| {scale})")
    del out, card
    torch.cuda.empty_cache()


def _example_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_example_child(directory: str, device="cuda") -> int:
    """(c), run by `train_example` in a child process whose environment
    sets CUBLAS_WORKSPACE_CONFIG before cuBLAS starts: the example model
    through the port's `Trainer` under deterministic algorithms — 300
    steps with checkpoints, then 40 steps straight against 20 and a new
    `Trainer` resuming to 40, params and optimizer state equal bit for
    bit."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import DataConfig
    from repro_torch.models import count_params, init_lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_items
    from repro_torch.train import Trainer, TrainerConfig

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cfg = _example_module().mini_config()

    def trainer(steps, sub, ckpt_every, log_every):
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, param_dtype=torch.float32)
        return Trainer(
            cfg, params,
            DataConfig(cfg.vocab_size, EXAMPLE_SEQ, EXAMPLE_BATCH),
            os.path.join(directory, sub), opt_cfg=AdamWConfig(lr=1e-3),
            trainer_cfg=TrainerConfig(total_steps=steps,
                                      ckpt_every=ckpt_every,
                                      log_every=log_every),
            device=dev)

    t0 = time.perf_counter()
    tr = trainer(EXAMPLE_STEPS, "run", 100, 20)
    log = tr.run()
    wall = time.perf_counter() - t0
    first, last = log[0], log[-1]
    say("train", run="example", model=f"{cfg.name}-mini",
        layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        params=count_params(tr.params), batch=f"{EXAMPLE_BATCH}x{EXAMPLE_SEQ}",
        steps=EXAMPLE_STEPS, wall_s=wall,
        step_s_median=statistics.median(r["step_time_s"] for r in log[1:]),
        loss=f"{first['loss']:.4f}->{last['loss']:.4f}",
        accuracy=f"{first['accuracy']:.4f}->{last['accuracy']:.4f}",
        loss_rows=",".join(f"{r['step']}:{r['loss']:.3f}" for r in log),
        checkpoints=tr.ckpt.manifest()["steps"],
        deterministic=torch.are_deterministic_algorithms_enabled(),
        cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    check(last["loss"] < first["loss"], "example: the loss did not fall")
    check(tr.ckpt.manifest()["steps"] == [100, 200, 300],
          "example: checkpoints at 100, 200, 300")

    t0 = time.perf_counter()
    full = trainer(RESUME_STEPS, "full", 20, 10)
    full.run()
    trainer(RESUME_STEPS // 2, "resume", 20, 10).run()
    resumed = trainer(RESUME_STEPS, "resume", 20, 10)
    check(resumed.start_step == RESUME_STEPS // 2, "resume step")
    resumed.run()
    trees = [(a, b) for a, b in ((full.params, resumed.params),
                                 (full.opt_state.m, resumed.opt_state.m),
                                 (full.opt_state.v, resumed.opt_state.v))]
    unequal = [path for a, b in trees
               for (path, x), (_, y) in zip(tree_items(a), tree_items(b))
               if not torch.equal(x, y)]
    say("train", run="resume", steps=f"{RESUME_STEPS} vs "
        f"{RESUME_STEPS // 2}+{RESUME_STEPS // 2}",
        leaves=sum(len(list(tree_items(a))) for a, _ in trees),
        unequal_leaves=len(unequal),
        step=int(resumed.opt_state.step), seconds=time.perf_counter() - t0)
    check(not unequal, f"resume: leaves differ: {unequal[:5]}")
    check(int(full.opt_state.step) == int(resumed.opt_state.step)
          == RESUME_STEPS, "resume: optimizer steps")
    return 0


def train_example(dev):
    """(c) in a child process: CUBLAS_WORKSPACE_CONFIG must be set before
    cuBLAS starts, and this process's cuBLAS started long ago."""
    import tempfile
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--train-example", directory],
            env=env, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    sys.stdout.write(r.stdout)
    sys.stdout.flush()
    check(r.returncode == 0,
          f"training example child exited {r.returncode}: {r.stderr[-3000:]}")


def train(dev, laps) -> None:
    """The `[train]` phase: (a), (b) and (c), each timed by `laps`."""
    train_full_width(dev)
    laps.lap("train full width")
    train_card_vs_cpu(dev)
    laps.lap("train card vs cpu")
    train_example(dev)
    laps.lap("train example")


# ---------------------------------------------------------------------------
# phase 20: distribution on torch.distributed ([dist])
# ---------------------------------------------------------------------------

#: (a) tensor-parallel dense `generate`: prompts, prompt length, new tokens
DIST_B, DIST_T, DIST_NEW = 8, 512, 32
#: (b) data-parallel training: rows per rank of the 2 x 4 x 512 batch
DIST_TRAIN_ROWS, DIST_TRAIN_SEQ, DIST_TRAIN_STEPS = 4, 512, 2
#: (c) the reduction networks: one 16 MiB f32 shard per rank
DIST_REDUCE_NUMEL = 4 << 20
#: (g) the MoE's microbatches across data: phi3.5-moe at 2 layers, f32,
#: its d_ff cut to a quarter (two ranks' f32 training state and the
#: one-rank steps share the card), capacity factor 0.5 (capacity binds),
#: 8 x 128 rows in 2 microbatches, 2 steps at the full lr
DIST_MB = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, d_ff=1600,
               capacity_factor=0.5, rows=8, seq=128, micro=2, steps=2)
DIST_MB_METRICS = ("loss", "nll", "accuracy", "moe_aux", "grad_norm")
#: (g) against one rank: the metrics (grad_norm relative), the params
DIST_MB_METRIC_TOL, DIST_MB_PARAM_TOL = 1e-5, 1e-4
#: TP = 2 shard shapes of qwen2-1.5b's projections [K -> M]: wq and wo,
#: wk / wv (one kv head), w_gate / w_up, w_down
DIST_SHARD_MATRICES = ((1536, 768), (768, 1536), (1536, 128), (1536, 4480),
                       (4480, 1536))


def dist_counts(before: dict, after: dict) -> dict:
    return {k: {f: after[k][f] - before[k][f] for f in after[k]}
            for k in after}


def dist_generate(cfg, params, prompts, new_tokens, cache_len, dev):
    """`ServeEngine.generate` on the dense cache under the active sharding
    context: tokens, walls split at the prefill's end (a CUDA event), the
    collectives of prefill and of the decode steps, the launch counts."""
    from repro_torch.dist import collectives
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, params, ServeConfig(
        max_cache_len=cache_len, max_new_tokens=new_tokens, device=str(dev)))
    prefill, marks = eng._prefill, {}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def prefill_then_mark(*args, **kw):
        out = prefill(*args, **kw)
        events[1].record()
        marks["prefill"] = collectives.read_counts()
        return out

    eng._prefill = prefill_then_mark
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_counts()
    start = collectives.read_counts()
    reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    out = eng.generate(prompts)
    events[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    end = collectives.read_counts()
    tokens = out.cpu().numpy()
    steps = new_tokens - 1
    decode = dist_counts(marks["prefill"], end)
    return tokens, dict(
        wall_s=wall, prefill_s=events[0].elapsed_time(events[1]) / 1e3,
        decode_s=events[1].elapsed_time(events[2]) / 1e3,
        tokens_per_s=tokens.size / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        prefill_collectives=dist_counts(start, marks["prefill"]),
        all_reduce_calls_per_decode_step=decode["all_reduce"]["calls"] / steps,
        all_reduce_bytes_per_decode_step=decode["all_reduce"]["bytes"] / steps,
        all_gather_calls_per_decode_step=decode["all_gather"]["calls"] / steps,
        staged_bytes=end["staged"]["bytes"],
        collective_s=sum(v["seconds"] for k, v in end.items()
                         if k != "staged"),
        collectives=dist_counts(start, end),
        launches=launches)


def dist_init(cfg, dev, dtype=None):
    from repro_torch.models import init_lm
    return init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED + 50),
                   dev, param_dtype=dtype)


def dist_place(whole, mesh):
    """This rank's blocks of `whole` by `param_shardings`, and the specs.
    A leaf the layout keeps whole (the experts, Mamba2's weights) is the
    tree's own tensor, a cut block a tensor of its own: dropping `whole`
    frees the cut leaves, and no whole leaf is held twice."""
    from repro_torch.dist.sharding import local_block
    from repro_torch.launch.specs import param_shardings
    from repro_torch.quant.bitplane import PimWeight

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, PimWeight):
            return PimWeight(place(x.planes, spec.planes),
                             place(x.scale, spec.scale), x.n_bits, x.group)
        out = local_block(x, spec, mesh)
        return x if out.shape == x.shape else out.contiguous().clone()
    specs = param_shardings(whole, mesh)
    return place(whole, specs), specs


def dist_quantize(cfg, whole):
    """`ServeEngine.quantize` (8-bit, g = 1) of the whole tree, K5 counted."""
    from repro_torch.quant import PimQuantConfig
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, whole,
                      ServeConfig(device=str(whole["embed"].device)))
    reset_launches()
    eng.quantize(PimQuantConfig(n_bits=8, group=1, min_features=1))
    torch.cuda.synchronize()
    return eng.params, read_launches()["bitplane_pack"]


def dist_tp_full_width(dev, mesh) -> dict:
    """(a) and (a''): qwen2-1.5b at 28 layers, TP = 2, dense `generate` of
    8 x 512 prompts, 32 new tokens, bf16 and then 8-bit g = 1 weights
    (quantized whole, K5, then cut by the specs). K5 on this rank's
    column block of one w_gate must give the planes of the cut."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import SERVE_RULES, sharding_rules
    from repro_torch.kernels import ops

    cfg = get_config("qwen2-1.5b")
    prompts = dense_prompts(cfg.vocab_size, DIST_B, DIST_T, SEED + 51)
    cache_len = DIST_T + DIST_NEW
    out = {}
    for weights in ("bf16", "pim8"):
        whole = dist_init(cfg, dev)
        k5 = 0
        if weights == "pim8":
            lo = mesh.coords["model"] * cfg.d_ff // 2
            w0 = whole["layers"]["mlp"]["w_gate"][0][:, lo: lo + cfg.d_ff // 2]
            w0 = w0.clone()
            whole, k5 = dist_quantize(cfg, whole)
        params, _ = dist_place(whole, mesh)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        shapes = dict(
            q_heads=params["layers"]["attn"]["wq"].shape[-1] // cfg.hd,
            kv_heads=params["layers"]["attn"]["wk"].shape[-1] // cfg.hd,
            d_ff=params["layers"]["mlp"]["w_up"].shape[-1],
            embed=tuple(params["embed"].shape))
        if weights == "pim8":
            reset_launches()
            planes, scale = ops.quantize_and_pack(w0, 8, 1)
            mine = params["layers"]["mlp"]["w_gate"][0]
            check(read_launches()["bitplane_pack"] == 1
                  and torch.equal(planes, mine.planes)
                  and torch.equal(scale, mine.scale),
                  "K5 on a rank's column block differs from the cut planes")
            wg = params["layers"]["mlp"]["w_gate"]
            wd = params["layers"]["mlp"]["w_down"]
            shapes.update(planes_w_gate=tuple(wg.planes.shape),
                          planes_w_down=tuple(wd.planes.shape),
                          scale_w_down=tuple(wd.scale.shape))
            del w0, planes, scale
        with torch.no_grad(), sharding_rules(mesh, SERVE_RULES):
            tokens, stats = dist_generate(cfg, params, prompts, DIST_NEW,
                                          cache_len, dev)
        check(tokens.shape == (DIST_B, DIST_NEW)
              and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
              f"TP=2 {weights} generate: bad tokens {tokens.shape}")
        out[weights] = dict(stats, k5_launches_quantize=k5, tokens=tokens,
                            **shapes)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dist_tp_parity(dev, mesh, ckpt_dir) -> dict:
    """(a') and (e): f32, 4 layers, TP = 2 against one rank (the whole
    tree on this rank, no context): prefill logits within DIST_LOGIT_TOL,
    greedy tokens equal; the same with 8-bit weights, tokens equal. Then
    the TP = 2 params, and a bf16 copy of them, saved whole by rank 0 and
    restored onto one rank and back onto TP = 2, bit for bit."""
    import dataclasses
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import SERVE_RULES, sharding_rules
    from repro_torch.models import prefill
    from repro_torch.optim.adamw import tree_map

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4,
                              dtype="float32")
    prompts = dense_prompts(cfg.vocab_size, DIST_B, DIST_T, SEED + 52)
    cache_len = DIST_T + DIST_NEW
    toks = torch.from_numpy(prompts).to(dev)
    out = {}
    for weights in ("f32", "pim8"):
        whole = dist_init(cfg, dev)
        if weights == "pim8":
            whole = dist_quantize(cfg, whole)[0]
        params, specs = dist_place(whole, mesh)
        with torch.no_grad():
            one_tokens, one = dist_generate(cfg, whole, prompts, DIST_NEW,
                                            cache_len, dev)
            one_logits = prefill(whole, toks, cfg, cache_len)[0]
            collectives.barrier(mesh)
            with sharding_rules(mesh, SERVE_RULES):
                tp_tokens, tp = dist_generate(cfg, params, prompts, DIST_NEW,
                                              cache_len, dev)
                tp_logits = prefill(params, toks, cfg, cache_len)[0]
        err = float((tp_logits - one_logits).abs().max())
        out[weights] = dict(
            logits_max_abs_err=err,
            logits_max_abs=float(one_logits.abs().max()),
            tokens_equal=bool(np.array_equal(one_tokens, tp_tokens)),
            tokens_differ=int((one_tokens != tp_tokens).sum()),
            one_rank_launches=one["launches"], launches=tp["launches"])
        if weights == "f32":
            mgr = CheckpointManager(ckpt_dir)
            out["elastic"] = dist_elastic(whole, params, specs, mesh, mgr,
                                          1, dev)
            whole = tree_map(lambda x: x.to(torch.bfloat16), whole)
            params = dist_place(whole, mesh)[0]
            out["elastic_bf16"] = dist_elastic(whole, params, specs, mesh,
                                               mgr, 2, dev)
        del whole, params
        torch.cuda.empty_cache()
    return out


def dist_elastic(whole, params, specs, mesh, mgr, step, dev) -> dict:
    """(e) the TP = 2 blocks `params` of `whole` gathered and saved whole
    by rank 0 as `step`, then restored onto one rank and back onto
    TP = 2 by `restore(shardings=)`: leaves unequal to `whole`'s and to
    the blocks', seconds, bytes."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import gather_tree

    t0 = time.perf_counter()
    back = gather_tree(params, specs, mesh)
    if mesh.rank == 0:
        mgr.save(step, back)
    collectives.barrier(mesh)
    save_s = time.perf_counter() - t0
    target = meta_like(back)
    t0 = time.perf_counter()
    one_rank, _ = mgr.restore(target, step=step, device=dev)
    two_rank, _ = mgr.restore(target, step=step, shardings=specs, mesh=mesh,
                              device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    return dict(
        save_s=save_s, restore_s=restore_s,
        leaves=len(list(_leaves(whole))),
        dtypes=",".join(sorted({str(x.dtype).replace("torch.", "")
                                for x in _leaves(whole)})),
        one_rank_unequal=sum(not torch.equal(a, b) for a, b in zip(
            _leaves(one_rank), _leaves(whole))),
        tp2_unequal=sum(not torch.equal(a, b) for a, b in zip(
            _leaves(two_rank), _leaves(params))),
        bytes=sum(x.numel() * x.element_size() for x in _leaves(whole)))


def meta_like(tree, dtype=None):
    """The tree's shapes and dtypes (or `dtype`) on the `meta` device (a
    restore target that allocates nothing)."""
    if isinstance(tree, dict):
        return {k: meta_like(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype or tree.dtype, device="meta")


def ckpt(dev) -> None:
    """Phase ckpt: qwen2-1.5b's serving params at full width (28 L, bf16
    weights, f32 norm gains) through `CheckpointManager`: `save`, then
    `save_async` + `wait`, each into a temp dir of its own (one 3 GB
    file on the disk at a time); each restored onto the card with every
    leaf `torch.equal`, and the first once more into an f32 target, the
    bf16 values widened exactly. Host seconds: `save_s` (device-to-host
    copy and write), `snapshot_s` (the copy `save_async` makes before it
    returns), `write_s` (its thread's write, waited for), `restore_s`
    (file to card, synchronised)."""
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = get_config("qwen2-1.5b")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    leaves = list(_leaves(params))
    check(any(x.dtype == torch.bfloat16 for x in leaves),
          "[ckpt] qwen2-1.5b's serving params hold no bf16 leaf")
    fields = dict(model=cfg.name, layers=cfg.n_layers, leaves=len(leaves),
                  bf16_leaves=sum(x.dtype == torch.bfloat16 for x in leaves),
                  bytes=sum(x.numel() * x.element_size() for x in leaves))
    torch.cuda.synchronize()
    for how in ("save", "save_async"):
        with tempfile.TemporaryDirectory(prefix="ckpt_") as tmp:
            mgr = CheckpointManager(tmp)
            t0 = time.perf_counter()
            if how == "save":
                mgr.save(1, params)
                fields["save_s"] = time.perf_counter() - t0
            else:
                mgr.save_async(1, params)
                t1 = time.perf_counter()
                mgr.wait()
                fields["snapshot_s"] = t1 - t0
                fields["write_s"] = time.perf_counter() - t1
            fields[f"{how}_file_bytes"] = os.path.getsize(
                os.path.join(tmp, "step_00000001", "arrays.npz"))
            t0 = time.perf_counter()
            got, _ = mgr.restore(meta_like(params), device=dev)
            torch.cuda.synchronize()
            key = "restore_s" if how == "save" else "restore_async_s"
            fields[key] = time.perf_counter() - t0
            fields[f"{how}_unequal"] = sum(
                not (a.dtype == b.dtype and a.device == b.device
                     and torch.equal(a, b))
                for a, b in zip(_leaves(got), leaves))
            del got
            if how == "save":
                t0 = time.perf_counter()
                wide, _ = mgr.restore(meta_like(params, torch.float32),
                                      device=dev)
                torch.cuda.synchronize()
                fields["restore_f32_s"] = time.perf_counter() - t0
                fields["f32_unequal"] = sum(
                    not (a.dtype == torch.float32
                         and torch.equal(a, b.float()))
                    for a, b in zip(_leaves(wide), leaves))
                del wide
            torch.cuda.empty_cache()
    say("ckpt", **fields)
    for key in ("save_unequal", "save_async_unequal", "f32_unequal"):
        check(fields[key] == 0, f"[ckpt] {key}={fields[key]}: a restored "
              "leaf differs from the saved one")
    del params, leaves
    torch.cuda.empty_cache()


def dist_dp_train(dev, mesh) -> dict:
    """(b) and (d): qwen2-1.5b at 28 layers, DP = 2, f32 masters, remat,
    `make_train_step` on this rank's 4 of 2 x 4 x 512 rows, 2 steps; one
    DP = 2 f32 step at 2 layers against the one-rank step on the whole
    batch; `compressed_psum` over the tied embedding's gradient."""
    import copy
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import local_block
    from repro_torch.optim import (AdamWConfig, adamw_init, compressed_psum,
                                   init_residual)
    from repro_torch.train import make_loss_fn, make_train_step

    def rows(batch):
        return {k: local_block(v, ("data",), mesh).contiguous()
                for k, v in batch.items()}

    cfg = get_config("qwen2-1.5b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = dist_init(cfg, dev, torch.float32)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(), warmup_steps=2,
                           total_steps=DIST_TRAIN_STEPS, mesh=mesh)
    times, losses, grads = [], [], []
    world_rows = DIST_TRAIN_ROWS * mesh.size
    for s in range(DIST_TRAIN_STEPS):
        batch = rows(train_batch(cfg, s, world_rows, DIST_TRAIN_SEQ, dev))
        torch.cuda.synchronize()
        collectives.reset_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        grads.append(collectives.read_counts()["all_reduce"])
    out = {"b": dict(
        layers=cfg.n_layers, batch=f"{mesh.size}x{DIST_TRAIN_ROWS}x"
        f"{DIST_TRAIN_SEQ}", step_s=",".join(f"{t:.4f}" for t in times),
        tokens_per_s=world_rows * DIST_TRAIN_SEQ / times[-1],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        grad_all_reduce_calls=grads[-1]["calls"],
        grad_all_reduce_bytes=grads[-1]["bytes"],
        grad_all_reduce_s=grads[-1]["seconds"],
        loss=",".join(f"{v:.6f}" for v in losses),
        finite=all(bool(torch.isfinite(x).all()) for x in _leaves(params)))}
    del params, opt, m, batch
    gc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = dist_init(small, dev, torch.float32)
    whole = train_batch(small, 0, world_rows, DIST_TRAIN_SEQ, dev)
    lr = AdamWConfig().lr
    # warmup_steps=0: the first step runs at the full lr (under warmup
    # its lr would be 0 and the params would not move)
    one, _, m1 = make_train_step(small, AdamWConfig(), warmup_steps=0)(
        copy.deepcopy(params), adamw_init(params), whole)
    dp, _, m2 = make_train_step(small, AdamWConfig(), warmup_steps=0,
                                mesh=mesh)(
        copy.deepcopy(params), adamw_init(params), rows(whole))
    out["b_parity"] = dict(
        loss_one_rank=float(m1["loss"]), loss_dp=float(m2["loss"]),
        loss_rel_err=abs(float(m1["loss"]) - float(m2["loss"]))
        / abs(float(m1["loss"])),
        params_max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(_leaves(one), _leaves(dp))),
        lr=lr)
    del one, dp

    local = rows(whole)
    params["embed"].requires_grad_(True)
    loss = make_loss_fn(small)(params, local)[0]
    g = torch.autograd.grad(loss, params["embed"])[0]
    params["embed"].requires_grad_(False)
    exact = collectives.all_reduce(g, "data", mesh) / mesh.size
    collectives.reset_counts()
    t0 = time.perf_counter()
    got, res = compressed_psum({"embed": g}, init_residual({"embed": g}),
                               "data", mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = collectives.read_counts()
    out["d"] = dict(
        shape=tuple(g.shape),
        rel_err=float((got["embed"] - exact).abs().max())
        / float(exact.abs().max()),
        residual_max_abs=float(res["embed"].abs().max()),
        int32_all_reduce_bytes=counts["all_reduce"]["bytes"],
        f32_all_reduce_bytes=int(2 * (mesh.size - 1) / mesh.size
                                 * g.numel() * 4),
        seconds=seconds)
    del params, g, got, res, exact
    torch.cuda.empty_cache()
    return out


def dist_moe_micro(dev) -> dict:
    """(g) phi3.5-moe's f32 training in DIST_MB["micro"] microbatches on
    (data, model) = (2, 1), each rank on its rows, capacity binding: the
    step re-lays the rows so a rank's microbatch i is its block of the
    global microbatch i, and the MoE routes the rows one rank routes.
    Rank 0 then runs the same steps on one rank on the whole batch and
    compares metrics and params."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import local_block
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    p = DIST_MB
    cfg = dataclasses.replace(get_config(p["arch"]), n_layers=p["layers"],
                              d_ff=p["d_ff"], dtype="float32",
                              capacity_factor=p["capacity_factor"])
    mesh = Mesh((2, 1), ("data", "model"))

    def run(split):
        params = dist_init(cfg, dev, torch.float32)
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(), warmup_steps=0,
                               n_microbatches=p["micro"],
                               mesh=mesh if split else None)
        metrics, times = [], []
        for s in range(p["steps"]):
            batch = train_batch(cfg, s, p["rows"], p["seq"], dev)
            if split:
                batch = {k: local_block(v, ("data",), mesh).contiguous()
                         for k, v in batch.items()}
            torch.cuda.synchronize(dev)
            collectives.reset_counts()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(m[k]) for k in DIST_MB_METRICS})
        del opt
        return params, metrics, times, collectives.read_counts()

    torch.cuda.reset_peak_memory_stats(dev)
    params, metrics, times, counts = run(True)
    out = dict(step_s=",".join(f"{t:.4f}" for t in times),
               loss=",".join(f"{m['loss']:.6f}" for m in metrics),
               moe_aux=",".join(f"{m['moe_aux']:.6f}" for m in metrics),
               all_gather_calls=counts["all_gather"]["calls"],
               all_reduce_calls=counts["all_reduce"]["calls"],
               reduce_scatter_calls=counts["reduce_scatter"]["calls"],
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    if mesh.rank == 0:
        gc.collect()
        one, one_metrics, _, _ = run(False)
        out["metric_max_abs_err"] = max(
            abs(a[k] - b[k]) for a, b in zip(metrics, one_metrics)
            for k in DIST_MB_METRICS if k != "grad_norm")
        out["grad_norm_rel_err"] = max(
            abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
            for a, b in zip(metrics, one_metrics))
        out["params_max_abs_err"] = max(
            float((a - b).abs().max())
            for a, b in zip(_leaves(params), _leaves(one)))
        del one
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_pair(ckpt_dir, device="cuda") -> dict:
    """What each of the two ranks of (a), (a'), (a''), (b), (d), (e), (g)
    runs (`repro_torch.dist.spawn`): TP on a (1, 2) mesh, DP on (2,), the
    MoE's microbatches on (2, 1)."""
    from repro_torch.launch.mesh import Mesh

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = Mesh((1, 2), ("data", "model"))
    dp = Mesh((2,), ("data",))
    t0 = time.perf_counter()
    out = {"a": dist_tp_full_width(dev, tp)}
    t1 = time.perf_counter()
    out["a1"] = dist_tp_parity(dev, tp, ckpt_dir)
    t2 = time.perf_counter()
    out.update(dist_dp_train(dev, dp))
    t3 = time.perf_counter()
    out["g"] = dist_moe_micro(dev)
    out["seconds"] = {"a": t1 - t0, "a' and e": t2 - t1,
                      "b and d": t3 - t2, "g": time.perf_counter() - t3}
    return out


def dist_reduce(go: str, device="cuda") -> dict:
    """(c) every schedule of `SCHEDULES` and `reduce_to_zero_binary_hopping`
    on 4 ranks of the card over a 16 MiB f32 shard of integer values:
    each result equal to `allreduce_tree`'s, seconds, bytes moved. The
    ranks start while the two-rank world runs and wait for the file `go`
    before they touch the card's work."""
    from repro_torch.core.reduction import (SCHEDULES,
                                            collective_bytes_per_device,
                                            make_sharded_allreduce,
                                            reduce_to_zero_binary_hopping)
    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import Mesh

    while not os.path.exists(go):
        time.sleep(0.05)
    mesh = Mesh((4,), ("x",))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + mesh.rank)
    x = torch.randint(-1000, 1000, (DIST_REDUCE_NUMEL,), generator=gen,
                      device=dev).float()
    tree = make_sharded_allreduce(mesh, "x", "tree")(x)   # warm-up too
    out = {}
    for name in list(SCHEDULES) + ["reduce_to_zero"]:
        collectives.barrier(mesh)
        collectives.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "reduce_to_zero":
            y = reduce_to_zero_binary_hopping(x, "x", mesh)
        else:
            y = make_sharded_allreduce(mesh, "x", name)(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = collectives.read_counts()
        equal = torch.equal(y, tree) if (name != "reduce_to_zero"
                                         or mesh.rank == 0) else True
        out[name] = dict(
            seconds=seconds, equal=equal,
            bytes=sum(counts[k]["bytes"] for k in (
                "ppermute", "all_reduce", "reduce_scatter", "all_gather")),
            staged_bytes=counts["staged"]["bytes"],
            # reduce-to-zero: every rank but 0 sends its partial once
            model_bytes=(x.numel() * 4 if mesh.rank else 0)
            if name == "reduce_to_zero" else collective_bytes_per_device(
                name, x.numel() * 4, mesh.size))
    return out


def dist_shard_kernel_checks(dev, errs) -> None:
    """K3/K4/K5 against their plain versions at the TP = 2 shard shapes
    of qwen2-1.5b (8-bit g = 1): decode's 8 rows (K3) and prefill's
    8 x 512 (K4)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    rel_err = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                             "matmul_bf16", "matmul_f32"), 0.0)
    for k, m in DIST_SHARD_MATRICES:
        check_bitplane_matrix(dev, gen, 8, 1, k, m, (DIST_B, DIST_B * DIST_T),
                              errs, rel_err)
    say("bitplane", model="qwen2-1.5b TP=2 shards", format="(8,1)",
        matrices=",".join(f"{k}->{m}" for k, m in DIST_SHARD_MATRICES),
        rows=f"{DIST_B},{DIST_B * DIST_T}", pack="byte-identical",
        gemv_rel_err=rel_err["bitplane_gemv"],
        gemm_rel_err=rel_err["bitplane_gemm"],
        matmul_rel_err_bf16=rel_err["matmul_bf16"],
        matmul_rel_err_f32=rel_err["matmul_f32"])


#: (a') f32 logits, TP = 2 against one rank: the row-parallel partial
#: sums add in another order
DIST_LOGIT_TOL = 1e-4

#: (f) the tensor-parallel families at published width, TP = 2 on ranks
#: sharing the card: (arch, layers (None: all), weights). Peak bytes for
#: the two ranks together, reckoned: phi3.5-moe's experts are whole on
#: both ranks (16 x 3 x 4096 x 6400 bf16 = 2.52 GB a layer), 8 layers
#: 40.3 GB, 60.4 GB while pim8 quantizes (the dense and packed trees at
#: once); llama4-scout 4.03 GB of experts a layer and 4.1 GB of embedding
#: and head whole until placed, 4 layers 41.3 GB; zamba2 (2.4 GB),
#: xlstm (0.7 GB) and whisper (1.5 GB) at full depth, twice
DIST_FAM_RUNS = (("phi3.5-moe-42b-a6.6b", 8, ("bf16", "pim8")),
                 ("llama4-scout-17b-a16e", 4, ("bf16",)),
                 ("zamba2-1.2b", None, ("bf16", "pim8")),
                 ("xlstm-350m", None, ("bf16",)),
                 ("whisper-medium", None, ("bf16",)))
#: the decoder-only runs' dense `generate`: prompts, prompt length, new
#: tokens; whisper: prompts of WH_PROMPT tokens over WH_FRAMES frames
DIST_FAM_B, DIST_FAM_T, DIST_FAM_NEW = 4, 256, 16
#: (f') f32 parity, TP = 2 against one rank: layers (whisper 2 + 2),
#: prompts, prompt length, new tokens
DIST_FAM_PARITY = dict(layers=2, b=2, t=64, new=8)
#: K3 / K4 at whisper-medium's TP = 2 shard shapes: `wq` [1024 -> 512]
#: (column) and `w_down` [2048 -> 1024] (row), at decode's and the
#: encoder's row counts
DIST_FAM_SHARD_MATRICES = ((1024, 512), (2048, 1024))


def tree_bytes(tree) -> int:
    """The bytes of a parameter tree's tensors (a `PimWeight`'s planes and
    scale)."""
    from repro_torch.quant.bitplane import PimWeight
    return sum(x.planes.numel() + x.scale.numel() * x.scale.element_size()
               if isinstance(x, PimWeight) else x.numel() * x.element_size()
               for x in _leaves(tree))


def dist_family_init(arch, layers, dev, dtype=None):
    """`init_lm` (`init_encdec` for whisper) of `arch` at published width,
    cut to `layers` (whisper: both stacks), seeded alike on every rank."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_encdec, init_lm

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers, **(
            {"n_encoder_layers": layers} if cfg.is_encoder_decoder else {}))
    gen = torch.Generator(device=dev).manual_seed(SEED + 54)
    init = init_encdec if cfg.is_encoder_decoder else init_lm
    return cfg, init(cfg, gen, dev, param_dtype=dtype)


def dist_family_generate(cfg, params, dev, b, t, new, seed):
    """The family's serving path under the active context: dense
    `generate` (`dist_generate`), or whisper's `prefill_encdec` and
    `decode_step_encdec`s (`encdec_generate`), the collectives counted
    by kind. Returns the tokens and the stats."""
    from repro_torch.dist import collectives

    if not cfg.is_encoder_decoder:
        prompts = dense_prompts(cfg.vocab_size, b, t, seed)
        return dist_generate(cfg, params, prompts, new, t + new, dev)
    frames, prompt = whisper_inputs(cfg, dev, b, WH_FRAMES, seed)
    collectives.reset_counts()
    start = collectives.read_counts()
    tokens, stats, launches = encdec_generate(
        cfg, params, frames, prompt, new, prompt.shape[1] + new, dev)
    end = collectives.read_counts()
    stats = {k: v for k, v in stats.items() if not k.startswith("launches")}
    return tokens, dict(stats, staged_bytes=end["staged"]["bytes"],
                        collectives=dist_counts(start, end),
                        launches=launches)


def dist_family_run(arch, layers, weights, dev, mesh, shapes):
    """(f) one family at TP = 2: init the whole tree (pim8: quantized
    whole, K5 counted), place this rank's blocks, run the serving path.
    The bit-plane products of a pim8 run go into `shapes`."""
    import contextlib
    import gc
    from repro_torch.dist.sharding import SERVE_RULES, sharding_rules

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, whole = dist_family_init(arch, layers, dev)
    k5 = 0
    if weights == "pim8":
        if cfg.is_encoder_decoder:
            raise ValueError("whisper's TP run is bf16 only")
        whole, k5 = dist_quantize(cfg, whole)
    params = dist_place(whole, mesh)[0]
    del whole
    gc.collect()
    torch.cuda.synchronize()
    init = dict(init_s=time.perf_counter() - t0,
                init_max_memory_allocated=torch.cuda.max_memory_allocated(),
                param_bytes_rank=tree_bytes(params))
    torch.cuda.empty_cache()
    rows = ({} if cfg.is_encoder_decoder
            else {"b": DIST_FAM_B, "t": DIST_FAM_T})
    with torch.no_grad(), sharding_rules(mesh, SERVE_RULES), (
            shapes if weights == "pim8" else contextlib.nullcontext()):
        tokens, stats = dist_family_generate(
            cfg, params, dev, rows.get("b", DIST_FAM_B),
            rows.get("t", WH_PROMPT), DIST_FAM_NEW, SEED + 55)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check(tokens.shape == (DIST_FAM_B, DIST_FAM_NEW)
          and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          f"(f) {arch} TP=2 {weights}: bad tokens {tokens.shape}")
    layers_s = (f"{cfg.n_encoder_layers}+{cfg.n_layers}"
                if cfg.is_encoder_decoder else cfg.n_layers)
    return dict(stats, **init, layers=layers_s, tokens=tokens,
                k5_launches_quantize=k5)


def dist_family_parity(arch, dev, mesh) -> dict:
    """(f') f32, DIST_FAM_PARITY["layers"] layers at published width:
    TP = 2 against one rank (the whole tree on this rank, no context):
    the prefill's logits within DIST_LOGIT_TOL, greedy tokens equal."""
    import dataclasses
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import SERVE_RULES, sharding_rules
    from repro_torch.models import prefill, prefill_encdec

    p = DIST_FAM_PARITY
    cfg, whole = dist_family_init(arch, p["layers"], dev, torch.float32)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = dist_place(whole, mesh)[0]
    b, t = p["b"], p["t"] if not cfg.is_encoder_decoder else WH_PROMPT

    def logits(tree):
        if cfg.is_encoder_decoder:
            frames, prompt = whisper_inputs(cfg, dev, b, WH_FRAMES, SEED + 56)
            return prefill_encdec(tree, frames, prompt, cfg, t + p["new"])[0]
        toks = torch.from_numpy(dense_prompts(cfg.vocab_size, b, t,
                                              SEED + 56)).to(dev)
        return prefill(tree, toks, cfg, t + p["new"])[0]

    with torch.no_grad():
        one_tokens, _ = dist_family_generate(cfg, whole, dev, b, t, p["new"],
                                             SEED + 56)
        one_logits = logits(whole)
        collectives.barrier(mesh)
        with sharding_rules(mesh, SERVE_RULES):
            tp_tokens, _ = dist_family_generate(cfg, params, dev, b, t,
                                                p["new"], SEED + 56)
            tp_logits = logits(params)
    out = dict(
        layers=(f"{cfg.n_encoder_layers}+{cfg.n_layers}"
                if cfg.is_encoder_decoder else cfg.n_layers),
        logits_max_abs_err=float((tp_logits - one_logits).abs().max()),
        logits_max_abs=float(one_logits.abs().max()),
        tokens_equal=bool(np.array_equal(one_tokens, tp_tokens)),
        tokens_differ=int((one_tokens != tp_tokens).sum()))
    del whole, params
    torch.cuda.empty_cache()
    return out


def dist_families_pair(device="cuda") -> dict:
    """What each of the two ranks of (f) and (f') runs (`spawn`): every
    run of DIST_FAM_RUNS, then the f32 parities, on a (1, 2) mesh. Rank 0
    then holds K3-K5 against their plain versions at every [K -> M] and
    row count the pim8 runs gave them."""
    from repro_torch.launch.mesh import Mesh

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh((1, 2), ("data", "model"))
    shapes = BitplaneShapes()
    out = {"runs": {}, "parity": {}, "seconds": {}}
    for arch, layers, weights in DIST_FAM_RUNS:
        for w in weights:
            t0 = time.perf_counter()
            out["runs"][(arch, w)] = dist_family_run(arch, layers, w, dev,
                                                     mesh, shapes)
            out["seconds"][f"{arch} {w}"] = time.perf_counter() - t0
    for arch, _, _ in DIST_FAM_RUNS:
        t0 = time.perf_counter()
        out["parity"][arch] = dist_family_parity(arch, dev, mesh)
        out["seconds"][f"{arch} parity"] = time.perf_counter() - t0
    if mesh.rank == 0:
        errs = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                              "bitplane_pack"), 0.0)
        family_bitplane(dev, "TP=2 families", shapes, errs)
        out["errs"] = errs
    return out


def dist_family_shard_checks(dev, errs) -> None:
    """K3/K4/K5 against their plain versions at whisper-medium's TP = 2
    shard shapes (8-bit g = 1): decode's rows (K3) and the encoder's
    DIST_FAM_B x WH_FRAMES (K4)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 57)
    rel_err = dict.fromkeys(("bitplane_gemv", "bitplane_gemm",
                             "matmul_bf16", "matmul_f32"), 0.0)
    rows = (DIST_FAM_B, DIST_FAM_B * WH_FRAMES)
    for k, m in DIST_FAM_SHARD_MATRICES:
        check_bitplane_matrix(dev, gen, 8, 1, k, m, rows, errs, rel_err)
    say("bitplane", model="whisper-medium TP=2 shards", format="(8,1)",
        matrices=",".join(f"{k}->{m}" for k, m in DIST_FAM_SHARD_MATRICES),
        rows=",".join(map(str, rows)), pack="byte-identical",
        gemv_rel_err=rel_err["bitplane_gemv"],
        gemm_rel_err=rel_err["bitplane_gemm"],
        matmul_rel_err_bf16=rel_err["matmul_bf16"],
        matmul_rel_err_f32=rel_err["matmul_f32"])


def dist_families(dev, errs, laps) -> dict:
    """(f) and (f'): the MoE, recurrent and encoder-decoder stacks at
    TP = 2 on two ranks sharing the card. Returns the kernel launches of
    each run, summed over ranks, by path."""
    from repro_torch.dist import spawn

    dist_family_shard_checks(dev, errs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pair = spawn.run("chip_smoke:dist_families_pair", 2, timeout=600,
                     paths=[str(ROOT)])
    laps.lap("dist TP families")
    return dist_families_report(pair, errs)


def dist_families_report(pair, errs) -> dict:
    """The `[dist] case=f` / `f'` lines and checks of the two ranks'
    results; returns each run's launches, summed over ranks, by path."""
    for name, e in pair[0]["errs"].items():
        errs[name] = max(errs[name], e)
    by_path = {}
    for arch, _, weights in DIST_FAM_RUNS:
        for w in weights:
            ranks = [r["runs"][(arch, w)] for r in pair]
            check(np.array_equal(ranks[0]["tokens"], ranks[1]["tokens"]),
                  f"(f) {arch} TP=2 {w}: the ranks' tokens differ")
            for rank, r in enumerate(ranks):
                line = dict(batch=f"{DIST_FAM_B}x{WH_PROMPT}"
                            if "whisper" in arch
                            else f"{DIST_FAM_B}x{DIST_FAM_T}",
                            new_tokens=DIST_FAM_NEW)
                line.update((k, v) for k, v in r.items() if k not in (
                    "tokens", "launches", "prefill_collectives",
                    "collectives", "staged_bytes"))
                line.update((f"{kind}_{f}", v)
                            for kind, c in r["collectives"].items()
                            for f, v in c.items() if c["calls"])
                line.update((f"launches_{k}", v)
                            for k, v in r["launches"].items() if v)
                say("dist", case="f", model=arch, weights=w, tp=2,
                    rank=rank, **line)
            path = by_path[f"{arch} TP=2 {w}"] = {
                k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
            path["bitplane_pack"] += sum(r["k5_launches_quantize"]
                                         for r in ranks)
            check(w != "pim8" or (path["bitplane_gemv"] > 0
                                  and path["bitplane_gemm"] > 0
                                  and path["bitplane_pack"] > 0),
                  f"(f) {arch} TP=2 pim8: K3/K4/K5 must launch, got {path}")
    for rank, r in enumerate(pair):
        for arch, p in r["parity"].items():
            say("dist", case="f'", model=arch, dtype="float32", tp=2,
                rank=rank, tolerance=DIST_LOGIT_TOL, **p)
            check(p["tokens_equal"], f"(f') {arch}: TP=2 tokens differ "
                  f"from one rank's ({p['tokens_differ']})")
            check(p["logits_max_abs_err"] <= DIST_LOGIT_TOL,
                  f"(f') {arch}: logits err {p['logits_max_abs_err']}")
    say("dist", case="f parts", **{f"rank{r}_{k}_s": v
                                   for r, p in enumerate(pair)
                                   for k, v in p["seconds"].items()})
    return by_path


def dist(dev, errs, laps) -> dict:
    """Phase 20: the distribution layer on the card. Ranks are processes
    that all use this card and talk over gloo (NCCL refuses two ranks on
    one device): each rank computes at its shard's shapes on real
    blocks, with real collectives between processes, but the transport
    is gloo's host path, not NVLink. Returns the kernel launches of the
    TP paths, summed over ranks, by path."""
    import gc
    import tempfile
    from repro_torch.dist import spawn

    dist_shard_kernel_checks(dev, errs)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("dist", case="release", parent_memory_allocated=
        torch.cuda.memory_allocated(), parent_memory_reserved=
        torch.cuda.memory_reserved())
    with tempfile.TemporaryDirectory(prefix="dist_") as tmp:
        # the four-rank world starts now and waits for `go`: its start-up
        # overlaps the two-rank world's run, its measurements do not
        go = os.path.join(tmp, "go")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            quad = pool.submit(spawn.run, "chip_smoke:dist_reduce", 4,
                               args=(go,), timeout=900, paths=[str(ROOT)])
            try:
                pair = spawn.run("chip_smoke:dist_pair", 2, args=(tmp,),
                                 timeout=600, paths=[str(ROOT)])
                laps.lap("dist TP and DP")
            finally:
                open(go, "w").close()
            four = quad.result()
    laps.lap("dist reduction networks")
    families = dist_families(dev, errs, laps)
    by_path = dict(families)
    for weights in ("bf16", "pim8"):
        ranks = [r["a"][weights] for r in pair]
        check(np.array_equal(ranks[0]["tokens"], ranks[1]["tokens"]),
              f"(a) TP=2 {weights}: the ranks' tokens differ")
        for rank, r in enumerate(ranks):
            say("dist", case="a" if weights == "bf16" else "a''",
                model="qwen2-1.5b", layers=28, weights=weights, tp=2,
                rank=rank, batch=f"{DIST_B}x{DIST_T}", new_tokens=DIST_NEW,
                **{k: v for k, v in r.items()
                   if k not in ("tokens", "launches", "prefill_collectives",
                                "collectives")},
                **{f"launches_{k}": v for k, v in r["launches"].items() if v})
        by_path[f"qwen2-1.5b TP=2 {weights}"] = {
            k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}
        by_path[f"qwen2-1.5b TP=2 {weights}"]["bitplane_pack"] += sum(
            r["k5_launches_quantize"] for r in ranks)
    pim = by_path["qwen2-1.5b TP=2 pim8"]
    check(pim["bitplane_gemv"] > 0 and pim["bitplane_gemm"] > 0
          and pim["bitplane_pack"] > 0,
          f"(a'') TP=2 pim8: K3/K4/K5 must launch, got {pim}")
    for rank, r in enumerate(pair):
        for weights in ("f32", "pim8"):
            p = r["a1"][weights]
            say("dist", case="a'", model="qwen2-1.5b", layers=4,
                dtype="float32", weights=weights, tp=2, rank=rank,
                tolerance=DIST_LOGIT_TOL, **p)
            check(p["tokens_equal"], f"(a') {weights}: TP=2 tokens differ "
                  f"from one rank's ({p['tokens_differ']})")
            check(weights == "pim8" or p["logits_max_abs_err"]
                  <= DIST_LOGIT_TOL,
                  f"(a') logits err {p['logits_max_abs_err']}")
        e = r["a1"]["elastic"]
        say("dist", case="e", rank=rank, **e)
        check(e["one_rank_unequal"] == 0 and e["tp2_unequal"] == 0,
              f"(e) elastic restore not bit-exact: {e}")
        e = r["a1"]["elastic_bf16"]
        say("dist", case="e bf16", rank=rank, **e)
        check(e["dtypes"] == "bfloat16" and e["one_rank_unequal"] == 0
              and e["tp2_unequal"] == 0,
              f"(e) bf16 elastic restore not bit-exact: {e}")
        b, bp, d = r["b"], r["b_parity"], r["d"]
        say("dist", case="b", model="qwen2-1.5b", dp=2, rank=rank, **b)
        check(b["finite"], "(b) non-finite params")
        say("dist", case="b parity", layers=2, dtype="float32", dp=2,
            rank=rank, **bp)
        check(bp["loss_rel_err"] <= 1e-6
              and bp["params_max_abs_err"] <= 0.1 * bp["lr"],
              f"(b) DP=2 step vs one rank: {bp}")
        say("dist", case="d", dp=2, rank=rank, **d)
        check(d["rel_err"] < 0.05 and d["residual_max_abs"] > 0,
              f"(d) compressed_psum: {d}")
    check(pair[0]["b"]["loss"] == pair[1]["b"]["loss"],
          "(b) the ranks' losses differ")
    for rank, r in enumerate(pair):
        g = r["g"]
        say("dist", case="g", model="phi3.5-moe", layers=DIST_MB["layers"],
            d_ff=DIST_MB["d_ff"], dtype="float32", data=2, model_axis=1,
            microbatches=DIST_MB["micro"],
            capacity_factor=DIST_MB["capacity_factor"],
            batch=f"{DIST_MB['rows']}x{DIST_MB['seq']}", rank=rank,
            metric_tol=DIST_MB_METRIC_TOL, param_tol=DIST_MB_PARAM_TOL, **g)
    g = pair[0]["g"]
    check(g["metric_max_abs_err"] <= DIST_MB_METRIC_TOL
          and g["grad_norm_rel_err"] <= DIST_MB_METRIC_TOL
          and g["params_max_abs_err"] <= DIST_MB_PARAM_TOL,
          f"(g) MoE microbatches across data vs one rank: {g}")
    check(pair[0]["g"]["loss"] == pair[1]["g"]["loss"],
          "(g) the ranks' losses differ")
    say("dist", case="parts", **{f"rank{r}_{k}_s": v
                                 for r, p in enumerate(pair)
                                 for k, v in p["seconds"].items()})
    for name, r0 in four[0].items():
        say("dist", case="c", schedule=name, ranks=4,
            shard_bytes=DIST_REDUCE_NUMEL * 4,
            transport="gloo through host memory, not NVLink",
            seconds=",".join(f"{r[name]['seconds']:.4f}" for r in four),
            bytes_per_rank=",".join(str(r[name]["bytes"]) for r in four),
            model_bytes_per_rank=",".join(str(int(r[name]["model_bytes"]))
                                          for r in four),
            staged_bytes_rank0=r0["staged_bytes"],
            equal_to_tree=all(r[name]["equal"] for r in four))
        check(all(r[name]["equal"] for r in four),
              f"(c) {name} differs from allreduce_tree")
        check(all(r[name]["bytes"] == r[name]["model_bytes"] for r in four),
              f"(c) {name}: bytes moved differ from the model")
    return by_path


# ---------------------------------------------------------------------------
# phase 21: the tools ([tools]: [lint], [analysis], [roofline], [dryrun],
# [examples])
# ---------------------------------------------------------------------------

#: qwen2-1.5b's decode slots in the lint and the roofline: K1's timing
#: row (5,858 cached positions; the cache holds one row more, for the
#: decoded token), and K2's 768-token chunk after a 256-token cached
#: prefix
TOOLS_LENGTHS = (340, 420, 560, 700, 810, 930, 1010, 1088)
TOOLS_CHUNK, TOOLS_CACHED, TOOLS_BS = 768, 256, 16
#: gemma3-27b at published width and one 5:1 period: two layer groups
TOOLS_G3_LAYERS = 6
TOOLS_G3_LENGTHS = (1400, 1700, 2100, 2400, 2700, 3000, 3200, 3392)
#: the dry-run cells the child runs: the reference's slow-test cell, a
#: training cell, and the MoE, recurrent and encoder-decoder stacks on a
#: `model` axis of 16: each one's decode step on 2 x 16 x 16, zamba2's
#: training step, and xlstm's training step at 16 positions (a shape as
#: `ShapeConfig`'s fields): its train_4k runs as a Python loop over 4,096
#: time steps on meta tensors, whose pointwise meta kernels are Python,
#: over an hour for one step
TOOLS_DRYRUN = (("qwen2-1.5b", "decode_32k", True),
                ("qwen2-1.5b", "train_4k", False),
                ("phi3.5-moe-42b-a6.6b", "decode_32k", True),
                ("llama4-scout-17b-a16e", "decode_32k", True),
                ("zamba2-1.2b", "decode_32k", True),
                ("xlstm-350m", "decode_32k", True),
                ("whisper-medium", "decode_32k", True),
                ("zamba2-1.2b", "train_4k", False),
                ("xlstm-350m", "train_4k", False),
                ("llava-next-34b", "prefill_32k", False))
#: rank 0's argument bytes of cells of TOOLS_DRYRUN by the reference's
#: own specs (`tests/test_torch_dryrun.py` holds them to the reference)
TOOLS_DRYRUN_BYTES = {"xlstm-350m|train_4k|single": 2_610_212_868,
                      "llava-next-34b|prefill_32k|single": 8_765_871_616}
#: timed calls of each step in [roofline] (median)
ROOF_CALLS = 10


def dryrun_child() -> int:
    """`chip_smoke.py --dryrun-child`: the dry-run cells, one JSON line
    each (the fake world of 256 / 512 ranks lives and dies in this
    process)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import run_cell
    for arch, shape, multi in TOOLS_DRYRUN:
        r = run_cell(arch, shape, multi)
        r.get("detail", {}).pop("flops_by_op", None)
        print(json.dumps(r), flush=True)
    return 0


def start_children(names) -> dict:
    """Start the `[tools]` children: the dry-run child (CPU only, one
    thread: it is started right after the build and runs beside the
    earlier phases) and the two examples (on the card)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {"dryrun": [sys.executable, str(Path(__file__).resolve()),
                       "--dryrun-child"],
            "quickstart": [sys.executable,
                           str(ROOT / "examples" / "quickstart_torch.py")],
            "serve_pim_gemv": [sys.executable, str(
                ROOT / "examples" / "serve_pim_gemv_torch.py")]}
    envs = {"dryrun": dict(env, OMP_NUM_THREADS="1")}
    procs = {name: subprocess.Popen(cmds[name], env=envs.get(name, env),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name in names}
    _CHILDREN.extend(procs.values())
    return procs


#: every child this script started; any still running at exit is killed
_CHILDREN: list = []


@atexit.register
def _stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def launched_since(before: dict) -> dict:
    """The launches of each kernel since `before` (a `read_launches()`)."""
    return {k: v - before[k] for k, v in read_launches().items()
            if v != before[k]}


def tools_lint_steps(cfg, params, dev, kv_dtype, lengths):
    from repro_torch.analysis.dispatch_lint import probe_steps
    return probe_steps(cfg, params, dev, impl="cuda", kv_dtype=kv_dtype,
                       n_slots=len(lengths), lengths=lengths,
                       prompt=TOOLS_CHUNK, cached=TOOLS_CACHED,
                       block_size=TOOLS_BS, max_len=max(lengths) + 1)


def tools_lint(dev, qparams, pparams, g3params, g3cfg, cfg):
    """[lint]: the dispatch lint of the real paged steps at full width, on
    the card (K1-K4, under set_sync_debug_mode("error"))."""
    from repro_torch.analysis.dispatch_lint import lint_call
    from repro_torch.analysis.findings import count_by

    runs = (("qwen2-1.5b", cfg, qparams, "bf16", TOOLS_LENGTHS),
            ("qwen2-1.5b", cfg, qparams, "int8", TOOLS_LENGTHS),
            ("qwen2-1.5b pim8", cfg, pparams, "bf16", TOOLS_LENGTHS),
            (f"gemma3-27b[{TOOLS_G3_LAYERS}L]", g3cfg, g3params, "bf16",
             TOOLS_G3_LENGTHS))
    total = []
    with torch.no_grad():
        for model, c, p, kv, lens in runs:
            for name, fn, kw in tools_lint_steps(c, p, dev, kv, lens):
                before = read_launches()
                found = lint_call(fn, f"<dispatch:{name}:{model}:{kv}>", **kw)
                torch.cuda.synchronize()
                fired = launched_since(before)
                say("lint", model=model, kv=kv, step=name,
                    groups=kw["expected_groups"], findings=len(found),
                    by_rule=json.dumps(count_by(found, "rule")),
                    launches=json.dumps(fired))
                for f in found:
                    print(f"  {f}", flush=True)
                want = {"decode": "paged_decode",
                        "prefill": "paged_prefill"}[name]
                check(fired.get(want, 0) > 0,
                      f"[lint] {model} {name}: {want} did not launch")
                if "pim8" in model:
                    k = "bitplane_gemv" if name == "decode" else \
                        "bitplane_gemm"
                    check(fired.get(k, 0) > 0,
                          f"[lint] {model} {name}: {k} did not launch")
                total.extend(found)
    say("lint", findings=len(total),
        by_rule=json.dumps(count_by(total, "rule")))
    check(not total, f"[lint] {len(total)} finding(s) on the card")


def tools_analysis(tmp):
    """[analysis]: the repo and kernel layers over the tree, then
    `obs.regress.make_record` over the findings JSON."""
    from repro_torch.analysis.__main__ import main as analyze
    from repro_torch.obs import regress

    out = os.path.join(tmp, "analysis_findings.json")
    rc = analyze(["--root", str(ROOT), "--layers", "repo,kernels",
                  "--gate", "--json", out])
    with open(out) as fh:
        counts = json.load(fh)["counts"]
    rec = regress.make_record(tmp)
    say("analysis", findings=counts["total"], new=counts["new"], rc=rc,
        findings_total=rec["metrics"].get("analysis.findings_total"),
        findings_new=rec["metrics"].get("analysis.findings_new"))
    check(rc == 0 and counts["total"] == 0 and counts["new"] == 0,
          f"[analysis] findings {counts}")
    check(rec["metrics"].get("analysis.findings_total") == 0.0,
          "[analysis] make_record did not read analysis.findings_total")


def tools_time_step(fn) -> float:
    """Median device-clock seconds of `fn()` over ROOF_CALLS calls, each
    between CUDA events (one warm call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROOF_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def tools_roofline_step(cell, model_flops, fn_for, analytic_bytes,
                        kernel_bytes, routes=("cuda", "ref")):
    """Count one step on impl="cuda" and on impl="ref" (both on the card),
    require equal FLOPs and kernel bytes, time the cuda step and print
    its roofline shares. `model_flops(count)` gives the step's useful
    FLOPs."""
    from repro_torch.launch import roofline as R

    counts = {}
    for impl in routes:
        before = read_launches()
        counts[impl] = R.count_step(fn_for(impl))[1]
        torch.cuda.synchronize()
        if impl == "cuda" and kernel_bytes:
            check(launched_since(before),
                  f"[roofline] {cell}: no kernel launched on impl=cuda")
    a, b = counts["cuda"], counts[routes[-1]]
    check(a["flops"] == b["flops"] and a["kernel_bytes"] == b["kernel_bytes"],
          f"[roofline] {cell}: cuda {a['flops']}/{a['kernel_bytes']} != "
          f"ref {b['flops']}/{b['kernel_bytes']}")
    terms, _ = R.terms_from_count(
        cell, a, 1, model_flops(a), analytic_bytes=analytic_bytes,
        kernel_bytes=kernel_bytes)
    measured = tools_time_step(fn_for("cuda"))
    sh = R.shares(terms, measured)
    say("roofline", cell=cell, flops=a["flops"], aten_flops=a["aten_flops"],
        kernel_flops=a["kernel_flops"], kernel_bytes=a["kernel_bytes"],
        bytes=terms.hlo_bytes, routes_equal=True,
        kernels=json.dumps({k: v["calls"] for k, v in a["kernels"].items()}),
        **sh)
    check(sh["bound_share"] <= 1.0,
          f"[roofline] {cell}: bound/measured {sh['bound_share']} > 1")
    return sh


def serve_step_flop(cfg, rows: int, logit_rows: int) -> float:
    """Weight-product FLOP of one serving step of a dense attention stack:
    every layer's projections for the `rows` tokens it runs and the head's
    for the `logit_rows` it returns (a prefill chunk: its last position).
    The attention's share is what K1/K2 report (their visible pairs)."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    layer = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * f
    return 2.0 * (layer * cfg.n_layers * rows
                  + d * cfg.vocab_size * logit_rows)


def tools_roofline(dev, cfg, qparams, pparams):
    """[roofline]: qwen2-1.5b 28 L, one paged decode step, one 768-token
    prefill chunk, the pim8 decode step, and (in tools_train_roofline) one
    training step of 8 x 512. Memory: the weights no kernel reads (all of
    them, bar the pim8 planes) plus the kernels' reported bytes."""
    from repro_torch.analysis.dispatch_lint import probe_steps
    from repro_torch.launch import roofline as R

    rows = {"decode": (len(TOOLS_LENGTHS), len(TOOLS_LENGTHS)),
            "prefill": (TOOLS_CHUNK, 1)}

    def steps(params, impl):
        return {name: fn for name, fn, _ in probe_steps(
            cfg, params, dev, impl=impl, n_slots=len(TOOLS_LENGTHS),
            lengths=TOOLS_LENGTHS, prompt=TOOLS_CHUNK, cached=TOOLS_CACHED,
            block_size=TOOLS_BS, max_len=max(TOOLS_LENGTHS) + 1)}

    def useful(name):
        def model_flops(count):
            attn = sum(v["flops"] for k, v in count["kernels"].items()
                       if k.startswith("paged_"))
            return serve_step_flop(cfg, *rows[name]) + attn
        return model_flops

    out = {}
    with torch.no_grad():
        for tag, params, names in (("bf16", qparams, ("decode", "prefill")),
                                   ("pim8", pparams, ("decode",))):
            built = {impl: steps(params, impl) for impl in ("cuda", "ref")}
            for name in names:
                cell = f"qwen2-1.5b|{name}|{tag}"
                out[cell] = tools_roofline_step(
                    cell, useful(name),
                    lambda impl, n=name: built[impl][n],
                    R.unkerneled_param_bytes(params), kernel_bytes=True)
    return out


def tools_train_roofline(dev, cfg):
    """[roofline] one training step of qwen2-1.5b at 8 x 512 (f32 masters,
    remat): counted FLOPs (no kernel on this path), the analytic bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline as R
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                     param_dtype=torch.float32)
    state = {"p": params, "o": adamw_init(params)}
    step = make_train_step(cfg, AdamWConfig(), warmup_steps=2,
                           total_steps=100)
    batch = train_batch(cfg, 0, TRAIN_BATCH, TRAIN_SEQ, dev)

    def run():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)

    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    sh = tools_roofline_step(
        "qwen2-1.5b|train|8x512",
        lambda count: R.model_flops_for_cell(cfg, shape, params),
        lambda impl: run, R.analytic_bytes_for_cell(cfg, shape, params),
        kernel_bytes=False, routes=("cuda",))
    del params, state
    torch.cuda.empty_cache()
    return sh


def tools_collect(children):
    """[dryrun] and [examples]: wait for the children and check them."""
    outs = {}
    for name, p in children.items():
        out, err = p.communicate(timeout=600)
        outs[name] = (p.returncode, out, err)
        check(p.returncode == 0,
              f"[tools] child {name} exited {p.returncode}: {err[-3000:]}")
    rows = [json.loads(l) for l in outs["dryrun"][1].splitlines()
            if l.startswith("{")]
    check(len(rows) == len(TOOLS_DRYRUN), "[dryrun] missing cells")
    for r in rows:
        rf = r.get("roofline", {})
        say("dryrun", cell=r["cell"], status=r["status"],
            chips=r.get("chips"), trace_s=r.get("trace_s"),
            argument_bytes=r.get("argument_bytes"),
            temp_bytes=r.get("temp_bytes"),
            bytes_per_device=r.get("bytes_per_device"),
            memory_note=r.get("memory_note"),
            collectives=json.dumps(r.get("detail", {}).get(
                "collectives_by_kind")),
            compute_s=rf.get("compute_s"), memory_s=rf.get("memory_s"),
            collective_s=rf.get("collective_s"), bound=rf.get("bound"),
            useful_flops_ratio=rf.get("useful_flops_ratio"))
        check(r["status"] == "ok", f"[dryrun] {r['cell']}: {r}")
        check(r["argument_bytes"] == TOOLS_DRYRUN_BYTES.get(
            r["cell"], r["argument_bytes"]),
            f"[dryrun] {r['cell']}: argument bytes {r['argument_bytes']}, "
            f"the reference's specs give {TOOLS_DRYRUN_BYTES.get(r['cell'])}")
    q = outs["quickstart"][1]
    s = outs["serve_pim_gemv"][1]
    for line in (q + s).splitlines():
        print(f"  [example] {line}", flush=True)
    check("bit-exact vs numpy" in q, "[examples] quickstart: no bit-exact")
    check("same tokens as without prefix sharing: True" in s,
          "[examples] serve_pim_gemv: prefix drain tokens differ")
    kq = dict(re.findall(r"(K\d) \w+ (\d+)", q.split("kernel launches")[-1]))
    ks = dict(re.findall(r"(K\d)=(\d+)", s.split("kernel launches")[-1]))
    say("examples", quickstart_launches=json.dumps(kq),
        serve_pim_gemv_launches=json.dumps(ks))
    check(int(kq.get("K5", 0)) > 0 and int(kq.get("K3", 0)) > 0,
          f"[examples] quickstart launched {kq}")
    check(all(int(ks.get(k, 0)) > 0 for k in ("K1", "K2", "K3", "K5")),
          f"[examples] serve_pim_gemv launched {ks}")


def tools(dev, laps, dryrun) -> dict:
    """The `[tools]` phase: the port's dry run (`dryrun`, the child
    started after the build), roofline, static analysis, regress record
    and both examples, on the card. Returns the launches of the lint +
    roofline path."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    children = dict(start_children(("quickstart", "serve_pim_gemv")),
                    dryrun=dryrun)
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    qparams = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    pparams = quantize_params(cfg, qparams)[0]
    g3cfg = dataclasses.replace(get_config("gemma3-27b"),
                                n_layers=TOOLS_G3_LAYERS)
    g3params = init_lm(g3cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    torch.cuda.synchronize()
    say("tools", init_s=time.perf_counter() - t0)
    reset_launches()
    tools_lint(dev, qparams, pparams, g3params, g3cfg, cfg)
    del g3params
    torch.cuda.empty_cache()
    laps.lap("tools lint")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        tools_analysis(tmp)
    laps.lap("tools analysis")
    tools_roofline(dev, cfg, qparams, pparams)
    launches = read_launches()
    del qparams, pparams
    torch.cuda.empty_cache()
    tools_train_roofline(dev, cfg)
    laps.lap("tools roofline")
    tools_collect(children)
    laps.lap("tools dryrun and examples")
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--train-example"]:
        return train_example_child(sys.argv[2])
    if sys.argv[1:2] == ["--dryrun-child"]:
        return dryrun_child()
    if sys.argv[1:2] == ["--mellum"]:
        return mellum_only()
    if sys.argv[1:2] == ["--bitplane"]:
        return bitplane_only()
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
    dryrun = start_children(("dryrun",))["dryrun"]
    sass = tensor_core_counts(libs)
    say("sass", **{name: n for name, n in sass.items()})
    for name in TENSOR_CORE_KERNELS:
        check(sass[name] == "unavailable" or sass[name] > 0,
              f"{name}: no tensor-core instruction in its SASS")

    laps = Laps()
    errs = kernel_checks(dev)
    errs["paged_prefill"] = max(errs["paged_prefill"],
                                zoo_kernel_checks(dev),
                                zoo_kernel_checks(dev, LL_H, LL_KV,
                                                  "llava-next-34b"))
    errs.update(bitplane_checks(dev))
    times = kernel_timings(dev)
    gemma3_kernel_timings(dev)
    times.update(bitplane_timings(dev))
    zoo_kernel_timings(dev)
    family_kernel_timings(dev)
    laps.lap("kernel checks and timings")

    cfg = get_config("qwen2-1.5b")
    # the timings' queued work is not init's: wait for it first, and say
    # how long that took
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    queued_s = time.perf_counter() - t0
    modules = len(sys.modules)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    say("init", model=cfg.name, params=n_params,
        seconds=time.perf_counter() - t0, queued_before_s=queued_s,
        modules_imported_by_it=len(sys.modules) - modules)
    by_path = {}
    launches, off_results, off_stats = serve_full_width(cfg, params, dev,
                                                        "bf16")
    by_path["qwen2-1.5b bf16 KV"] = launches
    qwen2_telemetry(cfg, params, dev, off_results, off_stats)
    qwen2_annotations(cfg, params, dev)
    by_path["qwen2-1.5b int8 KV"] = serve_full_width(cfg, params, dev,
                                                     "int8")[0]
    bf16_tokens, by_path["qwen2-1.5b dense bf16"] = qwen2_dense(cfg, params,
                                                                dev)
    by_path["qwen2-1.5b dense batcher"] = qwen2_dense_batcher(cfg, params,
                                                              dev)
    reset_launches()
    qparams, frac, seconds = quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    q_launches = by_path["qwen2-1.5b pim8"] = serve_quantized(
        cfg, qparams, frac, seconds, dev)
    by_path["qwen2-1.5b dense pim8"] = qwen2_dense_quantized(
        cfg, qparams, bf16_tokens, dev)
    launches = dict(launches)
    for name in ("bitplane_gemv", "bitplane_gemm", "bitplane_pack"):
        launches[name] = q_launches[name]
    del qparams
    torch.cuda.empty_cache()
    qwen2_parity(dev)
    qwen2_parity(dev, quantize=True)
    dense_parity(dev)
    laps.lap("qwen2-1.5b")
    ckpt(dev)
    laps.lap("ckpt")

    g3 = gemma3_full_width(dev)
    by_path["gemma3-27b bf16 KV"] = g3["bf16"]
    by_path["gemma3-27b int8 KV"] = g3["int8"]
    by_path["gemma3-27b dense bf16"] = g3["dense"]
    gemma3_parity(dev)
    by_path["gemma3-27b[12L] pim8"] = gemma3_quantized(dev)
    laps.lap("gemma3-27b")
    imagine(dev)
    laps.lap("imagine")
    by_path.update(zoo_full_width(dev, errs))
    laps.lap("zoo")
    zoo_parity(dev)
    laps.lap("zoo parity")
    by_path.update(families(dev, errs, laps))
    by_path["mellum2-12b-a2.5b pim8"] = mellum(dev, errs, times)
    launches["bitplane_grouped"] = by_path["mellum2-12b-a2.5b pim8"][
        "bitplane_grouped"]
    laps.lap("mellum2")
    reset_launches()
    train(dev, laps)
    train_launches = read_launches()
    check(not any(train_launches.values()),
          f"the training path launched a serving kernel: {train_launches}")
    tp_paths = dist(dev, errs, laps)
    by_path.update(tp_paths)
    for path in tp_paths.values():
        for name in ("bitplane_gemv", "bitplane_gemm", "bitplane_pack"):
            launches[name] += path[name]
    by_path["tools lint and roofline"] = tools(dev, laps, dryrun)

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
        "bitplane_grouped": (f"{csrc}/bitplane_grouped.cu",
                             "none: the reference vmaps bitplane_matmul"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_by_path={path: n.get(name, 0)
                              for path, n in by_path.items()}))
    say("done", seconds=time.perf_counter() - started, card=repr(smi))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mellum_only() -> int:
    """`python3 chip_smoke.py --mellum`: the build and the mellum2 phase
    alone."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build()
    say("build", seconds=time.perf_counter() - t0,
        libs=",".join(p.name for p in libs.values()))
    for name in ("bitplane_gemv", "bitplane_grouped"):
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    sass = tensor_core_counts(libs)
    say("sass", **{name: n for name, n in sass.items()})
    errs, times = {}, {}
    launches = mellum(dev, errs, times)
    say("done", k6_max_abs_err=errs["bitplane_grouped"],
        k6_launches=launches["bitplane_grouped"])
    return 0


def bitplane_only() -> int:
    """`python3 chip_smoke.py --bitplane`: the build, the bit-plane checks
    and the bit-plane timings alone."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build()
    say("build", seconds=time.perf_counter() - t0,
        libs=",".join(p.name for p in libs.values()))
    for line in _build.log_path("bitplane_gemv").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas bitplane_gemv: {line.strip()}", flush=True)
    errs = bitplane_checks(dev)
    bitplane_timings(dev)
    say("done", **errs)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
