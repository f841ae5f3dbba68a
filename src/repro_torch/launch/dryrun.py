"""Multi-pod dry run: counterpart of `repro.launch.dryrun`.

Per cell (arch x shape x mesh) this module:
  1. joins a fake world of 256 or 512 ranks as rank 0
     (`torch.distributed`'s "fake" backend, `FakeStore`): collectives
     are accepted and move nothing, and `make_production_mesh` builds its
     groups over that world;
  2. builds the parameters, optimizer state, cache and batch on the
     `meta` device (`launch.specs`: shapes only, nothing allocated) and
     cuts them to rank 0's blocks by the cell's specs, each block a
     tensor of its own (a view would carry the whole tensor's storage
     into the memory count);
  3. runs the step — `train.make_train_step`, `models.prefill` or
     `models.decode_step` (their encoder-decoder forms for whisper) —
     on those blocks under `sharding_rules(mesh, TRAIN_RULES |
     SERVE_RULES)`, with the plain kernels (`resolve_impl` sends a
     non-CUDA device to `ref`), counting it as `launch.roofline` does;
  4. records the per-rank bytes, the collectives by kind and the
     roofline terms at `H100_SXM`, and emits a JSON artifact.

The reference lowers and compiles each cell; the port has no compiler,
so `lower_s` / `compile_s` become `trace_s`, the seconds the step took
to run on shapes. Shape errors, sharding mismatches and refusals surface
there as they would at compile time.

Meta tensors, not `FakeTensorMode`. Both propagate shapes without
storage. A fake tensor's every op passes through Python (its dispatch
cache and output wrapping), which made a `train_4k` step several times
slower under the counting and memory modes this dry run also runs. On
meta tensors, matmuls and views are C++, but elementwise ops go through
PyTorch's Python reference meta kernels (`torch._prims_common`): about
a millisecond an op, so a step costs what it dispatches. The models'
loops over positions, blocks and chunks are `models.scan`s, which on
meta run four of their alike steps and account exactly for the others
(FLOPs, memory; see that module), so a cell's cost no longer grows with
its sequence length. The step counter of the optimizer stays a real CPU
tensor, as in training: the schedule reads it on the host.

Per-rank bytes. `bytes_per_device` is the bytes of the rank's argument
blocks (params, optimizer state, cache, batch) plus the peak of
`torch.distributed._tools.mem_tracker.MemTracker` over the step (its
`Total` over every device). Where `MemTracker` cannot be imported or
fails during the step, `temp_bytes` is `null`, `memory_note` says why,
and `bytes_per_device` holds the argument bytes alone: nothing is
estimated in its place.

Every stack runs tensor-parallel (`dist.parallel`): dense attention,
MoE, recurrent and encoder-decoder stacks alike, so every applicable
cell ends `ok` or fails. The rows of the batch are split over the batch
axes where the global batch divides over them (the token and batch
specs), and the sharding context says so (`sharding_rules(rows=)`):
the MoE routes the step's global rows, as the reference does.

The world is torn down after each cell, so no later code sees it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..dist.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    place_tree,
    sharding_rules,
)
from ..models import decode_step, prefill
from ..models.encdec import decode_step_encdec, prefill_encdec
from ..optim import AdamWConfig
from ..quant.bitplane import PimWeight
from ..train.step import make_train_step
from . import specs as S
from .mesh import make_production_mesh, mesh_chips
from .roofline import (
    analytic_bytes_for_cell,
    count_step,
    model_flops_for_cell,
    terms_from_count,
)


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake world of `world_size` ranks, torn
    down on exit. Refuses to start inside another world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process with no world of "
                           "its own; one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree):
    """Every tensor of a tree of dicts, tuples (an `AdamWState` too) and
    `PimWeight`s."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, PimWeight):
        yield tree.planes
        yield tree.scale


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               n_microbatches: int = 2, quantized: bool = False):
    """`(step, args)`: a zero-argument callable running rank 0's step on
    its blocks, and the list of those blocks (params, optimizer state,
    batch or cache and tokens). Run it under `sharding_rules(mesh,
    ...)`."""
    params_shapes = S.abstract_params(
        cfg, quantized=quantized and shape.kind != "train")
    rules = TRAIN_RULES if shape.kind == "train" else SERVE_RULES
    p_specs = S.param_shardings(params_shapes, mesh, rules)
    params = place_tree(params_shapes, p_specs, mesh)

    if shape.kind == "train":
        opt = S.abstract_opt_state(params)
        batch_shapes, b_specs = S.train_batch_specs(cfg, shape, mesh)
        batch = place_tree(batch_shapes, b_specs, mesh)
        split_model = mesh.shape.get("model", 1) > 1
        step = make_train_step(cfg, AdamWConfig(),
                               n_microbatches=n_microbatches, mesh=mesh,
                               param_specs=p_specs if split_model else None)
        return (lambda: step(params, opt, batch)), [params, opt, batch]

    tok_shapes, tok_spec = (
        S.prefill_token_specs(cfg, shape, mesh) if shape.kind == "prefill"
        else S.decode_token_spec(shape, mesh))
    tokens = place_tree(tok_shapes, tok_spec, mesh)
    rows = tokens.shape[0]
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            frames = torch.empty((rows, shape.seq_len, cfg.d_model),
                                 device=S.META)
            return (lambda: prefill_encdec(params, frames, tokens, cfg,
                                           shape.seq_len)), \
                [params, tokens, frames]
        if cfg.frontend == "vision_stub":
            nf = cfg.frontend_tokens
            tokens = tokens[:, : shape.seq_len - nf]
            patches = torch.empty((rows, nf, cfg.d_model), device=S.META)
            return (lambda: prefill(params, tokens, cfg, shape.seq_len,
                                    extra_embeds=patches)), \
                [params, tokens, patches]
        return (lambda: prefill(params, tokens, cfg, shape.seq_len)), \
            [params, tokens]

    cache_shapes = S.abstract_cache(cfg, shape)
    c_specs = S.cache_shardings(cache_shapes, cfg, shape, mesh)
    cache = {k: place_tree(v, c_specs[k], mesh)
             if isinstance(v, torch.Tensor) else v
             for k, v in cache_shapes.items()}
    stepper = decode_step_encdec if cfg.is_encoder_decoder else decode_step
    return (lambda: stepper(params, tokens, cache, cfg)), \
        [params, tokens, cache]


def _tracker():
    """A `MemTracker`, or `(None, why)` where it cannot be imported."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except Exception as e:  # an older torch has no _tools.mem_tracker
        return None, f"MemTracker unavailable: {type(e).__name__}: {e}"
    return MemTracker(), None


def _total(tracker, which: str) -> int:
    snap = tracker.get_tracker_snapshot(which)
    return int(sum(per_dev["Total"] for per_dev in snap.values()))


def _run(step, args):
    """`(count, temp_bytes, note)` of one counted run of `step`: the
    peak `MemTracker` total above the argument blocks (registered as
    external before the run), or None with the reason it is missing."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except Exception as e:  # an older torch has no _tools.mem_tracker
        note = f"MemTracker unavailable: {type(e).__name__}: {e}"
        return count_step(step)[1], None, note
    tracker = MemTracker()
    tracker.track_external(*[t for a in args for t in _tensors(a)])
    before = _total(tracker, "current")
    try:
        with tracker:
            count = count_step(step)[1]
    except Exception as e:
        note = f"MemTracker failed: {type(e).__name__}: {e}"
        return count_step(step)[1], None, note
    return count, _total(tracker, "peak") - before, None


def run_cell(
    arch: str, shape_name, multi_pod: bool, out_dir: Optional[str] = None,
    quantized: bool = False,
) -> Dict:
    """One cell. `shape_name`: a name of `SHAPES`, or a `ShapeConfig` of
    its own (a cell cut shorter than the assigned shapes)."""
    cfg = get_config(arch)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    ok, why = shape_applicable(cfg, shape)
    cell = f"{arch}|{shape_name}|{'multi' if multi_pod else 'single'}"
    if not ok:
        return {"cell": cell, "status": "skipped", "reason": why}
    if quantized:
        cell += "|pim-quantized"
    rules = TRAIN_RULES if shape.kind == "train" else SERVE_RULES
    base = {"cell": cell, "arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single"}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        base["chips"] = mesh_chips(mesh)
        grad = (contextlib.nullcontext() if shape.kind == "train"
                else torch.no_grad())
        rows = S.batch_rows(mesh, shape.global_batch)
        t0 = time.perf_counter()
        with grad, sharding_rules(mesh, rules, rows=rows):
            step, args = build_step(cfg, shape, mesh, quantized=quantized)
            count, temp, note = _run(step, args)
        trace_s = time.perf_counter() - t0
        arg_bytes = sum(t.numel() * t.element_size()
                        for a in args for t in _tensors(a))
        params_shapes = S.abstract_params(
            cfg, quantized=quantized and shape.kind != "train")
        mf = model_flops_for_cell(cfg, shape, params_shapes)
        ab = analytic_bytes_for_cell(cfg, shape, params_shapes)
        memory = {"argument_size_in_bytes": arg_bytes,
                  "temp_size_in_bytes": temp}
        terms, detail = terms_from_count(
            cell, count, mesh_chips(mesh), mf, analytic_bytes=ab,
            memory_analysis=memory,
            bytes_per_device=arg_bytes + (temp or 0))
    result = dict(
        base, status="ok", trace_s=round(trace_s, 2),
        argument_bytes=arg_bytes, temp_bytes=temp,
        bytes_per_device=arg_bytes + (temp or 0),
        roofline=terms.as_dict(), detail=detail)
    if note:
        result["memory_note"] = note
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = cell.replace("|", "__").replace(".", "_") + ".json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    r = run_cell(arch, shape_name, mp, args.out)
                    if r["status"] == "ok":
                        rf = r["roofline"]
                        print(
                            f"[OK] {r['cell']:55s} trace={r['trace_s']:7.1f}s "
                            f"bound={rf['bound']:10s} "
                            f"c/m/k={rf['compute_s']:.2e}/{rf['memory_s']:.2e}/"
                            f"{rf['collective_s']:.2e}s "
                            f"useful={rf['useful_flops_ratio']:.2f} "
                            f"bytes/rank={r['bytes_per_device']}",
                            flush=True,
                        )
                    else:
                        print(f"[SKIP] {r['cell']:54s} {r['reason']}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {arch}|{shape_name}|{mp}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
