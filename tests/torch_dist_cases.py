"""What each rank runs in the multi-rank tests (`repro_torch.dist.spawn`
imports this module in every rank process). Each function returns
plain CPU tensors or numbers, which the test compares."""

import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.reduction import (
    SCHEDULES,
    collective_bytes_per_device,
    make_sharded_allreduce,
    reduce_to_zero_binary_hopping,
)
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    SERVE_RULES,
    gather_tree,
    local_block,
    place_tree,
    sharding_rules,
)
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh


def collectives_rank(inputs):
    """The reduction schedules, `reduce_to_zero_binary_hopping` and
    `compressed_psum` on one axis of every rank (8 in the tests)."""
    from repro_torch.optim.compress import compressed_psum, shared_codes

    mesh = Mesh((8,), ("x",))
    out = {"schedules": {}, "bytes": {}, "model_bytes": {}}
    for case, whole in inputs["schedules"].items():
        x = local_block(torch.from_numpy(whole), ("x",), mesh)
        for name in SCHEDULES:
            collectives.reset_counts()
            y = make_sharded_allreduce(mesh, "x", name)(x)
            counts = collectives.read_counts()
            out["schedules"][(case, name)] = y
            moved = sum(counts[k]["bytes"] for k in (
                "ppermute", "all_reduce", "reduce_scatter", "all_gather"))
            out["bytes"][(case, name)] = moved
            out["model_bytes"][(case, name)] = collective_bytes_per_device(
                name, x.numel() * x.element_size(), 8)
    west = local_block(torch.from_numpy(inputs["west"]), ("x",), mesh)
    out["west"] = reduce_to_zero_binary_hopping(west, "x", mesh)
    g = local_block(torch.from_numpy(inputs["grads"]), ("x",), mesh)
    q, scale = shared_codes(g, "x", mesh)
    mean, residual = compressed_psum({"w": g}, {"w": torch.zeros_like(g)},
                                     "x", mesh)
    out.update(codes=q, scale=scale, mean=mean["w"],
               residual=residual["w"])
    return out


# ---------------------------------------------------------------------------
# tensor- and data-parallel model runs
# ---------------------------------------------------------------------------

def _cfg(arch, dtype, **overrides):
    return dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                               **overrides)


def _tp_case(params, arch, dtype, mesh, tokens, cache_len, new_tokens,
             overrides=None):
    """forward, prefill and greedy decode_step on this rank's blocks."""
    from repro_torch.models import decode_step, forward, prefill

    cfg = _cfg(arch, dtype, **(overrides or {}))
    local = place_tree(params, specs.param_shardings(params, mesh), mesh)
    rows = specs.batch_rows(mesh, tokens.shape[0])
    toks = local_block(tokens, specs._spec(rows), mesh)
    collectives.reset_counts()
    with torch.no_grad(), sharding_rules(mesh, SERVE_RULES, rows=rows):
        logits, _ = forward(local, toks, cfg)
        out, cache = prefill(local, toks, cfg, cache_len)
        greedy = [out[:, -1].float().argmax(-1)]
        for _ in range(new_tokens - 1):
            out, cache = decode_step(local, greedy[-1][:, None], cache, cfg)
            greedy.append(out[:, -1].float().argmax(-1))
    return {"logits": logits.float(), "tokens": torch.stack(greedy, 1),
            "cache_k_shape": tuple(cache["k"].shape),
            "counts": collectives.read_counts()}


def tp_rank(cases, mesh_shape):
    """Each (name -> params, arch, dtype, tokens, config overrides) case
    on a (data, model) mesh of every rank."""
    mesh = Mesh(mesh_shape, ("data", "model"))
    return {name: _tp_case(p, arch, dt, mesh, toks, 24, 6, over)
            for name, (p, arch, dt, toks, over) in cases.items()}


def dp_rank(params, arch, dtype, batch, lr, steps, warmup):
    """`steps` `make_train_step` steps on this rank's rows of the batch,
    on a (data,) mesh of every rank."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    world = torch.distributed.get_world_size()
    mesh = Mesh((world,), ("data",))
    cfg = _cfg(arch, dtype)
    local = {k: local_block(v, ("data",), mesh) for k, v in batch.items()}
    step = make_train_step(cfg, AdamWConfig(lr=lr), warmup_steps=warmup,
                           mesh=mesh)
    p, opt = params, adamw_init(params)
    for _ in range(steps):
        p, opt, metrics = step(p, opt, local)
    return {"params": p, "metrics": {k: float(v) for k, v in metrics.items()}}


def tp_train_rank(cases, lr, steps, mesh_shape=(1, 4), n_microbatches=1):
    """`steps` tensor-parallel `make_train_step` steps on a (data, model)
    mesh (name -> f32 masters, arch, config overrides, batch), with
    `n_microbatches` microbatches: each rank trains its blocks on its rows
    of the batch; the whole params gathered back, and the metrics."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    mesh = Mesh(mesh_shape, ("data", "model"))
    out = {}
    for name, (params, arch, over, batch) in cases.items():
        cfg = _cfg(arch, "float32", **over)
        p_specs = specs.param_shardings(params, mesh)
        p = place_tree(params, p_specs, mesh)
        rows = specs.batch_rows(mesh, batch["tokens"].shape[0])
        mine = {k: local_block(v, specs._spec(rows), mesh)
                for k, v in batch.items()}
        step = make_train_step(cfg, AdamWConfig(lr=lr), warmup_steps=0,
                               n_microbatches=n_microbatches, mesh=mesh,
                               param_specs=p_specs)
        opt = adamw_init(p)
        with sharding_rules(mesh):   # the step says how rows are split
            for _ in range(steps):
                p, opt, metrics = step(p, opt, mine)
        out[name] = {"params": gather_tree(p, p_specs, mesh),
                     "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def trainer_rank(params, arch, data_cfg, ckpt_dir, steps):
    """`Trainer(mesh=, batch_spec=)` for `steps` steps on a (data,) mesh of
    every rank, then a second Trainer on the same directory, which
    resumes."""
    from repro_torch.train import Trainer, TrainerConfig

    world = torch.distributed.get_world_size()
    mesh = Mesh((world,), ("data",))
    cfg = get_config(arch, smoke=True)
    tc = TrainerConfig(total_steps=steps, ckpt_every=2, log_every=1,
                       async_ckpt=False)
    tr = Trainer(cfg, params, data_cfg, ckpt_dir, trainer_cfg=tc, mesh=mesh,
                 batch_spec=("data",), device="cpu")
    log = tr.run()
    again = Trainer(cfg, {k: v for k, v in params.items()}, data_cfg,
                    ckpt_dir, trainer_cfg=tc, mesh=mesh,
                    batch_spec=("data",), device="cpu")
    return {"log": log, "params": tr.params, "resumed_at": again.start_step}


def elastic_rank(w, ckpt_dir):
    """Save a leaf held in blocks on (8,), and a bf16 leaf of `w / 3`
    beside it, rank 0 writing the whole; restore each onto (4, 2) with
    the specs swapped."""
    from repro_torch.ckpt import CheckpointManager

    mesh8 = Mesh((8,), ("data",))
    tree = {"w": w, "wb": (w / 3).to(torch.bfloat16)}
    specs8 = {k: ("data",) for k in tree}
    blocks = {k: local_block(v, ("data",), mesh8).clone()
              for k, v in tree.items()}
    whole = gather_tree(blocks, specs8, mesh8)
    mgr = CheckpointManager(ckpt_dir)
    if mesh8.rank == 0:
        mgr.save(1, whole)
    collectives.barrier(mesh8)
    mesh42 = Mesh((4, 2), ("data", "model"))
    out = {"rank": mesh42.rank}
    for key, name in (("w", "block"), ("wb", "block_bf16")):
        target = {key: torch.empty(w.shape, dtype=tree[key].dtype,
                                   device="meta")}
        r4, step = mgr.restore(target, shardings={key: ("model", "data")},
                               mesh=mesh42, device="cpu")
        out[name], out["step"] = r4[key], step
    return out


def world8(tp_cases, dp_args, ckpt_dir, w):
    """Everything the 8-rank world runs: TP on (2, 4), DP steps on (8,)
    (one per compute dtype), the elastic save and restore."""
    return {"tp": tp_rank(tp_cases, (2, 4)),
            "dp": {args[2]: dp_rank(*args) for args in dp_args},
            "elastic": elastic_rank(w, ckpt_dir)}


def world4(tp_cases, trainer_args, tp_train_args):
    """Everything the 4-rank world runs: TP on (1, 4), TP training on
    (1, 4), the Trainer on (4,)."""
    from repro_torch.launch.mesh import make_debug_mesh

    debug = make_debug_mesh(n_model=2)
    return {"tp": tp_rank(tp_cases, (1, 4)),
            "tp_train": tp_train_rank(*tp_train_args),
            "trainer": trainer_rank(*trainer_args),
            "debug_mesh": (debug.shape, debug.coords,
                           debug.ranks("model"), debug.ranks("data"))}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_gpu.py): ranks share the card over gloo
# ---------------------------------------------------------------------------

def card_collectives_rank():
    """all_gather, reduce_scatter, ppermute and all_reduce of CUDA tensors
    (the first three staged through host memory), returned on the host."""
    mesh = Mesh((2,), ("x",))
    r = mesh.rank
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * r
    collectives.reset_counts()
    out = {"all_gather": collectives.all_gather(x, "x", 0, mesh),
           "reduce_scatter": collectives.reduce_scatter(x, "x", 0, mesh),
           "ppermute": collectives.ppermute(x, "x", [(0, 1), (1, 0)], mesh),
           "all_reduce": collectives.all_reduce(x, "x", mesh)}
    out = {k: v.cpu() for k, v in out.items()}
    out["staged"] = collectives.read_counts()["staged"]["calls"]
    return out


def card_tp_rank(params, arch, tokens, cache_len, new_tokens):
    """f32 TP = 2 on the card: prefill logits and greedy tokens of this
    rank's blocks, and the bit-plane launches they made."""
    from repro_torch.kernels import bitplane_gemm, bitplane_gemv

    mesh = Mesh((1, 2), ("data", "model"))
    card = _to_card(params)
    before = (bitplane_gemv.LAUNCHES, bitplane_gemm.LAUNCHES)
    r = _tp_case(card, arch, "float32", mesh, tokens.cuda(), cache_len,
                 new_tokens)
    return {"logits": r["logits"].cpu(), "tokens": r["tokens"].cpu(),
            "k3": bitplane_gemv.LAUNCHES - before[0],
            "k4": bitplane_gemm.LAUNCHES - before[1]}


def _to_card(tree):
    from repro_torch.quant.bitplane import PimWeight
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, PimWeight):
        return PimWeight(tree.planes.cuda(), tree.scale.cuda(), tree.n_bits,
                         tree.group)
    return tree.cuda()


# ---------------------------------------------------------------------------
# the MoE, recurrent and encoder-decoder stacks (test_torch_dist_families.py)
# ---------------------------------------------------------------------------

#: the cache leaves a family's test holds against the one-rank cache cut
#: by `cache_shardings`
FAMILY_CACHE_KEYS = ("ssm", "conv", "C", "n", "m", "sc", "sn", "sm", "sh",
                     "xk", "xv", "k", "v", "shared_k", "shared_v")


def _family_case(params, arch, dtype, mesh, tokens, frames, cache_len,
                 new_tokens, overrides=None):
    """forward (or forward_encdec), prefill and greedy decode on this
    rank's blocks and rows; the cache leaves after prefill; the MoE's
    load-balance sum."""
    from repro_torch.models import (decode_step, decode_step_encdec, forward,
                                    forward_encdec, prefill, prefill_encdec)

    cfg = _cfg(arch, dtype, **(overrides or {}))
    local = place_tree(params, specs.param_shardings(params, mesh), mesh)
    rows = specs.batch_rows(mesh, tokens.shape[0])
    toks = local_block(tokens, specs._spec(rows), mesh)
    collectives.reset_counts()
    with torch.no_grad(), sharding_rules(mesh, SERVE_RULES, rows=rows):
        if cfg.is_encoder_decoder:
            fr = local_block(frames, specs._spec(rows), mesh)
            logits, aux = forward_encdec(local, fr, toks, cfg)
            out, cache = prefill_encdec(local, fr, toks, cfg, cache_len)
        else:
            logits, aux = forward(local, toks, cfg)
            out, cache = prefill(local, toks, cfg, cache_len)
        kept = {k: cache[k].clone() for k in FAMILY_CACHE_KEYS if k in cache}
        greedy = [out[:, -1].float().argmax(-1)]
        for _ in range(new_tokens - 1):
            tok = greedy[-1][:, None]
            out, cache = (decode_step_encdec(local, tok, cache, cfg)
                          if cfg.is_encoder_decoder
                          else decode_step(local, tok, cache, cfg))
            greedy.append(out[:, -1].float().argmax(-1))
    return {"logits": logits.float(), "moe_aux": float(aux["moe_aux"]),
            "tokens": torch.stack(greedy, 1), "cache": kept,
            "counts": collectives.read_counts()}


def moe_rows_case(params, x, top_k, capacity_factor, mesh):
    """One MoE layer on this rank's rows of `x` under the mesh: its rows
    of the output and the (global) load-balance loss and dropped
    fraction."""
    from repro_torch.models.moe import moe_forward

    rows = specs.batch_rows(mesh, x.shape[0])
    with torch.no_grad(), sharding_rules(mesh, SERVE_RULES, rows=rows):
        y, aux = moe_forward(params, local_block(x, specs._spec(rows), mesh),
                             top_k=top_k, capacity_factor=capacity_factor)
    return {"y": y, **{k: float(v) for k, v in aux.items()}}


def families_rank(cases, mesh_shape, moe_rows=None, train=None):
    """Each (name -> params, arch, dtype, tokens, frames, overrides) case
    on a (data, model) mesh of every rank; the MoE layer on the rows of
    the batch, on that mesh and, in a world of 8, on a (pod, data, model)
    = (2, 2, 2) mesh; tensor-parallel training (mesh name ->
    `tp_train_rank`'s arguments)."""
    mesh = Mesh(mesh_shape, ("data", "model"))
    out = {"cases": {
        name: _family_case(p, arch, dt, mesh, toks, frames, 24, 6, over)
        for name, (p, arch, dt, toks, frames, over) in cases.items()}}
    if moe_rows is not None:
        out["moe_rows"] = moe_rows_case(*moe_rows, mesh)
        if mesh.size == 8:
            out["moe_rows_pod"] = moe_rows_case(
                *moe_rows, Mesh((2, 2, 2), ("pod", "data", "model")))
            # 3 rows do not divide over data: every rank holds them all
            layer, x, *rest = moe_rows
            out["moe_rows_whole"] = moe_rows_case(layer, x[:3], *rest, mesh)
    if train is not None:
        out["train"] = {k: tp_train_rank(*a) for k, a in train.items()}
    return out
