"""train_step factory: loss + grad + AdamW, with microbatch accumulation.
Counterpart of `repro.train.step`.

The step is plain eager PyTorch: `torch.autograd.grad` through the
port's model code (no kernel of the serving path runs here — dense
leaves are plain matmuls and `forward` uses the dense attention), then
`adamw_update`, which updates the params and the optimizer state in
place.

Under a mesh (`mesh=`), each rank takes its rows of the global batch
and the step does what XLA inserts for the reference's sharded jit:
the gradients are averaged over the batch axes (`pod`, `data`), so
every rank holds the global batch's mean gradient, and the loss
metrics are global means. The step runs under a sharding context whose
rows are split over those axes (`sharding_rules(rows=)`; the caller's
rules where it has a context), so the MoE routes every rank's rows
together, as the reference routes the global batch: the reduce-scatter
its row gather takes back sums each row's gradient over the ranks, and
the mean over the batch axes divides that sum back. The gradient norm that clipping reads is the
global one: leaves whole on every rank of `model` count once, and the
squared sums of leaves split over `model` (by `param_specs`, the spec
tree of `launch.specs.param_shardings`) are all-reduced over it.

Microbatches under a mesh. The reference's microbatch i is a contiguous
block of the global batch (rows [i B/n, (i+1) B/n)), whatever the
sharding. With `n_microbatches > 1` and rows split over D ranks of the
batch axes, the step first re-lays the rows (one counted all-gather of
the batch over those axes, then a cut): rank r's microbatch i is the
r-th of D equal sub-blocks of the reference's microbatch i. The MoE's
row gather then joins exactly the reference's rows of microbatch i, in
its order, so rows compete for the experts' places as there. A rank's
rows that do not split into `n_microbatches` equal blocks are refused,
as the reference's reshape refuses them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist import collectives
from ..dist.sharding import (
    TRAIN_RULES,
    current_context,
    sharding_rules,
    spec_axes,
)
from ..models import forward, forward_encdec
from ..optim import AdamWConfig, AdamWState, adamw_update
from ..optim.adamw import tree_items
from ..optim.schedule import warmup_cosine
from .loss import softmax_cross_entropy

Batch = Dict[str, torch.Tensor]

#: the loss metrics, summed over microbatches
LOSS_METRICS = ("loss", "nll", "z_loss", "accuracy", "moe_aux")


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch: Batch):
        if cfg.is_encoder_decoder:
            logits, aux = forward_encdec(params, batch["frames"],
                                         batch["tokens"], cfg)
        elif cfg.frontend == "vision_stub":
            logits, aux = forward(
                params, batch["tokens"], cfg, extra_embeds=batch["patches"]
            )
            logits = logits[:, batch["patches"].shape[1]:]
        else:
            logits, aux = forward(params, batch["tokens"], cfg)
        loss, metrics = softmax_cross_entropy(logits, batch["targets"])
        loss = loss + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _unflatten(paths: List[str], leaves: List[Any]) -> Dict:
    tree: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _batch_axes(mesh) -> Tuple[str, ...]:
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names
                 and mesh.shape[a] > 1)


def _mean_over(tensors, axes, mesh):
    """Each tensor averaged over the ranks along `axes`, in place."""
    n = mesh.axis_size(axes)
    for t in tensors:
        collectives.all_reduce(t, axes, mesh, inplace=True).div_(n)
    return tensors


def _global_norm(paths, grads, mesh, param_specs) -> torch.Tensor:
    """sqrt of the global sum of squares: the whole leaves' once, the
    `model`-split leaves' summed over ``model``."""
    split = {p for p, spec in tree_items(param_specs)
             if any("model" in spec_axes(e) for e in spec)}
    whole = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    parts = torch.zeros_like(whole)
    for path, g in zip(paths, grads):
        sq = torch.sum(torch.square(g.float()))
        if path in split:
            parts = parts + sq
        else:
            whole = whole + sq
    return torch.sqrt(whole + collectives.all_reduce(parts, "model", mesh))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    n_microbatches: int = 1,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    mesh=None,
    param_specs=None,
) -> Callable:
    """`mesh`: the mesh the ranks run on (see the module docstring); with
    a ``model`` axis of more than one rank, `param_specs` says which
    leaves are split over it."""
    loss_fn = make_loss_fn(cfg)
    batch_axes = _batch_axes(mesh)
    split_model = (mesh is not None and "model" in mesh.axis_names
                   and mesh.shape["model"] > 1)
    if split_model and param_specs is None:
        raise ValueError("make_train_step: a mesh with a model axis needs "
                         "param_specs (launch.specs.param_shardings)")
    # NOTE: warmup_steps is deliberately NOT derived from total_steps —
    # lr(step) must be a function of the step index alone so a run that
    # crashes and resumes under a different total_steps replays the exact
    # schedule (the bit-exact recovery property of DESIGN.md §7).

    def rows_split():
        if not batch_axes:
            return contextlib.nullcontext()
        ctx = current_context()
        return sharding_rules(mesh, TRAIN_RULES if ctx is None else ctx.rules,
                              rows=batch_axes)

    def value_and_grad(params, leaves, batch):
        for p in leaves:
            p.requires_grad_(True)
        try:
            with rows_split():
                loss, metrics = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a leaf the loss never reads (zamba2's shared block in a stack
        # with no full group) gets zeros, as under `jax.grad`
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def relay(batch: Batch) -> Batch:
        """This rank's rows re-laid so that its microbatch i is its block
        of the reference's global microbatch i (module docstring)."""
        d, r = mesh.axis_size(batch_axes), mesh.axis_index(batch_axes)
        out = {}
        for k, x in batch.items():
            per = x.shape[0] // n_microbatches
            whole = collectives.all_gather(x, batch_axes, 0, mesh)
            out[k] = whole.reshape((n_microbatches, d, per)
                                   + tuple(x.shape[1:]))[:, r].reshape(
                                       x.shape)
        return out

    def split_micro(batch: Batch) -> List[Batch]:
        for k, x in batch.items():
            if x.shape[0] % n_microbatches:
                raise ValueError(
                    f"make_train_step: {x.shape[0]} rows of {k!r} do not "
                    f"split into {n_microbatches} microbatches")
        if batch_axes:
            batch = relay(batch)
        return [
            {k: x.reshape((n_microbatches, x.shape[0] // n_microbatches)
                          + tuple(x.shape[1:]))[i] for k, x in batch.items()}
            for i in range(n_microbatches)
        ]

    def train_step(
        params, opt_state: AdamWState, batch: Batch
    ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        paths, leaves = zip(*tree_items(params))
        if n_microbatches > 1:
            grads, metrics = None, None
            for mb in split_micro(batch):
                m, g = value_and_grad(params, leaves, mb)
                if grads is None:
                    # f32 accumulators (0 + g is g exactly)
                    grads = [x.float() for x in g]
                    metrics = {k: m[k].float() for k in LOSS_METRICS}
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                    metrics = {k: metrics[k] + m[k] for k in LOSS_METRICS}
                del g
            grads = [g.div_(n_microbatches) for g in grads]
            metrics = {k: v / n_microbatches for k, v in metrics.items()}
        else:
            metrics, grads = value_and_grad(params, leaves, batch)

        norm = None
        if batch_axes:
            grads = _mean_over(grads, batch_axes, mesh)
            names = list(metrics)
            stacked = torch.stack([metrics[k].float() for k in names])
            stacked = _mean_over([stacked], batch_axes, mesh)[0]
            metrics = {k: stacked[i] for i, k in enumerate(names)}
        if split_model:
            norm = _global_norm(paths, grads, mesh, param_specs)
        lr = warmup_cosine(opt_state.step, opt_cfg.lr, warmup_steps,
                           total_steps)
        params2, opt_state2, gnorm = adamw_update(
            _unflatten(paths, grads), opt_state, params, opt_cfg, lr=lr,
            norm=norm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params2, opt_state2, metrics

    return train_step
