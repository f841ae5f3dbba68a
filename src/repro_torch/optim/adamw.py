"""AdamW with decoupled weight decay and global-norm clipping:
counterpart of `repro.optim.adamw`.

The state is shaped like the params (m, v in f32), a `NamedTuple` so
that a checkpoint's keys read `step`, `m` and `v` as the reference's
do. The arithmetic is the reference's, in its order: the clip factor
`min(1, max_norm / max(norm, 1e-9))`, the f32 bias corrections from
`b ** step`, `delta = mhat / (sqrt(vhat) + eps)` plus the decay, and
`p - lr * delta` in f32, cast back to the leaf's dtype. Trees are walked
in sorted key order, the order of the reference's leaves, so the norm
sums its terms in the same order.

Two differences, neither of which changes a value:
  * `adamw_update` updates params, m and v IN PLACE (under
    `torch.no_grad()`), the counterpart of the reference's
    `donate_argnums=(0, 1)`: a full-width step holds one copy of the
    training state, not two.
  * The step counter is a 0-dim int32 tensor on the CPU, wherever the
    params live: the schedule's lr and the bias corrections are host
    scalars, so no step reads the card back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _is_decayable(path: str, leaf) -> bool:
    """Decay projection kernels + embeddings; not norms/biases. On the
    stacked `[L, ...]` layer tree a per-layer vector has ndim 2, so it
    is decayed (`attn/bq`, `mamba/A_log`, ...), as in the reference."""
    name = path.split("/")[-1]
    return getattr(leaf, "ndim", 0) >= 2 and not name.startswith(("g", "b_"))


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out[k] = _tree_paths(v, f"{prefix}/{k}" if prefix else k)
        return out
    return prefix


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """`(path, leaf)` of a nested dict in sorted key order (the order
    `jax.tree_util` flattens a dict in), paths joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, x in tree_items(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = _clip_factor(norm, max_norm)
    return tree_map(lambda g: g * factor.to(g.dtype), grads), norm


def adamw_init(params: Params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(
    grads: Params,
    state: AdamWState,
    params: Params,
    cfg: AdamWConfig,
    lr: Optional[torch.Tensor] = None,
    norm: Optional[torch.Tensor] = None,
) -> Tuple[Params, AdamWState, torch.Tensor]:
    """Returns (params, new_state, pre-clip grad norm); `params` and the
    state's m and v are the same tensors, updated in place. The grads
    are clipped in place too. `norm`: the grads' global norm where the
    caller computes it (over the ranks of a mesh), else `global_norm`."""
    gnorm = global_norm(grads) if norm is None else norm
    factor = _clip_factor(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr,
                           dtype=torch.float32)
    stepf = step.float()
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf
    paths = dict(tree_items(_tree_paths(params)))
    g_items = dict(tree_items(grads))
    m_items, v_items = dict(tree_items(state.m)), dict(tree_items(state.v))
    for path, p in tree_items(params):
        g, m, v = g_items[path], m_items[path], v_items[path]
        gf = g.mul_(factor.to(g.dtype)).float()
        m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(gf).mul_(1 - cfg.b2))
        del gf
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        if _is_decayable(paths[path], p):
            delta.add_(p.float() * cfg.weight_decay)
        delta.mul_(lr_t)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p.float() - delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
