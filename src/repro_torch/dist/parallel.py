"""Tensor-parallel compute on each rank's stored blocks.

Each rank holds the blocks `launch.specs.param_shardings` gives it
(`sharding.place_tree`) and runs the model on local tensors. Under a
context whose mesh splits over ``model`` (`sharding.tensor_parallel`):

  * the residual stream is held whole on every rank (so the gradient of
    a gathered value is identical on every rank, and the gather's
    backward takes this rank's block of it);
  * a column-parallel projection (`wq`, `wk`, `wv`, `w_gate`, `w_up`,
    `lm_head`, and the `planes` / `scale` of such a `PimWeight`) gives
    this rank's output columns; its input enters through
    `collectives.enter`, whose gradient is all-reduced;
  * a row-parallel projection (`wo`, `w_down`) takes this rank's input
    rows and gives a partial sum, all-reduced over ``model``
    (`row_linear`);
  * any other split is gathered before use, and counted: `embed`, split
    on its last dimension, d_model (the reference's `_leaf_spec`), gives
    each rank a block of every token's features, which the embed hook
    gathers; a column block that cuts a head is gathered at the heads
    hook; a row-parallel weight's stacked `scale [L, M]`, split on its
    layer dimension, is gathered once per call (`gather_layer_split`).

Outside such a context every function here returns its input, so a
single-rank run takes the plain code path.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..quant.bitplane import PimWeight, pim_linear
from . import collectives
from .sharding import shard, tensor_parallel


def enter(x: torch.Tensor) -> torch.Tensor:
    """A whole activation entering column-parallel products."""
    if tensor_parallel() is None:
        return x
    return collectives.enter(x, "model")


def local_columns(bias: torch.Tensor, width: int) -> torch.Tensor:
    """A bias held whole (the reference replicates 1-D leaves) cut to the
    `width` output columns this rank computes (its gradient gathered
    back to the whole)."""
    if bias.shape[-1] == width:
        return bias
    return collectives.scatter(bias, "model", -1)


def split_dim(y: torch.Tensor, full: int, dim: int = -1):
    """`dim` when `y` holds a block of a `full`-wide dimension, else None."""
    return dim if y.shape[dim] < full else None


def shard_heads(y: torch.Tensor, n: int, hd: int, name: str) -> torch.Tensor:
    """A projection's [B, T, n*hd] output (or this rank's column block of
    it) as [B, T, heads, hd] in the layout `name` ("heads" /
    "kv_heads") resolves to. A block that cuts a head is gathered
    first."""
    b, t, width = y.shape
    split = width < n * hd
    if split and width % hd:
        y, split = shard(y, None, None, None, src_dim=2), False
    return shard(y.reshape(b, t, -1, hd), "batch", "seq", name, "head_dim",
                 src_dim=2 if split else None)


def kv_for_heads(q_heads: int, n_heads: int, n_kv: int, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads [B, S, KV', hd] that this rank's `q_heads` query
    heads read, in GQA layout. With the queries whole, or K/V split like
    them, that is `k`, `v`. With K/V held whole and the queries split,
    the block of query heads reads a range of whole groups (kept
    grouped), or lies inside one group (that one head), or else each
    query head gets its own copy of its K/V head."""
    if q_heads == n_heads or k.shape[2] < n_kv:
        return k, v
    # each rank reads its own heads of the whole K/V: their gradients are
    # partial, and summed over the ranks
    k, v = collectives.enter(k, "model"), collectives.enter(v, "model")
    g = n_heads // n_kv
    h0 = tensor_parallel().mesh.axis_index("model") * q_heads
    lo, hi = h0 // g, (h0 + q_heads - 1) // g + 1
    if (h0 % g == 0 and q_heads % g == 0) or hi - lo == 1:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    ids = torch.div(torch.arange(h0, h0 + q_heads, device=k.device), g,
                    rounding_mode="floor")
    return k[:, :, ids], v[:, :, ids]


def _rows(w: Any) -> int:
    return w.shape[0] if isinstance(w, PimWeight) else w.shape[-2]


def row_linear(x: torch.Tensor, w: Any, k_full: int,
               impl: str = "auto") -> torch.Tensor:
    """`x @ w` for a row-parallel weight that may hold a block of its
    `k_full` input rows: `x` is the whole input or the same block; the
    partial sums are all-reduced over ``model``."""
    if tensor_parallel() is None or _rows(w) == k_full:
        return pim_linear(x, w, impl)
    if x.shape[-1] == k_full:
        x = collectives.scatter(x, "model", -1)
    return collectives.reduce_partial(pim_linear(x, w, impl), "model")


def gather_layer_split(params: Any, n_layers: int) -> Any:
    """The tree with every row-parallel `PimWeight` whose stacked scale
    holds a block of the layers (the reference's layer split of `scale
    [L, M]`) given its whole scale back: each layer's product needs its
    own layer's scale."""
    if tensor_parallel() is None:
        return params
    if isinstance(params, dict):
        return {k: gather_layer_split(v, n_layers) for k, v in params.items()}
    if isinstance(params, PimWeight) and params.scale.dim() >= 2 \
            and params.scale.shape[0] < n_layers:
        return PimWeight(params.planes,
                         collectives.gather(params.scale, "model", 0),
                         params.n_bits, params.group)
    return params


def whole_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The entry points' logits, whole on every rank: a vocab block (the
    logits hook's layout under a split `lm_head`) is gathered."""
    if logits.shape[-1] == vocab:
        return logits
    return collectives.gather(logits, "model", logits.dim() - 1)
