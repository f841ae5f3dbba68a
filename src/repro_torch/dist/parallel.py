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
    layer dimension, is gathered once per call, and an unstacked
    column-parallel weight's whole 1-D scale is cut to its columns
    (`pim_scales`).

The recurrent and MoE stacks follow the same design. Their whole
weights (Mamba2's, the sLSTM's, the mLSTM's `wf` / `wog`, the router
and the expert stacks: the reference's rules split none of them) are
computed whole on every rank. A column-parallel product whose output
such a block reads whole (the mLSTM's `wq`, `wk`, `wv`, `wi`) is
computed on this rank's columns and gathered (`whole_linear`). A
recurrent state the cache holds in blocks (`sharding.STATE_DIMS`) is
gathered before a decode step reads it (`gather_state`), and each
rank writes back its block (`state_block`). The MoE routes every rank's
rows of the batch together, as the reference routes the step's global
batch: the rows are gathered over the batch axes before dispatch
(`collectives.gather_apart`) and each rank keeps its own.

Outside such a context every function here returns its input, so a
single-rank run takes the plain code path.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..quant.bitplane import PimWeight, pim_linear
from . import collectives
from .sharding import current_context, shard, tensor_parallel


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


def whole_linear(x: torch.Tensor, w: Any, full: int,
                 impl: str = "auto") -> torch.Tensor:
    """`x @ w`, whole on every rank, for a column-parallel weight that may
    hold a block of its `full` output columns: this rank's columns,
    gathered. A whole weight is a plain product of the whole `x` (its
    gradient the same on every rank, so `x` does not enter)."""
    if tensor_parallel() is None or w.shape[-1] == full:
        return pim_linear(x, w, impl)
    return collectives.gather(pim_linear(enter(x), w, impl), "model", -1)


def _split_dim(held: Sequence[int], whole: Sequence[int]) -> Optional[int]:
    return next((d for d, (a, b) in enumerate(zip(held, whole)) if a != b),
                None)


def gather_state(held: torch.Tensor, whole: Sequence[int]) -> torch.Tensor:
    """A recurrent state of shape `whole` from this rank's stored block
    `held` of it: the dimension where the two differ is all-gathered
    over ``model`` (a whole `held` is returned as it is)."""
    d = _split_dim(held.shape, whole)
    return held if d is None else collectives.all_gather(held, "model", d)


def state_block(value: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole new state `value`, in the layout of
    its stored block `held` (`value` itself where `held` is whole)."""
    d = _split_dim(held.shape, value.shape)
    return value if d is None else collectives.scatter(value, "model", d)


def local_rows(y: torch.Tensor, rows: Tuple[str, ...]) -> torch.Tensor:
    """This rank's block of the rows (dimension 0) of `y`, computed from
    the rows gathered over the batch axes `rows`."""
    mesh = current_context().mesh
    n = y.shape[0] // mesh.axis_size(rows)
    return y.narrow(0, mesh.axis_index(rows) * n, n)


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


def pim_scales(params: Any, n_layers: int) -> Any:
    """The tree with each `PimWeight`'s scale brought to the columns its
    planes hold. A row-parallel weight's stacked scale that holds a block
    of the layers (the reference's layer split of `scale [L, M]`) is
    gathered: each layer's product needs its own layer's scale. A
    column-parallel weight held unstacked (zamba2's shared block), whose
    1-D scale the reference's spec keeps whole, has it cut to this
    rank's columns."""
    if tensor_parallel() is None:
        return params
    if isinstance(params, dict):
        return {k: pim_scales(v, n_layers) for k, v in params.items()}
    if not isinstance(params, PimWeight):
        return params
    scale = params.scale
    if scale.dim() >= 2 and scale.shape[0] < n_layers:
        scale = collectives.gather(scale, "model", 0)
    scale = local_columns(scale, params.planes.shape[-1])
    if scale is params.scale:
        return params
    return PimWeight(params.planes, scale, params.n_bits, params.group)


def whole_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The entry points' logits, whole on every rank: a vocab block (the
    logits hook's layout under a split `lm_head`) is gathered."""
    if logits.shape[-1] == vocab:
        return logits
    return collectives.gather(logits, "model", logits.dim() - 1)
