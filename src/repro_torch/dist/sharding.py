"""Logical-axis sharding rules: counterpart of `repro.dist.sharding`.

Model code never names mesh axes. It annotates values with *logical*
axes — ``shard(x, "batch", "seq", "heads", "head_dim")`` — and a rule
table maps each logical axis to zero or more mesh axes. Outside a
``sharding_rules(mesh, rules)`` context every annotation is a no-op, so
unit tests on one device run the exact production code path.

Resolution is defensive in two ways, as in the reference:

  - divisibility: a mesh axis is used only when its size divides the
    dimension (batch=1 long_500k drops the batch axes);
  - single use: each mesh axis is consumed at most once per value,
    left to right (decode_32k's batch grabs ``data`` so the kv_seq rule
    is dropped; long_500k's batch=1 frees ``data`` for kv_seq).

A spec is a tuple with one entry per leading dimension — a mesh axis
name, a tuple of names, or None — trailing Nones dropped: the
reference's `PartitionSpec` as a plain tuple (`bridge.spec_from_jax`
converts one).

Layout against compute. The reference's specs are GSPMD layouts, and
XLA inserts whatever collectives a layout needs. The port has no
partitioner: each rank stores exactly the block of each leaf its spec
gives it (`local_block`, `place_tree`) and computes on local tensors.
`shard` is then a layout transition over the ``model`` axis: the
caller says which dimension of its local tensor holds this rank's
block (`src_dim`, None for a tensor held whole), and `shard` gathers
or cuts it to the layout the rules resolve for the value's global
shape (`dist.parallel` holds the tensor-parallel compute around it).
The batch axes (``pod``, ``data``) move no row through a hook: the
caller gives each rank its rows of the global batch
(`PrefetchLoader(mesh=, batch_spec=)`, `local_block`), and a value's
batch dimension is already local when it reaches one. The one place
that needs the other ranks' rows is the MoE's routing, in which every
row of the step competes for the experts' places: it gathers them over
the axes the context says split the rows (`row_axes`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..quant.bitplane import PimWeight

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

#: training: batch over (pod, data); TP over model for heads / ff / vocab.
TRAIN_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "layers": None,
    "kv_seq": None,
    "cache_head_dim": None,
}

#: serving: same TP split, plus sequence-parallel KV for batch-1 cells
#: (kv_seq over data — only claimed when the batch rule leaves it free).
SERVE_RULES: Dict[str, Axes] = {
    **TRAIN_RULES,
    "kv_seq": "data",
}


def spec_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ShardingContext:
    def __init__(self, mesh, rules: Dict[str, Axes],
                 rows: Axes = None):
        self.mesh = mesh
        self.rules = dict(rules)
        self.rows: Tuple[str, ...] = tuple(
            a for a in spec_axes(rows) if self._axis_size(a) > 1)

    def _axis_size(self, name: str) -> int:
        return self.mesh.shape[name] if name in self.mesh.axis_names else 1

    @property
    def model(self) -> int:
        """Size of the ``model`` axis (1 when the mesh has none)."""
        return self._axis_size("model")

    def resolve(self, *names: Optional[str],
                shape: Optional[Sequence[int]] = None) -> Spec:
        """Logical names -> spec under this mesh, skipping mesh axes that
        do not divide the dimension or are already used."""
        used: set = set()
        out: list = []
        for i, logical in enumerate(names):
            axes = self.rules.get(logical) if logical else None
            if axes is None:
                out.append(None)
                continue
            cand = [a for a in spec_axes(axes)
                    if self._axis_size(a) > 1 and a not in used]
            dim = None if shape is None or i >= len(shape) else int(shape[i])
            picked: Tuple[str, ...] = ()
            if dim is not None:
                total = math.prod(self._axis_size(a) for a in cand)
                if total > 1 and dim % total == 0:
                    picked = tuple(cand)
                else:  # composite didn't fit — try a single axis
                    for a in cand:
                        if dim % self._axis_size(a) == 0:
                            picked = (a,)
                            break
            else:
                picked = tuple(cand)
            used.update(picked)
            if not picked:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(picked)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


_local = threading.local()


def current_context() -> Optional[ShardingContext]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[Dict[str, Axes]] = None,
                   rows: Axes = None):
    """`rows`: the spec entry (a mesh axis or a tuple of them) the caller
    split the batch rows over, each rank holding its block of the global
    batch (`local_block` with that entry); None where every rank holds
    the same rows."""
    prev = current_context()
    _local.ctx = ShardingContext(mesh, TRAIN_RULES if rules is None else rules,
                                 rows)
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def within(ctx: Optional[ShardingContext]):
    """`ctx` as this thread's context inside (None: no context). The
    context is per thread, and the autograd engine runs the backward of
    CUDA tensors, and so a rematerialised layer's recompute, on a thread
    of its own: code that runs there re-enters the context it captured."""
    prev = current_context()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def suspended():
    """No sharding context inside (whole values, as on one rank)."""
    return within(None)


class TensorParallelUnsupported(ValueError):
    """The paged path met a ``model`` axis: it serves on one rank, as the
    reference's does."""


def tensor_parallel() -> Optional[ShardingContext]:
    """The active context when its mesh splits over ``model``, else None:
    the test every tensor-parallel branch of the model code makes."""
    ctx = current_context()
    return ctx if ctx is not None and ctx.model > 1 else None


def row_axes() -> Tuple[str, ...]:
    """The mesh axes the batch rows are split over in the active context
    (`sharding_rules(rows=)`); () without a context."""
    ctx = current_context()
    return () if ctx is None else ctx.rows


#: the recurrent cache leaves ([L, B, ...]) and the dimensions the
#: reference's `cache_shardings` tries to split over ``model``, in order:
#: Mamba2's `ssm` [L, B, H, P, N] over heads and `conv` [L, B, k-1, cd]
#: over its channels; the mLSTM's `C` [L, B, H, hd, hd] over heads, else
#: over its first hd, `n` [L, B, H, hd] and `m` [L, B, H] over heads; the
#: sLSTM's states [L, B, D] over D
STATE_DIMS = {"ssm": (2,), "conv": (3,), "C": (2, 3), "n": (2,), "m": (2,),
              "sc": (2,), "sn": (2,), "sm": (2,), "sh": (2,)}


def state_model_dim(key: str, shape: Sequence[int],
                    model: int) -> Optional[int]:
    """The dimension of the whole recurrent cache leaf `key` of `shape`
    that a ``model`` axis of `model` ranks splits (the first of its
    `STATE_DIMS` that `model` divides), or None."""
    if model <= 1:
        return None
    return next((d for d in STATE_DIMS[key] if shape[d] % model == 0), None)


def model_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec splits over ``model``, or None."""
    for i, entry in enumerate(spec):
        if "model" in spec_axes(entry):
            return i
    return None


def shard(x: torch.Tensor, *names: Optional[str],
          src_dim: Optional[int] = None) -> torch.Tensor:
    """Bring the local `x` to the layout its logical axis names resolve
    to over ``model`` (no-op without a context, or on a mesh without a
    ``model`` axis). `src_dim`: the dimension of `x` that holds this
    rank's contiguous block of the value (after a column-parallel
    product, or a lookup of a split table); None when `x` is held whole.
    A block the rules do not split is all-gathered; a whole value the
    rules split is cut to this rank's block."""
    ctx = tensor_parallel()
    if ctx is None:
        return x
    from . import collectives

    shape = list(x.shape)
    if src_dim is not None:
        src_dim %= x.dim()
        shape[src_dim] *= ctx.model
    dst = model_dim(ctx.resolve(*names, shape=shape))
    if dst == src_dim:
        return x
    if src_dim is not None:
        x = collectives.gather(x, "model", dim=src_dim)
    if dst is not None:
        x = collectives.scatter(x, "model", dim=dst)
    return x


# ---------------------------------------------------------------------------
# parameter partitioning
# ---------------------------------------------------------------------------

#: projection kernels whose OUTPUT features split over model (col-parallel)
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "wi"}
#: second matmuls: INPUT features split over model (row-parallel)
_ROW_PARALLEL = {"wo", "w_down", "w2"}


def _leaf_spec(name: str, leaf) -> Spec:
    """The reference's `_leaf_spec` for a tensor leaf under dict key
    `name`. A `PimWeight`'s planes and scale are flattened children in
    the reference, whose path walk passes their indices and reaches the
    weight's own name: so a row-parallel weight's stacked `scale [L, M]`
    splits on its layer dimension when `L % model == 0`, as there."""
    ndim = getattr(leaf, "ndim", 0)
    shape = tuple(getattr(leaf, "shape", ()))
    ctx = current_context()
    if ctx is None or ndim < 2:
        return ()
    model = ctx.model

    def fit(dim: int) -> Optional[str]:
        return "model" if model > 1 and dim % model == 0 else None

    axes: list = [None] * ndim
    if name in _COL_PARALLEL or name == "embed" or name == "lm_head":
        axes[-1] = fit(shape[-1])
    elif name in _ROW_PARALLEL:
        axes[-2] = fit(shape[-2])
    elif name == "planes" and ndim >= 3:   # PimWeight [n_d, K8, M]
        axes[-1] = fit(shape[-1])
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def params_partition_specs(params_shapes: Any, name: str = ""):
    """Spec tree for a parameter tree (needs an active sharding_rules
    context; `launch.specs.param_shardings` applies the per-leaf
    divisibility fixup on top). Leaves may be tensors of any device
    (`meta` ones allocate nothing); a `PimWeight` gives a `PimWeight`
    whose planes and scale are their specs."""
    if isinstance(params_shapes, dict):
        return {k: params_partition_specs(v, k)
                for k, v in params_shapes.items()}
    if isinstance(params_shapes, PimWeight):
        w = params_shapes
        return PimWeight(_leaf_spec(name, w.planes), _leaf_spec(name, w.scale),
                         w.n_bits, w.group)
    return _leaf_spec(name, params_shapes)


# ---------------------------------------------------------------------------
# placement: each rank's block of a whole value
# ---------------------------------------------------------------------------

def block_index(mesh, entry: Axes) -> Tuple[int, int]:
    """`(index, count)` of this rank's block along a dimension split over
    `entry`'s axes (the first axis major, as a tuple of mesh axes splits
    a dimension in the reference)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `x` under `spec` (a view)."""
    for dim, entry in enumerate(spec):
        idx, n = block_index(mesh, entry)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


def _with_specs(fn, tree: Any, specs: Any) -> Any:
    """`fn(leaf, spec)` over a tree and its spec tree of the same
    structure: dicts, named tuples such as `AdamWState`, and `PimWeight`s,
    which block by their planes' and scale's specs."""
    if isinstance(tree, dict):
        return {k: _with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_with_specs(fn, getattr(tree, n),
                                        getattr(specs, n))
                            for n in tree._fields])
    if isinstance(tree, PimWeight):
        return PimWeight(_with_specs(fn, tree.planes, specs.planes),
                         _with_specs(fn, tree.scale, specs.scale),
                         tree.n_bits, tree.group)
    return fn(tree, specs)


def place_tree(tree: Any, specs: Any, mesh, copy: bool = True) -> Any:
    """Each rank's blocks of a whole tree under its spec tree. With `copy`
    every block is a contiguous tensor of its own, so the whole tree can
    be dropped."""
    def one(x, spec):
        out = local_block(x, spec, mesh)
        return out.clone(memory_format=torch.contiguous_format) if copy \
            else out
    return _with_specs(one, tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole tree from each rank's blocks (the inverse of
    `place_tree`): every split dimension all-gathered over its axes."""
    from . import collectives

    def one(x, spec):
        for dim, entry in enumerate(spec):
            if block_index(mesh, entry)[1] > 1:
                x = collectives.all_gather(x, spec_axes(entry), dim, mesh)
        return x
    return _with_specs(one, tree, specs)
