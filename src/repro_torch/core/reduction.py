"""Reduction-network schedules and their step models: counterpart of
`repro.core.reduction` (paper eqn (1) dataflows).

The paper compares array-level reduction networks (Table IV): linear NEWS
shift-add (SPAR-2), binary-add, a global adder tree (CCB/CoMeFa), and
PiCaSO's binary-hopping. These functions count the steps and bytes of
each schedule — what eqn (1) is fitted against and what the collective
terms of a roofline are priced with.

Step-count models (for eqn (1) fitting; one "step" moves one shard over
one link):

  linear        : P-1 sequential hops          -> a=0-ish, b ~ hop cost
  binary-hopping: log2(P) hops of 2^h distance -> aN log P + (P-1) pattern
  tree          : the library's all-reduce     -> the 'global adder tree'

The schedules themselves run as collectives over an axis of the port's
mesh (`launch.mesh.Mesh`): each hop is one `dist.collectives.ppermute`
over the same pairs as the reference's `lax.ppermute`, so the bytes a
rank moves are counted (`dist.collectives.COUNTS`) and can be held
against `collective_bytes_per_device`. A schedule takes the local shard
and the axis name, and the mesh of the active sharding context unless
one is passed; `make_sharded_allreduce` binds a mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..dist import collectives


# ---------------------------------------------------------------------------
# step-count models (cycles in units of one hop + one add)
# ---------------------------------------------------------------------------

def steps_linear(p: int) -> int:
    return max(0, p - 1)


def steps_binary_hopping(p: int) -> int:
    return int(math.ceil(math.log2(p))) if p > 1 else 0


def movement_linear(p: int) -> int:
    return max(0, p - 1)


def movement_binary_hopping(p: int) -> int:
    # sum of 2^h hop distances = P - 1 (paper Table IV, binary-hopping)
    return max(0, p - 1)


def reduction_latency_model(
    schedule: str, n_bits: int, p: int, add_cycles_per_bit: float = 1.0,
    hop_cycles: float = 1.0,
) -> float:
    """Cycles for array-level reduction under a schedule — instantiates
    eqn (1) with schedule-specific (a, b, c) structure."""
    if schedule == "linear":
        return (add_cycles_per_bit * n_bits + hop_cycles) * steps_linear(p)
    if schedule == "binary-hopping":
        return (
            add_cycles_per_bit * n_bits * steps_binary_hopping(p)
            + hop_cycles * movement_binary_hopping(p)
        )
    if schedule == "tree":
        # fully-pipelined global adder tree: log P latency, no serial moves
        return add_cycles_per_bit * steps_binary_hopping(p) + 2.0
    raise ValueError(f"unknown schedule {schedule!r}")


def collective_bytes_per_device(
    schedule: str, shard_bytes: float, p: int
) -> float:
    """Bytes each device moves over its links for one all-reduce of a
    `shard_bytes` shard — the napkin model behind the collective term."""
    if p <= 1:
        return 0.0
    if schedule == "linear":
        return shard_bytes * (p - 1)
    if schedule == "binary-hopping":
        return shard_bytes * math.ceil(math.log2(p))
    if schedule == "tree":
        # a ring reduce-scatter + all-gather: 2(P-1)/P shards
        return shard_bytes * 2.0 * (p - 1) / p
    if schedule == "rs-ag":
        return shard_bytes * 2.0 * (p - 1) / p
    raise ValueError(schedule)


# ---------------------------------------------------------------------------
# the schedules as collectives over a mesh axis
# ---------------------------------------------------------------------------

def _axis_size(axis: str, mesh=None) -> int:
    return collectives._mesh(mesh).axis_size(axis)


def allreduce_linear(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """SPAR-2-style linear shift-add ring: P-1 sequential permute+add.

    Deliberately latency-suboptimal (the paper's 'Very Slow' row) — kept as
    the baseline the Gold Standard fit must flag as out-of-range.
    """
    p = _axis_size(axis, mesh)
    acc = x
    buf = x
    perm = [(i, (i + 1) % p) for i in range(p)]
    for _ in range(p - 1):
        buf = collectives.ppermute(buf, axis, perm, mesh)
        acc = acc + buf
    return acc


def allreduce_binary_hopping(x: torch.Tensor, axis: str, mesh=None
                             ) -> torch.Tensor:
    """PiCaSO binary-hopping == recursive doubling: log2(P) hops of
    stride 2^h. Every rank ends with the full sum."""
    p = _axis_size(axis, mesh)
    if p & (p - 1):
        raise ValueError("binary-hopping needs a power-of-two axis size")
    acc = x
    h = 1
    while h < p:
        perm = [(i, i ^ h) for i in range(p)]
        acc = acc + collectives.ppermute(acc, axis, perm, mesh)
        h <<= 1
    return acc


def reduce_to_zero_binary_hopping(x: torch.Tensor, axis: str, mesh=None
                                  ) -> torch.Tensor:
    """East->west accumulation onto index 0 (IMAGine's west column):
    at level h, rank j receives from j + 2^h for j % 2^(h+1) == 0.
    Other ranks keep partials (masked out by the caller)."""
    m = collectives._mesh(mesh)
    p = m.axis_size(axis)
    if p & (p - 1):
        raise ValueError("binary-hopping needs a power-of-two axis size")
    acc = x
    idx = m.axis_index(axis)
    h = 1
    while h < p:
        # send j -> j - h for odd multiples of h
        perm = [(j, j - h) for j in range(p) if (j % (2 * h)) == h]
        moved = collectives.ppermute(acc, axis, perm, m)
        if idx % (2 * h) == 0:
            acc = acc + moved
        h <<= 1
    return acc


def allreduce_tree(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The 'global adder tree': the library's all-reduce."""
    return collectives.all_reduce(x, axis, mesh)


def reduce_scatter_then_gather(x: torch.Tensor, axis: str, mesh=None
                               ) -> torch.Tensor:
    """Bandwidth-optimal all-reduce = reduce-scatter + all-gather, written
    explicitly so the collective bytes compare against the tree's.
    Operates on the flattened tensor, zero-padded to a multiple of P, so
    any shard shape works."""
    p = _axis_size(axis, mesh)
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    scattered = collectives.reduce_scatter(flat, axis, 0, mesh)
    full = collectives.all_gather(scattered, axis, 0, mesh)
    if pad:
        full = full[: -pad]
    return full.reshape(shape)


SCHEDULES: Dict[str, Callable[..., torch.Tensor]] = {
    "linear": allreduce_linear,
    "binary-hopping": allreduce_binary_hopping,
    "tree": allreduce_tree,
    "rs-ag": reduce_scatter_then_gather,
}


def make_sharded_allreduce(mesh, axis: str, schedule: str
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(local shard) -> the all-reduce of the shards along `axis` of
    `mesh` under the chosen schedule. The reference's takes the global
    array and maps over its `P(axis)` blocks; here each rank calls it on
    its own block (`sharding.local_block`)."""
    fn = SCHEDULES[schedule]

    def reduced(x: torch.Tensor) -> torch.Tensor:
        return fn(x, axis, mesh)

    return reduced
