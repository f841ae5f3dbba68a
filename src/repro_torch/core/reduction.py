"""Reduction-network step models: the framework-free half of
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

The reference's other half — the schedules themselves as collectives
over a device mesh (`allreduce_linear`, `allreduce_binary_hopping`,
`reduce_to_zero_binary_hopping`, `allreduce_tree`,
`reduce_scatter_then_gather`, `make_sharded_allreduce`) — is not ported
yet: it comes with the port's distribution layer on `torch.distributed`
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import math


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
