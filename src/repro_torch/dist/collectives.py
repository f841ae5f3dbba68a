"""The one place the port issues collectives: per mesh axis, counted.

Every collective of the distribution layer goes through this module:
`all_reduce`, `all_gather`, `reduce_scatter`, `ppermute` (the
reference's `lax.ppermute`: `batch_isend_irecv` over the pairs given),
`pmax`, and the differentiable forms the tensor-parallel model code
uses (`gather`, `gather_apart`, `scatter`, `reduce_partial`, `enter`).
An axis is a mesh axis name or a tuple of names; the mesh is the active sharding
context's unless one is passed.

Counts. `COUNTS[kind]` holds `[calls, bytes, seconds]`: the bytes this
rank moves over its links for the call, by the ring model that
`core.reduction.collective_bytes_per_device` prices (an all-reduce of n
bytes over P ranks moves 2(P-1)/P n, a reduce-scatter or all-gather
(P-1)/P of the whole, a permute the bytes this rank sends), and the
host seconds spent inside the library's calls (each returns when its
transfer is done). `COUNTS["staged"]` counts the calls and bytes that went through host
buffers (below). `reset_counts` / `read_counts` bracket a run.

Backends. NCCL carries every collective of CUDA tensors, gloo every
collective of CPU tensors. gloo carries `all_reduce` of CUDA tensors,
but not all-gather, reduce-scatter or send / recv:
those are staged through pinned host buffers by `_through_host`, which
runs only when the group's backend is gloo and the tensor is on CUDA.
The backend is the caller's choice at `init_process_group`; nothing
here falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

#: kind -> [calls, bytes moved by this rank, host seconds in the call]
COUNTS: Dict[str, List[float]] = {}

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute", "pmax",
         "staged")


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update({k: [0, 0, 0.0] for k in KINDS})


def read_counts() -> Dict[str, Dict[str, float]]:
    return {k: {"calls": c, "bytes": b, "seconds": t}
            for k, (c, b, t) in COUNTS.items()}


reset_counts()


def _count(kind: str, nbytes: float) -> None:
    entry = COUNTS[kind]
    entry[0] += 1
    entry[1] += int(nbytes)


@contextlib.contextmanager
def _timed(kind: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COUNTS[kind][2] += time.perf_counter() - t0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from .sharding import current_context
    ctx = current_context()
    if ctx is None:
        raise RuntimeError("a collective needs a mesh: pass one, or run "
                           "under sharding_rules(mesh)")
    return ctx.mesh


def _through_host(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor `x`, counted as staged."""
    with _timed("staged"):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
    _count("staged", _nbytes(x))
    return h


def all_reduce(x: torch.Tensor, axis, mesh=None, op: str = "sum",
               inplace: bool = False) -> torch.Tensor:
    """Sum (or max) of `x` over the ranks along `axis`: a new tensor, or
    `x` itself, overwritten, with `inplace`."""
    mesh = _mesh(mesh)
    p = mesh.axis_size(axis)
    out = x if inplace else x.clone()
    if p == 1:
        return out
    kind = "pmax" if op == "max" else "all_reduce"
    _count(kind, 2 * (p - 1) / p * _nbytes(x))
    with _timed(kind):
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=mesh.group(axis))
    return out


def barrier(mesh=None) -> None:
    """Every rank of the mesh waits for the others."""
    mesh = _mesh(mesh)
    if mesh.size > 1:
        dist.barrier(group=mesh.group(mesh.axis_names))


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    return all_reduce(x, axis, mesh, op="max")


def all_gather(x: torch.Tensor, axis, dim: int = 0, mesh=None
               ) -> torch.Tensor:
    """The blocks of every rank along `axis`, concatenated on `dim` in
    axis order."""
    mesh = _mesh(mesh)
    p = mesh.axis_size(axis)
    if p == 1:
        return x.clone()
    group = mesh.group(axis)
    _count("all_gather", (p - 1) * _nbytes(x))
    src = x.contiguous()
    staged = _through_host(group, src)
    if staged:
        src = _host(src)
    parts = [torch.empty_like(src) for _ in range(p)]
    with _timed("all_gather"):
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def reduce_scatter(x: torch.Tensor, axis, dim: int = 0, mesh=None
                   ) -> torch.Tensor:
    """This rank's block (along `dim`, `P` equal blocks) of the sum of
    `x` over the ranks along `axis`."""
    mesh = _mesh(mesh)
    p = mesh.axis_size(axis)
    if p == 1:
        return x.clone()
    if x.shape[dim] % p:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split into {p} blocks")
    group = mesh.group(axis)
    _count("reduce_scatter", (p - 1) / p * _nbytes(x))
    src = x
    staged = _through_host(group, src)
    if staged:
        src = _host(src)
    chunks = [c.contiguous() for c in src.chunk(p, dim=dim)]
    out = torch.empty_like(chunks[0])
    with _timed("reduce_scatter"):
        dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device, non_blocking=True) if staged else out


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]],
             mesh=None) -> torch.Tensor:
    """`lax.ppermute`: for each `(src, dst)` pair of axis indices the
    rank at `src` sends `x` to the rank at `dst`; a rank that receives
    nothing gets zeros."""
    mesh = _mesh(mesh)
    me = mesh.axis_index(axis)
    ranks = mesh.ranks(axis)
    group = mesh.group(axis) if len(ranks) > 1 else None
    send = [d for s, d in perm if s == me]
    recv = [s for s, d in perm if d == me]
    src = x.contiguous()
    if send == [me] and recv == [me]:
        return src.clone()
    staged = group is not None and _through_host(group, src)
    if staged and send:
        src = _host(src)
    out = torch.zeros(x.shape, dtype=x.dtype, pin_memory=staged,
                      device="cpu" if staged else x.device)
    ops = [dist.P2POp(dist.isend, src, ranks[d], group) for d in send]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in recv]
    if ops:
        _count("ppermute", len(send) * _nbytes(x))
        with _timed("ppermute"):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out.to(x.device, non_blocking=True) if staged else out


# ---------------------------------------------------------------------------
# differentiable forms for the tensor-parallel model code
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, axis, dim: int, mesh) -> torch.Tensor:
    p = mesh.axis_size(axis)
    size = x.shape[dim] // p
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


class _Gather(torch.autograd.Function):
    """Blocks -> the whole value on every rank; the gradient of a value
    every rank holds whole (and uses alike) is this rank's block."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return all_gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.args
        return _block(g, axis, dim, mesh).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """The whole value -> this rank's block; its gradient is gathered
    back to the whole."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return _block(x, axis, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.args
        return all_gather(g, axis, dim, mesh), None, None, None


class _GatherApart(torch.autograd.Function):
    """Blocks -> the whole value on every rank, where each rank goes on
    to use its own part of what it computes from it (the MoE's routing
    over every rank's rows): the gradient, partial on each rank, is summed
    over the ranks and cut to this rank's block (a reduce-scatter). A loss
    every rank computes whole (the MoE's load-balance loss) so enters each
    row's gradient once per rank: the training step's mean over the batch
    axes divides it back."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return all_gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.args
        return reduce_scatter(g, axis, dim, mesh), None, None, None


class _ReducePartial(torch.autograd.Function):
    """Partial sums -> their sum on every rank; the gradient passes."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """A whole value entering rank-local products: the identity, whose
    gradient (partial on each rank) is summed."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return all_reduce(g, axis, mesh), None, None


def gather(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    return _Gather.apply(x, axis, dim, _mesh(mesh))


def gather_apart(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    return _GatherApart.apply(x, axis, dim, _mesh(mesh))


def scatter(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    return _Scatter.apply(x, axis, dim, _mesh(mesh))


def reduce_partial(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    return _ReducePartial.apply(x, axis, _mesh(mesh))


def enter(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, axis, _mesh(mesh))
