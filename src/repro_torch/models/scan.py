"""`scan`: the models' loops over positions, blocks and chunks, the
counterpart of the reference's `lax.scan`.

`scan(body, carry, n, join)` runs `carry, outs = body(carry, i)` for
i = 0 .. n-1 and joins each output of the steps along a dimension
(`("stack", d)`: `torch.stack`, `("cat", d)`: `torch.cat`). On CPU and
CUDA tensors that is all it does: the loop, op for op.

On meta tensors (the dry run, `launch.dryrun`) a loop costs what its
steps dispatch, and each elementwise op of each step goes through
PyTorch's Python meta kernels. The steps of a scan are alike (the same
ops on the same shapes), so there it runs steps 0, 1, 2 and `alike - 1`
(and any steps past `alike`) and accounts exactly for the rest:

  * operations: step 2 runs under `kernels.work.repeat(alike - 3)`, so
    the roofline's counters count each op it dispatches, in the forward
    and in the backward (a hook on each autograd node it made), once for
    each of steps 2 .. alike-2;
  * memory: each storage step 1 made that is alive after step 2 (its
    outputs, what autograd saved, the carry the next step saved) is
    allocated once more for each of steps 3 .. alike-2 before step
    `alike - 1` runs, and freed when step 1's storage is freed. So the
    last step's transient peak sits on what alike - 1 steps keep, as in
    the loop, and `MemTracker` reads the loop's peak;
  * outputs: each joined output is allocated whole; its gradient flows
    back to the steps that ran.

Nothing is estimated: step `alike - 1` must dispatch the ops step 1 did,
on the same shapes, or the scan raises. A step that issues a collective
is not alike (the counts would miss it), so the scan raises there too.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..dist import collectives
from ..kernels import work

#: (kind, dim) of each joined output: ("stack", d) or ("cat", d)
Join = Sequence[Tuple[str, int]]

#: the fewest alike steps a meta scan shortens (steps 0, 1, 2 and the
#: last run; at least one is accounted for)
MIN_STEPS = 5


def scan(body: Callable[[Any, int], Tuple[Any, Tuple[torch.Tensor, ...]]],
         carry: Any, n: int, join: Join = (),
         alike: Optional[int] = None) -> Tuple[Any, Tuple[torch.Tensor, ...]]:
    """`(carry, joined outputs)` of `n` steps of `body(carry, i) ->
    (carry, outs)`, `outs` a tuple with one tensor per entry of `join`.
    Steps 0 .. `alike - 1` (all n by default) dispatch the same ops on
    the same shapes; later ones (a ragged last block) may differ."""
    alike = n if alike is None else alike
    parts: List[List[torch.Tensor]] = [[] for _ in join]

    def run(i: int) -> None:
        nonlocal carry
        carry, outs = body(carry, i)
        for acc, y in zip(parts, outs):
            acc.append(y)

    # a carry on meta says so before step 0, which is then watched too
    zero = _Steps() if _on_meta(carry, ()) else contextlib.nullcontext()
    with zero:
        run(0)
    short = alike >= MIN_STEPS and _on_meta(carry, parts)
    if short:
        _shortened(run, lambda: (carry, [p[-1] for p in parts]), alike,
                   zero if isinstance(zero, _Steps) else None)
    for i in range(alike if short else 1, n):
        run(i)
    if short:
        return carry, tuple(_Joined.apply(kind, dim, n, alike, *acc)
                            for acc, (kind, dim) in zip(parts, join))
    return carry, tuple(_JOIN[kind](acc, dim)
                        for acc, (kind, dim) in zip(parts, join))


_JOIN = {"stack": torch.stack, "cat": torch.cat}


def _on_meta(carry, parts) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_meta
               for t in tree_leaves((carry, parts)))


def _shortened(run: Callable[[int], None], last: Callable, alike: int,
               zero: Optional["_Steps"]) -> None:
    """Steps 1, 2 and `alike - 1` of a meta scan, the others accounted
    for (module docstring). `zero`: what step 0 made, where it was
    watched (a scan with a carry)."""
    with _Steps() as one:
        run(1)
    if zero is not None and [b for _, b in zero.made] != [
            b for _, b in one.made]:
        raise RuntimeError("scan: step 1 made other storages than step 0; "
                           "the steps are not alike")
    grad = torch.is_grad_enabled()
    start = _next_sequence_nr() if grad else None
    with work.repeat(alike - 3):
        run(2)
    if grad:
        _repeat_in_backward(tree_leaves(last()), start, alike - 3)
    for st, nbytes, tie in one.kept(zero):
        box = [torch.empty((nbytes * (alike - 4),), dtype=torch.uint8,
                           device="meta")]
        weakref.finalize(tie, box.clear)
        del st, tie, box
    with _Steps() as tail:
        run(alike - 1)
    if tail.ops != one.ops:
        raise RuntimeError("scan: the last step dispatched other ops than "
                           "step 1; the steps are not alike")


class _Steps(TorchDispatchMode):
    """The ops a step dispatches (op and output shapes) and the storages
    it makes (weakly), and whether it issued a collective."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple] = []
        self.made: List[Tuple[weakref.ref, int]] = []

    def __enter__(self):
        self._calls = _collective_calls()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if exc[0] is None and _collective_calls() != self._calls:
            raise RuntimeError("scan: a step issued a collective; its "
                               "steps cannot be accounted for")
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops.append((func, tuple((tuple(t.shape), t.dtype)
                                     for t in outs)))
        seen = {t.untyped_storage()._cdata
                for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in seen and st.nbytes():
                seen.add(st._cdata)
                self.made.append((weakref.ref(st), st.nbytes()))
        return out

    def kept(self, zero: Optional["_Steps"]):
        """`(storage, bytes, tie)` for each storage made that is still
        alive. `tie` is the storage whose death frees the steps'
        copies: step 0's counterpart (made by the same op) where step 0
        was watched, else the storage itself. A step's carry that the
        next step saves lives until that step's backward, so the copies
        of the skipped steps' carries must outlive step 2's backward,
        as step 0's carry does."""
        out = []
        for i, (ref, nbytes) in enumerate(self.made):
            st = ref()
            tie = st if zero is None else zero.made[i][0]()
            if st is not None and tie is not None:
                out.append((st, nbytes, tie))
        return out


def _collective_calls() -> int:
    return sum(c for c, _, _ in collectives.COUNTS.values())


def _next_sequence_nr() -> int:
    """The sequence number autograd gives the next node it makes."""
    with torch.enable_grad():
        probe = torch.empty((0,), device="meta", requires_grad=True)
        return probe.view((0,)).grad_fn._sequence_nr() + 1


def _repeat_in_backward(outs, start: int, k: int) -> None:
    """Each autograd node made since sequence number `start` and reached
    from `outs` counts its backward ops `k` times (`work.repeat`)."""
    def enter(*_):
        work.enter_repeat(k)

    def leave(*_):
        work.leave_repeat(k)

    seen = set()
    todo = [t.grad_fn for t in outs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node._sequence_nr() < start \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        node.register_prehook(enter)
        node.register_hook(leave)
        todo.extend(f for f, _ in node.next_functions)


class _Joined(torch.autograd.Function):
    """The joined output of a shortened scan: one allocation of the
    whole, whose gradient goes back to the steps that ran (0, 1, 2,
    `alike - 1`, and any past `alike`)."""

    @staticmethod
    def forward(ctx, kind, dim, n, alike, *ran):
        steps = (0, 1, 2) + tuple(range(alike - 1, n))
        if kind == "stack":
            shape = list(ran[0].shape)
            shape.insert(dim % (ran[0].dim() + 1), n)
            at = [(s, None) for s in steps]
        else:
            size = ran[0].shape[dim]
            sizes = [size] * 3 + [t.shape[dim] for t in ran[3:]]
            offsets = [0, size, 2 * size] + [
                (alike - 1) * size + sum(sizes[3:3 + j])
                for j in range(len(ran) - 3)]
            shape = list(ran[0].shape)
            shape[dim] = alike * size + sum(sizes[4:])
            at = list(zip(offsets, sizes))
        ctx.args = (kind, dim, at)
        return ran[0].new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        kind, dim, at = ctx.args
        if kind == "stack":
            grads = [g.select(dim, s) for s, _ in at]
        else:
            grads = [g.narrow(dim, off, size) for off, size in at]
        return (None, None, None, None, *grads)
