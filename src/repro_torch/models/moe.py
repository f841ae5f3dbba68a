"""Mixture-of-Experts layer with capacity-based top-k routing:
counterpart of `repro.models.moe`; and the port's dropless routing.

The routing is the reference's, decision for decision, because a
different routing changes tokens, not just logits:

  * tokens are cut into chunks of `min(chunk, n)` rows, the last one
    zero-padded at its end; each chunk gives every expert
    `capacity = min(chunk, max(1, ceil(chunk * top_k / E * factor)))`
    places, computed in Python floats;
  * the router runs in f32 (`x.float() @ router`, the router kept f32);
    the top-k among equal probabilities takes the lowest expert index
    first, as `jax.lax.top_k` does (a stable sort; zero padding rows
    give uniform probabilities, so ties do occur);
  * priority is token order inside the chunk (a cumsum over the [N, E]
    assignment); a token past its expert's capacity is dropped there.

What differs is how the rows move, not what they are: the reference
builds a one-hot [N, E, C] dispatch tensor and contracts it with
einsums; here each kept (token, expert) pair's place `e * C + pos`
indexes a gather into the [E, C, D] expert input and a gather back out
of the expert output. Every slot of the reference's dispatch einsum
holds one token or none, so the gathered input is the same numbers;
the combine adds a token's top-k gated outputs, which the reference's
einsum adds among zeros. Empty places hold zero rows, as there.

Expert products: `torch.bmm` for dense [E, K, M] stacks (the
reference's `einsum("ecd,edf->ecf")`, outside any kernel of the repo),
and one `ops.bitplane_matmul` per expert for a PIM-resident
[E, K, M] `PimWeight` (K3 at C <= 512 rows, K4 above, as the
reference's `jax.vmap` of `bitplane_matmul` dispatches).

Returns `(y, aux)` with the Switch load-balance loss
(`E * sum_e f_e * p_e`, means over chunks) and the dropped fraction.

Under a mesh. The router and the expert stacks are whole on every rank
(no rule splits them), so each rank computes the routed experts whole.
The reference routes the step's global batch; a rank that holds its
block of the rows (`dist.sharding.row_axes`) gathers every rank's rows
before dispatch, routes them all, and keeps its own rows' outputs, so
the drops, the loss and the dropped fraction are the one-rank values.
llama4's shared expert is the tensor-parallel SwiGLU of `models.mlp` on
this rank's rows; the routed output is added after its all-reduce (added
before it, it would be summed once per rank).

Dropless routing (`capacity_factor <= 0`, the port's own; DESIGN.md
§19). The router is `_route`'s (f32 softmax, a stable top-k, the gates
renormalised), and every token's k (token, expert) pairs are computed:
none is dropped, so a row's output depends on no other row of the step,
idle slots and padding included. The pairs are sorted by expert on the
device (a stable sort: token order inside an expert), each expert's rows
counted by a fixed-shape scatter into [E] and summed into offsets [E+1];
a PIM-resident stack then runs gate, up and down as one K6 launch each
(`ops.bitplane_grouped_matmul`) over the sorted rows, and each token adds
its k gated outputs in f32, in its top-k order. No shape depends on the
routing and nothing is read back to the host, so a CUDA graph captures
the step (`serve.graphs`). A dense stack runs every expert over every
row and keeps each row's own expert's (plain PyTorch, E times the work:
for the CPU tests; no served configuration takes it).

With a `MoeWatch` set in `WATCH` (a serving loop with telemetry), each
dropless call adds its pairs, its busiest expert's rows and 1 to the
watch's device counters (so a replayed graph adds them too), and an
eager call runs inside the span `model/moe`.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..dist import collectives
from ..dist.parallel import local_rows
from ..dist.sharding import row_axes, shard
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..quant.bitplane import PimWeight
from .common import ACTS, Params, dense_init
from .mlp import init_swiglu, swiglu
from .scan import scan

#: token chunk of the dispatch (the reference's)
MOE_CHUNK = 2048


@dataclasses.dataclass
class MoeWatch:
    """What a serving loop with telemetry hands the dropless layers:
    `counts` int64 [3] on the device (pairs computed, the busiest
    expert's rows summed over calls, calls) and the span ring."""

    counts: torch.Tensor
    spans: object


#: the watch of the step now running, or None
WATCH = contextvars.ContextVar("moe_watch", default=None)


def init_moe(d_model: int, d_ff: int, n_experts: int, n_shared: int,
             generator, device, dtype=torch.float32, out=None) -> Params:
    """The router (always f32: the reference routes in f32), the expert
    stacks [E, d_model, d_ff] / [E, d_ff, d_model] drawn one expert at
    a time, and the shared SwiGLU of width `d_ff * n_shared` if any.
    `out`: preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]

    p: Params = {"router": dense_init(d_model, n_experts, generator, device,
                                      torch.float32, o("router"))}
    for name, (k, m) in (("we_gate", (d_model, d_ff)),
                         ("we_up", (d_model, d_ff)),
                         ("we_down", (d_ff, d_model))):
        stack = o(name)
        if stack is None:
            stack = torch.empty((n_experts, k, m), dtype=dtype, device=device)
        for e in range(n_experts):
            dense_init(k, m, generator, device, dtype, stack[e])
        p[name] = stack
    if n_shared:
        p["shared"] = init_swiglu(d_model, d_ff * n_shared, generator,
                                  device, dtype, o("shared"))
    return p


def _route(logits: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [N, E] -> (gates [N, k], idx [N, k], probs [N, E]); among
    equal probabilities the lower expert index comes first."""
    probs = torch.softmax(logits.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt.values[:, :top_k], srt.indices[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, idx, probs


def _expert_matmul(x_ec: torch.Tensor, w, impl: str) -> torch.Tensor:
    """Per-expert matmul [E, C, K] x [E, K, M] -> [E, C, M]; a
    PIM-resident stack runs the bit-plane op one expert at a time."""
    if isinstance(w, PimWeight):
        return torch.stack([
            kops.bitplane_matmul(x_ec[e], w.planes[e], w.scale[e],
                                 n_bits=w.n_bits, group=w.group, impl=impl)
            for e in range(x_ec.shape[0])
        ])
    return torch.bmm(x_ec, w.to(x_ec.dtype))


def _dispatch_chunk(params: Params, x: torch.Tensor, top_k: int,
                    capacity: int, act: str, impl: str):
    """Capacity-limited dispatch / combine of one chunk x [Nc, D]:
    (y [Nc, D], f_e * p_e [E], dropped fraction)."""
    nc, d = x.shape
    e = params["router"].shape[-1]
    logits = x.float() @ params["router"]
    gates, idx, probs = _route(logits, top_k)

    # expert assignment and intra-expert positions (priority = token order)
    onehot = torch.nn.functional.one_hot(idx, e).float()      # [Nc, k, E]
    assign = onehot.sum(dim=1)                                # [Nc, E]
    pos = torch.cumsum(assign, dim=0) - 1.0                   # [Nc, E]
    keep = (pos < capacity) & (assign > 0)
    # a kept (token, expert) pair's place in the flat [E * C] expert
    # input; every other pair points at the dump place E * C
    place = (torch.arange(e, device=x.device)[None, :] * capacity
             + pos.clamp(0, capacity - 1).long())
    dump = e * capacity
    place = torch.where(keep, place, dump)                    # [Nc, E]
    src = torch.full((dump + 1,), nc, dtype=torch.long, device=x.device)
    src.scatter_(0, place.flatten(), torch.arange(
        nc, device=x.device).repeat_interleave(e))
    x_ext = torch.cat([x, x.new_zeros((1, d))])
    xin = x_ext[src[:dump]].reshape(e, capacity, d)           # [E, C, D]
    # the expert dimension's hook: no rule maps "experts" to a mesh axis
    # (the reference's spec tree keeps the `we_*` stacks whole), so it
    # places nothing yet; expert parallelism would give it one
    xin = shard(xin, "experts", None, "embed")

    # expert FFNs (PIM-aware)
    h = ACTS[act](_expert_matmul(xin, params["we_gate"], impl))
    h = h * _expert_matmul(xin, params["we_up"], impl)
    xout = _expert_matmul(h.to(x.dtype), params["we_down"], impl)

    # combine: each token's kept top-k outputs, weighted by their gates
    # (in x's dtype, as the reference's combine tensor)
    gate_per_e = (onehot * gates[..., None]).sum(dim=1)       # [Nc, E]
    w = torch.where(keep, gate_per_e, 0.0).to(x.dtype)
    out_ext = torch.cat([xout.reshape(dump, d).to(x.dtype),
                         x.new_zeros((1, d))])
    sel_place = place.gather(1, idx)                          # [Nc, k]
    sel_w = w.gather(1, idx).float()
    y = (sel_w[..., None] * out_ext[sel_place].float()).sum(dim=1)

    # Switch load-balance loss terms (means accumulated outside)
    f_e = assign.mean(dim=0)          # fraction routed per expert (pre-drop)
    p_e = probs.mean(dim=0)
    dropped = 1.0 - keep.sum() / assign.sum().clamp(min=1.0)
    return y.to(x.dtype), f_e * p_e, dropped


def _grouped_matmul(xs: torch.Tensor, w, offsets: torch.Tensor,
                    expert: torch.Tensor, impl: str) -> torch.Tensor:
    """Expert-sorted rows xs [P, K] through their experts' [E, K, M]
    stack: one K6 launch for a PIM-resident stack; for a dense one every
    expert over every row (`kref.every_expert_ref`, E times the work),
    which only the CPU takes."""
    if isinstance(w, PimWeight):
        return kops.bitplane_grouped_matmul(
            xs, w.planes, w.scale, offsets, expert, n_bits=w.n_bits,
            group=w.group, impl=impl)
    if xs.device.type != "cpu":
        raise ValueError(
            "dropless routing over a dense expert stack runs every expert "
            f"over every row ({w.shape[0]}x the work), a CPU path only; "
            "pack the experts (--quantize) to serve them on "
            f"{xs.device.type}")
    return kref.every_expert_ref(
        expert, w.shape[0], lambda e: xs @ w[e].to(xs.dtype))


def _dropless(params: Params, x: torch.Tensor, top_k: int, act: str,
              impl: str):
    """Every pair of x [N, D]: (y [N, D], f_e * p_e [E], rows per expert
    [E] int32)."""
    n, d = x.shape
    e = params["router"].shape[-1]
    gates, idx, probs = _route(x.float() @ params["router"], top_k)
    pair_expert = idx.reshape(-1)                             # [N * k]
    order = torch.sort(pair_expert, stable=True).indices
    expert = pair_expert[order]
    counts = torch.zeros((e,), dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, pair_expert, torch.ones_like(pair_expert,
                                                        dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros((1,)),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    xs = x[order // top_k]                                    # [P, D]
    h = ACTS[act](_grouped_matmul(xs, params["we_gate"], offsets, expert,
                                  impl))
    h = h * _grouped_matmul(xs, params["we_up"], offsets, expert, impl)
    out = _grouped_matmul(h.to(x.dtype), params["we_down"], offsets, expert,
                          impl)
    pairs = torch.empty_like(out)
    pairs[order] = out
    pairs = pairs.reshape(n, top_k, d)
    y = gates[:, 0, None] * pairs[:, 0].float()
    for j in range(1, top_k):
        y = y + gates[:, j, None] * pairs[:, j].float()
    f_e = counts.float() / max(n, 1)
    return y.to(x.dtype), f_e * probs.mean(dim=0), counts


def _watched(x: torch.Tensor, call):
    """`call()` (a `_dropless`) inside the `model/moe` span when eager,
    its counts added to the watch's device counters (the module's
    notes)."""
    watch = WATCH.get()
    if watch is None:
        return call()
    span = not (x.is_cuda and torch.cuda.is_current_stream_capturing())
    if span:
        watch.spans.begin("model/moe")
    try:
        out = call()
        counts = out[-1]
        watch.counts.add_(torch.stack([
            counts.sum(), counts.max(), counts.new_ones(())]).to(
                watch.counts.dtype))
    finally:
        if span:
            watch.spans.end()
    return out


def expert_capacity(chunk: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Each expert's places in a chunk of `chunk` rows, in Python floats
    as the reference computes them."""
    return min(chunk, max(1, int(math.ceil(chunk * top_k / n_experts
                                           * capacity_factor))))


def moe_forward(params: Params, x: torch.Tensor, *, top_k: int,
                capacity_factor: float, act: str = "silu",
                chunk: int = MOE_CHUNK, impl: str = "auto",
                shared_d_ff: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, T, D] -> (y [B, T, D], {"load_balance_loss",
    "dropped_fraction"}). Every row of x takes part in the routing —
    idle slots and padding rows included, as in the reference, since
    rows of one chunk compete for the experts' places — and, under a
    mesh whose batch axes split the rows, every other rank's rows too.
    `capacity_factor <= 0` routes dropless (`_dropless`: no chunks, no
    places, nothing dropped). `shared_d_ff`: the shared expert's whole
    width (tensor-parallel callers give it, as to `swiglu`)."""
    rows = row_axes()
    routed = collectives.gather_apart(x, rows, 0) if rows else x
    b, t, d = routed.shape
    e = params["router"].shape[-1]
    n = b * t
    flat = routed.reshape(n, d)
    if capacity_factor <= 0:
        y, fp, _ = _watched(x, lambda: _dropless(params, flat, top_k, act,
                                                 impl))
        return _finish(params, x, y.reshape(b, t, d), rows, act, impl,
                       shared_d_ff, e * fp.sum(), fp.new_zeros(()))
    chunk = min(chunk, n)
    if n % chunk:
        pad = chunk - n % chunk
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    n_chunks = flat.shape[0] // chunk
    capacity = expert_capacity(chunk, top_k, e, capacity_factor)

    def step(_, c):
        return None, _dispatch_chunk(params, flat[c * chunk:(c + 1) * chunk],
                                     top_k, capacity, act, impl)
    _, (y, fps, drs) = scan(step, None, n_chunks,
                            join=(("cat", 0), ("stack", 0), ("stack", 0)))
    return _finish(params, x, y[:n].reshape(b, t, d), rows, act, impl,
                   shared_d_ff, e * fps.mean(dim=0).sum(), drs.mean())


def _finish(params, x, y, rows, act, impl, shared_d_ff, lb_loss, dropped):
    """This rank's rows of the routed output, plus the shared expert."""
    if rows:
        y = local_rows(y, rows)
    if "shared" in params:
        y = y + swiglu(params["shared"], x, act, impl, d_ff=shared_d_ff)
    return y, {"load_balance_loss": lb_loss, "dropped_fraction": dropped}
