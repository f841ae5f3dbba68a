"""Mixture-of-Experts layer with capacity-based top-k routing:
counterpart of `repro.models.moe`.

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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..dist import collectives
from ..dist.parallel import local_rows
from ..dist.sharding import row_axes, shard
from ..kernels import ops as kops
from ..quant.bitplane import PimWeight
from .common import ACTS, Params, dense_init
from .mlp import init_swiglu, swiglu
from .scan import scan

#: token chunk of the dispatch (the reference's)
MOE_CHUNK = 2048


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
    `shared_d_ff`: the shared expert's whole width (tensor-parallel
    callers give it, as to `swiglu`)."""
    rows = row_axes()
    routed = collectives.gather_apart(x, rows, 0) if rows else x
    b, t, d = routed.shape
    e = params["router"].shape[-1]
    n = b * t
    flat = routed.reshape(n, d)
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
    y = y[:n].reshape(b, t, d)
    if rows:
        y = local_rows(y, rows)
    if "shared" in params:
        y = y + swiglu(params["shared"], x, act, impl, d_ff=shared_d_ff)
    aux = {
        "load_balance_loss": e * fps.mean(dim=0).sum(),
        "dropped_fraction": drs.mean(),
    }
    return y, aux
