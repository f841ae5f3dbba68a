"""Mamba2 (SSD) block: counterpart of `repro.models.mamba2` — the chunked
scan for prefill, the recurrence for decode.

State-space duality layer with n_groups = 1:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t ⊗ x_t)     h: [B, H, P, N]
    y_t = C_t · h_t + D ⊙ x_t

Prefill splits the sequence into chunks of `CHUNK` steps; within a chunk
the recurrence is unrolled into an attention-like quadratic form, and a
`models.scan` carries the [B, H, P, N] state across chunk boundaries
(the reference's `lax.scan`). The [B, L, L, H] decay tensor lives one chunk
at a time. Decode is the recurrence, a handful of projections through
`pim_linear`.

The reference's arithmetic is kept where it rounds: `conv_w`, `conv_b`,
`A_log`, `D` and `dt_bias` are f32 leaves; prefill's causal conv casts
`conv_w` and `conv_b` to the activation dtype, decode's conv is an f32
contraction with the raw f32 leaves. At bf16 the two round differently,
in the reference too. Neither path is a TPU kernel: both are plain
torch ops, as they are jnp in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..quant.bitplane import pim_linear
from .common import Params, dense_init, rmsnorm, rmsnorm_params
from .scan import scan

CHUNK = 256
#: the reference's clip of the log-decay exponents
_CLIP = 60.0


def conv_dim(d_inner: int, n_state: int) -> int:
    return d_inner + 2 * n_state  # x, B, C share the causal conv


def init_mamba2(d_model: int, d_inner: int, n_heads: int, n_state: int,
                d_conv: int, generator, device, dtype=torch.float32,
                out=None) -> Params:
    """The reference's leaves and init scales: the projections in
    `dtype`, the conv, `A_log`, `D` and `dt_bias` in f32. `out`:
    preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]
    cd = conv_dim(d_inner, n_state)
    f32 = dict(dtype=torch.float32, device=device)
    w_in = dense_init(d_model, 2 * d_inner + 2 * n_state + n_heads,
                      generator, device, dtype, o("w_in"))
    conv_w = torch.empty((d_conv, cd), **f32)
    conv_w.normal_(0.0, 0.1, generator=generator)
    leaves = {
        "conv_w": conv_w,
        "conv_b": torch.zeros((cd,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.full((n_heads,), math.log(math.expm1(0.01)), **f32),
    }
    if out is not None:
        leaves = {k: out[k].copy_(v) for k, v in leaves.items()}
    return {
        "w_in": w_in,
        **leaves,
        "norm": rmsnorm_params(d_inner, device, o("norm")),
        "w_out": dense_init(d_inner, d_model, generator, device, dtype,
                            o("w_out")),
    }


def mamba2_shapes(d_model: int, d_inner: int, n_heads: int, n_state: int,
                  d_conv: int, dtype) -> Params:
    """`init_mamba2`'s tree with a `(shape, dtype)` pair at each leaf."""
    cd, f32 = conv_dim(d_inner, n_state), torch.float32
    return {
        "w_in": ((d_model, 2 * d_inner + 2 * n_state + n_heads), dtype),
        "conv_w": ((d_conv, cd), f32), "conv_b": ((cd,), f32),
        "A_log": ((n_heads,), f32), "D": ((n_heads,), f32),
        "dt_bias": ((n_heads,), f32), "norm": {"g": ((d_inner,), f32)},
        "w_out": ((d_inner, d_model), dtype),
    }


def _split_proj(proj, d_inner, n_state, n_heads):
    """(z, xbc, dt) of the input projection."""
    cd = conv_dim(d_inner, n_state)
    return torch.split(proj, [d_inner, cd, proj.shape[-1] - d_inner - cd],
                       dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, xbc [B, T, C], w [K, C], in xbc's
    dtype: taps summed in order, as the reference's `sum(...)`."""
    k, t = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    w = w.to(xbc.dtype)
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + t] * w[i]
    return F.silu(out + b.to(xbc.dtype))


def _chunk_step(h_prev, xk, bk, ck, dtk, a):
    """One chunk of the SSD scan: xk [B, L, H, P] (activation dtype), bk
    and ck [B, L, N] f32, dtk [B, L, H] f32. Returns (h_new, y [B, L, H,
    P] f32)."""
    ak = dtk * a
    cums = torch.cumsum(ak, dim=1)                        # [B, L, H]
    scores = torch.einsum("bin,bjn->bij", ck, bk)         # [B, L, L]
    decay = torch.exp(torch.clamp(cums[:, :, None, :] - cums[:, None, :, :],
                                  -_CLIP, 0.0))           # [B, i, j, H]
    n = xk.shape[1]
    causal = torch.tril(torch.ones((n, n), dtype=torch.float32,
                                   device=xk.device))
    w = (scores[:, :, :, None] * decay * dtk[:, None, :, :]
         * causal[None, :, :, None])
    del decay
    xf = xk.float()
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xf)
    del w
    y_inter = torch.einsum("bin,bhpn->bihp", ck, h_prev) * torch.exp(
        torch.clamp(cums, -_CLIP, 0.0))[..., None]
    tail = torch.exp(torch.clamp(cums[:, -1:, :] - cums, -_CLIP, 0.0))
    dh = torch.einsum("blh,bln,blhp->bhpn", tail * dtk, bk, xf)
    h_new = torch.exp(torch.clamp(cums[:, -1], min=-_CLIP))[
        :, :, None, None] * h_prev + dh
    return h_new, y_intra + y_inter


def mamba2_forward(
    params: Params,
    u: torch.Tensor,                  # [B, T, D]
    *,
    n_heads: int,
    n_state: int,
    d_inner: int,
    chunk: int = CHUNK,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] f32
    return_state: bool = False,
    impl: str = "auto",
):
    """Full-sequence block output [B, T, D]; with `return_state` also
    `(h_last [B, H, P, N] f32, conv_tail [B, d_conv - 1, conv_dim])`, the
    tail being the last raw (pre-conv) inputs, left-padded with zeros
    when T < d_conv - 1."""
    b, t, _ = u.shape
    h_heads, n = n_heads, n_state
    p = d_inner // n_heads
    proj = pim_linear(u, params["w_in"], impl)
    z, xbc_raw, dt_raw = _split_proj(proj, d_inner, n, h_heads)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    x, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    x = x.reshape(b, t, h_heads, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # [B, T, H]
    a = -torch.exp(params["A_log"])                       # [H]

    lpad = (-t) % chunk
    xs, bs_, cs, dts = x, b_in.float(), c_in.float(), dt
    if lpad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, lpad))
        bs_ = F.pad(bs_, (0, 0, 0, lpad))
        cs = F.pad(cs, (0, 0, 0, lpad))
        dts = F.pad(dts, (0, 0, 0, lpad))

    def step(h, c):
        sl = slice(c * chunk, (c + 1) * chunk)
        h, yk = _chunk_step(h, xs[:, sl], bs_[:, sl], cs[:, sl], dts[:, sl],
                            a)
        return h, (yk,)
    h, (y,) = scan(step, init_state if init_state is not None
                   else torch.zeros((b, h_heads, p, n), dtype=torch.float32,
                                    device=u.device),
                   (t + lpad) // chunk, join=(("cat", 1),))
    y = y[:, :t]
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(b, t, d_inner).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = pim_linear(y, params["w_out"], impl)
    if not return_state:
        return out
    k = params["conv_w"].shape[0]
    pad_t = max(0, (k - 1) - t)
    tail = xbc_raw[:, t - (k - 1 - pad_t):]
    if pad_t:
        tail = F.pad(tail, (0, 0, pad_t, 0))
    return out, (h, tail)


def mamba2_decode(
    params: Params,
    u: torch.Tensor,                  # [B, 1, D]
    state: torch.Tensor,              # [B, H, P, N] f32
    conv_state: torch.Tensor,         # [B, d_conv - 1, conv_dim]
    *,
    n_heads: int,
    n_state: int,
    d_inner: int,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrence. Returns (y, new_state, new_conv_state);
    the inputs are not written."""
    b = u.shape[0]
    h_heads, n = n_heads, n_state
    p = d_inner // n_heads
    proj = pim_linear(u, params["w_in"], impl)
    z, xbc, dt_raw = _split_proj(proj, d_inner, n, h_heads)
    # causal conv against the cached tail, an f32 contraction
    hist = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)
    k = params["conv_w"].shape[0]
    window = hist[:, -k:]
    xbc_t = F.silu(
        torch.einsum("bkc,kc->bc", window.float(), params["conv_w"])
        + params["conv_b"]
    )[:, None, :].to(u.dtype)
    new_conv = hist[:, -(k - 1):]
    x, b_in, c_in = torch.split(xbc_t, [d_inner, n, n], dim=-1)
    x = x.reshape(b, h_heads, p).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])[:, 0]   # [B, H]
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a)                                   # [B, H]
    bf = b_in[:, 0].float()                                     # [B, N]
    cf = c_in[:, 0].float()
    new_state = decay[:, :, None, None] * state + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bf, x)
    y = (torch.einsum("bn,bhpn->bhp", cf, new_state)
         + params["D"][None, :, None] * x)
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return pim_linear(y, params["w_out"], impl), new_state, new_conv
