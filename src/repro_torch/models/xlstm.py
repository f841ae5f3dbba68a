"""xLSTM cells: counterpart of `repro.models.xlstm` — the mLSTM (matrix
memory) and the sLSTM (scalar memory).

The mLSTM keeps a matrix memory C [hd x hd] per head that each step
updates with a rank-1 term and reads with a GEMV, the update/readout
dataflow of a PIM block row. Both cells are recurrences over time: the
reference's `lax.scan` is `models.scan` here, a Python loop over T on
the card, about a dozen torch ops per token, so a long prompt's prefill
is bound by the host's dispatch. The stabiliser `m` starts at -1e30 and
every state is f32.

State trees:
  mLSTM: {"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}
  sLSTM: {"c", "n", "m", "h": [B, D]}

Under tensor parallelism (`dist.parallel`) each cell runs whole on every
rank, on whole states (the caller gathers the cache's blocks). The
mLSTM's column-parallel `wq`, `wk`, `wv` (and `wi` where the heads
split) give this rank's columns, gathered (`whole_linear`); its `wf`
and `wog` are whole, and `w_down` is row-parallel, its partial sums
all-reduced. The sLSTM's weights are all whole.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist.parallel import row_linear, whole_linear
from ..quant.bitplane import pim_linear
from .common import Params, dense_init
from .scan import scan

State = Dict[str, torch.Tensor]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), the reference's stabilised log forget gate."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(d_model: int, n_heads: int, expand: int, generator, device,
               dtype=torch.float32, out=None) -> Params:
    """The reference's projections. Its `wi` and `wf` come from one key,
    so they are equal; here `wf` is a copy of `wi`'s draw. `out`:
    preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]
    inner = expand * d_model

    def draw(name, fan_in, fan_out):
        return dense_init(fan_in, fan_out, generator, device, dtype, o(name))
    p = {"wq": draw("wq", d_model, inner), "wk": draw("wk", d_model, inner),
         "wv": draw("wv", d_model, inner),
         "wi": draw("wi", d_model, n_heads)}
    p["wf"] = p["wi"].clone() if out is None else out["wf"].copy_(p["wi"])
    p["wog"] = draw("wog", d_model, inner)
    p["w_down"] = draw("w_down", inner, d_model)
    return p


def mlstm_shapes(d_model: int, n_heads: int, expand: int, dtype) -> Params:
    inner = expand * d_model
    wide = ((d_model, inner), dtype)
    gate = ((d_model, n_heads), dtype)
    return {"wq": wide, "wk": wide, "wv": wide, "wi": gate, "wf": gate,
            "wog": wide, "w_down": ((inner, d_model), dtype)}


def mlstm_init_state(batch: int, n_heads: int, hd: int, device) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), **f32),
        "n": torch.zeros((batch, n_heads, hd), **f32),
        "m": torch.full((batch, n_heads), -1e30, **f32),
    }


def _mlstm_step(state: State, q, k, v, it, ft) -> Tuple[State, torch.Tensor]:
    """q, k, v [B, H, hd]; it, ft [B, H] pre-activations."""
    hd = q.shape[-1]
    k = k / (hd ** 0.5)
    log_f = _log_sigmoid(ft)
    m_new = torch.maximum(log_f + state["m"], it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = (f_g[..., None, None] * state["C"]
             + i_g[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = f_g[..., None] * state["n"] + i_g[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c_new, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, q).abs(),
                        torch.exp(-m_new))
    return {"C": c_new, "n": n_new, "m": m_new}, num / den[..., None]


def _mlstm_inputs(params, x, n_heads, impl):
    b, t, _ = x.shape
    inner = params["wog"].shape[-1]

    def heads(name):
        return whole_linear(x, params[name], inner, impl).reshape(
            b, t, n_heads, -1).float()
    q, k, v = heads("wq"), heads("wk"), heads("wv")
    it = whole_linear(x, params["wi"], n_heads, impl).float()  # [B, T, H]
    ft = pim_linear(x, params["wf"], impl).float()
    og = torch.sigmoid(pim_linear(x, params["wog"], impl).float())
    return q, k, v, it, ft, og


def mlstm_forward(params: Params, x: torch.Tensor, *, n_heads: int,
                  init_state: State = None, return_state: bool = False,
                  impl: str = "auto"):
    """The recurrence over the sequence, x [B, T, D]."""
    b, t, _ = x.shape
    q, k, v, it, ft, og = _mlstm_inputs(params, x, n_heads, impl)
    hd = q.shape[-1]

    def step(state, i):
        state, h = _mlstm_step(state, q[:, i], k[:, i], v[:, i], it[:, i],
                               ft[:, i])
        return state, (h,)
    # the initial state is not bound here, so the scan frees it after
    # step 0, as the loop did
    state, (h,) = scan(step, init_state if init_state is not None
                       else mlstm_init_state(b, n_heads, hd, x.device), t,
                       join=(("stack", 1),))
    h = h.reshape(b, t, n_heads * hd)
    y = row_linear((og * h).to(x.dtype), params["w_down"], n_heads * hd,
                   impl)
    return (y, state) if return_state else y


def mlstm_decode(params: Params, x: torch.Tensor, state: State, *,
                 n_heads: int, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, State]:
    """One-token step, x [B, 1, D]."""
    b = x.shape[0]
    q, k, v, it, ft, og = _mlstm_inputs(params, x, n_heads, impl)
    state, h = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                           ft[:, 0])
    h = h.reshape(b, 1, -1)
    y = row_linear((og * h).to(x.dtype), params["w_down"], h.shape[-1],
                   impl)
    return y, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(d_model: int, n_heads: int, generator, device,
               dtype=torch.float32, out=None) -> Params:
    """`w_gates` and `w_out` in `dtype`; the recurrent `r_gates` (N(0,
    0.1)) and the bias `b_gates` (zeros) in f32, as the reference keeps
    them."""
    def o(name):
        return None if out is None else out[name]
    hd = d_model // n_heads
    w_gates = dense_init(d_model, 4 * d_model, generator, device, dtype,
                         o("w_gates"))
    r = torch.empty((n_heads, hd, 4 * hd), dtype=torch.float32,
                    device=device)
    r.normal_(0.0, 0.1, generator=generator)
    b = torch.zeros((4 * d_model,), dtype=torch.float32, device=device)
    if out is not None:
        r, b = out["r_gates"].copy_(r), out["b_gates"].copy_(b)
    return {"w_gates": w_gates, "r_gates": r, "b_gates": b,
            "w_out": dense_init(d_model, d_model, generator, device, dtype,
                                o("w_out"))}


def slstm_shapes(d_model: int, n_heads: int, dtype) -> Params:
    hd, f32 = d_model // n_heads, torch.float32
    return {"w_gates": ((d_model, 4 * d_model), dtype),
            "r_gates": ((n_heads, hd, 4 * hd), f32),
            "b_gates": ((4 * d_model,), f32),
            "w_out": ((d_model, d_model), dtype)}


def slstm_init_state(batch: int, d_model: int, device) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d_model), **f32),
        "n": torch.full((batch, d_model), 1e-6, **f32),
        "m": torch.full((batch, d_model), -1e30, **f32),
        "h": torch.zeros((batch, d_model), **f32),
    }


def _slstm_step(state: State, gx: torch.Tensor, r_gates: torch.Tensor,
                n_heads: int) -> Tuple[State, torch.Tensor]:
    """gx [B, 4D] f32. The recurrent gates come out head by head and are
    then split four ways, which interleaves heads into gates — the
    reference's reshape, kept exactly."""
    b, d4 = gx.shape
    d = d4 // 4
    hr = state["h"].reshape(b, n_heads, d // n_heads)
    gr = torch.einsum("bhd,hde->bhe", hr, r_gates).reshape(b, d4)
    it, ft, zt, ot = (gx + gr).chunk(4, dim=-1)
    log_f = _log_sigmoid(ft)
    m_new = torch.maximum(log_f + state["m"], it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = f_g * state["c"] + i_g * torch.tanh(zt)
    n_new = f_g * state["n"] + i_g
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}, h_new


def _slstm_gates(params, x, impl):
    return (pim_linear(x, params["w_gates"], impl)
            + params["b_gates"].to(x.dtype)).float()


def slstm_forward(params: Params, x: torch.Tensor, *, n_heads: int,
                  init_state: State = None, return_state: bool = False,
                  impl: str = "auto"):
    b, t, d = x.shape
    gx = _slstm_gates(params, x, impl)

    def step(state, i):
        state, h = _slstm_step(state, gx[:, i], params["r_gates"], n_heads)
        return state, (h,)
    state, (h,) = scan(step, init_state if init_state is not None
                       else slstm_init_state(b, d, x.device), t,
                       join=(("stack", 1),))
    h = h.to(x.dtype)
    y = pim_linear(h, params["w_out"], impl)
    return (y, state) if return_state else y


def slstm_decode(params: Params, x: torch.Tensor, state: State, *,
                 n_heads: int, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, State]:
    gx = _slstm_gates(params, x, impl)
    state, h = _slstm_step(state, gx[:, 0], params["r_gates"], n_heads)
    return pim_linear(h[:, None, :].to(x.dtype), params["w_out"], impl), state
