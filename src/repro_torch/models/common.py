"""Shared model building blocks: dtype policy, device, init, norms, RoPE,
the additive mask's "minus infinity".

Counterpart of `repro.models.common`. Parameters are plain nested dicts
of tensors, with the reference's names (projection kernels ``w*``,
biases ``b*``, norm gains ``g``) and layouts (``[fan_in, fan_out]``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Entry points default to
    `"cuda"`; with no card present that raises instead of moving to the
    CPU behind the caller's back — the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# init (same shapes and scales as the reference; other random numbers)
# ---------------------------------------------------------------------------

def dense_init(fan_in: int, fan_out: int, generator: torch.Generator,
               device, dtype=torch.float32, out=None) -> torch.Tensor:
    """Truncated-normal fan-in init: stddev 1/sqrt(fan_in), cut at ±3σ.
    Drawn in f32, then cast to `dtype` — or copied, with the same
    rounding, into `out`, a preallocated view such as one layer of a
    stacked `[L, ...]` leaf."""
    w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=device)
    std = 1.0 / math.sqrt(fan_in)
    torch.nn.init.trunc_normal_(w, 0.0, std, -3.0 * std, 3.0 * std,
                                generator=generator)
    return w.to(dtype) if out is None else out.copy_(w)


def embed_init(vocab: int, dim: int, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=generator)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(dim: int, device, out=None) -> Params:
    if out is not None:
        return {"g": out["g"].fill_(1.0)}
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5):
    """RMS norm computed in f32 (the gain stays f32), cast back to x's
    dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["g"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def _yarn_bounds(head_dim: int, yarn) -> Tuple[float, float]:
    """YaRN's ramp `(low, high)` over the frequency index: `low =
    floor(d ln(orig / (2 pi beta_fast)) / (2 ln theta))`, `high` the
    ceiling of the same at `beta_slow`, both clamped into [0, d - 1]."""
    def dim(beta):
        return (head_dim * math.log(yarn.original_context
                                    / (beta * 2 * math.pi))
                / (2 * math.log(yarn.theta)))
    low = max(math.floor(dim(yarn.beta_fast)), 0)
    high = min(math.ceil(dim(yarn.beta_slow)), head_dim - 1)
    return float(low), float(high if high != low else high + 0.001)


def rope_frequencies(head_dim: int, theta, device) -> torch.Tensor:
    """The inverse frequencies `theta^(-2i/d)`, i in [0, d/2). `theta` a
    `configs.base.Yarn`: YaRN's blend `extrap * gamma + extrap / factor *
    (1 - gamma)`, `gamma = 1 - clamp((i - low) / (high - low), 0, 1)`
    (high-frequency dimensions keep their rate, low ones are
    interpolated). Device ops only, so a captured decode graph holds
    them."""
    half = head_dim // 2
    base = getattr(theta, "theta", theta)
    i = torch.arange(0, half, dtype=torch.float32, device=device)
    extrap = 1.0 / (base ** (i / half))
    if base is theta:
        return extrap
    low, high = _yarn_bounds(head_dim, theta)
    gamma = 1.0 - torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return extrap * gamma + (extrap / theta.factor) * (1.0 - gamma)


def apply_rope(
    x: torch.Tensor,            # [..., T, H, hd]
    positions: torch.Tensor,    # [..., T] int
    theta,                      # float, or a `configs.base.Yarn`
) -> torch.Tensor:
    """Rotary positions (rotate-half form); under YaRN cos and sin are
    also multiplied by its attention factor."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # [hd/2]
    angles = positions[..., None].float() * freqs               # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., T, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    mscale = getattr(theta, "attention_factor", None)
    if mscale is not None:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's `jax.nn.gelu`, whose default is the tanh
    approximation (torch's default is the exact erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTS = {
    "silu": torch.nn.functional.silu,
    "gelu": _gelu_tanh,
    "relu": torch.nn.functional.relu,
}

#: the additive attention mask's value at a masked score (the
#: reference's; finite, so a fully masked row stays finite)
NEG_INF = -1e30
