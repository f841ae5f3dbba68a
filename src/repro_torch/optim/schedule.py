"""Learning-rate schedules (pure functions of the step): counterpart of
`repro.optim.schedule`.

Computed on the host in f32 tensors, in the reference's order of
operations. The cosine is the C library's `cosf`, the function XLA's
CPU code calls for an f32 cosine (torch's vectorised cosine differs from
it in the last bit at about one step in twenty), so every step's lr
equals the reference's f32 value. The result is a 0-dim (or, for a
vector of steps, 1-dim) f32 tensor on the CPU; a step on the card is
read back first — the optimizer keeps its step counter on the host for
that reason."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _cos_f32(x: torch.Tensor) -> torch.Tensor:
    cosf = _libm_cosf()
    flat = [cosf(v) for v in x.reshape(-1).tolist()]
    return torch.tensor(flat, dtype=torch.float32).reshape(x.shape)


def _host_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def warmup_cosine(
    step,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    step = _host_f32(step)
    peak = torch.tensor(peak_lr, dtype=torch.float32)
    warm = peak * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    angle = torch.tensor(math.pi, dtype=torch.float32) * progress
    cos = peak * (min_ratio + (1 - min_ratio) * 0.5 * (1 + _cos_f32(angle)))
    return torch.where(step < warmup_steps, warm, cos)


def linear_warmup_constant(step, peak_lr: float, warmup_steps: int
                           ) -> torch.Tensor:
    step = _host_f32(step)
    peak = torch.tensor(peak_lr, dtype=torch.float32)
    return peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)
