"""LM loss: cross-entropy + z-loss: counterpart of `repro.train.loss`."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def softmax_cross_entropy(
    logits: torch.Tensor,     # [B, T, V]
    targets: torch.Tensor,    # [B, T] int
    z_loss_coef: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`(loss, {"nll", "z_loss", "accuracy"})`, all f32 scalars: the
    logsumexp in f32, the gold logit gathered, accuracy from `argmax`,
    which takes the first maximum, as `jnp.argmax` does."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss_coef * torch.square(lse)
    loss = torch.mean(nll + zl)
    metrics = {
        "nll": torch.mean(nll),
        "z_loss": torch.mean(zl),
        "accuracy": torch.mean(
            (torch.argmax(lf, dim=-1) == targets.long()).float()
        ),
    }
    return loss, metrics
