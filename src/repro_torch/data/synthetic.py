"""Deterministic synthetic token pipeline: counterpart of
`repro.data.synthetic`, a copy of its numpy code, so batches equal the
reference's bit for bit.

Stateless by design: batch(step) is a pure function of (seed, step), so a
restarted trainer reproduces the exact stream with no iterator state in
the checkpoint.

The "documents" are a mixture of structured patterns (repeats, ngram
chains) so the LM loss actually decreases.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.vocab_size, cfg.seq_len])
    )


def batch_at(cfg: DataConfig, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, targets) int32 [global_batch, seq_len]; next-token LM."""
    rng = _rng_for(cfg, step)
    b, t, v = cfg.global_batch, cfg.seq_len + 1, cfg.vocab_size
    # mostly short-period repeats (periods 2-4) with a small unstructured
    # remainder: learnable structure at any vocab size, enough signal that
    # a smoke model's loss visibly decreases within a 60-step run.
    base = rng.integers(0, v, size=(b, t), dtype=np.int64)
    period = rng.integers(2, 5, size=(b, 1))
    idx = np.arange(t)[None, :]
    repeated = base[np.arange(b)[:, None], idx % period]
    mix = rng.random((b, 1)) < 0.95
    seq = np.where(mix, repeated, (base + np.cumsum(base % 3, axis=1)) % v)
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def host_shard(
    arr: np.ndarray, host_index: int, host_count: int
) -> np.ndarray:
    """Static batch-dim sharding across hosts (data loading parallelism)."""
    b = arr.shape[0]
    per = b // host_count
    return arr[host_index * per : (host_index + 1) * per]
