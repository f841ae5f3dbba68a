"""Deterministic data pipeline: counterpart of `repro.data`."""

from .loader import PrefetchLoader
from .synthetic import DataConfig, batch_at, host_shard
__all__ = ["PrefetchLoader", "DataConfig", "batch_at", "host_shard"]
