"""Serving, dense and paged, and continuous batching: counterpart of
`repro.serve`."""

from .engine import ServeConfig, ServeEngine
from .paged_cache import SCRATCH_PAGE, PagedKVCache
from .prefix_cache import PrefixIndex
from .scheduler import ContinuousBatcher, Request

__all__ = [
    "ServeConfig", "ServeEngine", "ContinuousBatcher", "Request",
    "PagedKVCache", "PrefixIndex", "SCRATCH_PAGE",
]
