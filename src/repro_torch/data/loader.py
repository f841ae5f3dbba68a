"""Host loader with background prefetch: counterpart of
`repro.data.loader`.

Pulls deterministic batches (`data.synthetic`) from step `start_step`
on and overlaps host generation with device compute via a one-deep
prefetch thread. Batches are placed on an explicit `device`: on the
card the worker pins each batch's host memory and `__next__` copies it
with `non_blocking=True`.

With a `mesh` (`launch.mesh.Mesh`) and a `batch_spec` (a spec, e.g.
`launch.specs.train_batch_specs`' `("data",)`), each rank takes its
block of the global batch by the spec (`dist.sharding.local_block`) —
the rows the reference's `device_put` onto the `NamedSharding` gives
that device. Every rank draws the same global batch: the pipeline is
a pure function of the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import torch

from ..dist.sharding import local_block
from ..models.common import resolve_device
from .synthetic import DataConfig, batch_at


class PrefetchLoader:
    def __init__(
        self,
        cfg: DataConfig,
        mesh=None,
        batch_spec=None,
        start_step: int = 0,
        prefetch: int = 2,
        device="cuda",
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.spec = tuple(batch_spec) if batch_spec is not None else ()
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host(self, arr) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.mesh is not None:
            t = local_block(t, self.spec, self.mesh).contiguous()
        return t.pin_memory() if self._pin else t

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            tokens, targets = batch_at(self.cfg, step)
            item = (step, self._host(tokens), self._host(targets))
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            step += 1

    def __iter__(self) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self):
        step, tokens, targets = self._q.get()
        return (step, tokens.to(self.device, non_blocking=self._pin),
                targets.to(self.device, non_blocking=self._pin))

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
