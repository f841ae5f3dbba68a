"""Trainer loop: checkpoint cadence, resume, straggler monitoring.
Counterpart of `repro.train.trainer`.

  - resume-from-latest on start (a preempted job restarts and continues
    bit-identically — the data pipeline is a pure function of the step);
  - async checkpointing off the critical path;
  - straggler monitor: per-step wall-time EWMA; a step slower than
    `straggler_factor` x EWMA raises a StragglerEvent to the callback.
    The first step is not a baseline (it pays one-time costs: the
    allocator's first blocks, cuBLAS's handles), and each step is
    checked against the EWMA from before its own update;
  - bounded metric logging.

The step runs eagerly on `device` (there is no `jit`); the loop
synchronises on each step's loss, where the reference blocks on it, so
a step's wall time is the device's.

With a `mesh` (data-parallel: its batch axes; the rows of each rank by
`batch_spec`) every rank runs the loop: the loader gives each rank its
rows, the step averages the gradients over the batch axes, so the
params stay equal on every rank. Rank 0 writes the checkpoints, and
every rank reads them on resume. A ``model`` axis of more than one
rank is refused: its params are blocks, which a checkpoint of whole
leaves would need gathered.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.base import ModelConfig
from ..data.loader import PrefetchLoader
from ..dist import collectives
from ..data.synthetic import DataConfig
from ..models.common import resolve_device
from ..models.frontend_stub import make_stub_embeddings
from ..optim import AdamWConfig, adamw_init
from .step import make_train_step


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    n_microbatches: int = 1
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    async_ckpt: bool = True


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        data_cfg: DataConfig,
        ckpt_dir: str,
        opt_cfg: AdamWConfig = AdamWConfig(),
        trainer_cfg: TrainerConfig = TrainerConfig(),
        mesh=None,
        batch_spec=None,
        straggler_callback: Optional[Callable[[StragglerEvent], None]] = None,
        step_fn: Optional[Callable] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.tc = trainer_cfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        if mesh is not None and "model" in mesh.axis_names \
                and mesh.shape["model"] > 1:
            raise ValueError("Trainer runs data-parallel: a mesh without a "
                             "model axis of more than one rank")
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.ckpt = CheckpointManager(ckpt_dir)
        self.straggler_callback = straggler_callback
        self.params = params
        self.opt_state = adamw_init(params)
        self.start_step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self._resume_if_possible()
        self.train_step = step_fn or make_train_step(
            cfg, opt_cfg,
            n_microbatches=trainer_cfg.n_microbatches,
            total_steps=trainer_cfg.total_steps, mesh=mesh,
        )

    # -- fault tolerance -------------------------------------------------

    def _resume_if_possible(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = self.ckpt.restore(state)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.start_step = step
        print(f"[trainer] resumed from step {step}")

    def _save(self, step: int):
        if self.mesh is not None and self.mesh.rank != 0:
            return
        state = {"params": self.params, "opt": self.opt_state}
        if self.tc.async_ckpt:
            self.ckpt.save_async(step, state)
        else:
            self.ckpt.save(step, state)

    # -- loop --------------------------------------------------------------

    def run(self) -> List[Dict[str, float]]:
        loader = PrefetchLoader(self.data_cfg, mesh=self.mesh,
                                batch_spec=self.batch_spec,
                                start_step=self.start_step,
                                device=self.device)
        ewma = None
        measured = 0
        try:
            for step, tokens, targets in loader:
                if step >= self.tc.total_steps:
                    break
                batch = self._make_batch(tokens, targets)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch
                )
                metrics["loss"].item()     # wait for the step's device work
                dt = time.perf_counter() - t0
                measured += 1
                if measured == 1:
                    pass  # first step pays one-time costs — not a baseline
                elif ewma is None:
                    ewma = dt
                else:
                    # straggler check against the PRE-update baseline so a
                    # slow step cannot mask itself
                    if dt > self.tc.straggler_factor * ewma and self.straggler_callback:
                        self.straggler_callback(StragglerEvent(step, dt, ewma))
                    ewma = (
                        self.tc.ewma_alpha * dt
                        + (1 - self.tc.ewma_alpha) * ewma
                    )
                if step % self.tc.log_every == 0 or step == self.tc.total_steps - 1:
                    row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = step
                    row["step_time_s"] = dt
                    self.metrics_log.append(row)
                if (step + 1) % self.tc.ckpt_every == 0:
                    self._save(step + 1)
            self.ckpt.wait()
            self._save(self.tc.total_steps)
            self.ckpt.wait()
            if self.mesh is not None:
                collectives.barrier(self.mesh)  # rank 0's files are written
        finally:
            loader.close()
        return self.metrics_log

    def _make_batch(self, tokens, targets) -> Dict[str, Any]:
        batch = {"tokens": tokens, "targets": targets}
        if self.cfg.is_encoder_decoder:
            batch["frames"] = make_stub_embeddings(
                self.cfg, tokens.shape[0], tokens.shape[1],
                device=self.device)
        elif self.cfg.frontend == "vision_stub":
            batch["patches"] = make_stub_embeddings(
                self.cfg, tokens.shape[0], min(self.cfg.frontend_tokens, 8),
                device=self.device)
        return batch
