"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``. Counterpart of `repro.launch.train`, with its flags, plus
`--device` (default `cuda`; `--device cpu` runs on the CPU, and without
it the launcher raises when no card is present).

Runs the smoke config by default (`--full` for the published one): f32
master weights from `init_lm` / `init_encdec`, the prefetching loader,
fault-tolerant checkpointing (a second run with the same `--ckpt-dir`
resumes from its latest step) and the straggler monitor. The default
checkpoint directory lies under the system's temp directory. See
examples/train_lm_torch.py for the 35.7M-param end-to-end run.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get_config
from ..data.synthetic import DataConfig
from ..models import init_encdec, init_lm
from ..models.common import resolve_device
from ..optim import AdamWConfig
from ..train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    init = init_encdec if cfg.is_encoder_decoder else init_lm
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                  param_dtype=torch.float32)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
    )
    ckpt_dir = os.path.join(args.ckpt_dir, args.arch.replace("/", "_"))
    trainer = Trainer(
        cfg, params, data_cfg, ckpt_dir,
        opt_cfg=AdamWConfig(lr=args.lr),
        trainer_cfg=TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            n_microbatches=args.microbatches,
        ),
        device=dev,
    )
    log = trainer.run()
    print(json.dumps(log[-3:], indent=1))
    print(f"final loss: {log[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
