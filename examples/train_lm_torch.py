"""End-to-end training on the PyTorch port: the same run as
examples/train_lm.py — a qwen2-family LM of 35.7M parameters at the
defaults (8 layers, d_model 512, vocab 8192) trained for a few hundred
steps through the port's `Trainer`: f32 master weights, the
prefetching data pipeline, fault-tolerant checkpointing and the
straggler monitor.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
      (on the card; add --device cpu for the CPU, where it takes a
      while — use --d-model 256 for a faster run of the same code path)
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.models import count_params, init_lm
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def mini_config(d_model=512, layers=8, vocab=8192):
    """qwen2-1.5b's family cut to `layers` x `d_model`, as
    examples/train_lm.py cuts it."""
    return dataclasses.replace(
        get_config("qwen2-1.5b"),
        n_layers=layers, d_model=d_model,
        n_heads=max(2, d_model // 128), n_kv_heads=max(1, d_model // 256),
        d_ff=d_model * 4, vocab_size=vocab, remat=False,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = mini_config(args.d_model, args.layers, args.vocab)
    dev = torch.device(args.device)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                     param_dtype=torch.float32)
    print(f"model: {cfg.name}-mini, {count_params(params)/1e6:.1f}M params "
          f"(count_params: {count_params(params)})")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    stragglers = []
    trainer = Trainer(
        cfg, params, data_cfg, ckpt_dir,
        opt_cfg=AdamWConfig(lr=1e-3),
        trainer_cfg=TrainerConfig(total_steps=args.steps, ckpt_every=100,
                                  log_every=20),
        straggler_callback=stragglers.append,
        device=dev,
    )
    log = trainer.run()
    first, last = log[0], log[-1]
    print(f"\nloss: {first['loss']:.3f} (step {first['step']}) -> "
          f"{last['loss']:.3f} (step {last['step']})")
    print(f"accuracy: {first['accuracy']:.3f} -> {last['accuracy']:.3f}")
    print(f"checkpoints in {ckpt_dir} (resume by re-running with --ckpt-dir)")
    if stragglers:
        print(f"straggler events: {[(e.step, round(e.step_time, 2)) for e in stragglers]}")
    assert last["loss"] < first["loss"], "training must reduce loss"


if __name__ == "__main__":
    main()
