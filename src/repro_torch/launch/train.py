"""Training CLI: the port of ``repro.launch.train``, with the same
arguments and defaults plus ``--device``: the CUDA card unless
``--device cpu`` is asked for.

Examples:
  # smoke-size 2-layer qwen3 on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --smoke --steps 50 --seq-len 64 --batch 8 --device cpu
  # mamba2-130m whole on the card (the SSD-scan kernel in each layer's
  # forward, its recompute under --remat full too)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 10 --seq-len 1024 --batch 4
  # ~100M-param model for a few hundred steps:
  # python -m repro_torch.examples.train_100m

Weights are random, from ``--seed`` (``init_params(..., master=True)``).
Prints the parameter count, a line every ``log_every`` steps and the
last step's metrics; ``--history-out`` writes every step's.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import REMAT_MODES, RunSettings
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="full", choices=REMAT_MODES)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace) -> Trainer:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = zoo.build(cfg, settings=RunSettings(remat=args.remat))
    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch, seed=args.seed)
    return Trainer(model, tc, dc, seed=args.seed, device=args.device)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer = build_trainer(args)
    print(f"arch={trainer.model.cfg.name} "
          f"params={zoo.param_count(trainer.params):,} steps={args.steps}")
    trainer.run(args.steps)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(trainer.history, f)
    print("final:", trainer.history[-1])
    return trainer


if __name__ == "__main__":
    main()
