"""End-to-end example: train a ~100M-parameter LM for a few hundred steps,
the port of the reference's ``examples/train_100m.py`` (same ``CFG_100M``
and settings), on the CUDA card unless ``--device cpu`` is asked for.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

Checkpoints land in /tmp/repro_100m_torch; re-running resumes
automatically (the fault-tolerant restart path).
"""
import argparse

from repro_torch.configs.base import ArchConfig, DENSE
from repro_torch.models import model_zoo as zoo
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer

CFG_100M = ArchConfig(
    name="lm-100m", family=DENSE, num_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32000,
    tie_embeddings=True, norm="rmsnorm", act="silu")


def train_config(steps: int, ckpt: str) -> TrainConfig:
    return TrainConfig(opt=AdamWConfig(lr=6e-4, warmup_steps=30,
                                       total_steps=steps),
                       microbatches=2, checkpoint_dir=ckpt,
                       checkpoint_every=50, log_every=10)


def data_config(batch: int, seq_len: int) -> DataConfig:
    return DataConfig(vocab_size=CFG_100M.vocab_size, seq_len=seq_len,
                      global_batch=batch, seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/repro_100m_torch")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    model = zoo.build(CFG_100M)
    trainer = Trainer(model, train_config(args.steps, args.ckpt),
                      data_config(args.batch, args.seq_len), seed=0,
                      device=args.device)
    n = zoo.param_count(trainer.params)
    print(f"params: {n:,} (~{n / 1e6:.0f}M), resuming from step "
          f"{trainer.step}")
    trainer.run(args.steps - trainer.step)
    print("done:", trainer.history[-1])
    return trainer


if __name__ == "__main__":
    main()
