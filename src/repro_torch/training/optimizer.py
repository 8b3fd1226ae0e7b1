"""AdamW with a cosine schedule: the port of ``repro.training.optimizer``,
as plain functions on nested dicts of tensors (no ``torch.optim``).

The numerics are the reference's.  ``mu``/``nu`` start as
``zeros_like(params)``; ``step`` is an int32 0-d tensor; the update runs
in fp32 and casts the new parameter to its own dtype.  ``lr`` and the
bias corrections are fp32 0-d tensors and every product is taken in
fp32, so no bf16 operand sets a product's dtype, which a 0-d tensor
would let it do in torch where JAX's fp32 scalar would not.  Weight
decay applies to every leaf of two or more dimensions: since the layers
are stacked, that includes the stacked ``(L, d)`` norm scales and biases,
as in the reference.

Memory: ``adamw_update`` writes each leaf's new parameter, ``mu`` and
``nu`` into the dicts it was given as soon as they are computed,
replacing the old tensors (which it never writes into), so the old and
the new trees never take memory together; the reference's update builds
new trees, which XLA keeps beside the old ones.  At llama2-7b's full
width that is the difference between 30 GB of fp32 state plus one leaf's
temporaries and twice as much.  On DTensor leaves (a sharding plan) the
same holds shard by shard: each new leaf keeps its parameter's
placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_frac, as an fp32 0-d
    tensor (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def adamw_init(params) -> dict:
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
    step_device = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (params, opt_state, metrics): the trees it was given, every
    leaf of ``params``, ``opt_state["mu"]`` and ``opt_state["nu"]``
    replaced by its update, and ``opt_state["step"]`` advanced."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    t = step.float() + 1.0
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(g, m, v, p):
        if isinstance(p, DTensor):
            # a gradient may come back on other placements than its
            # parameter's; the update keeps the parameter's
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                  # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    def update(g, mu, nu, p):
        for k in g:
            if isinstance(g[k], dict):
                update(g[k], mu[k], nu[k], p[k])
            else:
                p[k], mu[k], nu[k] = upd(g[k], mu[k], nu[k], p[k])

    update(grads, opt_state["mu"], opt_state["nu"], params)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
