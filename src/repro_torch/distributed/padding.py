"""Pad-to-shard planning.

Several assigned configs do not divide the tensor-parallel axis (e.g.
qwen3-14b has 40 Q / 8 KV heads vs TP=16). We compute a *physical* plan:

* KV heads are replicated ``rep = tp // Hkv`` times when ``Hkv < tp``
  (Megatron-style GQA replication; requires ``Hkv | tp``). Replication
  happens on the *activation* after the KV projection, so the logical model
  (and its gradients) are exactly preserved at any tp.
* Q heads are padded so that (a) every device holds an integer number of
  heads and (b) all Q heads on a device share that device's KV head:
  per KV-copy group size ``Gp = ceil(G / rep)`` with ``G = Hq / Hkv``;
  physical ``Qp = Hkv * rep * Gp``. Padded heads are masked at the output
  projection (their gradients are exactly zero).
* Physical Q-head layout: ``[kv0.copy0 (Gp heads), kv0.copy1, ..., kv1.copy0,
  ...]``; physical q head ``i`` attends with physical kv head ``i // Gp``,
  and physical kv head ``j`` is original head ``j // rep``.
* Vocab is padded to a multiple of 256 (padded logits masked to -inf in the
  loss and sampler).
* MoE experts are padded to a multiple of the EP axis; padded experts get
  ``-inf`` router logits.
* SSD heads are padded to a multiple of tp and masked at ``out_proj``.

``tp == 1`` (all CPU tests) yields the identity plan, so smoke-test numerics
are exactly the logical model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig, pad_to


@dataclass(frozen=True)
class PadPlan:
    tp: int
    # attention
    n_q: int               # physical q heads
    n_kv: int              # physical kv heads (= logical * kv_rep)
    kv_rep: int
    group: int             # physical q heads per physical kv head (Gp)
    n_q_logical: int
    # vocab
    vocab: int
    vocab_logical: int
    # moe
    n_experts: int
    n_experts_logical: int
    # ssm
    ssm_heads: int
    ssm_heads_logical: int

    @property
    def has_q_padding(self) -> bool:
        return self.n_q != self.n_q_logical

    def q_head_mask(self) -> np.ndarray:
        """Boolean (n_q,) — True for heads that exist in the logical model.

        Layout: for each original kv head h, ``kv_rep`` copies, each with
        ``group`` physical slots; original q heads ``h*G .. h*G+G-1`` are
        distributed to copies in order (copy r holds logical q heads
        ``h*G + r*group .. min(h*G + (r+1)*group, (h+1)*G) - 1``).
        """
        if self.n_q_logical == 0:
            return np.zeros((0,), bool)
        hkv = self.n_kv // self.kv_rep
        g_logical = self.n_q_logical // max(1, hkv)
        mask = np.zeros((self.n_q,), bool)
        slot = 0
        for h in range(hkv):
            remaining = g_logical
            for _ in range(self.kv_rep):
                take = min(self.group, max(0, remaining))
                mask[slot:slot + take] = True
                remaining -= take
                slot += self.group
        assert mask.sum() == self.n_q_logical, (mask.sum(), self)
        return mask

    def ssm_head_mask(self) -> np.ndarray:
        mask = np.zeros((self.ssm_heads,), bool)
        mask[: self.ssm_heads_logical] = True
        return mask

    def expert_mask(self) -> np.ndarray:
        mask = np.zeros((self.n_experts,), bool)
        mask[: self.n_experts_logical] = True
        return mask


def make_pad_plan(cfg: ArchConfig, tp: int = 1) -> PadPlan:
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq and hkv:
        if hkv >= tp:
            if hkv % tp:
                raise ValueError(f"{cfg.name}: kv heads {hkv} vs tp {tp}")
            rep = 1
        else:
            if tp % hkv:
                raise ValueError(f"{cfg.name}: kv heads {hkv} must divide tp {tp}")
            rep = tp // hkv
        g = hq // hkv
        if hq % hkv:
            raise ValueError(f"{cfg.name}: q heads {hq} not multiple of kv {hkv}")
        gp = math.ceil(g / rep)
        n_kv_p = hkv * rep
        n_q_p = n_kv_p * gp
        group = gp
    else:
        rep, group, n_kv_p, n_q_p = 1, 1, hkv, hq

    vocab_p = pad_to(cfg.vocab_size, max(256, tp)) if cfg.vocab_size else 0

    n_exp = cfg.moe.num_experts if cfg.moe else 0
    n_exp_p = pad_to(n_exp, tp) if n_exp else 0

    ssm_h = cfg.ssm.n_heads(cfg.d_model) if cfg.ssm else 0
    ssm_h_p = pad_to(ssm_h, tp) if ssm_h else 0

    return PadPlan(tp=tp,
                   n_q=n_q_p, n_kv=n_kv_p, kv_rep=rep, group=group,
                   n_q_logical=hq,
                   vocab=vocab_p, vocab_logical=cfg.vocab_size,
                   n_experts=n_exp_p, n_experts_logical=n_exp,
                   ssm_heads=ssm_h_p, ssm_heads_logical=ssm_h)
