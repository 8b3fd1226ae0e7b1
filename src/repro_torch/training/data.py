"""Training data pipeline: deterministic synthetic LM streams.

Offline container => no real corpora; the pipeline generates a seeded
Zipfian token stream with Markov structure (so the LM has learnable
signal and loss decreases), packed into fixed-length sequences.  The
interface (``DataConfig`` -> iterator of {"tokens","labels"} batches,
checkpointable cursor) is what a real loader would implement.

The port's copy of ``repro.training.data`` (numpy only, as it stands).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    markov_order: int = 1
    markov_weight: float = 0.7    # learnable structure strength


class DataPipeline:
    """Deterministic, seekable batch stream (cursor = batch index)."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.RandomState(dc.seed)
        v = dc.vocab_size
        # base Zipf distribution over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._base = ranks ** -dc.zipf_a
        self._base /= self._base.sum()
        # a sparse deterministic successor table: tok -> preferred next
        self._succ = rng.permutation(v)
        self.cursor = 0

    def batch_at(self, idx: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rng = np.random.RandomState((dc.seed * 1_000_003 + idx) % 2 ** 31)
        b, s = dc.global_batch, dc.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(dc.vocab_size, size=b, p=self._base)
        follow = rng.random_sample((b, s)) < dc.markov_weight
        rand_part = rng.choice(dc.vocab_size, size=(b, s), p=self._base)
        for t in range(s):
            nxt = np.where(follow[:, t], self._succ[toks[:, t]],
                           rand_part[:, t])
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.cursor)
            self.cursor += 1

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
