"""Iteration workload summary: the port's copy of ``BatchMix`` and
``_bucket8`` from ``repro.core.costmodel.operators``.

The serving engine records one ``BatchMix`` per iteration, exactly as the
reference engine does, so the two engines' records compare field by
field.  The operator graph of the reference module is the simulator's
cost model and is not part of the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


def _bucket8(n: int) -> int:
    """Power-of-two padding bucket (>=8) — mirrors the real engine's
    prefill shape bucketing so calibrated backends see the same shapes."""
    return max(8, 1 << (int(n) - 1).bit_length()) if n > 0 else 0


@dataclass(frozen=True)
class BatchMix:
    new_tokens: int = 0
    attn_units: float = 0.0
    kv_read_tokens: float = 0.0
    n_seqs: int = 0
    enc_tokens: int = 0
    padded_tokens: float = 0.0     # Σ bucket(prefill chunk) + decodes

    @staticmethod
    def from_batch(prefill: List[Tuple[int, int]],
                   decode_ctx: List[int],
                   enc_tokens: int = 0) -> "BatchMix":
        """prefill: [(chunk_len, ctx_before)], decode_ctx: [context_len]."""
        new_tokens = sum(c for c, _ in prefill) + len(decode_ctx)
        attn_units = sum(c * (b + (c + 1) / 2.0) for c, b in prefill) \
            + float(sum(decode_ctx))
        kv_read = sum(b + c for c, b in prefill) + float(sum(decode_ctx))
        padded = float(sum(_bucket8(c) for c, _ in prefill)) \
            + len(decode_ctx)
        return BatchMix(new_tokens=new_tokens, attn_units=attn_units,
                        kv_read_tokens=kv_read,
                        n_seqs=len(prefill) + len(decode_ctx),
                        enc_tokens=enc_tokens, padded_tokens=padded)
