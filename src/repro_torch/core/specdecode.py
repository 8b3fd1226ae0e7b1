"""Speculative decoding for the DES core (Leviathan et al. 2023; vLLM).

A draft model proposes ``lookahead`` (K) tokens per step; the target
model verifies them in one batched forward over K+1 query positions and
keeps the accepted prefix plus one bonus/correction token, so a decode
step emits between 1 and K+1 tokens.  The simulator models this as:

  * **draft cost** — K sequential decode iterations of a second,
    ``HardwareSpec``-costed roofline model built from the draft
    architecture (same chip as the worker, smaller weights),
  * **verify cost** — the K+1 draft tokens enter the target iteration's
    ``BatchMix`` as a prefill-like chunk (causal attention over the
    live context), so verify tokens bill the same operator-granular
    roofline as everything else and count against the local scheduler's
    ``max_batched_tokens`` budget,
  * **accept/rollback** — the number of accepted tokens is sampled from
    an ``AcceptanceModel``; KV blocks of rejected draft tokens are
    released via ``BlockManager.rollback_tokens`` in the same iteration
    (no leaked blocks, property-tested in tests/test_spec_decode.py).

This reproduces the known batch-occupancy crossover: at batch 1 decode
is weight-bandwidth-bound, verifying K+1 tokens costs about the same as
one, and speculation multiplies tokens/step; at high occupancy verify
work is compute-bound and the rejected fraction plus draft overhead
makes speculation net-negative (see benchmarks/spec_decode.py).

The port's copy of ``repro.core.specdecode``, its imports rewritten.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Tuple, Union

#: acceptance-probability model kinds
CONSTANT = "constant"      # same probability at every draft position
GEOMETRIC = "geometric"    # decaying: p_i = rate * decay**i
TRACE = "trace"            # per-position probabilities fitted offline
ACCEPTANCE_KINDS = (CONSTANT, GEOMETRIC, TRACE)


@dataclass(frozen=True)
class AcceptanceModel:
    """Per-position probability that the target accepts draft token i.

    ``constant`` uses ``rate`` everywhere; ``geometric`` decays it by
    ``decay`` per position (later draft tokens condition on earlier
    unverified ones, so real acceptance falls with depth); ``trace``
    takes explicit ``per_position`` probabilities fitted from a measured
    acceptance trace (positions past the tuple reuse its last entry).
    """

    kind: str = CONSTANT
    rate: float = 0.8
    decay: float = 0.9
    per_position: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.kind not in ACCEPTANCE_KINDS:
            raise ValueError(
                f"acceptance kind {self.kind!r} not in {ACCEPTANCE_KINDS}")
        if self.kind == TRACE and not self.per_position:
            raise ValueError("trace acceptance model needs per_position")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")

    def prob(self, position: int) -> float:
        """Acceptance probability at draft position ``position`` (0-based)."""
        if self.kind == CONSTANT:
            return self.rate
        if self.kind == GEOMETRIC:
            return self.rate * self.decay ** position
        idx = min(position, len(self.per_position) - 1)
        return self.per_position[idx]

    def sample_accepted(self, rng: random.Random, k: int) -> int:
        """Accepted draft tokens in one verify step: the draft prefix up
        to (excluding) the first rejection, capped at ``k``."""
        for i in range(k):
            if rng.random() >= self.prob(i):
                return i
        return k

    def expected_accepted(self, k: int) -> float:
        """E[accepted] for a K-token draft (closed form over prefixes)."""
        exp, live = 0.0, 1.0
        for i in range(k):
            live *= self.prob(i)
            exp += live
        return exp


@dataclass(frozen=True)
class SpecDecodeSpec:
    """Speculative-decoding configuration attached to ``SimSpec``.

    ``draft_arch`` names the proposer (any registry config or an
    ``ArchConfig``); it is costed on the *same* ``HardwareSpec`` as the
    worker it runs on, with optional ``draft_hw_overrides`` (e.g. a
    dedicated draft accelerator's FLOPs).  ``lookahead`` is K, the draft
    tokens proposed per step.  The acceptance model decides how many
    survive verification; ``seed`` decorrelates acceptance sampling
    while keeping the simulation a pure function of its spec.
    """

    draft_arch: Union[str, object] = "qwen2-0.5b"
    lookahead: int = 4
    acceptance: AcceptanceModel = field(default_factory=AcceptanceModel)
    seed: int = 0
    draft_hw_overrides: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if self.lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {self.lookahead}")

    @property
    def verify_tokens(self) -> int:
        """Query positions per verify step (K drafts + 1 bonus)."""
        return self.lookahead + 1

    def rng_for_worker(self, wid: int) -> random.Random:
        """Deterministic per-worker acceptance RNG (event order inside a
        worker is deterministic, so this keeps runs reproducible)."""
        return random.Random((self.seed + 1) * 0x9E3779B1 + wid)
