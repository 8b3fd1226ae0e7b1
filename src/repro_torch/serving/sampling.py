"""Token sampling (greedy / temperature), padded-vocab aware: the port
of ``repro.serving.sampling``.

Greedy picks the first maximum, as ``jnp.argmax`` does.  Temperature
sampling draws from the caller's ``torch.Generator``; it cannot match
the reference's ``jax.random`` draws bit for bit.
"""
from __future__ import annotations

import torch


def sample_token(logits, generator=None, *, greedy: bool = True,
                 temperature: float = 1.0, vocab_logical: int = 0) -> int:
    """logits: (V_phys,). Returns a token id < vocab_logical."""
    logits = logits.float()
    if vocab_logical and vocab_logical < logits.shape[-1]:
        logits = logits.clone()
        logits[vocab_logical:] = -1e30
    if greedy:
        return int(torch.argmax(logits, dim=-1))
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))
