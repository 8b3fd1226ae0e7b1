"""Attention compute: the port of ``repro.models.attention_impl``.

* ``naive``   — materializes (B,H,Sq,Skv) fp32 scores; the oracle.
* ``pallas``  — the hand-written flash kernel
                (``repro_torch.kernels.flash_attention``); on CPU tensors
                its wrapper runs the kernel's plain version.
* ``blocked`` / ``blocked_causal`` — ``lax.scan`` formulations of flash
                attention in the reference, not ported as such: on the
                card they go to the flash kernel, on the CPU to ``naive``.
* ``decode_attention`` — one query token against a contiguous cache.

All paths take q:(B,Sq,H,D), k/v:(B,Skv,Hkv,D) with H a multiple of Hkv
(GQA groups contiguous: q head i uses kv head i // (H//Hkv)).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def _gqa_expand(k, n_q_heads):
    """(B,S,Hkv,D) -> (B,S,H,D) by repeating each kv head contiguously."""
    rep = n_q_heads // k.shape[2]
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def naive_attention(q, k, v, *, causal: bool, q_offset=0,
                    logit_softcap: float = 0.0):
    """Reference full-materialization attention (fp32 softmax).  Like the
    reference, the probabilities are rounded to v's dtype before the
    second product."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (d ** -0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_softcap: float = 0.0):
    """q: (B,1,H,D); caches: (B,S,Hkv,D); cache_len: (B,) valid length
    (the new token's kv must already be written at cache_len-1)."""
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    kc = _gqa_expand(k_cache, h)
    vc = _gqa_expand(v_cache, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) \
        * (d ** -0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, None, :] < cache_len[:, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vc.float())
    return out.to(q.dtype)


def attend(q, k, v, *, causal: bool, impl: str, q_offset=0,
           logit_softcap: float = 0.0):
    if impl in ("blocked", "blocked_causal"):
        impl = "pallas" if q.is_cuda else "naive"
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               logit_softcap=logit_softcap)
    if impl == "pallas":
        if q_offset:
            raise ValueError("the flash kernel aligns causal masking "
                             "top-left and takes no q_offset")
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         softcap=logit_softcap)
    raise ValueError(f"unknown attention impl {impl!r}")
