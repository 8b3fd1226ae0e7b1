"""Attention compute: the port of ``repro.models.attention_impl``.

* ``naive``          — materializes (B,H,Sq,Skv) fp32 scores; the oracle.
* ``blocked``        — flash-style loop over q and kv blocks with an fp32
                       online softmax, O(block^2) memory; computes the
                       full rectangle with masking (the reference's
                       ``lax.scan``/``lax.map`` loop, block for block).
* ``blocked_causal`` — the same, visiting only the lower-triangle
                       (qb, kb) block pairs in row-major order.
* ``pallas``         — the hand-written flash kernel
                       (``repro_torch.kernels.flash_attention``); on CPU
                       tensors its wrapper runs the kernel's plain version.
* ``decode_attention`` — one query token against a contiguous cache.

``blocked`` and ``blocked_causal`` are plain PyTorch on every device, as
the reference's are plain JAX: they take any dtype and head_dim, fall
back to ``naive`` on ragged shapes as the reference does, and neither
reads a tensor value on the host, so a CUDA graph captures them.

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


def _online_softmax_step(o, m, l, s, v_blk):
    """Fold one block of fp32 scores ``s`` (B,H,Bq,Bk) and its values
    ``v_blk`` (B,Bk,H,D) into the running (o, m, l)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v_blk.float())
    return o_new, m_new, l_new


def _block_scores(q_blk, k_blk, *, h, scale, softcap, q_pos0, k_pos0,
                  causal):
    """fp32 scores (B,H,Bq,Bk) of one (q block, kv block) pair, softcapped
    and causally masked as the reference's loop bodies do."""
    k_blk = _gqa_expand(k_blk, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k_blk.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        dev = s.device
        qpos = q_pos0 + torch.arange(s.shape[2], device=dev)[:, None]
        kpos = k_pos0 + torch.arange(s.shape[3], device=dev)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    return s


def _init_state(b, h, bq, d, device):
    return (torch.zeros(b, h, bq, d, dtype=torch.float32, device=device),
            torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros(b, h, bq, dtype=torch.float32, device=device))


def _finish(o, l):
    """(B,H,Bq,D) accumulators -> (B,Bq,H,D) fp32 output."""
    return (o / l[..., None].clamp_min(1e-30)).transpose(1, 2)


def _flash_inner(q_blk, k, v, *, block_kv, causal, q_pos0, softcap):
    """Online softmax over the kv blocks for one q block.

    q_blk: (B, Bq, H, D); k/v: (B, Skv, Hkv, D).  Returns (B, Bq, H, D)
    in q's dtype."""
    b, bq, h, d = q_blk.shape
    nkv = k.shape[1] // block_kv
    o, m, l = _init_state(b, h, bq, d, q_blk.device)
    for ki in range(nkv):
        kv = slice(ki * block_kv, (ki + 1) * block_kv)
        s = _block_scores(q_blk, k[:, kv], h=h, scale=d ** -0.5,
                          softcap=softcap, q_pos0=q_pos0,
                          k_pos0=ki * block_kv, causal=causal)
        o, m, l = _online_softmax_step(o, m, l, s,
                                       _gqa_expand(v[:, kv], h))
    return _finish(o, l).to(q_blk.dtype)


def blocked_attention(q, k, v, *, causal: bool, block_q=1024, block_kv=1024,
                      logit_softcap: float = 0.0):
    """Flash attention computing the full rectangle (masked)."""
    b, sq, h, d = q.shape
    block_q = min(block_q, sq)
    block_kv = min(block_kv, k.shape[1])
    if sq % block_q or k.shape[1] % block_kv:
        # ragged shapes fall back, as in the reference
        return naive_attention(q, k, v, causal=causal,
                               logit_softcap=logit_softcap)
    return torch.cat(
        [_flash_inner(q[:, qi:qi + block_q], k, v, block_kv=block_kv,
                      causal=causal, q_pos0=qi, softcap=logit_softcap)
         for qi in range(0, sq, block_q)], dim=1)


def blocked_causal_attention(q, k, v, *, block_q=1024, block_kv=1024,
                             logit_softcap: float = 0.0):
    """Causal flash that visits only the lower-triangle (qb, kb) pairs,
    ``kb * block_kv <= qb * block_q + block_q - 1``, in row-major order
    (the reference's static pair list), each q block keeping its own
    online-softmax state."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    if sq % block_q or skv % block_kv or sq != skv:
        return naive_attention(q, k, v, causal=True,
                               logit_softcap=logit_softcap)
    nq, nkv = sq // block_q, skv // block_kv
    pairs = [(qi, ki) for qi in range(nq) for ki in range(nkv)
             if ki * block_kv <= qi * block_q + block_q - 1]
    state = [_init_state(b, h, block_q, d, q.device) for _ in range(nq)]
    for qi, ki in pairs:
        qs = slice(qi * block_q, (qi + 1) * block_q)
        kv = slice(ki * block_kv, (ki + 1) * block_kv)
        s = _block_scores(q[:, qs], k[:, kv], h=h, scale=d ** -0.5,
                          softcap=logit_softcap, q_pos0=qi * block_q,
                          k_pos0=ki * block_kv, causal=True)
        state[qi] = _online_softmax_step(*state[qi], s,
                                         _gqa_expand(v[:, kv], h))
    return torch.cat([_finish(o, l) for o, _, l in state],
                     dim=1).to(q.dtype)


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


def attend(q, k, v, *, causal: bool, impl: str, block_q=1024, block_kv=1024,
           q_offset=0, logit_softcap: float = 0.0):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               logit_softcap=logit_softcap)
    if impl == "blocked":
        return blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                 block_kv=block_kv,
                                 logit_softcap=logit_softcap)
    if impl == "blocked_causal":
        if not causal:
            return blocked_attention(q, k, v, causal=False, block_q=block_q,
                                     block_kv=block_kv,
                                     logit_softcap=logit_softcap)
        return blocked_causal_attention(q, k, v, block_q=block_q,
                                        block_kv=block_kv,
                                        logit_softcap=logit_softcap)
    if impl == "pallas":
        if q_offset:
            raise ValueError("the flash kernel aligns causal masking "
                             "top-left and takes no q_offset")
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         softcap=logit_softcap)
    raise ValueError(f"unknown attention impl {impl!r}")
