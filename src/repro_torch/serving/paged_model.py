"""Paged-KV model execution for the serving engine: the port of
``repro.serving.paged_model``.

The decode step runs against KV stored in fixed-size pages selected by a
block table.  Two attention paths:

* ``gather`` — plain PyTorch: gather the sequence's pages and run masked
               decode attention,
* ``pallas`` — the hand-written paged-attention kernel
               (``repro_torch.kernels.paged_attention``), which reads the
               pages in place; on CPU tensors its wrapper runs the
               kernel's plain version.

The page store keeps the reference's layout exactly: ``(L, NP, page,
Hkv, hd)``, token-major, with the last physical page as the trash page
that takes bucket padding and padded batch rows.  Unlike the reference,
which returns new arrays, ``scatter_prefill`` and ``paged_decode_step``
update the store **in place** (``index_put_``): at full width it is GiBs,
and a copy per layer per step is not affordable.  ``paged_decode_step``
also advances ``pages["len"]`` in place, so the store's tensors keep
their addresses, which a CUDA graph of the step replays.  They still
return the store, so callers read like the reference's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import DENSE, MOE, VLM
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import model_zoo as zoo
from repro_torch.models.attention_impl import decode_attention
from repro_torch.models.layers import norm_apply

PAGED_FAMILIES = (DENSE, MOE, VLM)
ATTN_PATHS = ("gather", "pallas")


def supports_paged(model: zoo.Model) -> bool:
    return model.cfg.family in PAGED_FAMILIES


# ---------------------------------------------------------------------------
# Page store
# ---------------------------------------------------------------------------
def init_pages(model: zoo.Model, num_pages: int, page_size: int,
               max_batch: int, max_pages_per_seq: int, device) -> Dict:
    cfg, plan = model.cfg, model.plan
    shape = (cfg.num_layers, num_pages, page_size, plan.n_kv, cfg.head_dim)
    cd = model.compute_dtype
    return {
        "k": torch.zeros(shape, dtype=cd, device=device),
        "v": torch.zeros(shape, dtype=cd, device=device),
        # per-slot block table + context len (padded rows are inactive)
        "tables": torch.zeros((max_batch, max_pages_per_seq),
                              dtype=torch.int32, device=device),
        "len": torch.zeros((max_batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Prefill: run the contiguous forward, then scatter KV into pages
# ---------------------------------------------------------------------------
def prefill_forward(model: zoo.Model, params, tokens):
    """The reference's ``prefill_collect`` on the shapes alone (what the
    engine captures per bucket): the caller picks the last real row of
    the logits.  tokens: (1, S) with S a padded bucket.

    Returns (logits (1,S,V), k, v (L,S,Hkv,hd))."""
    cache = zoo.init_cache(model, 1, tokens.shape[1], device=tokens.device)
    logits, cache = zoo.prefill(model, params, {"tokens": tokens}, cache)
    return logits, cache["k"][:, 0], cache["v"][:, 0]


def scatter_prefill(model: zoo.Model, pages, k, v, table_row,
                    prompt_len: int):
    """Write one request's prefill KV (L,S,Hkv,hd) into its pages, in
    place.

    table_row: (MP,) physical page ids covering the prompt.  Positions at
    or beyond ``prompt_len`` (bucket padding) land in the trash page (the
    last physical page, reserved by the engine)."""
    page_size = pages["k"].shape[2]
    trash = pages["k"].shape[1] - 1
    s = k.shape[1]
    pos = torch.arange(s, device=k.device)
    table_row = table_row.long()
    slot = table_row[torch.clamp(pos // page_size,
                                 max=table_row.shape[0] - 1)]
    page_idx = torch.where(pos < prompt_len, slot,
                           torch.full_like(slot, trash))
    offset = pos % page_size
    # Adjacent advanced indices keep the L axis leading: target positions
    # are (L, S, Hkv, hd).
    pages["k"][:, page_idx, offset] = k.to(pages["k"].dtype)
    pages["v"][:, page_idx, offset] = v.to(pages["v"].dtype)
    return pages


# ---------------------------------------------------------------------------
# Paged decode step
# ---------------------------------------------------------------------------
def _attn_decode_paged(p, x_t, model: zoo.Model, k_pages, v_pages, tables,
                       lens, *, attn_path: str):
    """x_t: (B,1,d); k/v_pages: (NP,page,Hkv,hd), written in place;
    tables: (B,MP) int32; lens: (B,) int32, context length *before* this
    token.  Returns out (B,1,d)."""
    cfg = model.cfg
    bsz = x_t.shape[0]
    page = k_pages.shape[1]
    positions = lens[:, None].long()
    q = zoo._q_proj(p, x_t, model, positions)            # (B,1,H,hd)
    k_t, v_t = zoo._kv_proj(p, x_t, model, positions)    # (B,1,Hkv,hd)

    lens_l = lens.long()
    prow = tables[torch.arange(bsz, device=x_t.device), lens_l // page].long()
    off = lens_l % page
    k_pages[prow, off] = k_t[:, 0].to(k_pages.dtype)
    v_pages[prow, off] = v_t[:, 0].to(v_pages.dtype)
    valid = lens + 1

    if attn_path == "pallas":
        ctx = paged_ops.paged_attention(
            q[:, 0], k_pages, v_pages, tables, valid,
            softcap=cfg.attn_logit_softcap)[:, None]
    else:
        mp = tables.shape[1]
        t = tables.long()
        k_seq = k_pages[t].reshape(bsz, mp * page, *k_pages.shape[2:])
        v_seq = v_pages[t].reshape(bsz, mp * page, *v_pages.shape[2:])
        ctx = decode_attention(q, k_seq, v_seq, valid,
                               logit_softcap=cfg.attn_logit_softcap)
    return zoo._attn_out(p, ctx, model)


def paged_decode_step(model: zoo.Model, params, pages, tokens,
                      attn_path: str = "gather"):
    """One decode iteration over the whole running batch.

    tokens: (B,) current token per slot (padded slots: anything).
    Returns (logits (B,V), pages with the new K/V written in place and
    ``pages["len"]`` advanced in place).  A learned position is read at
    each row's length, clamped to the table's last row as the
    reference's gather clamps it (``zoo._add_positions``)."""
    if attn_path not in ATTN_PATHS:
        raise ValueError(f"unknown attn_path {attn_path!r}; have "
                         f"{ATTN_PATHS}")
    cfg = model.cfg
    lens = pages["len"]
    tables = pages["tables"]
    x = zoo._add_positions(zoo._position_table(model, params),
                           zoo._embed_tokens(model, params, tokens[:, None]),
                           lens)
    for i in range(cfg.num_layers):
        lp = zoo.layer(params["layers"], i)
        h = norm_apply(lp["ln1"], x, cfg.norm)
        x = x + _attn_decode_paged(lp["attn"], h, model, pages["k"][i],
                                   pages["v"][i], tables, lens,
                                   attn_path=attn_path)
        h = norm_apply(lp["ln2"], x, cfg.norm)
        # every row of the batch, padded ones too: an MoE's token choice
        # has no capacity, so a padded row cannot change a live one
        x = x + zoo._ffn_apply(lp, h, model)[0]
    logits = zoo._lm_head(model, params, x)[:, 0]
    lens.add_(1)
    return logits, pages
