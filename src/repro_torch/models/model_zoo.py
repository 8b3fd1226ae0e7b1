"""Model zoo, dense, VLM and SSM families: the port of
``repro.models.model_zoo``.  VLM (chameleon) runs the dense code, as in
the reference, its images being tokens of the same vocabulary.

``Model`` is a frozen bundle of (ArchConfig, PadPlan, RunSettings), as in
the reference.  Parameters are a dict tree with the reference's keys and
shapes, layers stacked on a leading L axis; the functions below loop over
layers in Python where the reference has ``lax.scan``.

Storage dtypes (``param_dtype``): matmul weights and the embedding table
in the compute dtype, because every reader casts them to it first;
norm scales (qk-norm's too), the Mamba2 mixer's ``A_log``, ``D``,
``dt_bias``, ``norm_scale``, ``conv_w`` and ``conv_b``, and the
unembedding table when ``logits_fp32``, in fp32, because their readers
compute in fp32.  A tied embedding table is therefore fp32 and its rows
are cast at the lookup.  A learned position table (``pos``) is in the
compute dtype, because the reference casts it to the activations' dtype
before the add.  At llama2-7b that is about 13 GB of bf16 weights plus a 0.5 GB fp32
unembedding table.

Entry points
------------
* ``init_params(model, seed, device)`` — random parameters.
* ``forward(model, params, batch)``   — full-seq logits.
* ``init_cache / prefill / decode_step`` — decode cache, updated in
  place: dense ``{k,v: (L,B,Smax,Hkv,hd), len: (B,)}``; SSM
  ``{conv: (L,B,W-1,C), ssd: (L,B,H,N,P) fp32, len: (B,)}``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, ENCDEC,
                                      SSM, VLM)
from repro_torch.distributed.padding import PadPlan, make_pad_plan
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention_impl import attend, decode_attention
from repro_torch.models.common import (DEFAULT_SETTINGS, RunSettings,
                                       resolve_device)
from repro_torch.models.layers import (apply_rope, dense_apply, dense_init,
                                       embed_apply, embed_init,
                                       head_norm_apply, mlp_apply, mlp_init,
                                       norm_apply, norm_init, normal,
                                       unembed_apply)

#: families this slice ports; the others raise
PORTED_FAMILIES = (DENSE, VLM, SSM)
#: position encodings the port builds
POS_EMBS = ("rope", "learned", "none")
#: learned position tables are capped (reference model_zoo.py:48)
LEARNED_POS_CAP = 32_768
#: Mamba2 mixer leaves that the reference reads in fp32 (ssm.py:149-166,
#: 218-228, 261-263), stored in fp32 so the port reads the same values
SSM_FP32_LEAVES = ("A_log", "D", "dt_bias", "norm_scale", "conv_w",
                   "conv_b")


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    plan: PadPlan
    settings: RunSettings = DEFAULT_SETTINGS

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def with_settings(self, **kw) -> "Model":
        return dataclasses.replace(
            self, settings=dataclasses.replace(self.settings, **kw))


def build(cfg: ArchConfig, tp: int = 1,
          settings: RunSettings = DEFAULT_SETTINGS) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(have {PORTED_FAMILIES})")
    if cfg.pos_emb not in POS_EMBS:
        raise NotImplementedError(
            f"{cfg.name}: position encoding {cfg.pos_emb!r} is not ported "
            f"(have {POS_EMBS})")
    return Model(cfg=cfg, plan=make_pad_plan(cfg, tp), settings=settings)


def param_dtype(model: Model, path: Tuple[str, ...]) -> torch.dtype:
    """Storage dtype of the parameter at ``path`` in the tree."""
    fp32_logits = model.settings.logits_fp32
    if path[-2:] == ("unembed", "table") and fp32_logits:
        return torch.float32
    if path[-2:] == ("embed", "table") and fp32_logits \
            and model.cfg.tie_embeddings:
        return torch.float32
    if path[-1] in ("scale", "bias"):
        return torch.float32
    if "mixer" in path and path[-1] in SSM_FP32_LEAVES:
        return torch.float32
    return model.compute_dtype


def layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------
def _q_proj(p, x, model: Model, positions):
    cfg, plan = model.cfg, model.plan
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x, model.compute_dtype) \
        .reshape(b, s, plan.n_q, cfg.head_dim)
    if "q_norm" in p:
        q = head_norm_apply(p["q_norm"], q)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _kv_proj(p, x, model: Model, positions):
    """K/V in *physical* head layout (kv_rep applied)."""
    cfg, plan = model.cfg, model.plan
    cd = model.compute_dtype
    b, s, _ = x.shape
    nkv_log = plan.n_kv // plan.kv_rep
    k = dense_apply(p["wk"], x, cd).reshape(b, s, nkv_log, cfg.head_dim)
    v = dense_apply(p["wv"], x, cd).reshape(b, s, nkv_log, cfg.head_dim)
    if "k_norm" in p:
        k = head_norm_apply(p["k_norm"], k)
    if cfg.pos_emb == "rope" and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    if plan.kv_rep > 1:
        k = k.repeat_interleave(plan.kv_rep, dim=2)
        v = v.repeat_interleave(plan.kv_rep, dim=2)
    return k, v


@functools.lru_cache(maxsize=None)
def _head_mask(plan: PadPlan, kind: str, dtype, device):
    """The plan's q-head (``kind="q"``) or SSD-head mask on ``device``,
    made once: a host-to-device copy per call would stall the host, and
    cannot be captured in a CUDA graph."""
    mask = plan.q_head_mask() if kind == "q" else plan.ssm_head_mask()
    return torch.as_tensor(mask, dtype=dtype, device=device)


def _attn_out(p, ctx, model: Model):
    """ctx: (B,S,nq,hd) -> (B,S,d); padded q heads masked."""
    plan = model.plan
    b, s = ctx.shape[:2]
    if plan.has_q_padding:
        mask = _head_mask(plan, "q", ctx.dtype, ctx.device)
        ctx = ctx * mask[None, None, :, None]
    ctx = ctx.reshape(b, s, plan.n_q * model.cfg.head_dim)
    return dense_apply(p["wo"], ctx, model.compute_dtype)


def _attn_full(p, x, model: Model, positions, *, causal: bool):
    """Full-sequence attention. Returns (out, (k, v))."""
    q = _q_proj(p, x, model, positions)
    k, v = _kv_proj(p, x, model, positions)
    st = model.settings
    ctx = attend(q, k, v, causal=causal, impl=st.resolve_attn(q.shape[1]),
                 block_q=st.attn_block_q, block_kv=st.attn_block_kv,
                 logit_softcap=model.cfg.attn_logit_softcap)
    return _attn_out(p, ctx, model), (k, v)


def _ffn_apply(p, x, model: Model):
    return mlp_apply(p["mlp"], x, model.cfg.act, model.compute_dtype)


def _block_apply(p, x, model: Model, positions):
    """Pre-norm causal transformer block (full-seq). Returns (x, (k, v))."""
    cfg = model.cfg
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn, kv = _attn_full(p["attn"], h, model, positions, causal=True)
    x = x + attn
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn_apply(p, h, model), kv


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_params(model: Model, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales
    (model_zoo.py:266-293), drawn from a ``torch.Generator`` on
    ``device`` (not the reference's random stream).  ``device=None``
    means the CUDA card."""
    device = resolve_device(device)
    cfg, plan = model.cfg, model.plan
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    nq, nkv = plan.n_q, plan.n_kv // plan.kv_rep
    cd = model.compute_dtype
    kw = dict(generator=gen, device=device)

    def stacked(make):
        """Stack L per-layer trees, drawn one layer at a time into
        preallocated (L, ...) tensors (peak: the stack plus one layer)."""
        first = make()
        out = _tree_map(lambda a: torch.empty((L,) + a.shape, dtype=a.dtype,
                                              device=a.device), first)
        for i in range(L):
            tree = first if i == 0 else make()
            _tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        return out

    def block():
        dense = dict(dtype=cd, bias=cfg.qkv_bias, **kw)
        attn = {
            "wq": dense_init(d, nq * hd, **dense),
            "wk": dense_init(d, nkv * hd, **dense),
            "wv": dense_init(d, nkv * hd, **dense),
            "wo": dense_init(nq * hd, d, dtype=cd, scale=(nq * hd) ** -0.5,
                             **kw),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm_init(hd, "rmsnorm", device=device)
            attn["k_norm"] = norm_init(hd, "rmsnorm", device=device)
        return {
            "ln1": norm_init(d, cfg.norm, device=device),
            "attn": attn,
            "ln2": norm_init(d, cfg.norm, device=device),
            "mlp": mlp_init(d, cfg.d_ff, cfg.act, dtype=cd,
                            bias=mlp_bias(cfg), **kw),
        }

    def ssm_layer():
        return {"ln": norm_init(d, cfg.norm, device=device),
                "mixer": ssm_mod.mamba2_init(d, cfg.ssm, dtype=cd,
                                             n_heads_phys=plan.ssm_heads,
                                             **kw)}

    params: Dict[str, Any] = {
        "embed": embed_init(plan.vocab, d, dtype=param_dtype(
            model, ("embed", "table")), **kw),
        "layers": stacked(ssm_layer if cfg.family == SSM else block),
        "final_norm": norm_init(d, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(plan.vocab, d, dtype=param_dtype(
            model, ("unembed", "table")), **kw)
    if cfg.pos_emb == "learned":
        n_pos = min(cfg.max_seq_len, LEARNED_POS_CAP)
        params["pos"] = normal((n_pos, d), 0.02, dtype=param_dtype(
            model, ("pos",)), **kw)
    return params


def mlp_bias(cfg: ArchConfig) -> bool:
    """Whether the MLP has biases: the reference adds them for
    encoder-decoder and audio models and for learned positions (OPT) as
    well as where the config asks (model_zoo.py:202-204)."""
    return (cfg.mlp_bias or cfg.family in (AUDIO, ENCDEC)
            or cfg.pos_emb == "learned")


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# ---------------------------------------------------------------------------
# Full-sequence forward / prefill
# ---------------------------------------------------------------------------
def _embed_tokens(model: Model, params, tokens):
    return embed_apply(params["embed"], tokens, model.compute_dtype)


def _add_positions(model: Model, params, x, lens=None):
    """``x`` plus its learned position rows, where the model has them:
    rows 0..S-1 for a full sequence (``lens`` None), else row ``lens[b]``
    for the one token of each row b (x: (B,1,d)).  A decode index past
    the table's end reads its last row, as the reference's gather does
    (JAX clamps the index); the clamp reads ``lens`` on the device, so a
    CUDA graph replays it."""
    if model.cfg.pos_emb != "learned":
        return x
    table = params["pos"]
    if lens is None:
        return x + table[:x.shape[1]][None].to(x.dtype)
    idx = lens.clamp(max=table.shape[0] - 1).long()
    return x + table[idx][:, None].to(x.dtype)


def _lm_head(model: Model, params, x):
    x = norm_apply(params["final_norm"], x, model.cfg.norm)
    table = params.get("unembed", params["embed"])["table"]
    return unembed_apply(table, x, vocab_logical=model.plan.vocab_logical,
                         fp32=model.settings.logits_fp32)


def _run_blocks(model: Model, params, tokens, on_kv=None):
    """Embed, run every block, and hand each layer's (k, v) to on_kv."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = _add_positions(model, params, _embed_tokens(model, params, tokens))
    for i in range(model.cfg.num_layers):
        x, kv = _block_apply(layer(params["layers"], i), x, model, positions)
        if on_kv is not None:
            on_kv(i, kv)
    return x


def forward(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence logits.  batch: {"tokens": (B,S)}.

    Returns (logits (B,S,V_phys), aux dict — empty for these families)."""
    if model.cfg.family == SSM:
        x = _run_ssm_blocks(model, params, batch["tokens"])
    else:
        x = _run_blocks(model, params, batch["tokens"])
    return _lm_head(model, params, x), {}


def _ssm_head_mask(model: Model, device):
    plan = model.plan
    if plan.ssm_heads == plan.ssm_heads_logical:
        return None
    return _head_mask(plan, "ssm", torch.float32, torch.device(device))


def _run_ssm_blocks(model: Model, params, tokens, on_states=None):
    """Embed and run every Mamba2 block (pre-norm, residual), handing each
    layer's (conv_state, ssd_state) to on_states."""
    cfg = model.cfg
    x = _embed_tokens(model, params, tokens)
    hm = _ssm_head_mask(model, tokens.device)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = norm_apply(lp["ln"], x, cfg.norm)
        y, states = ssm_mod.mamba2_apply(
            lp["mixer"], h, cfg.ssm, compute_dtype=model.compute_dtype,
            head_mask=hm)
        x = x + y
        if on_states is not None:
            on_states(i, states)
    return x


def init_cache(model: Model, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    cfg, plan = model.cfg, model.plan
    lens = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == SSM:
        s = cfg.ssm
        conv_dim = plan.ssm_heads * s.head_dim + 2 * s.n_groups * s.d_state
        return {"conv": torch.zeros(
                    (cfg.num_layers, batch, s.conv_width - 1, conv_dim),
                    dtype=model.compute_dtype, device=device),
                "ssd": torch.zeros(
                    (cfg.num_layers, batch, plan.ssm_heads, s.d_state,
                     s.head_dim), dtype=torch.float32, device=device),
                "len": lens}
    kv = (cfg.num_layers, batch, max_len, plan.n_kv, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=model.compute_dtype, device=device),
            "v": torch.zeros(kv, dtype=model.compute_dtype, device=device),
            "len": lens}


def prefill(model: Model, params, batch, cache, prompt_lens=None):
    """Full-prompt forward that also fills the decode cache in place.

    batch: {"tokens": (B,S)}.  ``prompt_lens`` (B,) defaults to S for
    every row.  Returns (logits (B,S,V), cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if prompt_lens is None:
        prompt_lens = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)

    if model.cfg.family == SSM:
        def write_states(i, states):
            cache["conv"][i] = states[0]
            cache["ssd"][i] = states[1]

        x = _run_ssm_blocks(model, params, tokens, on_states=write_states)
        cache["len"].copy_(prompt_lens)
        return _lm_head(model, params, x), cache

    def write(i, kv):
        cache["k"][i, :, :s] = kv[0]
        cache["v"][i, :, :s] = kv[1]

    x = _run_blocks(model, params, tokens, on_kv=write)
    cache["len"].copy_(prompt_lens)
    return _lm_head(model, params, x), cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def _attn_decode(p, x_t, model: Model, k_cache, v_cache, cache_len):
    """One-token self-attention against a contiguous cache, written in
    place at ``cache_len``.  x_t: (B,1,d). Returns out (B,1,d)."""
    bsz = x_t.shape[0]
    positions = cache_len[:, None].long()
    q = _q_proj(p, x_t, model, positions)
    k_t, v_t = _kv_proj(p, x_t, model, positions)
    bidx = torch.arange(bsz, device=x_t.device)
    k_cache[bidx, cache_len.long()] = k_t[:, 0].to(k_cache.dtype)
    v_cache[bidx, cache_len.long()] = v_t[:, 0].to(v_cache.dtype)
    ctx = decode_attention(q, k_cache, v_cache, cache_len + 1,
                           logit_softcap=model.cfg.attn_logit_softcap)
    return _attn_out(p, ctx, model)


def decode_step(model: Model, params, cache, tokens):
    """One autoregressive step.  tokens: (B,) int (the current token).

    Returns (logits (B,V_phys), cache with the new token's K/V (dense)
    or states (SSM) written in place and ``len`` advanced)."""
    cfg = model.cfg
    if cfg.family == SSM:
        return _ssm_decode_step(model, params, cache, tokens)
    cache_len = cache["len"]
    x = _add_positions(model, params,
                       _embed_tokens(model, params, tokens[:, None]),
                       cache_len)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = norm_apply(lp["ln1"], x, cfg.norm)
        x = x + _attn_decode(lp["attn"], h, model, cache["k"][i],
                             cache["v"][i], cache_len)
        h = norm_apply(lp["ln2"], x, cfg.norm)
        x = x + _ffn_apply(lp, h, model)
    cache_len.add_(1)
    return _lm_head(model, params, x)[:, 0], cache


def _ssm_decode_step(model: Model, params, cache, tokens):
    """One Mamba2 step over every row of the cache, states written in
    place."""
    cfg = model.cfg
    x = _embed_tokens(model, params, tokens[:, None])[:, 0]
    hm = _ssm_head_mask(model, tokens.device)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = norm_apply(lp["ln"], x, cfg.norm)
        y, (cs, ss) = ssm_mod.mamba2_decode(
            lp["mixer"], h, cfg.ssm, compute_dtype=model.compute_dtype,
            conv_state=cache["conv"][i], ssd_state=cache["ssd"][i],
            head_mask=hm)
        cache["conv"][i] = cs
        cache["ssd"][i] = ss
        x = x + y
    cache["len"].add_(1)
    return _lm_head(model, params, x[:, None])[:, 0], cache
