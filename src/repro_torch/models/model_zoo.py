"""Model zoo, dense, MoE, VLM, SSM, hybrid and encoder-decoder families:
the port of ``repro.models.model_zoo``.  VLM (chameleon) runs the dense
code, as in the reference, its images being tokens of the same
vocabulary; MoE (granite) runs it with ``models.moe`` in place of the
MLP.  HYBRID (zamba2) runs groups of ``attn_period`` Mamba2 layers, each
group followed by a transformer block whose weights every application
shares (``shared_attn``).  AUDIO and ENCDEC (whisper) run an encoder of
non-causal blocks over precomputed frame embeddings (``batch["embeds"]``,
the reference's frontend stub) and a decoder whose blocks add
cross-attention to the encoder output.

``Model`` is a frozen bundle of (ArchConfig, PadPlan, RunSettings), as in
the reference.  Parameters are a dict tree with the reference's keys and
shapes, layers stacked on a leading L axis; the functions below loop over
layers in Python where the reference has ``lax.scan``.  Where autograd
records the forward, each layer the reference rematerialises (its
``_scan_blocks`` bodies) runs under ``RunSettings.remat`` (``_remat``).

Storage dtypes (``param_dtype``): matmul weights (the MoE experts'
``up``/``gate``/``down`` among them) and the embedding table in the
compute dtype, because every reader casts them to it first; norm scales
(qk-norm's too), the MoE router, the Mamba2 mixer's ``A_log``, ``D``,
``dt_bias``, ``norm_scale``, ``conv_w`` and ``conv_b``, and the
unembedding table when ``logits_fp32``, in fp32, because their readers
compute in fp32.  A tied embedding table is therefore fp32 and its rows
are cast at the lookup; so is an encoder-decoder model's, which has no
``unembed`` and is always its own unembedding (the reference's
``_lm_head`` reads ``params.get("unembed", params["embed"])``).  Learned
position tables (``pos``; ``enc_pos`` and ``dec_pos``) are in the
compute dtype, because the reference casts them to the activations'
dtype before the add.  At llama2-7b that is about 13 GB of bf16 weights
plus a 0.5 GB fp32 unembedding table.  That is a serving choice.
Training needs the reference's master tree, every leaf in
``cfg.param_dtype`` (fp32 in every config), which
``init_params(..., master=True)`` draws and ``is_master`` recognises: the
optimizer updates those values, and the readers cast them at use as they
cast the serving tree.

Entry points
------------
* ``init_params(model, seed, device, master)`` — random parameters;
  ``param_specs(model, master)`` the same tree on the meta device.
* ``forward(model, params, batch)``   — full-seq logits.
* ``loss_fn(model, params, batch)``   — the training loss and its metrics.
* ``init_cache / prefill / decode_step`` — decode cache, updated in
  place: dense ``{k,v: (L,B,Smax,Hkv,hd), len: (B,)}``; SSM
  ``{conv: (L,B,W-1,C), ssd: (L,B,H,N,P) fp32, len: (B,)}``; hybrid the
  SSM arrays of every layer and ``{k,v: (G,B,Smax,Hkv,hd)}``, one K/V
  cache for each of the G applications of the shared block;
  encoder-decoder ``{k,v: (Ld,B,Smax,Hkv,hd), xk,xv: (Ld,B,Senc,Hkv,hd),
  len: (B,)}``, the cross-attention's K/V written whole by ``prefill``
  and read-only in ``decode_step``.  ``cache_specs`` gives its tensors
  on the meta device.

Sharding: the reference's eight ``shard`` points (q, k and v at their
projections, the caches a decode step reads, each block's output, the
embedded tokens and the logits) call ``distributed.api.shard``, which
returns its input unless a sharding plan is installed
(``use_rules``); then every tree is DTensors placed by
``distributed.shard_plan`` and each point redistributes its activation
as the reference constrains it.  XLA chooses the placements between the
points for the whole program; DTensor chooses them op by op, so the port
adds points where its choice would gather a sharded weight whole
(``_reduced``: each attention, MLP and Mamba2 output joins the residual
stream whole over "model"; K/V whole over "model" when fewer KV heads
than TP) and places two gradients that DTensor could not take back
(``distributed.api.placed_grad``).  None of them changes a value.  The
attention routes and the SSD scan run on each rank's local shards there
(``distributed.api.local``), and so does the decode's row write into
the cache, which DTensor has no in-place rule for.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, ENCDEC,
                                      HYBRID, MOE, SSM, VLM)
from repro_torch.distributed.api import (current_mesh, current_rules,
                                         local, placements, placed_grad,
                                         replicated, shard, shard_start,
                                         use_rules)
from repro_torch.distributed.padding import PadPlan, make_pad_plan
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention_impl import attend, decode_attention
from repro_torch.models.common import (DEFAULT_SETTINGS, RunSettings,
                                       resolve_device, tree_leaves,
                                       tree_map)
from repro_torch.models.layers import (apply_rope, dense_apply, dense_init,
                                       embed_apply, embed_init,
                                       head_norm_apply, mlp_apply, mlp_init,
                                       norm_apply, norm_init, normal,
                                       softmax_xent, unembed_apply)
from repro_torch.models.moe import moe_apply, moe_init

#: encoder-decoder families (whisper), with ``enc_layers``/``dec_layers``
ENCDEC_FAMILIES = (AUDIO, ENCDEC)
#: families the port builds; any other raises
PORTED_FAMILIES = (DENSE, MOE, VLM, SSM, HYBRID) + ENCDEC_FAMILIES
#: families whose layers are Mamba2 blocks (HYBRID: all of ``layers``)
SSM_FAMILIES = (SSM, HYBRID)
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


def master_dtype(model: Model) -> torch.dtype:
    """The dtype of every leaf of a master tree: ``cfg.param_dtype``."""
    return getattr(torch, model.cfg.param_dtype)


def param_dtype(model: Model, path: Tuple[str, ...],
                master: bool = False) -> torch.dtype:
    """Storage dtype of the parameter at ``path`` in the tree: in the
    serving tree by the rules above, in a master tree ``master_dtype``."""
    if master:
        return master_dtype(model)
    fp32_logits = model.settings.logits_fp32
    if path[-2:] == ("unembed", "table") and fp32_logits:
        return torch.float32
    if path[-2:] == ("embed", "table") and fp32_logits \
            and (model.cfg.tie_embeddings
                 or model.cfg.family in ENCDEC_FAMILIES):
        return torch.float32
    if path[-1] in ("scale", "bias"):
        return torch.float32
    if path[-2:] == ("moe", "router"):
        return torch.float32
    if "mixer" in path and path[-1] in SSM_FP32_LEAVES:
        return torch.float32
    return model.compute_dtype


def layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def layers_of(layers: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer of a stacked layer tree (views, no copies), from one
    ``unbind`` a leaf: under autograd each stacked leaf then gets its
    gradient from one stack of the layers' gradients, where a ``layer``
    view per layer would give each layer's gradient the stacked size and
    sum them (L full-size fills and adds a leaf)."""
    parts = tree_map(lambda a: a.unbind(0), layers)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


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
    return shard(q, "batch", "seq", "heads", None)


def _kv_proj(p, x, model: Model, positions):
    """K/V in *physical* head layout (kv_rep applied)."""
    cfg, plan = model.cfg, model.plan
    cd = model.compute_dtype
    b, s, _ = x.shape
    nkv_log = plan.n_kv // plan.kv_rep
    k = dense_apply(p["wk"], x, cd)
    v = dense_apply(p["wv"], x, cd)
    if plan.kv_rep > 1:
        # fewer KV heads than TP: the weights are whole over "model", and
        # so must the products be before they split into heads (DTensor
        # may split their columns over "model", cutting heads apart)
        k = shard(k, "batch", "seq", None)
        v = shard(v, "batch", "seq", None)
    k = k.reshape(b, s, nkv_log, cfg.head_dim)
    v = v.reshape(b, s, nkv_log, cfg.head_dim)
    if "k_norm" in p:
        k = head_norm_apply(p["k_norm"], k)
    if cfg.pos_emb == "rope" and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    if plan.kv_rep > 1:
        k = k.repeat_interleave(plan.kv_rep, dim=2)
        v = v.repeat_interleave(plan.kv_rep, dim=2)
    k = shard(k, "batch", "kv_seq", "kv_heads", None)
    v = shard(v, "batch", "kv_seq", "kv_heads", None)
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
        mask = replicated(_head_mask(plan, "q", ctx.dtype, ctx.device))
        ctx = ctx * mask[None, None, :, None]
    ctx = ctx.reshape(b, s, plan.n_q * model.cfg.head_dim)
    return dense_apply(p["wo"], ctx, model.compute_dtype)


def _attn_full(p, x, model: Model, positions, *, causal: bool, kv_x=None,
               logit_softcap=None):
    """Full-sequence attention, K/V projected from ``kv_x`` where given
    (cross-attention to the encoder output, ``positions`` None), else
    from ``x``.  ``logit_softcap`` None means the config's.  Returns
    (out, (k, v))."""
    q = _q_proj(p, x, model, positions)
    k, v = _kv_proj(p, x if kv_x is None else kv_x, model, positions)
    st = model.settings
    if logit_softcap is None:
        logit_softcap = model.cfg.attn_logit_softcap
    ctx = attend(q, k, v, causal=causal, impl=st.resolve_attn(q.shape[1]),
                 block_q=st.attn_block_q, block_kv=st.attn_block_kv,
                 logit_softcap=logit_softcap)
    return _attn_out(p, ctx, model), (k, v)


def _ffn_apply(p, x, model: Model):
    """MLP or MoE second half-block. Returns (y, aux): the MoE's
    ``{"aux", "zloss"}``, None for an MLP."""
    cfg = model.cfg
    if "moe" in p:
        return moe_apply(p["moe"], x, top_k=cfg.moe.top_k,
                         n_experts_logical=model.plan.n_experts_logical,
                         impl=model.settings.moe_impl,
                         compute_dtype=model.compute_dtype)
    return mlp_apply(p["mlp"], x, cfg.act, model.compute_dtype), None


def _block_apply(p, x, model: Model, positions, *, causal=True, enc_out=None,
                 cross_softcap=None):
    """Pre-norm transformer block (full-seq): self-attention, then, in a
    decoder block of an encoder-decoder model (``xattn``), non-causal
    cross-attention to ``enc_out`` with logit softcap ``cross_softcap``
    (None: the config's), then the MLP or MoE.  Returns (x, kv, aux): kv
    is the self-attention's (k, v), followed by the cross-attention's
    (xk, xv) in a decoder block."""
    cfg = model.cfg
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn, kv = _attn_full(p["attn"], h, model, positions, causal=causal)
    x = x + _reduced(attn)
    if "xattn" in p:
        h = norm_apply(p["ln_x"], x, cfg.norm)
        attn, xkv = _attn_full(p["xattn"], h, model, None, causal=False,
                               kv_x=enc_out, logit_softcap=cross_softcap)
        x = x + _reduced(attn)
        kv = kv + xkv
    h = norm_apply(p["ln2"], x, cfg.norm)
    y, aux = _ffn_apply(p, h, model)
    return shard(x + _reduced(y), "batch", "seq", "embed"), kv, aux


def _reduced(y):
    """An attention's, an MLP's or a Mamba2 mixer's output, before it
    joins the residual stream, whole over "model" (a no-op without a
    sharding plan).  Its last product leaves a partial sum over "model";
    added as it is, DTensor splits the sum along d_model, the next
    block's weights are then gathered whole to meet it, and the
    backward's gradients take the split too.  Reduced here (Megatron's
    all-reduce points), the residual stream stays whole and its gradient
    too.  y: (B,S,d), or a Mamba2 decode step's (B,d)."""
    return shard(y, "batch", *("seq",) * (y.dim() - 2), "embed")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_params(model: Model, seed: int = 0, device=None,
                master: bool = False) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales
    (model_zoo.py:266-323), drawn from a ``torch.Generator`` on
    ``device`` (not the reference's random stream).  ``device=None``
    means the CUDA card.  ``master`` draws the training tree, every leaf
    in ``cfg.param_dtype`` as the reference's ``init_params`` stores it;
    otherwise the serving tree (``param_dtype``)."""
    device = resolve_device(device)
    cfg, plan = model.cfg, model.plan
    # the meta device (``param_specs``) draws nothing; a CPU generator
    # stands in for the one it cannot have
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = plan.n_q, plan.n_kv // plan.kv_rep
    # the matrices' storage dtype
    wd = master_dtype(model) if master else model.compute_dtype
    kw = dict(generator=gen, device=device)

    def stacked(make, n=cfg.num_layers):
        """Stack n per-layer trees, drawn one layer at a time into
        preallocated (n, ...) tensors (peak: the stack plus one layer)."""
        first = make()
        out = tree_map(lambda a: torch.empty((n,) + a.shape, dtype=a.dtype,
                                             device=a.device), first)
        for i in range(n):
            tree = first if i == 0 else make()
            tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        return out

    def attention(cross=False):
        dense = dict(dtype=wd, bias=cfg.qkv_bias, **kw)
        attn = {
            "wq": dense_init(d, nq * hd, **dense),
            "wk": dense_init(d, nkv * hd, **dense),
            "wv": dense_init(d, nkv * hd, **dense),
            "wo": dense_init(nq * hd, d, dtype=wd, scale=(nq * hd) ** -0.5,
                             **kw),
        }
        if cfg.qk_norm and not cross:
            attn["q_norm"] = norm_init(hd, "rmsnorm", device=device)
            attn["k_norm"] = norm_init(hd, "rmsnorm", device=device)
        return attn

    def block(cross=False):
        p = {"ln1": norm_init(d, cfg.norm, device=device),
             "attn": attention(),
             "ln2": norm_init(d, cfg.norm, device=device)}
        if cross:
            p["ln_x"] = norm_init(d, cfg.norm, device=device)
            p["xattn"] = attention(cross=True)
        if cfg.family == MOE:
            p["moe"] = moe_init(d, plan.n_experts, cfg.moe.d_expert,
                                cfg.act, dtype=wd, **kw)
        else:
            p["mlp"] = mlp_init(d, cfg.d_ff, cfg.act, dtype=wd,
                                bias=mlp_bias(cfg), **kw)
        return p

    def ssm_layer():
        return {"ln": norm_init(d, cfg.norm, device=device),
                "mixer": ssm_mod.mamba2_init(d, cfg.ssm, dtype=wd,
                                             n_heads_phys=plan.ssm_heads,
                                             **kw)}

    def positions(name, n):
        return normal((n, d), 0.02, dtype=param_dtype(model, (name,), master),
                      **kw)

    params: Dict[str, Any] = {
        "embed": embed_init(plan.vocab, d, dtype=param_dtype(
            model, ("embed", "table"), master), **kw)}
    if cfg.family in ENCDEC_FAMILIES:
        # no unembedding: the embedding table is the decoder's output
        # table, whatever tie_embeddings says (reference model_zoo.py:418)
        params.update(
            enc_pos=positions("enc_pos", cfg.enc_seq_len),
            dec_pos=positions("dec_pos", min(cfg.max_seq_len,
                                             LEARNED_POS_CAP)),
            enc_layers=stacked(block, cfg.n_enc_layers),
            dec_layers=stacked(lambda: block(cross=True), cfg.n_dec_layers),
            enc_norm=norm_init(d, cfg.norm, device=device),
            final_norm=norm_init(d, cfg.norm, device=device))
        return _as_master(model, params) if master else params
    params["layers"] = stacked(ssm_layer if cfg.family in SSM_FAMILIES
                               else block)
    if cfg.family == HYBRID:
        params["shared_attn"] = stacked(block, cfg.n_shared_attn)
    params["final_norm"] = norm_init(d, cfg.norm, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(plan.vocab, d, dtype=param_dtype(
            model, ("unembed", "table"), master), **kw)
    if cfg.pos_emb == "learned":
        params["pos"] = positions("pos", min(cfg.max_seq_len,
                                             LEARNED_POS_CAP))
    return _as_master(model, params) if master else params


def param_specs(model: Model, master: bool = False) -> Dict[str, Any]:
    """The tree of ``init_params(model, ..., master=master)`` on the meta
    device: every path, shape and dtype, nothing allocated (the
    reference's ``param_specs``, an ``eval_shape`` of its init)."""
    return init_params(model, device="meta", master=master)


def _as_master(model: Model, params):
    """Every leaf in the master dtype (its fp32 leaves are already)."""
    dt = master_dtype(model)
    return tree_map(lambda a: a.to(dt), params)


def is_master(model: Model, params) -> bool:
    """Whether every leaf of ``params`` is in ``cfg.param_dtype``."""
    dt = master_dtype(model)
    return all(a.dtype == dt for a in tree_leaves(params))


def param_count(params) -> int:
    return sum(a.numel() for a in tree_leaves(params))


def mlp_bias(cfg: ArchConfig) -> bool:
    """Whether the MLP has biases: the reference adds them for
    encoder-decoder and audio models and for learned positions (OPT) as
    well as where the config asks (model_zoo.py:202-204)."""
    return (cfg.mlp_bias or cfg.family in (AUDIO, ENCDEC)
            or cfg.pos_emb == "learned")


# ---------------------------------------------------------------------------
# Rematerialisation (the reference's _maybe_remat, model_zoo.py:341-352)
# ---------------------------------------------------------------------------
#: the plain matrix products, which ``dots_saveable`` keeps; batched ones
#: (``bmm``) are recomputed, as ``dots_with_no_batch_dims_saveable`` does
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(model: Model, body, x, p):
    """``body(x, p)``, one layer, under ``settings.remat``: ``none`` keeps
    every activation for the backward, ``full`` only the layer's inputs
    (the rest is recomputed in the backward), ``dots_saveable`` the
    inputs and the plain matrix products' outputs.  Where autograd
    records nothing (no input requires grad, or grad mode is off) the
    body runs as it is.  Remat changes memory, never values: the forward
    has no randomness to replay."""
    mode = model.settings.remat
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(a.requires_grad for a in tree_leaves(p)))
    if mode == "none" or not records:
        return body(x, p)
    mesh, rules = current_mesh(), current_rules()
    if rules is not None:
        # the recompute may run on autograd's device thread, which does
        # not see this thread's sharding rules: the layer takes them along
        layer_body = body

        def body(x, p):
            with use_rules(mesh, rules):
                return layer_body(x, p)
    kw = {}
    if mode == "dots_saveable":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(body, x, p, use_reentrant=False,
                      preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# Full-sequence forward / prefill
# ---------------------------------------------------------------------------
def _embed_tokens(model: Model, params, tokens):
    x = embed_apply(params["embed"], tokens, model.compute_dtype)
    return placed_grad(shard(x, "batch", "seq", "embed"))


def _position_table(model: Model, params):
    """The learned position table the decoder tokens read: ``dec_pos`` of
    an encoder-decoder model, which the reference adds whatever
    ``pos_emb`` says, ``pos`` of a model with learned positions; None
    for the others."""
    if model.cfg.family in ENCDEC_FAMILIES:
        return params["dec_pos"]
    return params["pos"] if model.cfg.pos_emb == "learned" else None


def _add_positions(table, x, lens=None):
    """``x`` plus its rows of the learned position ``table`` (None: ``x``
    as it is): rows 0..S-1 for a full sequence (``lens`` None), else row
    ``lens[b]`` for the one token of each row b (x: (B,1,d)).  A decode
    index past the table's end reads its last row, as the reference's
    gather does (JAX clamps the index); the clamp reads ``lens`` on the
    device, so a CUDA graph replays it."""
    if table is None:
        return x
    if lens is None:
        return x + table[:x.shape[1]][None].to(x.dtype)
    idx = lens.clamp(max=table.shape[0] - 1).long()
    return x + table[idx][:, None].to(x.dtype)


def _lm_head(model: Model, params, x):
    x = norm_apply(params["final_norm"], x, model.cfg.norm)
    table = params.get("unembed", params["embed"])["table"]
    logits = unembed_apply(table, x, vocab_logical=model.plan.vocab_logical,
                           fp32=model.settings.logits_fp32)
    return shard(logits, "batch", "seq", "vocab")


def _encode(model: Model, params, embeds):
    """The encoder over precomputed frame embeddings (B, Senc, d), the
    reference's frontend stub: cast to the compute dtype, plus
    ``enc_pos``, non-causal blocks, ``enc_norm``."""
    cfg = model.cfg
    s = embeds.shape[1]
    x = embeds.to(model.compute_dtype)
    x = _add_positions(params["enc_pos"], x)
    positions = torch.arange(s, device=x.device)

    def body(x, lp):
        return _block_apply(lp, x, model, positions, causal=False)[0]

    for lp in layers_of(params["enc_layers"]):
        x = _remat(model, body, x, lp)
    return norm_apply(params["enc_norm"], x, cfg.norm)


def _run_blocks(model: Model, params, batch, on_kv=None, cross_softcap=None):
    """Embed ``batch["tokens"]``, run every (decoder) block, and hand each
    layer's kv (``_block_apply``'s) to on_kv.  An encoder-decoder model
    first encodes ``batch["embeds"]``, which its decoder blocks attend
    to with logit softcap ``cross_softcap`` (None: the config's).
    Returns (x, aux): the MoE's aux values summed over layers, as the
    reference's ``_collect_aux`` sums them; empty for an MLP."""
    cfg = model.cfg
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = None
    layers = params.get("layers")
    if cfg.family in ENCDEC_FAMILIES:
        enc_out = _encode(model, params, batch["embeds"])
        layers = params["dec_layers"]
    x = _add_positions(_position_table(model, params),
                       _embed_tokens(model, params, tokens))
    total: Dict[str, torch.Tensor] = {}

    def body(x, lp):
        return _block_apply(lp, x, model, positions, enc_out=enc_out,
                            cross_softcap=cross_softcap)

    for i, lp in enumerate(layers_of(layers)):
        x, kv, aux = _remat(model, body, x, lp)
        for k, v in (aux or {}).items():
            total[k] = total[k] + v if k in total else v
        if on_kv is not None:
            on_kv(i, kv)
    return x, total


def forward(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence logits.  batch: {"tokens": (B,S)}, and for an
    encoder-decoder model "embeds" (B,Senc,d), the encoder's input.

    Returns (logits (B,S,V_phys), aux dict with the MoE losses if any)."""
    cfg = model.cfg
    if cfg.family == SSM:
        x, aux = _run_ssm_blocks(model, params, batch["tokens"]), {}
    elif cfg.family == HYBRID:
        # the reference's forward takes the copies in turn (model_zoo.py:
        # 537-538); its scanned branch for a single copy (:542-549) takes
        # copy 0, which is the same
        x = _run_hybrid_blocks(model, params, batch["tokens"],
                               lambda g: g % cfg.n_shared_attn)
        aux = {}
    else:
        x, aux = _run_blocks(model, params, batch)
    return _lm_head(model, params, x), aux


def loss_fn(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    """The training loss (reference model_zoo.py:563-574): the token
    cross-entropy of ``forward``'s logits against ``batch["labels"]``
    (masked by ``batch["loss_mask"]`` where given) and, for an MoE model,
    ``router_aux_coef`` times the load-balance loss plus
    ``router_z_coef`` times the z-loss.  Returns (loss, metrics):
    ``xent``, ``loss`` and the MoE's ``aux`` and ``zloss``."""
    logits, aux = forward(model, params, batch)
    loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    metrics = {"xent": loss}
    if aux:
        m = model.cfg.moe
        loss = loss + m.router_aux_coef * aux.get("aux", 0.0) \
            + m.router_z_coef * aux.get("zloss", 0.0)
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def _ssm_head_mask(model: Model, device):
    plan = model.plan
    if plan.ssm_heads == plan.ssm_heads_logical:
        return None
    return replicated(_head_mask(plan, "ssm", torch.float32,
                                 torch.device(device)))


def _ssm_block(model: Model, lp, x, hm):
    """The Mamba2 layer ``lp`` (pre-norm, residual) over a full sequence,
    under ``settings.remat``: (x, (conv_state, ssd_state))."""
    def body(x, lp):
        h = norm_apply(lp["ln"], x, model.cfg.norm)
        y, states = ssm_mod.mamba2_apply(
            lp["mixer"], h, model.cfg.ssm,
            compute_dtype=model.compute_dtype, head_mask=hm)
        return x + _reduced(y), states

    return _remat(model, body, x, lp)


def _run_ssm_blocks(model: Model, params, tokens, on_states=None):
    """Embed and run every Mamba2 block, handing each layer's
    (conv_state, ssd_state) to on_states."""
    x = _embed_tokens(model, params, tokens)
    hm = _ssm_head_mask(model, tokens.device)
    for i, lp in enumerate(layers_of(params["layers"])):
        x, states = _ssm_block(model, lp, x, hm)
        if on_states is not None:
            on_states(i, states)
    return x


def _hybrid_groups(model: Model) -> Tuple[int, int]:
    """(groups, Mamba2 layers a group): one application of the shared
    block follows each group."""
    cfg = model.cfg
    period = cfg.attn_period or cfg.num_layers
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of {period}")
    return cfg.num_layers // period, period


def _run_hybrid_blocks(model: Model, params, tokens, copy, on_states=None,
                       on_kv=None):
    """Embed, then each group's Mamba2 blocks followed by copy ``copy(g)``
    of the shared block (causal); hands each layer's states to on_states
    and each application's (k, v) to on_kv."""
    n_groups, period = _hybrid_groups(model)
    x = _embed_tokens(model, params, tokens)
    hm = _ssm_head_mask(model, tokens.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    lps, shared = layers_of(params["layers"]), layers_of(params["shared_attn"])
    for g in range(n_groups):
        for i in range(g * period, (g + 1) * period):
            x, states = _ssm_block(model, lps[i], x, hm)
            if on_states is not None:
                on_states(i, states)
        x, kv, _ = _block_apply(shared[copy(g)], x, model, positions,
                                causal=True)
        if on_kv is not None:
            on_kv(g, kv)
    return x


def _cache_struct(model: Model, batch: int,
                  max_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shapes and dtypes of the decode cache (reference model_zoo.py:
    580-610): dict of (shape, dtype)."""
    cfg, plan = model.cfg, model.plan
    cd, hd = model.compute_dtype, cfg.head_dim
    out: Dict[str, Tuple[tuple, torch.dtype]] = {}
    n_layers = cfg.num_layers
    if cfg.family in SSM_FAMILIES:
        s = cfg.ssm
        conv_dim = plan.ssm_heads * s.head_dim + 2 * s.n_groups * s.d_state
        ssm_cache = {
            "conv": ((n_layers, batch, s.conv_width - 1, conv_dim), cd),
            "ssd": ((n_layers, batch, plan.ssm_heads, s.d_state,
                     s.head_dim), torch.float32)}
        if cfg.family == SSM:
            return {**ssm_cache, "len": ((batch,), torch.int32)}
        n_layers = _hybrid_groups(model)[0]
        out = ssm_cache
    if cfg.family in ENCDEC_FAMILIES:
        n_layers = cfg.n_dec_layers
        xkv = (n_layers, batch, cfg.enc_seq_len, plan.n_kv, hd)
        out = {"xk": (xkv, cd), "xv": (xkv, cd)}
    kv = (n_layers, batch, max_len, plan.n_kv, hd)
    return {"k": (kv, cd), "v": (kv, cd), **out,
            "len": ((batch,), torch.int32)}


def init_cache(model: Model, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in _cache_struct(model, batch,
                                                max_len).items()}


def cache_specs(model: Model, batch: int, max_len: int):
    """The decode cache's tensors on the meta device (shapes and dtypes,
    nothing allocated), as the reference's ``cache_specs`` gives
    ``ShapeDtypeStruct``s."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in _cache_struct(model, batch,
                                                max_len).items()}


def prefill(model: Model, params, batch, cache, prompt_lens=None):
    """Full-prompt forward that also fills the decode cache in place.

    batch: {"tokens": (B,S)} (and "embeds" for an encoder-decoder model,
    whose cross-attention K/V are written whole and, as in the reference
    (model_zoo.py:693-695), computed without the logit softcap).
    ``prompt_lens`` (B,) defaults to S for every row.  Returns (logits
    (B,S,V), cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if prompt_lens is None:
        prompt_lens = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)

    def write_states(i, states):
        cache["conv"][i] = states[0]
        cache["ssd"][i] = states[1]

    def write(i, kv):
        _write_prefix(cache["k"][i], kv[0])
        _write_prefix(cache["v"][i], kv[1])
        if len(kv) == 4:
            cache["xk"][i] = kv[2]
            cache["xv"][i] = kv[3]

    family = model.cfg.family
    if family == SSM:
        x = _run_ssm_blocks(model, params, tokens, on_states=write_states)
    elif family == HYBRID:
        # every application takes copy 0 of the shared block, as the
        # reference's prefill does (model_zoo.py:726)
        x = _run_hybrid_blocks(model, params, tokens, lambda g: 0,
                               on_states=write_states, on_kv=write)
    else:
        x, _ = _run_blocks(model, params, batch, on_kv=write,
                           cross_softcap=0.0)
    cache["len"].copy_(prompt_lens)
    return _lm_head(model, params, x), cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def _write_cache_rows(cache, lens, new, start=0):
    """``cache[b, lens[b] - start] = new[b]`` for every row b, in place,
    where ``cache`` holds positions ``start`` on of the sequence; a row
    whose index falls outside it writes nothing, as the reference's
    ``.at[].set`` drops a write past the cache's end (an empty slot's
    length keeps advancing)."""
    n = cache.shape[1]
    if n == 0:
        return cache
    bidx = torch.arange(cache.shape[0], device=cache.device)
    pos = lens.long() - start
    idx = pos.clamp(0, n - 1)
    keep = ((pos >= 0) & (pos < n))[:, None, None]
    cache[bidx, idx] = torch.where(keep, new.to(cache.dtype),
                                   cache[bidx, idx])
    return cache


_ROWS = ("batch", "kv_seq", "kv_heads", None)


def _write_prompt(cache, kv, start=0):
    """``cache[:, :s] = kv`` (kv: (B,s,...)), in place, where ``cache``
    holds positions ``start`` on of the sequence."""
    lo, hi = start, min(start + cache.shape[1], kv.shape[1])
    if hi > lo:
        cache[:, :hi - lo] = kv[:, lo:hi]
    return cache


def _in_place(fn, cache, *args, in_specs):
    """``fn(cache, *args, start=0)`` on a cache of layout ``_ROWS``.
    Under a sharding plan each rank runs it on its own shard of the
    cache, with ``start`` that shard's first position (DTensor has no
    in-place rule for a write into part of a sharded dim).  The write
    lands in the cache itself only where the cache lies as its spec
    says, so any other placement is refused."""
    rules = current_rules()
    if rules is None or not isinstance(cache, DTensor):
        return fn(cache, *args)
    want = placements(current_mesh(), rules.spec(*_ROWS))
    if tuple(cache.placements) != want:
        raise ValueError(f"a cache placed as {cache.placements} is written "
                         f"in place only as its spec places it, {want}")
    return local(functools.partial(fn, start=shard_start(cache, 1)),
                 (_ROWS,), (_ROWS,) + in_specs)(cache, *args)


def _write_prefix(cache, kv):
    """The prompt's K or V into the first positions of a layer's cache."""
    if kv.shape[1] > cache.shape[1]:
        raise ValueError(f"a prompt of {kv.shape[1]} positions does not fit "
                         f"a cache of {cache.shape[1]}")
    return _in_place(_write_prompt, cache, kv,
                     in_specs=(("batch", None, "kv_heads", None),))


def _write_rows(cache, lens, new):
    """One decode token's K or V at each row's length."""
    return _in_place(_write_cache_rows, cache, lens, new,
                     in_specs=(("batch",), ("batch", "kv_heads", None)))


def _attn_decode(p, x_t, model: Model, k_cache, v_cache, cache_len, *,
                 cross: bool = False):
    """One-token attention against a contiguous cache.  Self-attention
    writes the new token's K/V at ``cache_len`` first; cross-attention
    reads the cache only, every one of its positions valid.  x_t:
    (B,1,d). Returns out (B,1,d)."""
    bsz = x_t.shape[0]
    positions = cache_len[:, None].long()
    q = _q_proj(p, x_t, model, positions)
    if cross:
        # replicated under a sharding plan, so that the attention's
        # boundary hands each rank its own rows of it
        valid_len = replicated(torch.full((bsz,), k_cache.shape[1],
                                          dtype=torch.int32,
                                          device=x_t.device))
    else:
        k_t, v_t = _kv_proj(p, x_t, model, positions)
        _write_rows(k_cache, cache_len, k_t[:, 0])
        _write_rows(v_cache, cache_len, v_t[:, 0])
        valid_len = cache_len + 1
    k_cache = shard(k_cache, "batch", "kv_seq", "kv_heads", None)
    v_cache = shard(v_cache, "batch", "kv_seq", "kv_heads", None)
    ctx = decode_attention(q, k_cache, v_cache, valid_len,
                           logit_softcap=model.cfg.attn_logit_softcap)
    return _attn_out(p, ctx, model)


def _block_decode(p, x_t, model: Model, k, v, cache_len, *, xk=None,
                  xv=None):
    """Pre-norm block, one token: self-attention on (k, v), written in
    place; in a decoder block, cross-attention on (xk, xv)."""
    cfg = model.cfg
    h = norm_apply(p["ln1"], x_t, cfg.norm)
    x_t = x_t + _reduced(_attn_decode(p["attn"], h, model, k, v,
                                      cache_len))
    if "xattn" in p:
        h = norm_apply(p["ln_x"], x_t, cfg.norm)
        x_t = x_t + _reduced(_attn_decode(p["xattn"], h, model, xk, xv,
                                          cache_len, cross=True))
    h = norm_apply(p["ln2"], x_t, cfg.norm)
    return x_t + _reduced(_ffn_apply(p, h, model)[0])


def decode_step(model: Model, params, cache, tokens):
    """One autoregressive step.  tokens: (B,) int (the current token).

    Returns (logits (B,V_phys), cache with the new token's K/V (dense,
    encoder-decoder, hybrid) and states (SSM, hybrid) written in place and
    ``len`` advanced)."""
    cfg = model.cfg
    if cfg.family == SSM:
        return _ssm_decode_step(model, params, cache, tokens)
    if cfg.family == HYBRID:
        return _hybrid_decode_step(model, params, cache, tokens)
    cache_len = cache["len"]
    x = _add_positions(_position_table(model, params),
                       _embed_tokens(model, params, tokens[:, None]),
                       cache_len)
    encdec = cfg.family in ENCDEC_FAMILIES
    layers = params["dec_layers"] if encdec else params["layers"]
    for i in range(cfg.n_dec_layers if encdec else cfg.num_layers):
        cross = {"xk": cache["xk"][i], "xv": cache["xv"][i]} if encdec \
            else {}
        x = _block_decode(layer(layers, i), x, model, cache["k"][i],
                          cache["v"][i], cache_len, **cross)
    cache_len.add_(1)
    return _lm_head(model, params, x)[:, 0], cache


def _ssm_decode_block(model: Model, params, cache, i, x, hm):
    """One step of Mamba2 layer ``i`` (pre-norm, residual) over every row
    of the cache, its states written in place.  x: (B,d)."""
    cfg = model.cfg
    lp = layer(params["layers"], i)
    h = norm_apply(lp["ln"], x, cfg.norm)
    y, (cs, ss) = ssm_mod.mamba2_decode(
        lp["mixer"], h, cfg.ssm, compute_dtype=model.compute_dtype,
        conv_state=cache["conv"][i], ssd_state=cache["ssd"][i],
        head_mask=hm)
    cache["conv"][i] = cs
    cache["ssd"][i] = ss
    return x + _reduced(y)


def _ssm_decode_step(model: Model, params, cache, tokens):
    """One Mamba2 step over every row of the cache, states written in
    place."""
    x = _embed_tokens(model, params, tokens[:, None])[:, 0]
    hm = _ssm_head_mask(model, tokens.device)
    for i in range(model.cfg.num_layers):
        x = _ssm_decode_block(model, params, cache, i, x, hm)
    cache["len"].add_(1)
    return _lm_head(model, params, x[:, None])[:, 0], cache


def _hybrid_decode_step(model: Model, params, cache, tokens):
    """One step of every row: each group's Mamba2 layers, then copy 0 of
    the shared block (as the reference's decode takes it,
    model_zoo.py:814) on the group's contiguous K/V cache."""
    n_groups, period = _hybrid_groups(model)
    cache_len = cache["len"]
    x = _embed_tokens(model, params, tokens[:, None])[:, 0]
    hm = _ssm_head_mask(model, tokens.device)
    blk = layer(params["shared_attn"], 0)
    for g in range(n_groups):
        for i in range(g * period, (g + 1) * period):
            x = _ssm_decode_block(model, params, cache, i, x, hm)
        x = _block_decode(blk, x[:, None], model, cache["k"][g],
                          cache["v"][g], cache_len)[:, 0]
    cache_len.add_(1)
    return _lm_head(model, params, x[:, None])[:, 0], cache
