"""Building-block layers: the port of ``repro.models.layers``.

Plain functions over dicts of tensors, with the reference's parameter
names and shapes: a dense weight is ``(d_in, d_out)`` and applies as
``y = x @ w``, so weights load from the JAX tree without transposes.

Numerics follow the reference: norms, RoPE and the SwiGLU activation
run in fp32 and cast back; ``dense_apply`` and ``embed_apply`` cast the
weight to the compute dtype first (the serving tree stores those weights
in the compute dtype already, so the cast is free there; a training
master tree holds them in fp32); ``unembed_apply`` runs in
fp32 when asked.  ``softmax_xent`` is the training loss, in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.api import replicated, shard


# ---------------------------------------------------------------------------
# Initializers (torch.Generator draws; same shapes and scales as the
# reference, not the same random stream)
# ---------------------------------------------------------------------------
def normal(shape, scale, *, generator, device, dtype):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(d_in, d_out, *, generator, device, dtype, bias=False,
               scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal((d_in, d_out), scale, generator=generator,
                     device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device, dtype=dtype)
    return p


def dense_apply(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(d, kind, *, device):
    """Norm parameters stay fp32: their readers compute in fp32."""
    p = {"scale": torch.ones((d,), device=device, dtype=torch.float32)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device, dtype=torch.float32)
    return p


def norm_apply(p, x, kind, eps=1e-5):
    """RMSNorm / LayerNorm in fp32, output in x.dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def head_norm_apply(p, x, eps=1e-6):
    """Per-head RMSNorm over head_dim (qk-norm), in fp32, output in
    x.dtype. x: (..., H, D).  The reference's eps here is 1e-6, not
    ``norm_apply``'s 1e-5."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    # a Python-scalar base: no host-to-device copy, which would stall the
    # host on the stream every layer
    exponent = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return theta ** exponent


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) or (S,).

    Rotates the split halves ``x[..., :D/2]`` and ``x[..., D/2:]``
    (GPT-NeoX style), as the reference's code does; its docstring's
    "interleaved" does not describe what it computes."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs            # (B,S,D/2)
    cos = replicated(torch.cos(angles)[:, :, None, :])
    sin = replicated(torch.sin(angles)[:, :, None, :])
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, device=None):
    """(max_len, d_model) fp32 table: sines of every position at the
    frequencies 10000^(-2i/d) in the first half, cosines in the second
    (reference layers.py:103-108).  No config of the repo reads it, and
    ``model_zoo.build`` refuses ``pos_emb="sinusoidal"``."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(d_model, d_ff, act, *, generator, device, dtype, bias=False):
    kw = dict(generator=generator, device=device, dtype=dtype, bias=bias)
    if act == "silu":  # SwiGLU
        return {"gate": dense_init(d_model, d_ff, **kw),
                "up": dense_init(d_model, d_ff, **kw),
                "down": dense_init(d_ff, d_model, scale=d_ff ** -0.5, **kw)}
    return {"up": dense_init(d_model, d_ff, **kw),
            "down": dense_init(d_ff, d_model, scale=d_ff ** -0.5, **kw)}


def mlp_apply(p, x, act, compute_dtype):
    if "gate" in p:
        g = dense_apply(p["gate"], x, compute_dtype)
        u = dense_apply(p["up"], x, compute_dtype)
        h = F.silu(g.float()).to(g.dtype) * u
    else:
        u = dense_apply(p["up"], x, compute_dtype)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(u.float(), approximate="tanh").to(u.dtype)
    return dense_apply(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_init(vocab, d_model, *, generator, device, dtype):
    # the reference writes the scale as 0.02·√d/√d
    return {"table": normal((vocab, d_model), 0.02,
                            generator=generator, device=device, dtype=dtype)}


def embed_apply(p, ids, compute_dtype):
    """Rows ``ids`` of the table in the compute dtype.  The reference
    casts the whole table, then gathers; gathering first and casting the
    rows gives the same values without a cast of the table per call.
    Under autograd the rows' gradients are then summed into the table in
    its own dtype (fp32 in a master tree), where the reference sums them
    in the compute dtype before its cast: a rounding difference of bf16
    training alone.  The lookup is ``F.embedding``, whose forward and
    backward DTensor has sharding rules for: under a sharding plan a
    vocab-sharded table gives each rank's rows as a masked partial sum.
    DTensor keeps that mask right only for ids it holds whole, so the
    ids are gathered first (a no-op without the plan)."""
    return F.embedding(replicated(ids), p["table"]).to(compute_dtype)


def unembed_apply(table, x, *, vocab_logical: int, fp32: bool = True):
    """x @ table.T with padded-vocab masking. table: (Vp, D)."""
    dt = torch.float32 if fp32 else x.dtype
    logits = x.to(dt) @ table.to(dt).T
    vp = table.shape[0]
    if vp != vocab_logical:
        pad = torch.arange(vp, device=logits.device) >= vocab_logical
        if isinstance(logits, DTensor):
            # under a sharding plan the product may be a partial sum (the
            # table's d_model over "data"), which a fill must not enter
            # before the shards are summed: out of place, DTensor reduces
            # it first; in place it has no rule for a partial sum
            return logits.masked_fill(replicated(pad), -1e30)
        logits.masked_fill_(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None):
    """Mean token cross-entropy, logsumexp minus the gold logit, in fp32.
    logits (..., V); labels int (...); an optional mask weights the
    tokens, and the masked mean divides by ``max(mask.sum(), 1)``."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        # under a sharding plan both terms are sums over the vocab shards
        # (Megatron's vocab-parallel cross-entropy), which stay split in
        # the backward too.  DTensor would gather the logits' vocab whole
        # for logsumexp, and runs a gather's backward (a scatter into
        # zeros) at the logits' whole global shape on every rank.  The
        # gold logit is the sum of its one column: the same value.
        top = shard(logits.detach().amax(dim=-1, keepdim=True),
                    "batch", "seq", None)
        logz = shard(torch.exp(logits - top).sum(-1), "batch", "seq") \
            .log() + top[..., 0]
        hit = labels[..., None].long() == shard(
            torch.arange(logits.shape[-1], device=logits.device), "vocab")
        gold = shard(torch.where(hit, logits, 0.0).sum(-1), "batch", "seq")
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
