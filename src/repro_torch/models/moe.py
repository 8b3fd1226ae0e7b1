"""Token-choice top-k MoE (granite-style): the port of
``repro.models.moe``, with its two interchangeable routes.

* ``dense_onehot`` — every expert computes every token; the outputs are
  combined with the (renormalised) top-k router weights.
* ``sort`` — dropless grouped GEMM: the token-to-expert assignments are
  sorted by expert id and multiplied group by group.  The reference's
  ``jax.lax.ragged_dot`` (an XLA op, not a Pallas kernel) becomes
  ``torch._grouped_mm`` with the group ends computed on the device.

Both routes read no device value on the host, so a CUDA graph captures
them: the one-hot weights and the group ends come from comparisons with
``arange(E)``, not from ``F.one_hot`` (its range check) or
``torch.bincount`` (its output size).  Token choice has no capacity, so
one token's output never depends on another token's routing: a padded
row of a decode batch cannot change a live row.

Expert weights are stacked on a leading expert axis, as in the
reference: gate/up ``(E, d_model, d_expert)``, down
``(E, d_expert, d_model)``, stored in the compute dtype (every reader
casts them to it); the router ``(d_model, E)`` is stored in fp32, which
its reader computes in.  Padded experts (``n_experts_logical < E``)
receive -1e30 router logits and so no routing weight.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import placed_grad, replicated
from repro_torch.models.layers import normal

NEG_INF = -1e30


def moe_init(d_model: int, n_experts: int, d_expert: int, act: str, *,
             generator, device, dtype):
    """The reference's shapes and scales (moe.py:29-42), drawn from
    ``generator``; the router in fp32, the experts in ``dtype``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "router": normal((d_model, n_experts), d_model ** -0.5,
                         generator=generator, device=device,
                         dtype=torch.float32),
        "up": normal((n_experts, d_model, d_expert), d_model ** -0.5, **kw),
        "down": normal((n_experts, d_expert, d_model), d_expert ** -0.5,
                       **kw),
    }
    if act == "silu":
        p["gate"] = normal((n_experts, d_model, d_expert), d_model ** -0.5,
                           **kw)
    return p


def _router(p, x, top_k: int, n_experts_logical: int):
    """Top-k routing. x: (T, d). Returns (probs (T,k), ids (T,k), aux)."""
    logits = x.float() @ p["router"].float()                 # (T, E)
    e = logits.shape[-1]
    if n_experts_logical < e:                                # padded experts
        pad = torch.arange(e, device=x.device) >= n_experts_logical
        logits = logits.masked_fill(pad, NEG_INF)
    top_logits, top_ids = torch.topk(logits, top_k, dim=-1)  # (T, k)
    probs = torch.softmax(top_logits, dim=-1)                # renormalised
    # Load-balance aux loss (Switch-style) + router z-loss, over real experts.
    me = torch.softmax(logits, dim=-1).mean(dim=0)           # (E,)
    # the counts start as a replicated tensor, so that under a sharding
    # plan the in-place add has a DTensor to add into (a no-op without it)
    ce = replicated(torch.zeros(e, dtype=torch.float32,
                                device=x.device)).index_add_(
        0, top_ids.reshape(-1),
        torch.full((top_ids.numel(),), 1.0 / top_ids.numel(),
                   device=x.device))
    aux = n_experts_logical * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return probs, top_ids, {"aux": aux, "zloss": zloss}


def _activate(up, g):
    """Gated SiLU (``g`` the gate product) or GELU, as the reference's
    (the tanh GELU, ``jax.nn.gelu``'s default), in fp32 and cast back."""
    if g is not None:
        return F.silu(g.float()).to(g.dtype) * up
    return F.gelu(up.float(), approximate="tanh").to(up.dtype)


def _expert_ffn_dense(p, x, compute_dtype):
    """All experts on all tokens. x: (T, d) -> (E, T, d)."""
    up = torch.matmul(x, p["up"].to(compute_dtype))         # (E, T, f)
    g = torch.matmul(x, p["gate"].to(compute_dtype)) if "gate" in p \
        else None
    h = _activate(up, g)
    return torch.bmm(h, p["down"].to(compute_dtype))        # (E, T, d)


def moe_apply_dense(p, x, *, top_k: int, n_experts_logical: int,
                    compute_dtype) -> Tuple[torch.Tensor, dict]:
    """dense_onehot route. x: (..., d)."""
    shp = x.shape
    # under a sharding plan the tokens' gradient must come back as the
    # tokens lie, to be viewed as (B, S) again
    x2 = placed_grad(x.reshape(-1, shp[-1]).to(compute_dtype))  # (T, d)
    probs, ids, aux = _router(p, x2, top_k, n_experts_logical)
    e = p["router"].shape[-1]
    outs = _expert_ffn_dense(p, x2, compute_dtype)           # (E, T, d)
    onehot = (ids[..., None] == torch.arange(e, device=x.device)).float()
    weights = torch.einsum("tk,tke->te", probs, onehot)      # (T, E)
    y = torch.einsum("te,etd->td", weights.to(compute_dtype), outs)
    return y.reshape(shp), aux


def moe_apply_sort(p, x, *, top_k: int, n_experts_logical: int,
                   compute_dtype) -> Tuple[torch.Tensor, dict]:
    """Dropless grouped-GEMM route. x: (..., d)."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1]).to(compute_dtype)            # (T, d)
    t, d = x2.shape
    probs, ids, aux = _router(p, x2, top_k, n_experts_logical)
    e = p["router"].shape[-1]

    flat_ids = ids.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    inv = torch.argsort(order)
    xs = x2[order // top_k]                                  # (T*k, d) sorted
    # end of each expert's group in the sorted rows
    ends = (flat_ids[None, :] <= torch.arange(e, device=x.device)[:, None]) \
        .sum(dim=1, dtype=torch.int32)                       # (E,)

    def grouped(a, w):
        return torch._grouped_mm(a, w.to(compute_dtype), offs=ends)

    up = grouped(xs, p["up"])
    g = grouped(xs, p["gate"]) if "gate" in p else None
    ys = grouped(_activate(up, g), p["down"])                # (T*k, d)

    y_flat = ys[inv]                                         # token order
    w = probs.reshape(-1)[:, None].to(compute_dtype)
    y = torch.sum((y_flat * w).reshape(t, top_k, d), dim=1)
    return y.reshape(shp), aux


def moe_apply(p, x, *, top_k: int, n_experts_logical: int, impl: str,
              compute_dtype):
    if impl == "dense_onehot":
        return moe_apply_dense(p, x, top_k=top_k,
                               n_experts_logical=n_experts_logical,
                               compute_dtype=compute_dtype)
    if impl == "sort":
        return moe_apply_sort(p, x, top_k=top_k,
                              n_experts_logical=n_experts_logical,
                              compute_dtype=compute_dtype)
    raise ValueError(f"unknown moe impl {impl!r}")
