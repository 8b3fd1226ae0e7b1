"""Parameter + activation sharding plans (FSDP + TP + EP + SP): the port
of ``repro.distributed.shard_plan``, its specs the reference's leaf for
leaf.

Mesh axes: ``("data", "model")`` per pod, ``("pod", "data", "model")``
across pods.  The plan:

* **TP** over ``"model"``: attention heads, MLP hidden, vocab, MoE
  experts, SSD heads.  The pad plan guarantees every sharded axis
  divides 16.
* **FSDP** over ``"data"``: the non-TP weight axis (usually d_model) is
  sharded so parameter + optimizer memory scales down with the pod;
  DTensor inserts the all-gathers where an op needs them.
* **DP** over ``"pod"``: parameters replicated across pods, batch
  sharded over ``pod × data``.
* **SP** (long_500k): with batch=1 nothing shards over ``data`` — the
  rule set moves the KV/sequence axis there instead.

KV projections when ``kv_rep > 1`` (fewer logical KV heads than TP) are
model-axis-replicated; the replicated physical KV activations then shard
cleanly — Megatron-style GQA replication.

``named(mesh, specs)`` gives each leaf's ``(mesh, placements)``, the
counterpart of a ``NamedSharding``; ``distribute(tree, mesh, specs)``
places a tree with them, the counterpart of ``jax.device_put(tree,
named(mesh, specs))``.
"""
from __future__ import annotations

import re
from typing import Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.api import (AxisRules, P, PartitionSpec,
                                         make_rules, placements)
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import tree_map

FSDP = "data"
TP = "model"


def default_rules(*, multi_pod: bool = False,
                  seq_parallel: bool = False) -> AxisRules:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return make_rules(
        batch=None if seq_parallel else dp,
        seq=None,
        kv_seq=dp if seq_parallel else None,
        heads=TP, kv_heads=TP, ff=TP, vocab=TP, experts=TP,
        embed=None)


# ---------------------------------------------------------------------------
# Parameter specs by tree path
# ---------------------------------------------------------------------------
def _param_spec(path: str, ndim: int, model: zoo.Model) -> PartitionSpec:
    """Spec for one parameter, identified by its '/'-joined path."""
    kv_rep = model.plan.kv_rep
    st = model.settings
    fsdp_ax = FSDP if st.fsdp_params else None
    stacked = path.startswith(("layers/", "enc_layers/", "dec_layers/",
                               "shared_attn/"))
    lead: Tuple = (None,) if stacked else ()

    def spec(*axes):
        axes = tuple(fsdp_ax if a is FSDP else a for a in axes)
        return P(*(lead + axes))

    name = path.split("/", 1)[1] if stacked else path

    # -- embeddings / positions ----------------------------------------
    if name == "embed/table":
        # "vocab": Megatron vocab-parallel (gather + cross-model reshard)
        # "fsdp":  d_model over data, vocab replicated (cheap gather).
        # Tied embeddings keep vocab-parallel: the same table feeds the
        # logits matmul, which must stay vocab-sharded.
        if st.embed_shard == "fsdp" and not model.cfg.tie_embeddings:
            return P(None, FSDP)
        return P(TP, FSDP)
    if name == "unembed/table":
        return P(TP, FSDP)   # logits matmul wants vocab over model
    if name in ("pos", "enc_pos", "dec_pos"):
        return P(None, None)

    # -- norms ------------------------------------------------------------
    if re.search(r"(ln\w*|final_norm|enc_norm)/(scale|bias)$", path):
        return spec(None) if stacked else P(None)
    if name.endswith(("q_norm/scale", "k_norm/scale")):
        return spec(None)

    # -- attention --------------------------------------------------------
    if name.endswith(("attn/wq/w", "xattn/wq/w")):
        return spec(FSDP, TP)
    if name.endswith(("attn/wk/w", "attn/wv/w", "xattn/wk/w",
                      "xattn/wv/w")):
        return spec(FSDP, None) if kv_rep > 1 else spec(FSDP, TP)
    if name.endswith(("attn/wq/b", "xattn/wq/b")):
        return spec(TP)
    if name.endswith(("attn/wk/b", "attn/wv/b", "xattn/wk/b",
                      "xattn/wv/b")):
        return spec(None) if kv_rep > 1 else spec(TP)
    if name.endswith(("attn/wo/w", "xattn/wo/w")):
        return spec(TP, FSDP)
    if name.endswith(("attn/wo/b", "xattn/wo/b")):
        return spec(None)

    # -- MLP ----------------------------------------------------------------
    if name.endswith(("mlp/gate/w", "mlp/up/w")):
        return spec(FSDP, TP)
    if name.endswith(("mlp/gate/b", "mlp/up/b")):
        return spec(TP)
    if name.endswith("mlp/down/w"):
        return spec(TP, FSDP)
    if name.endswith("mlp/down/b"):
        return spec(None)

    # -- MoE ------------------------------------------------------------------
    if name.endswith("moe/router"):
        return spec(FSDP, None)
    if name.endswith(("moe/up", "moe/gate", "moe/down")):
        return spec(TP, FSDP, None)        # expert axis -> EP over model

    # -- Mamba2 -----------------------------------------------------------
    if name.endswith("mixer/in_proj"):
        return spec(FSDP, TP)
    if name.endswith("mixer/conv_w"):
        return spec(None, TP)
    if name.endswith("mixer/conv_b"):
        return spec(TP)
    if name.endswith(("mixer/A_log", "mixer/D", "mixer/dt_bias")):
        return spec(TP)
    if name.endswith("mixer/norm_scale"):
        return spec(TP)
    if name.endswith("mixer/out_proj"):
        return spec(TP, FSDP)
    if name.endswith("ln/scale") or name.endswith("ln/bias"):
        return spec(None)

    # fallback: replicate
    return P(*([None] * ndim)) if ndim else P()


def _with_paths(tree, fn, prefix: Tuple[str, ...] = ()):
    """``fn("/"-joined path, leaf)`` over the leaves of a dict tree."""
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def param_pspecs(model: zoo.Model):
    """PartitionSpec tree matching ``init_params(model, ...)``."""
    return _with_paths(zoo.param_specs(model),
                       lambda path, leaf: _param_spec(path, leaf.dim(),
                                                      model))


def opt_pspecs(model: zoo.Model):
    """Specs for AdamW state: mu/nu mirror params, step replicated."""
    ps = param_pspecs(model)
    return {"mu": ps, "nu": ps, "step": P()}


def ef_pspecs(model: zoo.Model, grad_compression: bool):
    if grad_compression:
        return param_pspecs(model)
    return {"_": P()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_pspecs(batch, rules: AxisRules):
    """Mirror the batch dict's keys with the appropriate specs."""
    out = {}
    for key in batch:
        if key in ("tokens", "labels", "loss_mask"):
            out[key] = rules.spec("batch", "seq")
        elif key == "embeds":
            out[key] = rules.spec("batch", "seq", "embed")
        else:
            raise KeyError(key)
    return out


def cache_pspecs(model: zoo.Model, rules: AxisRules):
    """Specs matching ``zoo.cache_specs`` layouts (leading layer axis)."""
    cfg = model.cfg
    out = {"len": rules.spec("batch")}
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        kv = P(None, *rules.spec("batch", "kv_seq", "kv_heads", None))
        out["k"] = kv
        out["v"] = kv
    elif fam in ("ssm", "hybrid"):
        out["conv"] = P(None, *rules.spec("batch", None, "ff"))
        out["ssd"] = P(None, *rules.spec("batch", "heads", None, None))
        if fam == "hybrid":
            kv = P(None, *rules.spec("batch", "kv_seq", "kv_heads", None))
            out["k"] = kv
            out["v"] = kv
    elif fam in ("encdec", "audio"):
        kv = P(None, *rules.spec("batch", "kv_seq", "kv_heads", None))
        xkv = P(None, *rules.spec("batch", None, "kv_heads", None))
        out.update(k=kv, v=kv, xk=xkv, xv=xkv)
    return out


def named(mesh: DeviceMesh, tree):
    """Each spec of ``tree`` as ``(mesh, placements)``."""
    return tree_map(lambda s: (mesh, placements(mesh, s)), tree)


def distribute(tree, mesh: DeviceMesh, specs):
    """Every leaf of ``tree`` placed on ``mesh`` by its spec in ``specs``
    (a tree of the same keys): a DTensor whose local shard each rank
    holds."""
    return tree_map(lambda x, s: distribute_tensor(
        x, mesh, placements(mesh, s)), tree, specs)
