"""Shared model-runtime settings, the device rule of the port, and the
two helpers over parameter trees (nested dicts of tensors)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

#: every accepted ``RunSettings.attn_impl``; the reference's values all
#: resolve.  ``pallas`` names the hand-written flash kernel
#: (``repro_torch.kernels.flash_attention``); ``blocked`` and
#: ``blocked_causal`` are plain PyTorch loops over blocks of
#: ``attn_block_q`` x ``attn_block_kv``, as the reference's are plain JAX
#: (see ``models.attention_impl``).
ATTN_IMPLS = ("auto", "naive", "blocked", "blocked_causal", "pallas")
#: every accepted ``RunSettings.moe_impl`` (``models.moe``)
MOE_IMPLS = ("dense_onehot", "sort")
#: every accepted ``RunSettings.remat``: what a layer keeps for the
#: backward (``models.model_zoo``): all (``none``), only its input
#: (``full``), or its input and its plain matrix products
#: (``dots_saveable``)
REMAT_MODES = ("none", "full", "dots_saveable")
#: every accepted ``RunSettings.embed_shard`` (``distributed.shard_plan``):
#: the embedding table vocab-parallel over ``model`` and d_model over
#: ``data`` (``vocab``), or d_model over ``data`` alone (``fsdp``)
EMBED_SHARDS = ("vocab", "fsdp")


@dataclass(frozen=True)
class RunSettings:
    """Hashable knobs threaded through the model functions.

    The port's copy of ``repro.models.common.RunSettings``, with every
    field of the reference.  ``remat`` acts only where autograd records
    the forward.  ``scan_layers`` chooses no code path: the port always
    runs a Python loop over the stacked layers, which computes the same
    values as the reference's ``lax.scan`` and its unrolled loop alike,
    so every count the dry run (``launch/dryrun.py``) takes is the
    reference's unrolled (``scan_layers=False``) count; its one reader is
    the dry run's record, which keeps the setting as given.
    ``embed_shard`` and ``fsdp_params`` are read by
    ``distributed.shard_plan`` only.
    """

    attn_impl: str = "auto"         # one of ATTN_IMPLS
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    naive_attn_max_seq: int = 2048  # "auto" switches to blocked above this
    remat: str = "full"             # one of REMAT_MODES
    scan_layers: bool = True
    moe_impl: str = "dense_onehot"  # one of MOE_IMPLS
    logits_fp32: bool = True
    # --- sharding-plan knobs (read by distributed.shard_plan) ----------
    embed_shard: str = "vocab"      # one of EMBED_SHARDS
    fsdp_params: bool = True        # False: replicate non-embedding weights
    #                                 over "data" (pure TP+DP, no ZeRO-3)

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {self.attn_impl!r}; "
                             f"have {ATTN_IMPLS}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {self.remat!r}; "
                             f"have {REMAT_MODES}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe impl {self.moe_impl!r}; "
                             f"have {MOE_IMPLS}")
        if self.embed_shard not in EMBED_SHARDS:
            raise ValueError(f"unknown embed shard {self.embed_shard!r}; "
                             f"have {EMBED_SHARDS}")

    def resolve_attn(self, seq_len: int) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        return "naive" if seq_len <= self.naive_attn_max_seq else "blocked"


DEFAULT_SETTINGS = RunSettings()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Without one this raises: the port's
    entry points never fall back to the CPU on their own; a caller that
    wants the CPU (the tests) says so with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the
    first tree's keys), as ``jax.tree.map`` over dict trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a nested dict in sorted key order, the order of
    ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in tree_leaves(tree[k])]
    return [tree]
