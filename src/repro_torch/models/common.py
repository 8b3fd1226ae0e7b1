"""Shared model-runtime settings and the device rule of the port."""
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


@dataclass(frozen=True)
class RunSettings:
    """Hashable knobs threaded through the model functions.

    The port's copy of ``repro.models.common.RunSettings``, holding the
    fields that the serving path reads.  The remat, layer-scan, MoE and
    sharding knobs of the reference come with the slices that use them.
    """

    attn_impl: str = "auto"         # one of ATTN_IMPLS
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    naive_attn_max_seq: int = 2048  # "auto" switches to blocked above this
    logits_fp32: bool = True

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {self.attn_impl!r}; "
                             f"have {ATTN_IMPLS}")

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
