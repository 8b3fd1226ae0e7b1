"""Load the reference's parameters into the port.

``params_from_jax(model, tree, device)`` takes the JAX parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``), layers stacked on a
leading L axis as the reference stacks them, and returns the port's tree:
same keys and shapes, each leaf in its storage dtype
(``model_zoo.param_dtype``).  Dense weights keep the reference's
``(d_in, d_out)`` orientation, so nothing is transposed.  Casting matmul
weights (among them the Mamba2 ``in_proj``/``out_proj`` and the MoE
experts' ``up``/``gate``/``down``) and an untied
embedding table to the compute dtype here is exact, because every reader
in the reference casts them so before use; so do the qkv and MLP
biases and the learned position tables (``pos``; an encoder-decoder
model's ``enc_pos`` and ``dec_pos``), which the reference casts to the
activations' dtype before the add.  The leaves the reference reads in
fp32 (norm scales, qk-norm's and the encoder-decoder's ``ln_x`` and
``enc_norm`` among them, the MoE router, the Mamba2 mixer's ``A_log``,
``D``, ``dt_bias``, ``norm_scale``, ``conv_w``, ``conv_b``, a tied or
fp32-logit table, and an encoder-decoder model's embedding table, which
is its unembedding too) stay fp32.  An encoder-decoder tree
(``enc_layers``; ``dec_layers`` with ``ln_x`` and ``xattn``) goes
across as any other: the rule is the leaf's path.

``master=True`` gives the training tree instead: every leaf in
``cfg.param_dtype`` (``model_zoo.master_dtype``), so the reference's
fp32 weights come across bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import resolve_device


def params_from_jax(model: zoo.Model, tree: Dict[str, Any],
                    device=None, master: bool = False) -> Dict[str, Any]:
    device = resolve_device(device)

    def convert(node, path: Tuple[str, ...]):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), device=device,
                            dtype=zoo.param_dtype(model, path, master))

    return convert(tree, ())
