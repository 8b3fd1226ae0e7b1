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
biases and a learned position table (``pos``), which the reference casts
to the activations' dtype before the add.  The leaves the reference
reads in fp32 (norm scales, qk-norm's among them, the MoE router, the
Mamba2 mixer's
``A_log``, ``D``, ``dt_bias``, ``norm_scale``, ``conv_w``, ``conv_b``, a
tied or fp32-logit table) stay fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import resolve_device


def params_from_jax(model: zoo.Model, tree: Dict[str, Any],
                    device=None) -> Dict[str, Any]:
    device = resolve_device(device)

    def convert(node, path: Tuple[str, ...]):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), device=device,
                            dtype=zoo.param_dtype(model, path))

    return convert(tree, ())
