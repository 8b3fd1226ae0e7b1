"""Int8 error-feedback gradient compression for the data-parallel
all-reduce: the port of ``repro.training.grad_compress``.

Gradients are quantized to int8 with a per-tensor scale before the
all-reduce, and the quantization residual is fed back into the next
step's gradient (error feedback keeps the method convergent: Seide et
al., Karimireddy et al.).  ``jnp.round`` and ``torch.round`` both round
half to even, and the int8 cast follows the clip, as in the reference.

The reference's ``axis_name`` psum becomes an optional
``torch.distributed`` process group: the int8 values are summed as int32
over the group, and so is the count of members.  Without a group
(``group=None``, one process) nothing is reduced.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map


def ef_init(params) -> Any:
    """Error-feedback residual state (fp32 zeros like params)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def quantize(g, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q, scale) -> torch.Tensor:
    return q.float() * scale


def _all_reduce(t, group):
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def compress_grads(grads, ef_state, *, group=None):
    """Quantize (grad + residual), sum over ``group`` where given,
    dequantize, and compute the new residual.

    Returns (decompressed_grads, new_ef_state)."""
    def one(g, e):
        gf = g.float() + e
        q, scale = quantize(gf)
        if group is not None:
            qsum = _all_reduce(q.to(torch.int32), group)
            n = _all_reduce(torch.ones((), dtype=torch.int32,
                                       device=q.device), group)
            deq = qsum.float() * scale / n.float()
        else:
            deq = dequantize(q, scale)
        resid = gf - dequantize(q, scale)
        return deq.to(g.dtype), resid

    out = tree_map(one, grads, ef_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
