"""Mamba2 / SSD (state-space duality) block: the port of
``repro.models.ssm`` (arXiv:2405.21060).

Plain functions on tensors, with the reference's names, shapes and
numerics:

* ``ssd_chunked``   — chunked scan used for prefill.  On a CUDA tensor it
                      launches the hand-written SSD kernel
                      (``kernels.ssd_scan``); on a CPU tensor it runs that
                      kernel's plain version, the same chunked formula.
* ``ssd_recurrent`` — token-by-token recurrence (the oracle).
* ``ssd_step``      — one-token decode state update.

The block (``mamba2_init/apply/decode``) follows the Mamba2 layout:
``in_proj -> [z | xBC | dt]``, causal depthwise conv over xBC, SSD core,
D skip, gated RMSNorm, ``out_proj``.  B/C are grouped (``n_groups``).

Storage: the mixer's ``A_log``, ``D``, ``dt_bias``, ``norm_scale``,
``conv_w`` and ``conv_b`` are fp32, because the reference reads each of
them in fp32; ``in_proj`` and ``out_proj`` are in the compute dtype,
because the reference casts them to it before use
(``model_zoo.param_dtype``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import axis_size, local
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import normal


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_recurrent(xbar, dA_log, Bm, Cm, state0=None):
    """Token-by-token oracle.  xbar: (B,S,H,P) dt-scaled inputs;
    dA_log: (B,S,H) = dt*A (<=0);  Bm/Cm: (B,S,G,N), heads grouped
    contiguously (head h uses group h // (H//G)).

    Returns (y (B,S,H,P) fp32, final_state (B,H,N,P) fp32)."""
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    Bh = Bm.repeat_interleave(hpg, dim=2).float()            # (B,S,H,N)
    Ch = Cm.repeat_interleave(hpg, dim=2).float()
    xf = xbar.float()
    da = torch.exp(dA_log.float())                           # (B,S,H)
    state = torch.zeros((b, h, n, p), dtype=torch.float32,
                        device=xbar.device) if state0 is None \
        else state0.float()
    ys = []
    for t in range(s):
        state = state * da[:, t, :, None, None] + \
            Bh[:, t, :, :, None] * xf[:, t, :, None, :]      # (B,H,N,P)
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_chunked(xbar, dA_log, Bm, Cm, chunk: int, state0=None):
    """Chunked SSD scan, same signature and semantics as
    ``ssd_recurrent``; S must be a multiple of ``chunk``."""
    s = xbar.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    # under a sharding plan each rank scans its batch rows and SSD heads,
    # with the B/C groups those heads read: all of them (one group, or
    # heads left whole) or its share (groups sharded with the heads)
    n = axis_size("heads")
    g = Bm.shape[2]
    heads = "heads" if xbar.shape[2] % n == 0 and (g == 1 or g % n == 0) \
        else None
    groups = heads if g > 1 else None
    hs = ("batch", None, heads, None)
    state = ("batch", heads, None, None)
    gs = ("batch", None, groups, None)

    def scan(xbar, dA_log, Bm, Cm, state0):
        return ssd_ops.ssd_scan(xbar, dA_log, Bm, Cm, chunk=chunk,
                                state0=state0)

    return local(scan, (hs, state),
                 (hs, ("batch", None, heads), gs, gs,
                  None if state0 is None else state))(
        xbar, dA_log, Bm, Cm, state0)


def ssd_step(state, x_t, dA_log_t, B_t, C_t):
    """One decode step.  state: (B,H,N,P) fp32; x_t: (B,H,P) dt-scaled;
    dA_log_t: (B,H); B_t/C_t: (B,G,N).  Returns (y (B,H,P), state)."""
    h = x_t.shape[1]
    hpg = h // B_t.shape[1]
    Bh = B_t.repeat_interleave(hpg, dim=1).float()
    Ch = C_t.repeat_interleave(hpg, dim=1).float()
    a = torch.exp(dA_log_t.float())
    state = state * a[..., None, None] + \
        Bh[..., :, None] * x_t.float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y, state


# ---------------------------------------------------------------------------
# Depthwise causal conv1d
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b, state=None):
    """x: (B,S,C); w: (W,C); b: (C,).  Left-pads with `state`
    ((B,W-1,C), zeros if None).  Returns (y (B,S,C), new_state)."""
    bsz, s, c = x.shape
    wwin = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, wwin - 1, c), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    # depthwise conv as a sum of shifted scaled copies (W is tiny: 4)
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(wwin):
        y = y + xp[:, i:i + s, :].float() * w[i][None, None, :].float()
    y = y + b[None, None, :].float()
    return y.to(x.dtype), xp[:, s:, :]


def conv_step(x_t, w, b, state):
    """One-token conv.  x_t: (B,C); state: (B,W-1,C)."""
    xp = torch.cat([state, x_t[:, None, :]], dim=1)          # (B,W,C)
    y = torch.einsum("bwc,wc->bc", xp.float(), w.float()) + b.float()
    return y.to(x_t.dtype), xp[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def mamba2_init(d_model: int, ssm, *, generator, device, dtype,
                n_heads_phys: int = 0):
    """Random parameters with the shapes and scales of the reference's
    ``mamba2_init`` (ssm.py:172-199), drawn from ``generator``.  ``dtype``
    is the compute dtype, the storage of ``in_proj``/``out_proj``; the
    other leaves are fp32.  ``n_heads_phys`` >= logical heads (pad plan)."""
    h = n_heads_phys or ssm.n_heads(d_model)
    p = ssm.head_dim
    d_in_phys = h * p
    g, n = ssm.n_groups, ssm.d_state
    conv_dim = d_in_phys + 2 * g * n
    d_proj = 2 * d_in_phys + 2 * g * n + h                   # z|xBC|dt
    f32 = torch.float32
    kw = dict(generator=generator, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((h,), dtype=f32, **kw) * (hi - lo) + lo
    return {
        "in_proj": normal((d_model, d_proj), d_model ** -0.5, dtype=dtype,
                          **kw),
        "conv_w": normal((ssm.conv_width, conv_dim), conv_dim ** -0.5,
                         dtype=f32, **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=f32, device=device),
        # A in [-1, -16]: A_log = log(linspace(1, 16))
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm_scale": torch.ones((d_in_phys,), dtype=f32, device=device),
        "out_proj": normal((d_in_phys, d_model), d_in_phys ** -0.5,
                           dtype=dtype, **kw),
    }


def _mamba2_pre(p, x, ssm, h, compute_dtype):
    """Shared pre-SSD computation. x: (B,S,d_model) ->
    (z, xBC_raw, dt_raw) in compute dtype."""
    proj = x.to(compute_dtype) @ p["in_proj"].to(compute_dtype)
    d_in = h * ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * g * n]
    dt_raw = proj[..., -h:]
    return z, xBC, dt_raw


def _mamba2_post(p, y, z, x_conv, compute_dtype, head_mask=None):
    """D-skip + gated norm + out_proj.  y,x_conv: (B,S,H,P) fp32/compute."""
    b, s, h, pd = y.shape
    D = p["D"].float()
    y = y + D[None, None, :, None] * x_conv.float()
    if head_mask is not None:
        y = y * head_mask[None, None, :, None]
    y = y.reshape(b, s, h * pd)
    y = y * F.silu(z.float())
    # gated RMSNorm
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * p["norm_scale"].float()[None, None, :]
    return y.to(compute_dtype) @ p["out_proj"].to(compute_dtype)


def _split_xbc(xBC, h, pdim, g, n):
    x = xBC[..., : h * pdim]
    Bm = xBC[..., h * pdim: h * pdim + g * n]
    Cm = xBC[..., h * pdim + g * n:]
    return x, Bm, Cm


def _dt_terms(p, xc, dt_raw):
    """(dA_log, xbar) from the conv output and the raw dt, in fp32."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return dt * A, xc.float() * dt[..., None]


def mamba2_apply(p, x, ssm, *, compute_dtype, conv_state=None,
                 ssd_state=None, head_mask=None, impl: str = "chunked",
                 chunk: int = 0):
    """Full-sequence Mamba2 block.  x: (B,S,d_model).

    Returns (out (B,S,d_model), (conv_state, ssd_state)) so prefill can
    seed decode.  The chunked scan runs when ``impl == "chunked"``, S is
    a multiple of the chunk and S > 1, as in the reference; otherwise
    the recurrence does."""
    b, s, _ = x.shape
    h = p["A_log"].shape[0]
    pdim = ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    chunk = chunk or ssm.chunk_size

    z, xBC, dt_raw = _mamba2_pre(p, x, ssm, h, compute_dtype)
    xBC, conv_state = causal_conv1d(xBC, p["conv_w"], p["conv_b"],
                                    conv_state)
    xBC = F.silu(xBC.float()).to(compute_dtype)
    xc, Bm, Cm = _split_xbc(xBC, h, pdim, g, n)
    xc = xc.reshape(b, s, h, pdim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dA_log, xbar = _dt_terms(p, xc, dt_raw)

    if impl == "chunked" and s % chunk == 0 and s > 1:
        y, ssd_state = ssd_chunked(xbar, dA_log, Bm, Cm, chunk, ssd_state)
    else:
        y, ssd_state = ssd_recurrent(xbar, dA_log, Bm, Cm, ssd_state)

    out = _mamba2_post(p, y, z, xc, compute_dtype, head_mask)
    return out, (conv_state, ssd_state)


def mamba2_decode(p, x_t, ssm, *, compute_dtype, conv_state, ssd_state,
                  head_mask=None):
    """One-token decode.  x_t: (B,d_model); states from prefill.

    Returns (out (B,d_model), (conv_state, ssd_state))."""
    bsz = x_t.shape[0]
    h = p["A_log"].shape[0]
    pdim = ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state

    z, xBC, dt_raw = _mamba2_pre(p, x_t[:, None, :], ssm, h, compute_dtype)
    z, xBC, dt_raw = z[:, 0], xBC[:, 0], dt_raw[:, 0]
    xBC, conv_state = conv_step(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC.float()).to(compute_dtype)
    xc, Bm, Cm = _split_xbc(xBC, h, pdim, g, n)
    xc = xc.reshape(bsz, h, pdim)
    Bm = Bm.reshape(bsz, g, n)
    Cm = Cm.reshape(bsz, g, n)
    dA_log, xbar = _dt_terms(p, xc, dt_raw)

    y, ssd_state = ssd_step(ssd_state, xbar, dA_log, Bm, Cm)
    out = _mamba2_post(p, y[:, None], z[:, None], xc[:, None],
                       compute_dtype, head_mask)
    return out[:, 0], (conv_state, ssd_state)
