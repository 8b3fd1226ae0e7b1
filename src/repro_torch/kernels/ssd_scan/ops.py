"""Chunked Mamba2 SSD scan: the CUDA kernels' wrapper and its plain version.

Port of ``repro.kernels.ssd_scan`` (Pallas kernel ``ssd_scan_fwd``).
Contract, as the reference's: xbar ``(B,S,H,P)`` dt-scaled inputs,
dA_log ``(B,S,H)`` (``dt·A <= 0``), B/C ``(B,S,G,N)`` with head h reading
group ``h // (H/G)``; returns y ``(B,S,H,P)`` fp32 and the final state
``(B,H,N,P)`` fp32.  Beyond the Pallas kernel, both versions take an
initial state (``None`` means zeros), which is ``ssd_chunked``'s own
contract (``models.ssm``).

* ``ssd_chunked_ref`` — plain version: the chunked formula of the
  reference's ``ssd_chunked`` in fp32; S must be a multiple of ``chunk``.
* ``ssd_scan`` — the wrapper.  It picks the chunk as the reference's
  wrapper does and pads a ragged S with identity steps (``dA_log = 0``,
  ``x = 0``: the state passes through, the padded rows of y are cut
  off).  CPU tensors run ``ssd_chunked_ref``; CUDA tensors launch the
  kernels (``kernels/csrc/ssd_scan.cu``) or raise.  Meta tensors (the
  dry run's, ``launch/dryrun.py``) trace ``ssd_chunked_ref``'s ops,
  which compute nothing.  The kernels mask the
  ragged last chunk themselves, so nothing is padded on the card.

On the card a scan is three kernels on the current stream, ordered by
the stream alone, so every chunk of every head runs in parallel and only
the (N,P) recurrence across chunks is sequential: chunk state (seg, each chunk's own state, and C·Bᵀ once per group), state
passing (the state before every chunk, and the final state), chunk scan
(y, 64 rows of a chunk per block).  Their products are fp32 FMAs, so
the scan is bound by the card's fp32 rate (67 TFLOP/s outside the
tensor cores), not by its memory.  The wrapper allocates y, the final
state and the fp32 scratch the kernels pass between them, with
``torch.empty``; the kernels allocate nothing.

The kernels read B/C where they lie, through their strides (in the model
they are column slices of the conv output, ``models.ssm._split_xbc``),
in fp32 or bf16; x, dA_log and the initial state must be contiguous fp32.
Each scan counts as ``ssd_scan`` in ``kernels.counts``: one per wrapper
call on the card, whatever number of CUDA kernels a scan takes.

Gradients.  Where autograd records the call (grad mode on and an input
that requires grad), the card's scan runs inside ``_ScanFunction``: its
forward launches the kernels as above, and its backward recomputes the
plain version on the saved inputs and takes its gradients, with respect
to xbar, dA_log, B, C and the initial state where given.  That is the
gradient the reference's ``jax.grad`` takes of its plain ``ssd_chunked``;
no reference kernel has a backward, so there is no backward kernel.  On
the CPU the plain version is differentiable as it stands.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, counts

BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' limits (see ssd_scan.cu): a block's output tile spans P,
#: a chunk's seg fits in shared memory
MAX_STATE = 128
MAX_HEAD_DIM = 64
MAX_CHUNK = 1024


def ssd_chunked_ref(xbar, dA_log, Bm, Cm, chunk: int, state0=None):
    """Plain version: the reference's chunked SSD in fp32.  Within a
    chunk ``(C·Bᵀ ⊙ exp(segsum)) @ x``; across chunks a recurrence over
    per-chunk states."""
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc, L = s // chunk, chunk
    hpg = h // g

    xf = xbar.float().reshape(b, nc, L, h, p)
    la = dA_log.float().reshape(b, nc, L, h)
    Bc = Bm.float().reshape(b, nc, L, g, n)
    Cc = Cm.float().reshape(b, nc, L, g, n)

    seg = torch.cumsum(la, dim=2)                            # (B,nc,L,H)
    total = seg[:, :, -1, :]                                 # (B,nc,H)

    # within-chunk: scores (B,nc,G,L,L), decay exp(L_i - L_j) for i >= j
    scores = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xbar.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    decay = decay.movedim(-1, 2)                             # (B,nc,H,L,L)
    scores_h = scores.repeat_interleave(hpg, dim=2) * decay
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores_h, xf)

    # per-chunk states: sum_j exp(total - L_j) B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - seg)                # (B,nc,L,H)
    Bh = Bc.repeat_interleave(hpg, dim=3)                    # (B,nc,L,H,N)
    chunk_states = torch.einsum("bclh,bclhn,bclhp->bchnp", w, Bh, xf)

    # inter-chunk recurrence; states_in[c] is the state before chunk c
    state = torch.zeros((b, h, n, p), dtype=torch.float32,
                        device=xbar.device) if state0 is None \
        else state0.float()
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + \
            chunk_states[:, c]
    states_in = torch.stack(states_in, dim=1)                # (B,nc,H,N,P)

    Ch = Cc.repeat_interleave(hpg, dim=3)                    # (B,nc,L,H,N)
    y_inter = torch.einsum("bclh,bclhn,bchnp->bclhp", torch.exp(seg), Ch,
                           states_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


def _plain(xbar, dA_log, Bm, Cm, chunk, state0):
    """``ssd_chunked_ref`` at the wrapper's chunk, a ragged S padded with
    identity steps and cut off again."""
    s = xbar.shape[1]
    pad = (-s) % chunk
    if pad:
        xbar = F.pad(xbar.float(), (0, 0, 0, 0, 0, pad))
        dA_log = F.pad(dA_log.float(), (0, 0, 0, pad))
        Bm = F.pad(Bm.float(), (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad))
    y, fs = ssd_chunked_ref(xbar, dA_log, Bm, Cm, chunk, state0)
    return y[:, :s], fs


class _ScanFunction(torch.autograd.Function):
    """``forward_fn``'s scan with the plain version's gradients: the
    backward recomputes ``_plain`` on the saved inputs and differentiates
    it.  ``forward_fn(xbar, dA_log, Bm, Cm, chunk, state0)`` is the
    kernels' launch on the card."""

    @staticmethod
    def forward(ctx, forward_fn, chunk, xbar, dA_log, Bm, Cm, state0):
        ctx.chunk = chunk
        ctx.save_for_backward(xbar, dA_log, Bm, Cm, state0)
        return forward_fn(xbar, dA_log, Bm, Cm, chunk, state0)

    @staticmethod
    def backward(ctx, dy, dfs):
        inputs = ctx.saved_tensors
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(inputs, wanted)]
            y, fs = _plain(*leaves[:4], ctx.chunk, leaves[4])
            wrt = [t for t, w in zip(leaves, wanted) if w]
            got = iter(torch.autograd.grad((y, fs), wrt, (dy, dfs),
                                           allow_unused=True))
        grads = [next(got) if w else None for w in wanted]
        return (None, None, *grads)


def _lib():
    lib = build.load("ssd_scan")
    if lib.ssd_scan_launch.argtypes is None:
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 3
            + [ctypes.c_void_p])
        lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def _chunk(s: int, chunk: int) -> int:
    """The chunk the reference's wrapper takes for a sequence of s."""
    return min(chunk, s) if s % chunk == 0 or s < chunk else chunk


def _check(xbar, dA_log, Bm, Cm, state0):
    if xbar.dim() != 4 or dA_log.dim() != 3 or Bm.dim() != 4 \
            or Cm.dim() != 4:
        raise ValueError("ssd_scan expects xbar (B,S,H,P), dA_log (B,S,H), "
                         "B/C (B,S,G,N)")
    b, s, h, p = xbar.shape
    _, _, g, n = Bm.shape
    if dA_log.shape != (b, s, h) or Bm.shape[:2] != (b, s) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes do not fit: xbar {tuple(xbar.shape)}, "
                         f"dA_log {tuple(dA_log.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if xbar.dtype != torch.float32 or dA_log.dtype != torch.float32:
        raise TypeError("the ssd_scan kernel takes fp32 xbar and dA_log")
    if Bm.dtype not in BC_DTYPES or Cm.dtype != Bm.dtype:
        raise TypeError(f"the ssd_scan kernel takes fp32 or bf16 B/C of one "
                        f"dtype, got {Bm.dtype}/{Cm.dtype}")
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"d_state {n} > {MAX_STATE} or head_dim {p} > "
                         f"{MAX_HEAD_DIM}")
    if not (xbar.is_contiguous() and dA_log.is_contiguous()):
        raise ValueError("xbar and dA_log must be contiguous")
    if Bm.stride(3) != 1 or Cm.stride(3) != 1 or Bm.stride() != Cm.stride():
        raise ValueError("B and C need unit stride along N and equal "
                         "strides")
    if state0 is not None and (state0.shape != (b, h, n, p)
                               or state0.dtype != torch.float32
                               or not state0.is_contiguous()):
        raise ValueError("state0 must be a contiguous fp32 (B,H,N,P)")
    for t in (dA_log, Bm, Cm) + (() if state0 is None else (state0,)):
        if t.device != xbar.device:
            raise ValueError("all tensors must be on one device")


def ssd_scan(xbar, dA_log, Bm, Cm, *, chunk: int = 256, state0=None):
    """xbar (B,S,H,P); dA_log (B,S,H); Bm/Cm (B,S,G,N) ->
    (y (B,S,H,P) f32, final_state (B,H,N,P) f32)."""
    chunk = _chunk(xbar.shape[1], chunk)
    if xbar.device.type in ("cpu", "meta"):
        return _plain(xbar, dA_log, Bm, Cm, chunk, state0)
    if xbar.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda, cpu or meta, not "
                         f"{xbar.device}")
    _check(xbar, dA_log, Bm, Cm, state0)
    inputs = (xbar, dA_log, Bm, Cm, state0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _ScanFunction.apply(_launch, chunk, *inputs)
    return _launch(*inputs[:4], chunk, state0)


def _launch(xbar, dA_log, Bm, Cm, chunk, state0):
    """The kernels' scan on the card (inputs checked)."""
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    nc = -(-s // chunk)
    dev = xbar.device
    y = torch.empty_like(xbar)
    fs = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    # one fp32 workspace: seg (B,H,nc,L), each chunk's own state and the
    # state before each chunk (B,H,nc,N,P) each, C·Bᵀ (B,G,nc,L,L); each
    # part starts on a 16-byte boundary.  Freed on return: the caching
    # allocator hands it out again only to work queued after the scan on
    # this stream.
    sizes = [b * h * nc * chunk, b * h * nc * n * p, b * h * nc * n * p,
             b * g * nc * chunk * chunk]
    sizes = [-(-k // 4) * 4 for k in sizes]
    work = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs, at = [], work.data_ptr()
    for k in sizes:
        ptrs.append(at)
        at += 4 * k
    err = _lib().ssd_scan_launch(
        BC_DTYPES[Bm.dtype], xbar.data_ptr(), dA_log.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(),
        0 if state0 is None else state0.data_ptr(), y.data_ptr(),
        fs.data_ptr(), *ptrs, b, s, h, p, g, n, chunk,
        Bm.stride(0), Bm.stride(1), Bm.stride(2),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (error {err})")
    counts.count("ssd_scan")
    return y, fs
