"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.paged_attention`` (Pallas kernel
``paged_attention_fwd``).  Takes the serving layout: q ``(B,Hq,D)``,
token-major pages ``(NP,P,Hkv,D)``, block tables ``(B,MP)`` and context
lengths ``(B,)``; returns ``(B,Hq,D)``.  The kernel
(``kernels/csrc/paged_attention.cu``) reads the pages where they lie;
unlike the reference wrapper, nothing transposes the store.

Unlike the Pallas kernel, both versions take ``softcap``, so the kernel
path computes what the reference's default ``gather`` path computes
(paged_model.py:124-125); the reference's Pallas route drops it.

The kernel splits each sequence over blocks (``grid``: splits of
``split_len`` positions, from the shapes alone, so the wrapper reads no
device value), and takes the q heads of a kv head in chunks of at most
8 (the largest divisor of the group up to 8: the whole group up to 8,
8 at 16/1 or 32/1), a block a chunk.  Each call takes an fp32 workspace
from ``torch.empty`` for the splits' partial softmax states, and a set
of zeroed counters per device and stream, made once and kept: the
kernel leaves them zeroed, so the last block of each (sequence, chunk)
can merge the splits.  A CUDA graph takes the set of the stream it was
captured on with it (``take_ticket_counters``), so no later stream
shares the graph's.

The kernel takes bf16, fp16 and fp32 (each widened to fp32 as it is
read, the output rounded once to the input type), every head_dim that is
a multiple of 16 from 16 to 256 (``HEAD_DIMS``; a row on the power of
two of lanes at or above head_dim/8, a whole warp from 144 on, where one
kernel a dtype and group takes the head_dim at run time) and any group
(``hq % hkv == 0``); another head_dim raises on a CUDA tensor.
``paged_attention`` runs ``paged_attention_ref`` for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor it launches or raises
(``RuntimeError`` where autograd would record the call: the kernel has
no backward).
Each launch counts as ``paged_attention`` in ``kernels.counts`` (one a
call: the merge is inside the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = tuple(range(16, 257, 16))

#: (device index, stream) -> zeroed int32 counters, one per (sequence,
#: chunk of q heads); the kernel leaves them zeroed
_tickets = {}


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        softcap: float = 0.0):
    """Plain version: gather each sequence's pages into a contiguous
    cache, then masked fp32 softmax attention."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    mp = block_tables.shape[1]
    group = hq // hkv
    tables = block_tables.long()
    k_seq = k_pages[tables].reshape(b, mp * page, hkv, d)
    v_seq = v_pages[tables].reshape(b, mp * page, hkv, d)
    k_seq = k_seq.repeat_interleave(group, dim=2).float()
    v_seq = v_seq.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), k_seq) * (d ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(mp * page, device=q.device)
    valid = pos[None, None, :] < context_lens.to(q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, v_seq)
    return o.to(q.dtype)


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("paged_attention_split_len",
                     "paged_attention_heads_per_block"):
            getattr(lib, name).argtypes = [ctypes.c_int] * 2
            getattr(lib, name).restype = ctypes.c_int
    return lib


def grid(q, k_pages, block_tables):
    """The kernel's launch grid (splits, Hq / heads a block, B) and its
    positions per split, from the shapes alone: a block whose split
    starts at or past its sequence's length returns at once."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    lib = _lib()
    split = lib.paged_attention_split_len(DTYPES[q.dtype], d)
    chunks = hq // lib.paged_attention_heads_per_block(hq, hkv)
    return (-(-block_tables.shape[1] * page // split), chunks, b), split


def _ticket_counters(device, stream, n):
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def take_ticket_counters(device, stream):
    """Hand the counters of (device, stream) over to the caller, or None
    if that stream has none: a CUDA graph captured on the stream keeps
    the counters its launches were recorded with, and a later call on a
    stream with the same handle makes counters of its own."""
    return _tickets.pop((torch.device(device).index, stream), None)


def _check(q, k_pages, v_pages, block_tables, context_lens):
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2 \
            or context_lens.dim() != 1:
        raise ValueError("paged_attention expects q (B,Hq,D), pages "
                         "(NP,P,Hkv,D), tables (B,MP), lens (B,)")
    b, hq, d = q.shape
    _, _, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if block_tables.shape[0] != b or context_lens.shape[0] != b:
        raise ValueError("tables and lens need one row per sequence")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes bf16, fp16 or fp32 "
                        f"q/k/v of one dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block tables and context lens must be int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads "
                         f"{hkv}")
    for t in (q, k_pages, v_pages, block_tables, context_lens):
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel needs contiguous tensors")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and pages must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    softcap: float = 0.0):
    """q: (B,Hq,D); k/v_pages: (NP,P,Hkv,D) -> (B,Hq,D)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k_pages, v_pages)):
        raise RuntimeError(
            "the paged_attention kernel has no backward (nor has the "
            "reference's): call it under torch.no_grad(), or train on a "
            "plain attention route")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    (splits, chunks, _), _ = grid(q, k_pages, block_tables)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    # one record of (hq / chunks) * (d + 2) floats a (sequence, chunk,
    # split)
    ws = torch.empty(b * hq * splits * (d + 2) if splits > 1 else 1,
                     dtype=torch.float32, device=q.device)
    tickets = _ticket_counters(q.device, stream, b * chunks)
    err = _lib().paged_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), b, hq, hkv, d,
        page, block_tables.shape[1], d ** -0.5, float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(error {err})")
    counts.count("paged_attention")
    return out
