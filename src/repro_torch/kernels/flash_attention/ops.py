"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.flash_attention`` (Pallas kernel
``flash_attention_fwd``).  Model layout in and out: q ``(B,Sq,H,D)``,
k/v ``(B,Skv,Hkv,D)`` -> ``(B,Sq,H,D)``; q head h reads kv head
``h // (H/Hkv)``.

Masking follows the Pallas kernel: causal is top-left aligned
(``qpos >= kpos``, kernel.py:58-63), which differs from the reference's
``ref.py`` (bottom-right) when ``Sq != Skv``; key positions at or past
``Skv`` are masked.  The kernel (``kernels/csrc/flash_attention.cu``)
masks ragged lengths itself, so none of the TPU wrapper's padding of the
sequence to the block and of head_dim to 128 (with its rescaling of q,
ops.py:53-60) is carried over.

The kernels are written for Hopper and take bf16, fp16 and fp32, each
at every head_dim that is a multiple of 16 from 16 to 256
(``HEAD_DIMS``), any GQA group and any lengths.  bf16 and fp16, one
kernel template for both: TMA loads into a ring of K/V tiles, ``wgmma``
products accumulated in fp32, the softmax in registers, P rounded to the
input type for the P·V product; head_dims up to 64 run its 64-wide tiles
and those up to 128 its 128-wide tiles, the columns past head_dim read
as zeros.  Head_dims 144 to 256 run a kernel of 256-wide tiles
(``flash_kernel_wide``, the head_dim a runtime value): a producer
warpgroup keeps K and V rings of 64-key tiles filled, the softmax of a
tile runs while the P·V product of the tile before it retires, and a
block takes a pair of 64-row q units (``wide_schedule``): the longest
and its mirror when the blocks fit in one wave, so that at causal Sq =
Skv every block sweeps as many tiles, else neighbours.  fp32: the same shape on TF32 ``wgmma``,
each product taken as three TF32 products of the operands split into
hi + lo (3xTF32), since one TF32 product would miss the reference's fp32
tolerance; up to head_dim 128, 128-row q tiles over two warpgroups,
every thread of which splits its share of each raw 32-key K/V tile into
hi/lo K and a transposed hi/lo Vᵀ while the tile before it is
multiplied; from 144 to 256 (``flash_fp32_kernel_wide``) 64-row q tiles
and 16-key tiles: a producer warpgroup loads each tile and splits it
(K's lo stacked under K, so that one product takes Q's hi against both;
V into a transposed hi/lo) into rings that mbarriers hand over, and two
consumer warpgroups split head_dim between them, trade their partial
scores through shared memory and take a tile's softmax while the P·V
product of the tile before it runs.  There is no padding
copy: a head_dim that is not a multiple of 16, or above 256, raises on a
CUDA tensor.  The fp32 plain version serves the CPU
and the comparisons.  ``flash_attention`` runs ``flash_attention_ref``
for CPU tensors and the kernel for CUDA tensors; on a CUDA tensor it
launches or raises (``TypeError`` for a dtype but bf16, fp16 and fp32,
``ValueError`` for another head_dim; ``RuntimeError`` where autograd
would record the call, since the kernel has no backward, as the
reference's Pallas kernel has none).  Each launch counts as
``flash_attention`` in ``kernels.counts``, and by query length under
``("flash_attention", Sq)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts

NEG_INF = -1e30
#: -> the C dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = tuple(range(16, 257, 16))
#: q rows of a unit and keys of a K/V tile of the wide kernel (bf16 and
#: fp16 at head_dims 144 to 256)
WIDE_UNIT = 64
WIDE_KEYS = 64
#: SMs of an H100, one wide block an SM
H100_SMS = 132


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        softcap: float = 0.0):
    """Plain version: materialized fp32 scores, masked softmax."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    kf = k.repeat_interleave(group, dim=2).float()
    vf = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (d ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)


def wide_schedule(sq: int, skv: int, causal: bool, heads: int = 1,
                  batch: int = 1, sms: int = H100_SMS):
    """The wide kernel's blocks, by the rule its source
    (``flash_kernel_wide``) computes.

    A block takes a pair of 64-row q units of one (head, batch), the
    longer unit b and a shorter a (``None`` where it has none).  A unit's
    key tiles are the 64-key tiles that its rows attend.  Consumer 0
    sweeps a while consumer 1 sweeps b on the same tiles; b's tiles past
    a's go to consumer 1 and consumer 0 in turn.  When the blocks,
    ceil(U/2) a (head, batch) with U = ceil(Sq/64), fit in one wave of
    ``sms`` blocks, block z pairs unit b = U-1-z with its mirror a = z,
    so that at causal Sq = Skv every block sweeps as many tiles (mirror
    pairs); past one wave it pairs b = U-1-2z with its neighbour a = b-1,
    which share every tile but b's last, and the card's scheduler evens
    out their lengths.  Returns ``(mirror, blocks)``: the blocks of a
    (head, batch) in the order of z, each ``(a, b, tiles of a, tiles of
    b, tiles consumer 0 sweeps, tiles consumer 1 sweeps)``.  The grid is
    (len(blocks), heads, batch) with mirror pairs and (heads, batch,
    len(blocks)) with neighbour pairs, each head's longest block first.
    """
    units = -(-sq // WIDE_UNIT)
    n_kv = -(-skv // WIDE_KEYS)
    pairs = (units + 1) // 2
    mirror = pairs * heads * batch <= sms

    def tiles(u):
        last = (u * WIDE_UNIT + WIDE_UNIT - 1) // WIDE_KEYS
        return min(n_kv, last + 1) if causal else n_kv

    blocks = []
    for z in range(pairs):
        b, a = (units - 1 - z, z) if mirror else (units - 1 - 2 * z,
                                                  units - 2 - 2 * z)
        has_a = a < b if mirror else a >= 0
        nb = tiles(b)
        na = tiles(a) if has_a else 0
        blocks.append((a if has_a else None, b, na, nb, na + (nb - na) // 2,
                       na + (nb - na + 1) // 2))
    return mirror, blocks


def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention expects q (B,Sq,H,D) and k/v "
                         "(B,Skv,Hkv,D)")
    b, sq, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if bk != b or dk != d or h % hkv or sq == 0 or skv == 0:
        raise ValueError(f"shapes q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not fit")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16, fp16 or fp32 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("flash_attention kernel needs contiguous "
                             "tensors")
        if t.data_ptr() % 16:
            raise ValueError("q, k and v must be 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0):
    """Model layout in/out: q (B,Sq,H,D) -> (B,Sq,H,D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v)):
        raise RuntimeError(
            "the flash_attention kernel has no backward (nor has the "
            "reference's): call it under torch.no_grad(), or train on a "
            "plain attention route")
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _launcher()(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, skv, h, hkv, d, int(causal), d ** -0.5,
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(error {err})")
    counts.count("flash_attention", sq)
    return out
