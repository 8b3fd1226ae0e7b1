"""The port's CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA card and skip without one.  This file
imports no JAX, so it runs where the card is:

    python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py imports jax).  The kernel's
output is held against its plain version run in fp32 on the same
values, row by row (one q head of one token): the row's largest error
over its largest |value| stays within 1e-2 in bf16 and fp16 and 1e-4 in
fp32, as in chip_smoke.py.  Both attention kernels take bf16, fp16 and
fp32 at every head_dim that is a multiple of 16 from 16 to 256, and
paged every GQA group (in chunks of at most 8 q heads a block above 8);
the fp16 cases are the serving shapes of llama2-7b, qwen3-14b and
stablelm-3b, the narrowest head_dim and the edges of the splits and
tiles; the fp32 cases
are also held elementwise to the reference's fp32 tolerance
(tests/test_kernels.py, 2e-5), and the ``test_reference_*`` tests run
the reference's own flash, softcap, paged and permutation cases at their
shapes and dtypes.  ``test_fp32_limits_catch_a_planted_fault`` plants
faults in a copy of the fp32 flash kernel (its mask, its K/V ring, one
of the three TF32 products of P·V dropped) and shows that the fp32 row
limit catches each fault of the mask or the ring, and the reference's
elementwise 2e-5 the dropped product, an error of about 2^-12 of a
weight that the row limit need not see.
``test_relative_limit_catches_an_off_by_one`` plants a fault in a copy
of each kernel's source (a mask or length off by one, the stage of the
flash kernel's K/V ring, the end of a paged split, the paged merge's
rescale) and shows that the limit catches it on long rows; ``-s``
prints both readings.  ``test_relative_limit_catches_a_kv_tail_fault``
plants one in the non-causal tail (the key at position Skv, a row past
the end that TMA fills with zeros, joins the softmax) and shows that the
limit catches it at whisper-base's Skv of 1500.
``test_fp16_limit_catches_an_off_by_one`` plants one fault in each
kernel and runs it in fp16, the dtype that shares its code with bf16
but for the rounding of P and of the output.

Above head_dim 128 (Gemma's 256, every multiple of 16 from 144) the
flash kernels run their wide shapes (bf16 and fp16 in 256-wide tiles;
fp32 with a producer warpgroup and two consumers splitting D) and paged a warp of 32 lanes
a row: ``PAGED_WIDE`` and ``FLASH_WIDE`` take every such head_dim in
each dtype, paged at groups 1, 2, 5, 8, 16/1 and 32/1, flash causal,
non-causal with a ragged Skv and soft-capped, and the reference's
FLASH_CASES[4] shape at 256 in fp32 is held to its 2e-5.  The bf16/fp16
wide kernel also runs llama2-7b's served prefill at head_dim 256
(32/32), 2048 tokens (32/8), ragged q units with B 3 and a single q
unit; ``test_relative_limit_catches_a_wide_kernel_fault`` plants a fault
of its V ring and of each pairing of q units (``WIDE_FAULTS``) at the
served shape or 16/16, and ``test_wide_grid_follows_the_schedule`` holds the grid
the library launches to ``flash.wide_schedule``.  The fp32 wide kernel
also runs a sweep of one 16-key tile and a ragged Skv of 333, and
``test_fp32_limits_catch_a_wide_kernel_fault`` plants a fault of its V
ring, of its S exchange and of its split products (``WIDE_FP32_FAULTS``)
at causal S 1024 with 16/16 heads of 256.

Both attention kernels take head_dim 80 (stablelm-3b, zamba2-2.7b's
shared block) in padded tiles and lanes: flash in its D-128 tiles, paged
with 16 lanes a row, 6 of them dead.  Their cases cover every prefill
bucket and contexts up to 1056, and
``test_relative_limit_catches_a_head_dim_80_fault`` plants a fault of the
padding in each (the flash epilogue storing 128 columns, the paged dead
lanes writing into the merge buffer) and shows that the limit, read on
every row of every head, catches it.

The ``blocked``/``blocked_causal`` attention routes launch no kernel (they
are plain PyTorch, as the reference's are plain JAX): they are held to
the naive route on the card, with the same row limits, at stablelm-3b's
long prompts (head_dim 80 in bf16, and head_dim 128 in fp32; S 4096 in
blocks of 1024, and a ragged S 3000),
and one of them is captured in a CUDA graph and replayed, equal to eager.

The SSD scan (three kernels: chunk state, state passing, chunk scan) is
held to its plain version (run on the CPU, in fp32, on the same values;
two of its runs must agree within rounding) and to an fp64 recurrence
on the card, per row of P, on y and on the final state, within 1e-4:
its products are fp32 FMAs.
``test_ssd_limits_catch_a_planted_fault`` plants a fault in a copy of
its source and shows that this limit, and chip_smoke.py's limits for a
mamba2-130m layer through the kernel against ``impl="recurrent"``,
catch it.

Under autograd: the SSD wrapper launches its kernels once and carries
gradients, which equal ``torch.autograd.grad`` through the plain
version on the card within 1e-4 of each input's largest gradient, at
mamba2-130m's and zamba2-2.7b's prefill shapes (the latter from an
initial state); a mamba2 loss through the kernel has the same gradients
under each remat mode, the recompute launching the scan once more a
layer; and flash, paged and ``attend(impl="pallas")`` raise where
autograd would record them (none has a backward, nor has the
reference's).
"""
import ctypes
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, counts  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.models import attention_impl  # noqa: E402

REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
#: tests/test_kernels.py's elementwise tolerances (rtol = atol): flash
#: and paged in fp32; flash and paged in bf16, which hold fp16 too (the
#: reference's tests run no fp16 case)
REF_TOL = {torch.float32: 2e-5}
REF_TOL_BF16 = {"flash_attention": 2.5e-2, "paged_attention": 3e-2}


def _row_rel_err(got, want):
    """Per output row (the last axis): largest |error| over largest
    |value| of ``want``; a row that is not finite reads as infinite."""
    err = (got.float() - want.float()).abs().amax(-1)
    return torch.nan_to_num(err / want.float().abs().amax(-1)
                            .clamp_min(1e-30), nan=float("inf"))


def _paged_plain(args, **kw):
    q, kp, vp, bt, cl = args
    return paged.paged_attention_ref(q.float(), kp.float(), vp.float(), bt,
                                     cl, **kw)


def _flash_plain(q, k, v, **kw):
    return flash.flash_attention_ref(q.float(), k.float(), v.float(), **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(b, hq, hkv, d, npages, page, mp, dtype, device, seed=0,
                  lens=None, shared_pages=False):
    """Distinct pages per row (a permutation), the last row a padded row
    of length 1 on the trash page (the last page); or, with
    ``shared_pages``, tables drawn with replacement, so rows share pages
    as prefix-shared sequences do.  ``lens`` replaces the drawn lengths."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(npages, page, hkv, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(npages, page, hkv, d).astype(np.float32))
    perm = rng.permutation(npages - 1)
    bt = np.full((b, mp), npages - 1, np.int32)
    cl = rng.randint(1, mp * page + 1, size=(b,)).astype(np.int32)
    if shared_pages:
        bt = rng.randint(0, npages, size=(b, mp)).astype(np.int32)
    else:
        for i in range(b - 1):
            bt[i] = perm[i * mp:(i + 1) * mp]
    cl[-1] = 1
    if lens is not None:
        cl = np.asarray(lens, np.int32)
    return ([t.to(device=device, dtype=dtype) for t in (q, kp, vp)]
            + [torch.from_numpy(a).to(device) for a in (bt, cl)])


#: (b, hq, hkv, d, npages, page, mp, dtype, options)
PAGED = [
    (8, 32, 32, 128, 129, 16, 16, torch.bfloat16, {}),   # llama2-7b
    (8, 32, 8, 128, 129, 16, 16, torch.bfloat16, {}),    # GQA 4
    (4, 16, 2, 64, 65, 16, 16, torch.bfloat16, {}),      # GQA 8, d 64
    (3, 8, 4, 64, 33, 8, 8, torch.float32, {}),
    (3, 4, 4, 128, 33, 32, 8, torch.float32, {}),
    # lengths at a split boundary and one either side (split-boundary:
    # set from the kernel's split length), the last row padded
    (7, 32, 32, 128, 129, 16, 16, torch.bfloat16,
     {"lens": "split-boundary"}),
    (7, 8, 4, 64, 193, 16, 32, torch.float32, {"lens": "split-boundary"}),
    # a full table, and lengths past it (clamped to max_pages * page)
    (4, 8, 2, 128, 65, 16, 16, torch.bfloat16,
     {"lens": [256, 257, 100000, 1]}),
    (4, 8, 8, 64, 65, 16, 16, torch.float32, {"lens": [255, 256, 300, 1]}),
    # one long sequence among short ones
    (8, 32, 8, 128, 1025, 16, 128, torch.bfloat16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    # rows that share physical pages
    (6, 16, 4, 128, 40, 16, 32, torch.bfloat16, {"shared_pages": True}),
    (5, 8, 4, 64, 24, 8, 40, torch.float32, {"shared_pages": True}),
    # GQA 8 at d 128
    (4, 64, 8, 128, 129, 16, 32, torch.bfloat16, {}),
    (3, 16, 2, 128, 65, 16, 32, torch.float32, {}),
    # GQA 5 (qwen3-14b, 40/8) and GQA 7 (qwen2-0.5b, 14/2)
    (8, 40, 8, 128, 129, 16, 16, torch.bfloat16, {}),
    (3, 40, 8, 128, 65, 16, 16, torch.float32, {}),
    (7, 40, 8, 128, 129, 16, 16, torch.bfloat16,
     {"lens": "split-boundary"}),
    (8, 40, 8, 128, 1025, 16, 128, torch.bfloat16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    (8, 14, 2, 64, 129, 16, 16, torch.bfloat16, {}),
    (3, 14, 2, 64, 65, 16, 16, torch.float32, {}),
    (7, 14, 2, 64, 193, 16, 32, torch.float32, {"lens": "split-boundary"}),
    (6, 14, 2, 64, 40, 16, 32, torch.bfloat16, {"shared_pages": True}),
    (3, 5, 1, 64, 33, 8, 8, torch.float32, {}),
    (3, 7, 1, 128, 33, 8, 8, torch.bfloat16, {}),
    # GQA 3 (granite-moe-3b, 24/8, d 64)
    (8, 24, 8, 64, 129, 16, 16, torch.bfloat16, {}),
    (3, 24, 8, 64, 65, 16, 16, torch.float32, {}),
    (7, 24, 8, 64, 193, 16, 32, torch.bfloat16, {"lens": "split-boundary"}),
    (7, 24, 8, 64, 193, 16, 32, torch.float32, {"lens": "split-boundary"}),
    (8, 24, 8, 64, 1025, 16, 128, torch.bfloat16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    (6, 24, 8, 64, 40, 16, 32, torch.float32, {"shared_pages": True}),
    (3, 3, 1, 128, 33, 8, 8, torch.bfloat16, {}),
    # head_dim 80 (stablelm-3b, 32/32), bf16 and fp32: a row takes 16
    # lanes, 6 of them dead; contexts up to 1056 in the serving store
    (8, 32, 32, 80, 129, 16, 16, torch.bfloat16, {}),
    (8, 32, 32, 80, 129, 16, 16, torch.float32, {}),
    (7, 32, 32, 80, 129, 16, 16, torch.bfloat16, {"lens": "split-boundary"}),
    (7, 32, 32, 80, 129, 16, 16, torch.float32, {"lens": "split-boundary"}),
    (8, 32, 32, 80, 1025, 16, 128, torch.bfloat16,
     {"lens": [1056, 1, 64, 300, 1024, 17, 640, 1]}),
    (8, 32, 32, 80, 1025, 16, 128, torch.float32,
     {"lens": [1056, 1, 64, 300, 1024, 17, 640, 1]}),
    (4, 16, 4, 80, 65, 16, 16, torch.bfloat16, {}),
    (6, 8, 2, 80, 40, 16, 32, torch.float32, {"shared_pages": True}),
    # every other multiple of 16: a row on 2, 4, 8 (6 live) and 16 (12
    # and 14 live) lanes; at D 16 the split is 512 positions and the 64
    # row groups' accumulators fill the ring
    *((8, 32, 8, d, 257, 16, 32, dt, {})
      for d in (16, 32, 48, 96, 112)
      for dt in (torch.bfloat16, torch.float32)),
    *((7, 8, 2, d, 673, 16, 96, torch.float32, {"lens": "split-boundary"})
      for d in (16, 32, 48, 96, 112)),
    (6, 8, 2, 16, 40, 16, 32, torch.bfloat16, {"shared_pages": True}),
    (8, 16, 2, 32, 1025, 16, 128, torch.bfloat16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    # group 6, and groups above 8 in chunks: 16/1 and 32/1 (multi-query,
    # chunks of 8), 12/1 (two of 6), 9/1 (three of 3), 11/1 (eleven of 1)
    (8, 24, 4, 128, 129, 16, 16, torch.bfloat16, {}),
    (3, 12, 2, 64, 65, 16, 16, torch.float32, {}),
    (7, 48, 8, 128, 129, 16, 16, torch.bfloat16,
     {"lens": "split-boundary"}),
    (8, 16, 1, 128, 129, 16, 16, torch.bfloat16, {}),
    (8, 32, 1, 128, 129, 16, 16, torch.bfloat16, {}),
    (3, 32, 1, 64, 65, 16, 16, torch.float32, {}),
    (7, 32, 1, 128, 129, 16, 16, torch.float32, {"lens": "split-boundary"}),
    (8, 32, 2, 128, 1025, 16, 128, torch.bfloat16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    (4, 12, 1, 64, 65, 16, 16, torch.bfloat16, {}),
    (4, 9, 1, 32, 65, 16, 16, torch.float32, {}),
    (4, 11, 1, 16, 65, 16, 16, torch.float32, {}),
    # fp16: llama2-7b's decode, the split edges, qwen3-14b's 40/8 at
    # contexts up to 2048, stablelm-3b's head_dim 80, head_dim 16,
    # multi-query chunks, shared pages
    (8, 32, 32, 128, 129, 16, 16, torch.float16, {}),
    (7, 32, 32, 128, 129, 16, 16, torch.float16, {"lens": "split-boundary"}),
    (8, 40, 8, 128, 1025, 16, 128, torch.float16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    (8, 32, 32, 80, 129, 16, 16, torch.float16, {}),
    (8, 32, 8, 16, 257, 16, 32, torch.float16, {}),
    (8, 32, 1, 128, 129, 16, 16, torch.float16, {}),
    (6, 8, 2, 64, 40, 16, 32, torch.float16, {"shared_pages": True}),
]


#: head_dims 144 to 256 (a row on a warp of 32 lanes, 14 to 0 of them
#: dead): every head_dim in each dtype, the groups taken in turn, so each
#: dtype meets each group (q heads over kv heads: 1 = 16/16, 2 = 16/8,
#: 5 = 40/8, 8 = 64/8, multi-query 16/1 and 32/1); then every group at
#: 256 in bf16, the split edges and a long row among short ones
WIDE_GROUPS = [(16, 16), (16, 8), (40, 8), (64, 8), (16, 1), (32, 1)]
PAGED_WIDE = [
    *((8, *WIDE_GROUPS[(i + j) % len(WIDE_GROUPS)], d, 129, 16, 16, dt, {})
      for i, d in enumerate(range(144, 257, 16))
      for j, dt in enumerate((torch.bfloat16, torch.float16, torch.float32))),
    *((8, hq, hkv, 256, 129, 16, 16, torch.bfloat16, {})
      for hq, hkv in WIDE_GROUPS),
    (7, 16, 16, 256, 129, 16, 16, torch.bfloat16, {"lens": "split-boundary"}),
    (7, 16, 8, 144, 129, 16, 16, torch.float32, {"lens": "split-boundary"}),
    (8, 32, 1, 192, 1025, 16, 128, torch.float16,
     {"lens": [2048, 3, 17, 40, 64, 5, 100, 1]}),
    (6, 16, 8, 256, 40, 16, 32, torch.float32, {"shared_pages": True}),
]


def _paged_case_inputs(case, device):
    *shape, dtype, opts = case
    opts = dict(opts)
    if opts.get("lens") == "split-boundary":
        args = _paged_inputs(*shape, dtype, device)
        _, split = paged.grid(args[0], args[1], args[3])
        opts["lens"] = [split - 1, split, split + 1, 2 * split - 1,
                        2 * split, 2 * split + 1, 1]
    return _paged_inputs(*shape, dtype, device, **opts)


@pytest.mark.parametrize("case", PAGED + PAGED_WIDE, ids=lambda c: "-".join(
    map(str, c[:8])) + "".join(f"-{k}" for k in c[8]))
def test_paged_kernel_vs_plain(cuda, case):
    dtype = case[7]
    args = _paged_case_inputs(case, cuda)
    before = counts.get("paged_attention")
    got = paged.paged_attention(*args)
    torch.cuda.synchronize()
    assert counts.get("paged_attention") == before + 1
    want = _paged_plain(args)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=REF_TOL[dtype],
                                   atol=REF_TOL[dtype])


def test_paged_kernel_repeats_and_leaves_its_counters_zeroed(cuda):
    """Two calls give the same bits (the splits merge in a fixed order,
    whichever block comes last), and the merge tickets end at zero."""
    args = _paged_case_inputs(PAGED[9], cuda)
    first = paged.paged_attention(*args)
    second = paged.paged_attention(*args)
    torch.cuda.synchronize()
    assert paged.grid(args[0], args[1], args[3])[0][0] > 1
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not paged._tickets[(cuda.index or 0, stream)].any()


def test_paged_kernel_chunks_leave_their_counters_zeroed(cuda):
    """Multi-query 32/1 runs as four chunks of 8 q heads, each with its
    own merge ticket: two calls give the same bits, and the B * 4
    counters end at zero."""
    args = _paged_inputs(7, 32, 1, 128, 129, 16, 16, torch.bfloat16, cuda,
                         lens=[1, 63, 64, 65, 200, 256, 1])
    (splits, chunks, b), _ = paged.grid(args[0], args[1], args[3])
    assert (chunks, b) == (4, 7) and splits > 1
    first = paged.paged_attention(*args)
    second = paged.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _row_rel_err(first, _paged_plain(args)).max() <= \
        REL_TOL[torch.bfloat16]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    tickets = paged._tickets[(cuda.index or 0, stream)]
    assert tickets.numel() >= b * chunks and not tickets.any()


def test_paged_kernel_softcap(cuda):
    args = _paged_inputs(4, 8, 2, 128, 33, 16, 8, torch.float32, cuda)
    got = paged.paged_attention(*args, softcap=5.0)
    want = paged.paged_attention_ref(*args, softcap=5.0)
    assert _row_rel_err(got, want).max() <= REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_softcap_50_at_head_dim_256(cuda, dtype):
    """Gemma-2-9B's decode: 16 q heads over 8 kv heads of 256, logits
    soft-capped at 50."""
    args = _paged_inputs(8, 16, 8, 256, 129, 16, 16, dtype, cuda)
    got = paged.paged_attention(*args, softcap=50.0)
    want = _paged_plain(args, softcap=50.0)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]


#: tests/test_kernels.py's own cases, at their shapes and dtypes:
#: FLASH_CASES and test_flash_softcap (b, sq, skv, h, hkv, d, causal,
#: softcap, dtype); PAGED_CASES (b, hq, hkv, d, npages, page, mp, dtype)
REF_FLASH = [
    (2, 128, 128, 4, 2, 64, True, 0.0, torch.float32),
    (1, 256, 256, 4, 4, 64, True, 0.0, torch.bfloat16),
    (2, 64, 192, 4, 1, 32, False, 0.0, torch.float32),
    (1, 100, 100, 2, 2, 16, True, 0.0, torch.float32),
    (1, 128, 128, 8, 8, 128, True, 0.0, torch.float32),
    (1, 64, 64, 2, 2, 32, True, 20.0, torch.float32),
    # the bf16 case once more in fp16
    (1, 256, 256, 4, 4, 64, True, 0.0, torch.float16),
    # FLASH_CASES[4]'s shape (MHA 8/8, causal) at head_dim 256, fp32
    (1, 128, 128, 8, 8, 256, True, 0.0, torch.float32),
]
REF_PAGED = [
    (2, 4, 2, 64, 16, 16, 4, torch.float32),
    (3, 8, 1, 32, 32, 8, 6, torch.float32),
    (2, 4, 4, 64, 16, 16, 3, torch.bfloat16),
    (1, 16, 2, 128, 8, 32, 2, torch.float32),
    (2, 4, 4, 64, 16, 16, 3, torch.float16),
]


def _ref_tol(name, dtype):
    return REF_TOL[dtype] if dtype == torch.float32 else REF_TOL_BF16[name]


def _held(name, got, want, dtype):
    """The reference test's elementwise tolerance and the row limit."""
    assert got.dtype == dtype and torch.isfinite(got).all()
    tol = _ref_tol(name, dtype)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]


@pytest.mark.parametrize("case", REF_FLASH, ids=lambda c: "-".join(
    map(str, c)))
def test_reference_flash_cases(cuda, case):
    b, sq, skv, h, hkv, d, causal, softcap, dtype = case
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
               .to(cuda, dtype) for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    before = counts.get("flash_attention")
    got = flash.flash_attention(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert counts.get("flash_attention") == before + 1
    _held("flash_attention", got,
          _flash_plain(q, k, v, causal=causal, softcap=softcap), dtype)


@pytest.mark.parametrize("case", REF_PAGED, ids=lambda c: "-".join(
    map(str, c)))
def test_reference_paged_cases(cuda, case):
    b, hq, hkv, d, npages, page, mp, dtype = case
    rng = np.random.RandomState(2)
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(cuda, dtype) for shape in
                 ((b, hq, d), (npages, page, hkv, d), (npages, page, hkv, d)))
    bt = torch.from_numpy(rng.randint(0, npages, size=(b, mp))
                          .astype(np.int32)).to(cuda)
    cl = torch.from_numpy(rng.randint(1, mp * page + 1, size=(b,))
                          .astype(np.int32)).to(cuda)
    before = counts.get("paged_attention")
    got = paged.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert counts.get("paged_attention") == before + 1
    _held("paged_attention", got, _paged_plain((q, kp, vp, bt, cl)), dtype)


def test_reference_permutation_case(cuda):
    """test_paged_attention_respects_block_table_permutation at its shape
    (head_dim 16, 2/1): the same K/V through two page orders."""
    b, hq, hkv, d, npages, page, mp = 1, 2, 1, 16, 8, 4, 4
    rng = np.random.RandomState(3)
    q, kseq, vseq = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                     .to(cuda) for shape in
                     ((b, hq, d), (mp * page, hkv, d), (mp * page, hkv, d)))
    cl = torch.tensor([mp * page], dtype=torch.int32, device=cuda)
    outs = []
    for perm in ([0, 1, 2, 3], [3, 1, 0, 2]):
        kp, vp = (torch.zeros(npages, page, hkv, d, device=cuda)
                  for _ in range(2))
        for logical, phys in enumerate(perm):
            kp[phys] = kseq[logical * page:(logical + 1) * page]
            vp[phys] = vseq[logical * page:(logical + 1) * page]
        bt = torch.tensor([perm], dtype=torch.int32, device=cuda)
        outs.append(paged.paged_attention(q, kp, vp, bt, cl))
        _held("paged_attention", outs[-1], _paged_plain((q, kp, vp, bt, cl)),
              torch.float32)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


#: (b, sq, skv, h, hkv, d, causal, softcap, dtype)
FLASH = [
    (1, 512, 512, 32, 32, 128, True, 0.0, torch.bfloat16),
    (2, 200, 200, 8, 2, 128, True, 0.0, torch.bfloat16),   # ragged, GQA
    (2, 64, 192, 4, 1, 64, False, 0.0, torch.bfloat16),    # non-causal
    (1, 100, 260, 4, 4, 64, True, 0.0, torch.bfloat16),    # top-left
    (1, 256, 256, 4, 4, 128, True, 30.0, torch.bfloat16),  # softcap
    (2, 128, 128, 4, 2, 64, True, 0.0, torch.bfloat16),
    (1, 70, 150, 4, 2, 128, False, 20.0, torch.bfloat16),  # ragged softcap
    (1, 1000, 1000, 32, 32, 128, True, 0.0, torch.bfloat16),  # Sq % 128
    (1, 130, 300, 4, 4, 64, True, 0.0, torch.bfloat16),   # top-left, 2 tiles
    # opt-13b (40/40) and qwen3-14b (40/8) prefills; qwen2-0.5b (14/2, d 64)
    (1, 1024, 1024, 40, 40, 128, True, 0.0, torch.bfloat16),
    (1, 1024, 1024, 40, 8, 128, True, 0.0, torch.bfloat16),
    (1, 300, 300, 40, 8, 128, True, 0.0, torch.bfloat16),
    (1, 500, 500, 14, 2, 64, True, 0.0, torch.bfloat16),
    # whisper-base (8/8, d 64): the encoder (non-causal, 11 full q tiles
    # and 92 rows against as many kv tiles), the cross-attention of the
    # shortest and longest buckets against the 1500 frames, and the
    # decoder's causal self-attention
    (1, 1500, 1500, 8, 8, 64, False, 0.0, torch.bfloat16),
    (1, 8, 1500, 8, 8, 64, False, 0.0, torch.bfloat16),
    (1, 512, 1500, 8, 8, 64, False, 0.0, torch.bfloat16),
    (1, 512, 512, 8, 8, 64, True, 0.0, torch.bfloat16),
    # head_dim 80 (stablelm-3b and zamba2-2.7b's shared block, 32/32) in
    # the D-128 tiles: every prefill bucket, GQA 32/8, a ragged Sq,
    # non-causal with Sq != Skv, and a softcap
    *((1, s, s, 32, 32, 80, True, 0.0, torch.bfloat16)
      for s in (64, 128, 256, 512, 1024, 2048)),
    (1, 1024, 1024, 32, 8, 80, True, 0.0, torch.bfloat16),
    (1, 1000, 1000, 32, 32, 80, True, 0.0, torch.bfloat16),
    (2, 200, 333, 8, 8, 80, False, 0.0, torch.bfloat16),
    (1, 256, 256, 4, 4, 80, True, 30.0, torch.bfloat16),
    # every other multiple of 16 in bf16: 16, 32 and 48 in the D-64
    # tiles, 96 and 112 in the D-128 tiles
    *((1, 1000, 1000, 16, 4, d, True, 0.0, torch.bfloat16)
      for d in (16, 32, 48, 96, 112)),
    *((2, 200, 333, 8, 8, d, False, 20.0, torch.bfloat16)
      for d in (16, 48, 96)),
    (1, 1024, 1024, 32, 32, 96, True, 0.0, torch.bfloat16),
    # fp32 (3xTF32 wgmma, 128-row tiles): every head_dim, the serving
    # prefills of llama2-7b (32/32) and qwen3-14b (40/8), ragged,
    # top-left and non-causal, softcaps
    *((1, 300, 300, 8, 2, d, True, 0.0, torch.float32)
      for d in (16, 32, 48, 64, 80, 96, 112, 128)),
    (1, 1024, 1024, 32, 32, 128, True, 0.0, torch.float32),
    (1, 1024, 1024, 40, 8, 128, True, 0.0, torch.float32),
    (2, 2048, 2048, 4, 4, 64, True, 0.0, torch.float32),
    (1, 100, 260, 4, 4, 64, True, 0.0, torch.float32),     # top-left
    (1, 130, 300, 4, 4, 128, True, 0.0, torch.float32),
    (2, 64, 192, 4, 1, 32, False, 0.0, torch.float32),     # non-causal
    (1, 70, 1500, 8, 8, 64, False, 0.0, torch.float32),
    (1, 256, 256, 4, 4, 128, True, 30.0, torch.float32),   # softcap
    (1, 70, 150, 4, 2, 16, False, 20.0, torch.float32),
    # fp16 (the bf16 kernel's template): the serving prefills of
    # llama2-7b (32/32) and qwen3-14b (40/8), stablelm-3b's head_dim 80,
    # head_dim 16 in the D-64 tiles, a ragged Sq, top-left, whisper-base's
    # encoder, a non-causal softcap
    (1, 1024, 1024, 32, 32, 128, True, 0.0, torch.float16),
    (1, 1024, 1024, 40, 8, 128, True, 0.0, torch.float16),
    (1, 1024, 1024, 32, 32, 80, True, 0.0, torch.float16),
    (1, 1000, 1000, 16, 4, 16, True, 0.0, torch.float16),
    (2, 200, 200, 8, 2, 128, True, 0.0, torch.float16),
    (1, 100, 260, 4, 4, 64, True, 0.0, torch.float16),
    (1, 1500, 1500, 8, 8, 64, False, 0.0, torch.float16),
    (2, 200, 333, 8, 8, 48, False, 20.0, torch.float16),
]


#: head_dims 144 to 256 (bf16 and fp16 in the 256-wide tiles, fp32 with
#: the two warpgroups splitting D): every head_dim in each dtype, the
#: kinds taken in turn (causal ragged Sq, GQA; non-causal with Skv !=
#: Sq; causal with Gemma-2-9B's softcap of 50), so each dtype meets each
#: kind; then every kind at 256 in each dtype and the serving prefills of
#: head_dim 256 (16/16, 16/8)
_WIDE_KINDS = [
    lambda d, dt: (1, 300, 300, 8, 2, d, True, 0.0, dt),
    lambda d, dt: (2, 200, 333, 8, 8, d, False, 0.0, dt),
    lambda d, dt: (1, 256, 256, 16, 8, d, True, 50.0, dt),
]
FLASH_WIDE = [
    *(_WIDE_KINDS[(i + j) % 3](d, dt)
      for i, d in enumerate(range(144, 257, 16))
      for j, dt in enumerate((torch.bfloat16, torch.float16, torch.float32))),
    *(kind(256, dt) for kind in _WIDE_KINDS
      for dt in (torch.bfloat16, torch.float16, torch.float32)),
    *((1, 1024, 1024, 16, hkv, 256, True, 0.0, dt) for hkv in (16, 8)
      for dt in (torch.bfloat16, torch.float16, torch.float32)),
    (1, 100, 260, 4, 4, 256, True, 0.0, torch.bfloat16),   # top-left
    (1, 100, 260, 4, 4, 256, True, 0.0, torch.float32),
    (1, 70, 150, 4, 2, 144, False, 20.0, torch.float32),
    # the served prefill of llama2-7b at head_dim 256 (32/32); 32 q
    # units a head, so blocks outnumber the SMs several times; ragged q
    # units with B > 1; a single q unit pair
    (1, 1024, 1024, 32, 32, 256, True, 0.0, torch.bfloat16),
    (1, 1024, 1024, 32, 32, 256, True, 0.0, torch.float16),
    (1, 2048, 2048, 32, 8, 256, True, 0.0, torch.bfloat16),
    (3, 1000, 1000, 16, 8, 192, True, 0.0, torch.bfloat16),
    (1, 64, 64, 16, 16, 256, True, 0.0, torch.bfloat16),
    # the fp32 kernel's 16-key tiles: a sweep of one tile (causal, and
    # non-causal with Skv 10), and Skv 333 (20 tiles and 13 keys) with B 2
    (1, 16, 16, 4, 4, 256, True, 0.0, torch.float32),
    (1, 8, 10, 4, 2, 160, False, 0.0, torch.float32),
    (2, 100, 333, 8, 4, 224, False, 0.0, torch.float32),
]


@pytest.mark.parametrize("case", FLASH + FLASH_WIDE,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_vs_plain(cuda, case):
    b, sq, skv, h, hkv, d, causal, softcap, dtype = case
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
               .to(device=cuda, dtype=dtype)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    before = counts.get("flash_attention")
    got = flash.flash_attention(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert counts.get("flash_attention") == before + 1
    want = _flash_plain(q, k, v, causal=causal, softcap=softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=REF_TOL[dtype],
                                   atol=REF_TOL[dtype])


#: planted faults: source, the text replaced, its replacement
FAULTS = {
    "paged-drops-last-position": (
        "paged_attention", "const int len = min(lens[b], max_pages * page);",
        "const int len = min(lens[b] - 1, max_pages * page);"),
    "paged-reads-one-more-position": (
        "paged_attention", "const int len = min(lens[b], max_pages * page);",
        "const int len = min(lens[b] + 1, max_pages * page);"),
    # every full split leaves out its last position
    "paged-split-drops-its-last-position": (
        "paged_attention", "const int s1 = min(len, s0 + S::SPLIT);",
        "const int s1 = min(len, s0 + S::SPLIT - 1);"),
    # the merge adds each split's partial state without its exp(m_s - m)
    "paged-merge-skips-the-rescale": (
        "paged_attention", "const float f = exp2f(ms - mx[k]);",
        "const float f = 1.f;"),
    "flash-drops-the-diagonal": (
        "flash_attention", "(!causal || qpos >= kpos)",
        "(!causal || qpos > kpos)"),
    "flash-reads-one-more-position": (
        "flash_attention", "(!causal || qpos >= kpos)",
        "(!causal || qpos + 1 >= kpos)"),
    # the K/V ring: P·V reads V from the other stage of the ring
    "flash-ring-stage-off-by-one": (
        "flash_attention",
        "const uint32_t v_tile = base + L::V + stage * L::TILE;",
        "const uint32_t v_tile = base + L::V + ((stage + 1) % kStages) * "
        "L::TILE;"),
}


def _serving_shape_case(name, device, hq=32, hkv=32, d=128,
                        dtype=torch.bfloat16):
    """Run kernel ``name`` once at the serving path's shape (llama2-7b,
    bf16 unless asked; paged also at other decode shapes: qwen3-14b's
    40/8, granite-moe-3b's 24/8 at d 64); returns (kernel output, fp32
    plain output, the long rows).  Long rows: paged, every row but the
    padded one (contexts up to 2048); flash, causal S 2048, the rows at
    positions 512 and later."""
    if name == "paged_attention":
        args = _paged_inputs(8, hq, hkv, d, 1025, 16, 128, dtype, device)
        return paged.paged_attention(*args), _paged_plain(args), \
            slice(0, -1)
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 2048, 32, 128)
                                .astype(np.float32)).to(device, dtype)
               for _ in range(3))
    return flash.flash_attention(q, k, v), _flash_plain(q, k, v), \
        (slice(None), slice(512, None))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_relative_limit_catches_an_off_by_one(cuda, fault, tmp_path,
                                              monkeypatch):
    """The sound kernel reads within the bf16 limit at the serving shape;
    a copy of its source with one off-by-one planted reads past it on
    the long rows alone."""
    name, old, new = FAULTS[fault]
    got, want, rows = _serving_shape_case(name, cuda)
    sound = float(_row_rel_err(got, want)[rows].max())
    src = (build.CSRC / f"{name}.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / f"{name}.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    got, want, rows = _serving_shape_case(name, cuda)
    planted = float(_row_rel_err(got, want)[rows].max())
    print(f"\n{fault}: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


#: the non-causal tail: the key at position Skv joins the softmax
KV_TAIL_FAULT = ("flash_attention", "kpos < skv && (!causal || qpos >= kpos)",
                 "kpos <= skv && (!causal || qpos >= kpos)")
#: whisper-base's encoder length, the cross-attention's Skv
WHISPER_FRAMES = 1500


def _kv_tail_case(sq, device):
    """Flash at whisper-base's shapes (8 heads of 64, Skv 1500,
    non-causal), q drawn around +1 and k around -1, so every real key
    scores about -8 +- 1.7 and a zero-score key past the end would take
    about a third of a row's weight.  With centred inputs it would take
    about 1/2500 of it, which no bf16 limit can tell from rounding."""
    rng = np.random.RandomState(5)
    q = rng.randn(1, sq, 8, 64) + 1
    k = rng.randn(1, WHISPER_FRAMES, 8, 64) - 1
    v = rng.randn(1, WHISPER_FRAMES, 8, 64)
    q, k, v = (torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
               for a in (q, k, v))
    return (flash.flash_attention(q, k, v, causal=False),
            _flash_plain(q, k, v, causal=False))


@pytest.mark.parametrize("sq", [8, WHISPER_FRAMES])
def test_relative_limit_catches_a_kv_tail_fault(cuda, sq, tmp_path,
                                                monkeypatch):
    """The sound kernel reads within the bf16 limit at the
    cross-attention (Sq 8) and encoder (Sq 1500) shapes; a copy whose
    KV mask admits ``kpos <= Skv`` reads past it."""
    name, old, new = KV_TAIL_FAULT
    sound = float(_row_rel_err(*_kv_tail_case(sq, cuda)).max())
    src = (build.CSRC / f"{name}.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / f"{name}.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    planted = float(_row_rel_err(*_kv_tail_case(sq, cuda)).max())
    print(f"\nflash-reads-past-the-kv-end at Sq {sq}, Skv {WHISPER_FRAMES}: "
          f"relative error, sound {sound:.3e}, planted {planted:.3e}, "
          f"limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


def _planted_fault(fault, device, tmp_path, monkeypatch, **shape):
    """(sound, planted) long-row errors of the kernel of ``fault`` at
    ``shape`` (``_serving_shape_case``'s), before and after planting
    ``fault``."""
    name, old, new = FAULTS[fault]
    got, want, rows = _serving_shape_case(name, device, **shape)
    sound = float(_row_rel_err(got, want)[rows].max())
    src = (build.CSRC / f"{name}.cu").read_text()
    (tmp_path / f"{name}.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    got, want, rows = _serving_shape_case(name, device, **shape)
    return sound, float(_row_rel_err(got, want)[rows].max())


@pytest.mark.parametrize("fault", sorted(f for f in FAULTS
                                         if f.startswith("paged")))
def test_relative_limit_catches_an_off_by_one_at_group_5(
        cuda, fault, tmp_path, monkeypatch):
    """The paged faults again at qwen3-14b's decode shape (GQA 40/8)."""
    sound, planted = _planted_fault(fault, cuda, tmp_path,
                                          monkeypatch, hq=40, hkv=8)
    print(f"\n{fault} at G 5: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


@pytest.mark.parametrize("fault", sorted(f for f in FAULTS
                                         if f.startswith("paged")))
def test_relative_limit_catches_an_off_by_one_at_group_3(
        cuda, fault, tmp_path, monkeypatch):
    """The paged faults again at granite-moe-3b's decode shape (GQA 24/8,
    head_dim 64)."""
    sound, planted = _planted_fault(fault, cuda, tmp_path,
                                          monkeypatch, hq=24, hkv=8, d=64)
    print(f"\n{fault} at G 3: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


@pytest.mark.parametrize("fault", ["flash-drops-the-diagonal",
                                   "paged-drops-last-position"])
def test_fp16_limit_catches_an_off_by_one(cuda, fault, tmp_path,
                                          monkeypatch):
    """An off-by-one of each kernel again, in fp16 at llama2-7b's
    serving shape: the fp16 row limit holds the sound kernel and catches
    the planted one."""
    limit = REL_TOL[torch.float16]
    sound, planted = _planted_fault(fault, cuda, tmp_path,
                                          monkeypatch, dtype=torch.float16)
    print(f"\n{fault} in fp16: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {limit:.0e}")
    assert sound <= limit < planted


#: planted faults of the wide bf16/fp16 flash kernel (head_dims 144 to
#: 256), each held at llama2-7b's prefill at head_dim 256 (causal S 1024,
#: 32/32 heads: 256 blocks, neighbour pairs) or, for the mirror pairs that
#: a launch of one wave takes, with 16/16 heads (128 blocks): P·V reads V
#: from the other stage of its V ring; the schedule takes unit U-2-2z
#: (neighbour) or U-2-z (mirror) as block z's longer unit, so that no
#: block sweeps the last unit of a head (its rows are left as the
#: output's memory held, which the test fills with NaN first).  (text
#: replaced, its replacement, q heads = kv heads)
WIDE_FAULTS = {
    "flash-wide-ring-stage-off-by-one": (
        "const uint32_t v_prev = r.base + Smem::V + kTile * (prev % kVStages);",
        "const uint32_t v_prev = r.base + Smem::V + kTile * ((prev + 1) % "
        "kVStages);", 32),
    "flash-wide-schedule-skips-a-unit": (
        "unit_b = units - 1 - 2 * z;", "unit_b = units - 2 - 2 * z;", 32),
    "flash-wide-mirror-schedule-skips-a-unit": (
        "unit_b = units - 1 - z;", "unit_b = units - 2 - z;", 16),
}


def _wide_serving_case(device, heads):
    """The wide kernel once at a causal 1024-token prefill at head_dim
    256 with ``heads`` q and kv heads (bf16), its output's memory filled
    with NaN before the launch (the allocator hands the block just freed
    to the wrapper's ``empty_like``).  Returns the long rows' (positions
    512 and later) largest relative error; a row left unwritten reads
    inf."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, 1024, heads, 256)
                                .astype(np.float32)).to(device,
                                                        torch.bfloat16)
               for _ in range(3))
    poison = torch.full_like(q, float("nan"))
    del poison
    got = flash.flash_attention(q, k, v)
    return float(_row_rel_err(got, _flash_plain(q, k, v))[:, 512:].max())


@pytest.mark.parametrize("fault", sorted(WIDE_FAULTS))
def test_relative_limit_catches_a_wide_kernel_fault(cuda, fault, tmp_path,
                                                    monkeypatch):
    """The sound wide kernel reads within the bf16 limit on the long
    rows at head_dim 256's serving shape (and 16/16 for the mirror
    pairs); a copy of its source with a fault of its ring or of its
    schedule planted reads past it."""
    old, new, heads = WIDE_FAULTS[fault]
    sound = _wide_serving_case(cuda, heads)
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / "flash_attention.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    planted = _wide_serving_case(cuda, heads)
    print(f"\n{fault}: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


@pytest.mark.parametrize("shape", [(1, 1024, 32), (1, 1024, 16),
                                   (3, 1000, 16), (1, 2048, 32), (2, 64, 8),
                                   (1, 1, 4)])
def test_wide_grid_follows_the_schedule(cuda, shape):
    """The wide kernel's grid, as the library computes it for its
    launch, has one block a pair of ``flash.wide_schedule`` on this
    card's SMs, in its order."""
    b, sq, h = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    mirror, blocks = flash.wide_schedule(sq, sq, True, h, b, sms)
    lib = build.load("flash_attention")
    grid = (ctypes.c_int * 3)()
    for code in (1, 2):
        assert lib.flash_attention_grid(code, 256, b, sq, h, grid) == 0
        assert list(grid) == ([len(blocks), h, b] if mirror
                              else [h, b, len(blocks)])


#: planted faults of head_dim 80: the flash epilogue stores all 128
#: columns of its D-128 tile at the row stride of 80, over the first 48
#: columns of the next head; the paged kernel's dead lanes (10-15 of a
#: row's 16) write their zero accumulators into the row groups' merge
#: buffer, over the first 48 columns of the next (group, q head) record
HEAD_DIM_80_FAULTS = {
    "flash-epilogue-stores-128-columns": (
        "flash_attention", "for (int j = 0; j < DV / 8; ++j)",
        "for (int j = 0; j < D / 8; ++j)"),
    "paged-dead-lanes-write-the-merge": (
        "paged_attention",
        "    if (live_lane) {\n#pragma unroll\n"
        "      for (int i = 0; i < kVec; ++i)\n        grp_acc",
        "    if (true) {\n#pragma unroll\n"
        "      for (int i = 0; i < kVec; ++i)\n        grp_acc"),
}


def _head_dim_80_case(name, device):
    """Kernel ``name`` once at stablelm-3b's shapes (32/32 heads of 80,
    bf16): paged, the serving store's decode (contexts up to 2048, the
    last row padded); flash, a causal 2048-token prefill.  Returns
    (kernel output, fp32 plain output): every row of every head."""
    dtype = torch.bfloat16
    if name == "paged_attention":
        args = _paged_inputs(8, 32, 32, 80, 1025, 16, 128, dtype, device)
        return paged.paged_attention(*args), _paged_plain(args)
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2048, 32, 80)
                                .astype(np.float32)).to(device, dtype)
               for _ in range(3))
    return flash.flash_attention(q, k, v), _flash_plain(q, k, v)


@pytest.mark.parametrize("fault", sorted(HEAD_DIM_80_FAULTS))
def test_relative_limit_catches_a_head_dim_80_fault(cuda, fault, tmp_path,
                                                    monkeypatch):
    """The sound kernels read within the bf16 limit on every row of every
    head at head_dim 80; a copy of the source with a fault of the padded
    columns or lanes planted reads past it."""
    name, old, new = HEAD_DIM_80_FAULTS[fault]
    sound = float(_row_rel_err(*_head_dim_80_case(name, cuda)).max())
    src = (build.CSRC / f"{name}.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / f"{name}.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    planted = float(_row_rel_err(*_head_dim_80_case(name, cuda)).max())
    print(f"\n{fault}: relative error, sound {sound:.3e}, planted "
          f"{planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


#: planted faults of the fp32 flash kernel: its mask (the diagonal, one
#: key past it, the key at Skv), the stage of its K/V ring (P·V reads Vᵀ
#: from the other stage), each caught by the fp32 row limit; and one of
#: the three TF32 products of P·V dropped (lo·hi), an error of about
#: 2^-12 of a weight that the row limit may not see, caught by the
#: reference's elementwise 2e-5.  (text replaced, its replacement, the
#: limit that catches it)
FP32_FAULTS = {
    "flash-fp32-drops-the-diagonal": (
        "(causal && kpos > qpos)", "(causal && kpos >= qpos)", "row"),
    "flash-fp32-reads-one-more-position": (
        "(causal && kpos > qpos)", "(causal && kpos > qpos + 1)", "row"),
    "flash-fp32-reads-past-the-kv-end": (
        "if (kpos >= skv ||", "if (kpos > skv ||", "row"),
    "flash-fp32-ring-stage-off-by-one": (
        "const uint32_t vt_hi = tb + L::RING + stage * L::STAGE + 2 * "
        "L::KT;",
        "const uint32_t vt_hi = tb + L::RING + ((stage + 1) % kStages) * "
        "L::STAGE + 2 * L::KT;", "row"),
    "flash-fp32-drops-a-split-product": (
        "pv_tf32<PV>(o, p_lo[kk], vt_hi + 32 * kk);", "", "elementwise"),
}


def _fp32_flash_case(fault, device):
    """The fp32 kernel at llama2-7b's causal 2048-token prefill (32/32,
    head_dim 128), or for the KV-end fault at whisper-base's
    cross-attention shape (non-causal, 512 x 1500, 8 heads of 64); every
    row of every head.  Returns (kernel output, plain output)."""
    rng = np.random.RandomState(6)
    if fault == "flash-fp32-reads-past-the-kv-end":
        shapes, causal = ((1, 512, 8, 64), (1, 1500, 8, 64)), False
    else:
        shapes, causal = ((1, 2048, 32, 128), (1, 2048, 32, 128)), True
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(device) for shape in (shapes[0], shapes[1], shapes[1]))
    return (flash.flash_attention(q, k, v, causal=causal),
            _flash_plain(q, k, v, causal=causal))


def _elementwise_ratio(got, want):
    """Largest |error| over the reference's allowance, atol + rtol
    |want| at rtol = atol = 2e-5: above 1 fails its elementwise check."""
    tol = REF_TOL[torch.float32]
    err = (got.float() - want.float()).abs() / (tol + tol * want.abs())
    return float(torch.nan_to_num(err, nan=float("inf")).max())


@pytest.mark.parametrize("fault", sorted(FP32_FAULTS))
def test_fp32_limits_catch_a_planted_fault(cuda, fault, tmp_path,
                                           monkeypatch):
    """The sound fp32 kernel reads within the fp32 row limit and the
    reference's elementwise 2e-5 on every row; a copy of its source with
    one fault planted reads past the limit named beside the fault."""
    old, new, limit = FP32_FAULTS[fault]
    got, want = _fp32_flash_case(fault, cuda)
    sound = {"row": float(_row_rel_err(got, want).max()),
             "elementwise": _elementwise_ratio(got, want)}
    assert sound["row"] <= REL_TOL[torch.float32]
    assert sound["elementwise"] <= 1.0
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / "flash_attention.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    got, want = _fp32_flash_case(fault, cuda)
    planted = {"row": float(_row_rel_err(got, want).max()),
               "elementwise": _elementwise_ratio(got, want)}
    bar = {"row": REL_TOL[torch.float32], "elementwise": 1.0}[limit]
    print(f"\n{fault}: sound {sound}, planted {planted}; caught by the "
          f"{limit} limit ({bar:.0e}; elementwise reads error over "
          f"2e-5 + 2e-5 |want|)")
    assert sound[limit] <= bar < planted[limit]


#: planted faults of the fp32 kernel at head_dims 144 to 256
#: (``flash_fp32_kernel_wide``), each held at causal S 1024 with 16/16
#: heads of 256: the consumers read V's fragments from the other stage of
#: its ring, and add their own partial S twice (each caught by the fp32
#: row limit); one of the three TF32 products of P·V dropped (V's lo
#: times P's hi), caught by the reference's elementwise 2e-5.  (text
#: replaced, its replacement, the limit that catches it)
WIDE_FP32_FAULTS = {
    "flash-fp32-wide-ring-stage-off-by-one": (
        "const uint32_t vr = tb + L::V + (t % kWideVStages) * L::RAW;",
        "const uint32_t vr = tb + L::V + ((t + 1) % kWideVStages) * L::RAW;",
        "row"),
    "flash-fp32-wide-trades-s-with-itself": (
        "lds4(x + 4 * (1 - c) * L::KBOX + (j * 128 + wt) * 16)",
        "lds4(x + 4 * c * L::KBOX + (j * 128 + wt) * 16)", "row"),
    "flash-fp32-wide-drops-a-split-product": (
        "        wgmma_tf32_rs_n64(o[mt], v_lo[mt][ks],\n"
        "                          sw128_desc(pp + 32 * ks, 16, 1024));\n",
        "", "elementwise"),
}


def _fp32_wide_case(device):
    """The fp32 kernel at causal S 1024 with 16/16 heads of 256: (kernel
    output, plain output), every row of every head."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(1, 1024, 16, 256)
                                .astype(np.float32)).to(device)
               for _ in range(3))
    return flash.flash_attention(q, k, v), _flash_plain(q, k, v)


@pytest.mark.parametrize("fault", sorted(WIDE_FP32_FAULTS))
def test_fp32_limits_catch_a_wide_kernel_fault(cuda, fault, tmp_path,
                                               monkeypatch):
    """The sound fp32 kernel at head_dim 256 reads within the fp32 row
    limit and the reference's elementwise 2e-5; a copy of its source with
    a fault of its V ring, its S exchange or its split products planted
    reads past the limit named beside the fault."""
    old, new, limit = WIDE_FP32_FAULTS[fault]
    got, want = _fp32_wide_case(cuda)
    sound = {"row": float(_row_rel_err(got, want).max()),
             "elementwise": _elementwise_ratio(got, want)}
    assert sound["row"] <= REL_TOL[torch.float32]
    assert sound["elementwise"] <= 1.0
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert src.count(old) == 1
    (tmp_path / "flash_attention.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    got, want = _fp32_wide_case(cuda)
    planted = {"row": float(_row_rel_err(got, want).max()),
               "elementwise": _elementwise_ratio(got, want)}
    bar = {"row": REL_TOL[torch.float32], "elementwise": 1.0}[limit]
    print(f"\n{fault}: sound {sound}, planted {planted}; caught by the "
          f"{limit} limit ({bar:.0e})")
    assert sound[limit] <= bar < planted[limit]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_head_dim_80_reads_pages_where_the_table_says(cuda, dtype):
    """The same K/V content through two permutations of the pages gives
    the same bits at head_dim 80: each position is read where the block
    table puts it, and the merge order does not depend on page numbers."""
    b, h, d, page, mp, npages = 2, 32, 80, 16, 66, 140
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32)).to(cuda,
                                                                  dtype)
    seq = [torch.from_numpy(rng.randn(b * mp, page, h, d).astype(np.float32))
           .to(cuda, dtype) for _ in range(2)]
    lens = torch.tensor([1056, 700], dtype=torch.int32, device=cuda)
    outs = []
    for seed in (5, 6):
        perm = np.random.RandomState(seed).permutation(npages)[:b * mp]
        kp, vp = (torch.zeros(npages, page, h, d, device=cuda, dtype=dtype)
                  for _ in range(2))
        kp[torch.from_numpy(perm).to(cuda)] = seq[0]
        vp[torch.from_numpy(perm).to(cuda)] = seq[1]
        bt = torch.from_numpy(perm.reshape(b, mp).astype(np.int32)).to(cuda)
        outs.append(paged.paged_attention(q, kp, vp, bt, lens))
        want = _paged_plain((q, kp, vp, bt, lens))
        assert _row_rel_err(outs[-1], want).max() <= REL_TOL[dtype]
    assert torch.equal(outs[0], outs[1])


def test_head_dim_80_raises(cuda):
    """Both kernels take stablelm-3b's head_dim (2560/32 = 80) since they
    run it in padded tiles and lanes, and now every multiple of 16 up to
    256; the refusal this test pinned when they did not moves to head_dim
    136, which neither takes (not a multiple of 16): a CUDA tensor
    launches the kernel or raises, nothing falls back."""
    from repro_torch.configs import get_config
    assert get_config("stablelm-3b").head_dim == 80
    assert 80 in paged.HEAD_DIMS and 80 in flash.HEAD_DIMS
    d, h = 136, 32
    q = torch.zeros(2, h, d, device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros(9, 16, h, d, device=cuda, dtype=torch.bfloat16)
    bt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 136"):
        paged.paged_attention(q, kp, kp, bt, cl)
    x = torch.zeros(1, 64, h, d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 136"):
        flash.flash_attention(x, x, x)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    # head_dim 272: past 256, the widest the kernels take
    q = torch.zeros(2, 4, 272, device=cuda)
    kp = torch.zeros(8, 16, 2, 272, device=cuda)
    bt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_attention(q, kp, kp, bt, cl)
    q5 = torch.zeros(2, 12, 64, device=cuda)            # 12 q over 5 kv
    kp5 = torch.zeros(8, 16, 5, 64, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        paged.paged_attention(q5, kp5, kp5, bt, cl)
    x = torch.zeros(1, 64, 2, 272, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(x, x, x)
    x = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        flash.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        paged.paged_attention(x[:, 0], x, x, bt[:1], cl[:1])


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers compute the plain version and launch
    nothing."""
    args = _paged_inputs(3, 8, 4, 64, 33, 8, 8, torch.float32, "cpu")
    before = counts.get("paged_attention")
    torch.testing.assert_close(paged.paged_attention(*args),
                               paged.paged_attention_ref(*args))
    assert counts.get("paged_attention") == before
    q = torch.randn(1, 40, 4, 64)
    before = counts.get("flash_attention")
    torch.testing.assert_close(flash.flash_attention(q, q[:, :, :2],
                                                     q[:, :, :2]),
                               flash.flash_attention_ref(q, q[:, :, :2],
                                                         q[:, :, :2]))
    assert counts.get("flash_attention") == before


# ---------------------------------------------------------------------------
# the blocked attention routes (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------
#: (impl, s, h, hkv, d, dtype): stablelm-3b's head_dim 80 in bf16, and
#: head_dim 128 in fp32 (GQA 4); S 4096 is 4 x 4 blocks of 1024, S 3000
#: takes the reference's ragged fallback
BLOCKED = [
    ("blocked", 4096, 32, 32, 80, torch.bfloat16),
    ("blocked", 4096, 32, 8, 128, torch.float32),
    ("blocked_causal", 4096, 32, 32, 80, torch.bfloat16),
    ("blocked", 3000, 32, 32, 80, torch.bfloat16),
]


def _blocked_inputs(s, h, hkv, d, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(1, s, n, d, generator=gen, device=device).to(dtype)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("case", BLOCKED, ids=lambda c: "-".join(
    map(str, c[:5])) + "-" + str(c[5]).split(".")[-1])
def test_blocked_route_vs_naive(cuda, case):
    """The repaired route serves stablelm-3b's long prompts, and
    launches no kernel: each output row (one q head of one token) is
    within ``REL_TOL`` of the naive route on the same card."""
    impl, s, h, hkv, d, dtype = case
    q, k, v = _blocked_inputs(s, h, hkv, d, dtype, cuda)
    before = counts.snapshot()
    got = attention_impl.attend(q, k, v, causal=True, impl=impl)
    assert counts.snapshot() == before
    want = attention_impl.attend(q, k, v, causal=True, impl="naive")
    assert got.dtype == dtype and got.shape == q.shape
    err = float(_row_rel_err(got, want).max())
    print(f"\n{case}: largest row relative error {err:.3e}")
    assert err <= REL_TOL[dtype]


def test_blocked_route_captures_in_a_cuda_graph(cuda):
    """Nothing in the blocked loop reads a tensor on the host, so a CUDA
    graph captures it (as the engine captures a prefill bucket above
    2048 tokens); the replay on new inputs equals eager."""
    q, k, v = _blocked_inputs(4096, 32, 32, 80, torch.bfloat16, cuda)
    step = functools.partial(attention_impl.attend, q, k, v, causal=True,
                             impl="blocked")
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static = step()
    torch.cuda.current_stream(cuda).wait_stream(stream)
    for seed in (1, 2):
        for dst, src in zip((q, k, v), _blocked_inputs(
                4096, 32, 32, 80, torch.bfloat16, cuda, seed=seed)):
            dst.copy_(src)
        graph.replay()
        assert torch.equal(static, step())


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def _ssd_inputs(b, s, h, p, g, n, device, *, bc_dtype=torch.float32,
                strided=False, with_state=False, model_decay=False, seed=0):
    """tests/test_kernels.py's distribution: dt·A about -1 a step, so the
    state forgets a chunk within a few dozen steps.  ``model_decay``
    draws dt·A as a mamba2 layer does (dt = softplus(N(0,1) + dt_bias),
    dt_bias as ``mamba2_init`` draws it, A = -linspace(1, 16)): a step
    decays by 1e-3 to 1 and slow heads carry the state across chunks."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    xbar = torch.from_numpy(rng.randn(b, s, h, p).astype(f32))
    if model_decay:
        dt_bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3),
                                                     np.log(1e-1), h))))
        dt = np.log1p(np.exp(rng.randn(b, s, h) + dt_bias))
        dA = dt * -np.linspace(1.0, 16.0, h)
    else:
        dt = np.log1p(np.exp(rng.randn(b, s, h)))
        dA = -dt * np.exp(rng.uniform(size=(1, 1, h)))
    dA_log = torch.from_numpy(dA.astype(f32))
    if strided:
        xbc = torch.from_numpy(rng.randn(b, s, h * p + 2 * g * n).astype(f32))
        xbc = xbc.to(device=device, dtype=bc_dtype)
        Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        Bm, Cm = (torch.from_numpy(rng.randn(b, s, g, n).astype(f32))
                  .to(device=device, dtype=bc_dtype) for _ in range(2))
    state0 = torch.from_numpy(rng.randn(b, h, n, p).astype(f32)) \
        .to(device) if with_state else None
    return xbar.to(device), dA_log.to(device), Bm, Cm, state0


def _ssd_rel_errs(args, chunk):
    """(row error of y, of the final state): the kernel against its
    references (chip_smoke.py's ``ssd_errors``: the plain version, fp32
    on CPU copies of the same values, two of whose runs must agree, and
    an fp64 recurrence on the card)."""
    xbar, dA_log, Bm, Cm, state0 = args
    y, fs = ssd.ssd_scan(xbar, dA_log, Bm, Cm, chunk=chunk, state0=state0)
    torch.cuda.synchronize()
    errs = _chip_smoke().ssd_errors(y, fs, *args[:4], chunk, state0)
    assert errs["finite"]
    assert errs["plain_pair_agrees"], errs
    if errs["plain_runs"] > 2:
        print(f"\nssd plain runs disagreed: {errs}")
    return errs["rel_y"], errs["rel_s"]


#: (b, s, h, p, g, n, chunk, options): tests/test_kernels.py SSD_CASES
#: (the third ragged), then chip_smoke.py's serving-path shapes with a
#: model's decay
SSD = [
    (2, 128, 4, 32, 1, 64, 32, {}),
    (1, 96, 4, 16, 2, 32, 32, {}),
    (2, 100, 2, 16, 1, 16, 32, {}),
    (1, 64, 8, 64, 1, 128, 64, {}),
    (1, 1024, 24, 64, 1, 128, 256,
     {"bc_dtype": torch.bfloat16, "strided": True,
      "model_decay": True}),                            # mamba2-130m
    (1, 512, 24, 64, 2, 128, 256,
     {"bc_dtype": torch.bfloat16, "strided": True, "model_decay": True}),
    (2, 512, 8, 64, 1, 128, 256, {"with_state": True, "model_decay": True}),
    # a ragged last chunk (232 rows) that is not a multiple of the
    # kernels' 64-row tile
    (1, 1000, 24, 64, 1, 128, 256,
     {"bc_dtype": torch.bfloat16, "strided": True, "model_decay": True}),
    # many chunks (16) with a batch, from an initial state
    (2, 4096, 24, 64, 1, 128, 256,
     {"bc_dtype": torch.bfloat16, "strided": True, "with_state": True,
      "model_decay": True}),
    # N or P not a multiple of 4: the kernels' scalar loads, fp32 and bf16
    (2, 90, 4, 8, 2, 10, 64, {}),
    (1, 150, 2, 20, 1, 70, 100,
     {"bc_dtype": torch.bfloat16, "strided": True, "with_state": True}),
    # zamba2-2.7b's prefills: 80 heads of 64, N 64, the shortest and the
    # longest chunked bucket
    (1, 256, 80, 64, 1, 64, 256,
     {"bc_dtype": torch.bfloat16, "strided": True, "model_decay": True}),
    (1, 1024, 80, 64, 1, 64, 256,
     {"bc_dtype": torch.bfloat16, "strided": True, "model_decay": True}),
]


@pytest.mark.parametrize("case", SSD, ids=lambda c: "-".join(
    map(str, c[:7])) + "".join(f"-{k}" for k in c[7]))
def test_ssd_kernel_vs_plain(cuda, case):
    *shape, chunk, opts = case
    args = _ssd_inputs(*shape, cuda, **opts)
    before = counts.get("ssd_scan")
    rel_y, rel_s = _ssd_rel_errs(args, chunk)
    assert counts.get("ssd_scan") == before + 1
    assert rel_y <= REL_TOL[torch.float32]
    assert rel_s <= REL_TOL[torch.float32]


#: planted faults in ssd_scan.cu: the chunk scan's decay mask drops the
#: diagonal; state passing drops the state carried into each chunk; state
#: passing hands chunk c the state after it instead of the one before
SSD_FAULTS = {
    "ssd-drops-the-diagonal": (
        "const bool keep = j <= i && i < valid;",
        "const bool keep = j < i && i < valid;"),
    "ssd-drops-the-carried-state": (
        "s = s * decay + v;", "s = v;"),
    "ssd-hands-a-chunk-the-state-after-it": (
        "st[o] = s;\n    s = s * decay + v;",
        "s = s * decay + v;\n    st[o] = s;"),
}


@functools.cache
def _chip_smoke():
    """chip_smoke.py, imported for its SSD plain version, its comparison
    of the two SSD routes and its limits (running it needs the card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mamba2_route_errs(cs):
    """chip_smoke.py's comparison of the kernel route with
    ``impl="recurrent"`` through mamba2-130m at full width, on the
    prompts and weights (seed 0) of its serving phase."""
    args = cs.serve_cli.parse_args(["--arch", "mamba2-130m", "--seed",
                                    str(cs.SEED)])
    engine = cs.serve_cli.build_engine(args)
    for r in cs.mamba_requests():
        engine.add_request(r)
    err, _, _ = cs.ssm_route_errors(engine.model, engine.params,
                                    cs.route_prompts(engine), engine.max_ctx)
    return err


@pytest.mark.parametrize("fault", sorted(SSD_FAULTS))
def test_ssd_limits_catch_a_planted_fault(cuda, fault, tmp_path,
                                          monkeypatch):
    """The sound kernel reads within the 1e-4 kernel limit at the
    mamba2-130m prefill shape, and within chip_smoke.py's limits for the
    model's layers (kernel route against ``impl="recurrent"``); a copy of
    its source with the fault planted reads past the kernel limit, the
    block-output limit and the first-token logit limit (and, when it
    drops the carried state, the final-state limit)."""
    cs = _chip_smoke()
    case = SSD[4]
    with torch.no_grad():
        sound = max(_ssd_rel_errs(_ssd_inputs(*case[:6], cuda, **case[7]),
                                  case[6]))
        sound_layers = _mamba2_route_errs(cs)
        old, new = SSD_FAULTS[fault]
        src = (build.CSRC / "ssd_scan.cu").read_text()
        assert src.count(old) == 1
        (tmp_path / "ssd_scan.cu").write_text(src.replace(old, new))
        monkeypatch.setattr(build, "CSRC", tmp_path)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
        monkeypatch.setattr(build, "_loaded", {})
        planted = max(_ssd_rel_errs(_ssd_inputs(*case[:6], cuda,
                                                **case[7]), case[6]))
        planted_layers = _mamba2_route_errs(cs)
    print(f"\n{fault}: kernel row error sound {sound:.3e}, planted "
          f"{planted:.3e}, limit {REL_TOL[torch.float32]:.0e}")
    for key in sorted(sound_layers):
        print(f"{fault}: layers {key} sound {sound_layers[key]:.3e}, "
              f"planted {planted_layers[key]:.3e}")
    print(f"{fault}: limits block_rel_l2 {cs.SSM_BLOCK_REL}, state_rel_l2 "
          f"{cs.SSM_STATE_REL}, logits_rel {cs.SSM_LOGIT_REL}")
    assert sound <= REL_TOL[torch.float32] < planted
    assert sound_layers["block_rel_l2"] <= cs.SSM_BLOCK_REL \
        < planted_layers["block_rel_l2"]
    assert sound_layers["state_rel_l2"] <= cs.SSM_STATE_REL
    assert sound_layers["logits_rel"] <= cs.SSM_LOGIT_REL \
        < planted_layers["logits_rel"]
    if fault == "ssd-drops-the-carried-state":
        assert cs.SSM_STATE_REL < planted_layers["state_rel_l2"]


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 64, 2, 128, device=cuda)         # head_dim 128
    da = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ssd.ssd_scan(x, da, bc, bc, chunk=32)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x[..., :64].contiguous().half(), da, bc, bc, chunk=32)


def test_ssd_cpu_tensors_take_the_plain_version():
    args = _ssd_inputs(1, 64, 2, 16, 1, 16, "cpu")
    before = counts.get("ssd_scan")
    y, fs = ssd.ssd_scan(*args[:4], chunk=32)
    torch.testing.assert_close(y, ssd.ssd_chunked_ref(*args[:4], 32)[0])
    assert counts.get("ssd_scan") == before


#: (b, s, h, p, g, n, chunk, with_state): mamba2-130m's and zamba2-2.7b's
#: prefill shapes, the latter from an initial state
SSD_GRAD = [(1, 1024, 24, 64, 1, 128, 256, False),
            (1, 1024, 80, 64, 1, 64, 256, True)]


@pytest.mark.parametrize("case", SSD_GRAD,
                         ids=["mamba2-130m", "zamba2-2.7b-state0"])
def test_ssd_wrapper_gradients_match_the_plain_version(cuda, case):
    """Under autograd the wrapper launches the kernels once and carries
    gradients: a seeded scalar of (y, final state) differentiates, input
    by input, as the plain version does on the card, within 1e-4 of each
    input's largest gradient."""
    *shape, chunk, with_state = case
    args = _ssd_inputs(*shape, cuda, bc_dtype=torch.bfloat16, strided=True,
                       model_decay=True, with_state=with_state)
    inputs = [None if t is None else t.detach().requires_grad_()
              for t in args]
    wanted = [t for t in inputs if t is not None]
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, p, g, n = shape
    wy = torch.randn(b, s, h, p, generator=gen, device=cuda)
    wf = torch.randn(b, h, n, p, generator=gen, device=cuda)
    before = counts.get("ssd_scan")
    y, fs = ssd.ssd_scan(*inputs[:4], chunk=chunk, state0=inputs[4])
    assert counts.get("ssd_scan") == before + 1
    assert y.grad_fn is not None and fs.grad_fn is not None
    got = torch.autograd.grad((y * wy).sum() + (fs * wf).sum(), wanted)
    assert counts.get("ssd_scan") == before + 1
    y_ref, fs_ref = ssd.ssd_chunked_ref(*inputs[:4], chunk, inputs[4])
    want = torch.autograd.grad((y_ref * wy).sum() + (fs_ref * wf).sum(),
                               wanted)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        err = float((a.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= REL_TOL[torch.float32]


def test_attention_kernels_refuse_grad(cuda):
    """Flash and paged have no backward (nor have the reference's): on
    the card they raise where autograd would record the call, as
    ``attend(impl="pallas")`` does; under no_grad they launch."""
    q = torch.randn(1, 128, 8, 64, device=cuda,
                    dtype=torch.bfloat16).requires_grad_()
    k = torch.randn(1, 128, 8, 64, device=cuda, dtype=torch.bfloat16)
    pages = torch.randn(4, 16, 8, 64, device=cuda, dtype=torch.bfloat16)
    tables = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    lens = torch.tensor([50], dtype=torch.int32, device=cuda)
    calls = [lambda: flash.flash_attention(q, k, k),
             lambda: attention_impl.attend(q, k, k, causal=True,
                                           impl="pallas"),
             lambda: paged.paged_attention(q[:, 0], pages, pages, tables,
                                           lens)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with torch.no_grad():
        before = counts.snapshot()
        for call in calls:
            call()
        after = counts.snapshot()
    assert after["flash_attention"] == before.get("flash_attention", 0) + 2
    assert after["paged_attention"] == before.get("paged_attention", 0) + 1


@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
def test_remat_modes_agree_through_the_ssd_kernel(cuda, remat):
    """A mamba2 loss and its gradients through the SSD kernel are the
    same, bit for bit, under each remat mode as under ``none``; ``none``
    launches the scan once a layer, the others once more a layer in the
    recompute."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.common import RunSettings, tree_leaves
    from repro_torch.training.trainer import value_and_grad

    cfg = get_smoke_config("mamba2-130m")
    s = 2 * cfg.ssm.chunk_size
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, s + 1), generator=gen,
                           device=cuda)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    params = zoo.init_params(zoo.build(cfg), seed=0, device=cuda,
                             master=True)
    runs = {}
    for mode in ("none", remat):
        model = zoo.build(cfg, settings=RunSettings(remat=mode))
        before = counts.get("ssd_scan")
        (loss, _), grads = value_and_grad(model, params, batch)
        runs[mode] = (loss, tree_leaves(grads),
                      counts.get("ssd_scan") - before)
    (l0, g0, n0), (l1, g1, n1) = runs["none"], runs[remat]
    assert (n0, n1) == (cfg.num_layers, 2 * cfg.num_layers)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert all(bool(g.isfinite().all()) for g in g0)


def _serve_smoke_models(device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve_smoke as ex
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.common import RunSettings

    cfg = get_smoke_config(ex.ARCH)
    model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    params = zoo.init_params(model, seed=ex.SEED, device=device)
    return ex, cfg, model, params


def test_serve_smoke_example_on_the_kernel_routes(cuda):
    """The serve-then-simulate example's ``serve`` at the smoke config on
    the kernel routes (graphed): every request finishes, the paged kernel
    launches once a layer a decode iteration and flash once a layer a
    request's prefill, and the simulator fitted to the run's records
    finishes as many requests with a finite error.  The first-token
    logits of every prompt served, through the engine's prefill at its
    bucket, agree with the plain route's on the same weights."""
    from repro_torch.serving import paged_model
    from repro_torch.serving.engine import ServingEngine

    ex, cfg, model, params = _serve_smoke_models(cuda)
    before = counts.snapshot()
    eng, reqs, real = ex.serve(model, params, attn_path="pallas")
    after = counts.snapshot()
    assert eng.graphs is not None
    assert all(r.tokens_generated == r.output_len for r in reqs)
    decodes = sum(r.kind == "decode" for r in eng.records)
    prefills = sum(len(r.batch_ids) for r in eng.records
                   if r.kind == "prefill")
    assert prefills == len(reqs) and decodes > 0
    for name, n in (("paged_attention", decodes),
                    ("flash_attention", prefills)):
        assert after.get(name, 0) - before.get(name, 0) == cfg.num_layers * n
    sim, res = ex.simulate(cfg, ex.WORKLOAD,
                           [(r.mix, r.wall) for r in eng.records])
    assert len(res.finished) == len(eng.finished) == len(reqs)
    assert np.isfinite(ex.throughput_error(res, real))

    plain = model.with_settings(attn_impl="naive")
    for rid, prompt in eng.prompt_tokens.items():
        n = len(prompt)
        toks = torch.zeros((1, ServingEngine._bucket(n)), dtype=torch.long,
                           device=cuda)
        toks[0, :n] = torch.from_numpy(prompt.astype(np.int64))
        got, want = (paged_model.prefill_forward(m, params, toks)[0]
                     [0, n - 1, :cfg.vocab_size].float()
                     for m in (model, plain))
        assert torch.isfinite(got).all()
        # the serving logits' limit (chip_smoke.LOGIT_REL_MAX)
        assert (got - want).abs().max() <= 0.1 * want.abs().max(), rid


def test_kernels_at_the_serve_smoke_shapes(cuda):
    """The kernels at the shapes the example's kernel routes give them at
    the smoke config (bf16, 4/4 heads, head_dim 16): flash at every
    prefill bucket of the example's prompts, paged at the engine's page
    store (page size, batch, table width), each with the reference's
    inputs drawn with numpy, within its elementwise tolerance and the
    row limit."""
    from repro_torch.core.workload import generate
    from repro_torch.serving.engine import ServingEngine

    ex, cfg, model, _ = _serve_smoke_models(cuda)
    dtype, ec = model.compute_dtype, ex.ENGINE
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    buckets = sorted({ServingEngine._bucket(r.prompt_len)
                      for r in generate(ex.WORKLOAD)})
    assert len(buckets) > 1
    for s in buckets:
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.randn(1, s, n, d).astype(np.float32))
                   .to(cuda, dtype) for n in (h, hkv, hkv))
        before = counts.get("flash_attention")
        got = flash.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert counts.get("flash_attention") == before + 1
        _held("flash_attention", got, _flash_plain(q, k, v, causal=True),
              dtype)
    b, npages, page, mp = (ec.max_batch, ec.num_blocks + 1, ec.block_size,
                           ec.max_pages_per_seq)
    rng = np.random.RandomState(2)
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(cuda, dtype) for shape in
                 ((b, h, d), (npages, page, hkv, d), (npages, page, hkv, d)))
    bt = torch.from_numpy(rng.randint(0, npages, size=(b, mp))
                          .astype(np.int32)).to(cuda)
    cl = torch.from_numpy(rng.randint(1, mp * page + 1, size=(b,))
                          .astype(np.int32)).to(cuda)
    before = counts.get("paged_attention")
    got = paged.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert counts.get("paged_attention") == before + 1
    _held("paged_attention", got, _paged_plain((q, kp, vp, bt, cl)), dtype)
