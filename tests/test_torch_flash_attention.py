"""repro_torch.kernels.flash_attention against the reference.

On the CPU the wrapper runs the kernel's plain version; it is held to
the JAX wrapper ``repro.kernels.flash_attention.ops.flash_attention``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
on the reference's FLASH_CASES, its softcap case, shapes at the CUDA
kernel's tile edges, head_dim 80, and head_dims 144, 192 and 256 (with
test_kernels.py's tolerances).  Tolerances: 2e-5 in fp32, 3e-2 in bf16.  fp16, which the
reference's wrapper takes though its tests run none, on the bf16 case's
shape and at head_dim 80: 1e-2 (both versions compute in fp32 from the
same fp16 inputs and round the output once, so they differ by at most
about one fp16 rounding, 2^-11 of a value).  The CUDA kernel is held to
the plain version on the card in tests/test_torch_kernels_cuda.py.

The fp32 CUDA kernel takes each product as three TF32 products (3xTF32).
A model of that arithmetic on the CPU (``cvt.rna.tf32.f32`` as integer
bit operations, Q's hi as its bits truncated, which is what the kernel's
tensor cores read, and K's too above head_dim 128, where each half of
head_dim sums its three products apart and the halves are added after)
is held to the JAX reference on every fp32 case the reference holds to
2e-5, within 2e-5; with the hi·hi product alone it reads past 2e-5,
which is why the kernel takes three.

The bf16/fp16 kernel at head_dims 144 to 256 pairs 64-row q units in
its blocks by a rule ``ops.wide_schedule`` states in Python: every unit
once, the longest first, and the blocks within the design's bounds (one
tile of each other in one wave; SMs within 10% of even past it).  The
card tests' planted faults locate their lines by texts that must occur
once in the flash source; that is held here too.

The ``blocked`` and ``blocked_causal`` routes of ``attend`` are plain
loops over blocks in both packages; the port's are held to the
reference's ``attend`` with the same impl and blocks of 32, on even
blocks and on the shapes that fall back to ``naive`` (S not a multiple
of the block, and ``sq != skv`` for ``blocked_causal``).  Tolerances:
1e-5 in fp32; in bf16, each output row's largest error within 2e-2 of
its largest |value| (one bf16 rounding of the output is 2^-8).
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_flash  # noqa: E402
from repro.models import attention_impl as jax_attn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import attention_impl, model_zoo  # noqa: E402
from repro_torch.models.common import RunSettings  # noqa: E402

#: (b, sq, skv, h, hkv, d, causal, dtype) — tests/test_kernels.py
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, "float32"),
    (1, 256, 256, 4, 4, 64, True, "bfloat16"),
    (2, 64, 192, 4, 1, 32, False, "float32"),    # cross-attn ragged
    (1, 100, 100, 2, 2, 16, True, "float32"),    # ragged both dims
    (1, 128, 128, 8, 8, 128, True, "float32"),   # MHA, head_dim 128
]
#: where the CUDA kernel's 128-row tiles have edges: Sq not a multiple of
#: 128 (GQA, head_dim 128), and top-left causal with Sq < Skv whose q rows
#: cross a tile.  These pin the plain version that the card's checks hold
#: the kernel to.
TILE_EDGE_CASES = [
    (1, 300, 300, 4, 2, 128, True, "float32"),
    (1, 130, 260, 4, 4, 64, True, "float32"),
]
#: fp16 on FLASH_CASES[1]'s shape (the reference's bf16 case)
FP16_CASES = [(*FLASH_CASES[1][:7], "float16")]
#: tests/test_kernels.py's FLASH_CASES tolerances; fp16 (which it does
#: not test) within 1e-2
KERNEL_TOL = {"bfloat16": 2.5e-2, "float32": 2e-5, "float16": 1e-2}


def _inputs(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


def _tol(dtype):
    return {"bfloat16": 3e-2, "float16": KERNEL_TOL["float16"]}.get(dtype,
                                                                  2e-5)


def _jax(q, k, v, dtype, **kw):
    jd = getattr(jnp, dtype)
    out = jax_flash.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                    **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, k, v, dtype, device="cpu", **kw):
    td = getattr(torch, dtype)
    return ops.flash_attention(
        *(torch.from_numpy(a).to(device=device, dtype=td) for a in (q, k, v)),
        **kw)


@pytest.mark.parametrize("case", FLASH_CASES + TILE_EDGE_CASES + FP16_CASES)
def test_plain_vs_jax(case):
    b, sq, skv, h, hkv, d, causal, dtype = case
    q, k, v = _inputs(b, sq, skv, h, hkv, d)
    got = _torch(q, k, v, dtype, causal=causal)
    assert got.dtype == getattr(torch, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(
        got.float().numpy(),
        _jax(q, k, v, dtype, causal=causal, block_q=64, block_kv=64),
        rtol=tol, atol=tol)


#: head_dim 80 (stablelm-3b, zamba2-2.7b's shared block), which the CUDA
#: kernel runs in its D-128 tiles; the reference wrapper pads nothing in
#: interpret mode (ops.py:53)
HEAD_DIM_80_CASES = [
    (1, 128, 128, 4, 4, 80, True, "bfloat16"),
    (1, 100, 100, 2, 2, 80, True, "float32"),     # ragged
    (2, 64, 192, 4, 2, 80, False, "float32"),     # non-causal, GQA
    (1, 256, 256, 4, 1, 80, True, "float32"),     # GQA 4, two kv blocks
    (1, 128, 128, 4, 4, 80, True, "float16"),
]


@pytest.mark.parametrize("case", HEAD_DIM_80_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_head_dim_80(case):
    b, sq, skv, h, hkv, d, causal, dtype = case
    q, k, v = _inputs(b, sq, skv, h, hkv, d, seed=7)
    got = _torch(q, k, v, dtype, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, sq, h, d)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(),
        _jax(q, k, v, dtype, causal=causal, block_q=64, block_kv=64),
        rtol=tol, atol=tol)


#: the other multiples of 16 the CUDA kernels take (16 and 32 are in
#: FLASH_CASES in fp32): bf16 at 16 and 32 (the D-64 tiles), 48, 96 and
#: 112 in both dtypes; ragged, GQA, non-causal with Sq != Skv
WIDENED_HEAD_DIM_CASES = [
    (1, 100, 100, 4, 2, 16, True, "bfloat16"),
    (2, 64, 192, 4, 1, 32, False, "bfloat16"),
    (1, 100, 100, 4, 2, 48, True, "float32"),
    (1, 128, 128, 4, 4, 48, True, "bfloat16"),
    (2, 64, 192, 4, 2, 96, False, "float32"),
    (1, 128, 128, 4, 4, 96, True, "bfloat16"),
    (1, 130, 130, 6, 1, 112, True, "float32"),
    (1, 128, 128, 4, 4, 112, True, "bfloat16"),
]


@pytest.mark.parametrize("case", WIDENED_HEAD_DIM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_widened_head_dims(case):
    b, sq, skv, h, hkv, d, causal, dtype = case
    assert d in ops.HEAD_DIMS
    q, k, v = _inputs(b, sq, skv, h, hkv, d, seed=8)
    got = _torch(q, k, v, dtype, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, sq, h, d)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(),
        _jax(q, k, v, dtype, causal=causal, block_q=64, block_kv=64),
        rtol=tol, atol=tol)


#: head_dims above 128 (Gemma-7B's and Gemma-2-9B's 256, and 144 and 192
#: between), which the CUDA kernels run in their 256-wide tiles (bf16,
#: fp16) and D-split blocks (fp32) with the columns past head_dim read as
#: zeros: groups 1, 2 and 8, ragged, non-causal with Sq != Skv
WIDE_HEAD_DIM_CASES = [
    (1, 100, 100, 2, 2, 256, True, "float32"),
    (2, 64, 192, 4, 2, 256, False, "float32"),
    (1, 128, 128, 8, 1, 256, True, "float32"),
    (1, 128, 128, 8, 1, 256, True, "bfloat16"),
    (1, 100, 100, 4, 2, 256, True, "float16"),
    (1, 130, 130, 4, 2, 192, True, "float32"),
    (1, 128, 128, 4, 4, 192, True, "bfloat16"),
    (2, 64, 192, 8, 1, 144, False, "float32"),
    (1, 128, 128, 4, 2, 144, True, "bfloat16"),
    (1, 100, 100, 4, 4, 144, True, "float16"),
]


@pytest.mark.parametrize("case", WIDE_HEAD_DIM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_head_dims_above_128(case):
    b, sq, skv, h, hkv, d, causal, dtype = case
    assert d in ops.HEAD_DIMS
    q, k, v = _inputs(b, sq, skv, h, hkv, d, seed=10)
    got = _torch(q, k, v, dtype, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, sq, h, d)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(),
        _jax(q, k, v, dtype, causal=causal, block_q=64, block_kv=64),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_50_at_head_dim_256(dtype):
    """Gemma-2-9B's attention: 16 q heads over 8 kv heads of 256, logits
    soft-capped at 50."""
    q, k, v = _inputs(1, 128, 128, 16, 8, 256, seed=11)
    got = _torch(q, k, v, dtype, causal=True, softcap=50.0)
    want = _jax(q, k, v, dtype, causal=True, softcap=50.0, block_q=64,
                block_kv=64)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


#: shapes of the wide kernel's schedule (b, sq, skv, h, causal): the
#: head_dim-256 timing shapes (16 heads, one wave; 32 heads, two), 2048
#: tokens, ragged q units with B > 1, one q unit, ragged and top-left
#: causal, Sq past Skv, non-causal, one token
WIDE_SCHEDULE_SHAPES = [
    (1, 1024, 1024, 16, True), (1, 1024, 1024, 32, True),
    (1, 2048, 2048, 32, True), (3, 1000, 1000, 16, True),
    (1, 64, 64, 16, True), (1, 300, 300, 8, True), (1, 100, 260, 4, True),
    (1, 192, 64, 4, True), (2, 200, 333, 8, False),
    (1, 1500, 1500, 8, False), (1, 1, 1, 4, True), (1, 130, 130, 4, True),
]


def _wide_schedule(shape):
    b, sq, skv, h, causal = shape
    return ops.wide_schedule(sq, skv, causal, h, b)


def _sm_loads(shape):
    """The blocks of a launch laid on an H100's SMs in launch order, each
    on the first SM free (as the card's block scheduler does), a block
    taking its longer consumer's tiles: each SM's load, and the total."""
    b, _, _, h, _ = shape
    mirror, blocks = _wide_schedule(shape)
    steps = [max(c0, c1) for *_, c0, c1 in blocks]
    # mirror pairs: the blocks of a head together; neighbour pairs: every
    # head's block z before any head's z + 1
    order = (steps * (b * h) if mirror
             else [t for t in steps for _ in range(b * h)])
    loads = [0] * ops.H100_SMS
    for t in order:
        i = loads.index(min(loads))
        loads[i] += t
    return loads, sum(order)


@pytest.mark.parametrize("shape", WIDE_SCHEDULE_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wide_schedule_takes_every_q_unit_once(shape):
    _, sq, skv, _, _ = shape
    _, blocks = _wide_schedule(shape)
    units = [u for a, b, *_ in blocks for u in (a, b) if u is not None]
    assert sorted(units) == list(range(-(-sq // ops.WIDE_UNIT)))
    n_kv = -(-skv // ops.WIDE_KEYS)
    for a, b, na, nb, c0, c1 in blocks:
        # each of b's tiles once: a's on both consumers, the rest in turn
        assert c0 + c1 == na + nb and c1 - c0 in (0, 1)
        assert 0 < nb <= n_kv and (a is None) == (na == 0)


@pytest.mark.parametrize("shape", WIDE_SCHEDULE_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wide_schedule_puts_the_longest_sweeps_first(shape):
    _, blocks = _wide_schedule(shape)
    longer = [b for _, b, *_ in blocks]
    assert longer == sorted(longer, reverse=True)
    assert [nb for *_, nb, _, _ in blocks] == sorted(
        (nb for *_, nb, _, _ in blocks), reverse=True)
    assert all(na <= nb for _, _, na, nb, _, _ in blocks)


@pytest.mark.parametrize("shape", WIDE_SCHEDULE_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wide_schedule_balances_the_blocks(shape):
    """The design's bounds.  In one wave (mirror pairs) no block's longer
    consumer sweeps more than one tile past the mean block's half of its
    tiles; past one wave (neighbour pairs) the SMs' loads, the blocks
    laid in launch order, end within 10% of an even spread.  The 128-row
    q tiles of the kernel before took 1.83 times the even spread at
    causal S 1024 with 16 heads (the test below)."""
    mirror, blocks = _wide_schedule(shape)
    loads, total = _sm_loads(shape)
    if mirror:
        mean_half = sum(na + nb for _, _, na, nb, _, _ in blocks) / (
            2 * len(blocks))
        assert max(c1 for *_, c1 in blocks) <= mean_half + 1
    else:
        assert max(loads) <= 1.1 * total / ops.H100_SMS


def test_wide_schedule_takes_mirror_pairs_in_one_wave():
    """16 heads at causal S 1024 fill 128 of an H100's 132 SMs: mirror
    pairs, every block 9 tile-steps on its longer consumer; 32 heads need
    256 blocks: neighbour pairs, the longest first."""
    mirror, blocks = ops.wide_schedule(1024, 1024, True, 16)
    assert mirror and {max(c0, c1) for *_, c0, c1 in blocks} == {9}
    mirror, blocks = ops.wide_schedule(1024, 1024, True, 32)
    assert not mirror and [c1 for *_, c1 in blocks] == list(
        range(16, 0, -2))


def test_the_old_q_tiles_left_the_card_uneven():
    """The measure of the test above for 128-row q tiles, each block
    sweeping its last row's 64-key tiles on both consumers: at causal S
    1024 with 16 heads the longest block took 16 tile-steps against an
    even 8.7."""
    steps = [2 * i + 2 for i in range(8)] * 16
    assert max(steps) / (sum(steps) / ops.H100_SMS) > 1.8


def _card_test_module():
    spec = importlib.util.spec_from_file_location(
        "card_tests", pathlib.Path(__file__).with_name(
            "test_torch_kernels_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planted_texts():
    mod = _card_test_module()
    out = [(f, old) for f, (name, old, _) in mod.FAULTS.items()
           if name == "flash_attention"]
    out += [(f, old) for f, (name, old, _) in mod.HEAD_DIM_80_FAULTS.items()
            if name == "flash_attention"]
    out += [(f, old) for f, (old, _, _) in mod.FP32_FAULTS.items()]
    out += [(f, old) for f, (old, _, _) in mod.WIDE_FAULTS.items()]
    out += [(f, old) for f, (old, _, _) in mod.WIDE_FP32_FAULTS.items()]
    return out + [("flash-reads-past-the-kv-end", mod.KV_TAIL_FAULT[1])]


@pytest.mark.parametrize("fault", _planted_texts(), ids=lambda f: f[0])
def test_planted_fault_texts_occur_once_in_the_flash_source(fault):
    """Each planted fault of the card tests locates its line by a text
    that must occur once in the flash source, so that a kernel written
    beside another does not move the fault or fail the card test."""
    src = (pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    assert src.count(fault[1]) == 1


def test_wrapper_tables_cover_every_multiple_of_16():
    """The dtypes and head_dims the CUDA kernels take: fp32, bf16 and
    fp16, every multiple of 16 from 16 to 256 (the C interface's dtype
    codes are the paged kernel's)."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    assert ops.HEAD_DIMS == paged_ops.HEAD_DIMS == tuple(range(16, 257, 16))
    assert ops.DTYPES == paged_ops.DTYPES == {torch.float32: 0,
                                              torch.bfloat16: 1,
                                              torch.float16: 2}


def test_softcap():
    q, k, v = _inputs(1, 64, 64, 2, 2, 32, seed=1)
    got = _torch(q, k, v, "float32", causal=True, softcap=20.0)
    want = _jax(q, k, v, "float32", causal=True, softcap=20.0, block_q=32,
                block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_causal_is_top_left_when_sq_below_skv():
    """The Pallas kernel masks qpos >= kpos with no offset (top-left); its
    ``ref.py`` aligns bottom-right.  The port follows the kernel."""
    q, k, v = _inputs(1, 64, 128, 2, 1, 32, seed=2)
    got = _torch(q, k, v, "float32", causal=True)
    want = _jax(q, k, v, "float32", causal=True, block_q=32, block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # row 0 sees key 0 only: its output is v[0] of its kv head
    np.testing.assert_allclose(got[0, 0, 0].numpy(), v[0, 0, 0],
                               rtol=1e-6, atol=1e-6)



#: (impl, sq, skv, causal): S 96 is three blocks of 32; S 100 and
#: sq != skv take the reference's fallback to naive
BLOCKED_SHAPES = [
    ("blocked", 96, 96, True),
    ("blocked", 96, 96, False),
    ("blocked", 100, 100, True),
    ("blocked", 64, 96, False),
    ("blocked_causal", 96, 96, True),
    ("blocked_causal", 100, 100, True),
    ("blocked_causal", 64, 96, True),
    ("blocked_causal", 96, 96, False),
]
BLOCKED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 64])
@pytest.mark.parametrize("shape", BLOCKED_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_blocked_routes_vs_jax(shape, d, dtype):
    """GQA 4/2 through the port's and the reference's ``attend``."""
    impl, sq, skv, causal = shape
    q, k, v = _inputs(2, sq, skv, 4, 2, d, seed=3)
    jd = getattr(jnp, dtype)
    want = np.asarray(jax_attn.attend(
        *(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal, impl=impl,
        block_q=32, block_kv=32).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = attention_impl.attend(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), causal=causal,
        impl=impl, block_q=32, block_kv=32)
    assert got.dtype == td and got.shape == (2, sq, 4, d)
    got = got.float().numpy()
    tol = BLOCKED_TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        assert err.max() <= tol, err.max()


@pytest.mark.parametrize("impl", ["blocked", "blocked_causal"])
def test_blocked_block_order(impl, monkeypatch):
    """``blocked`` visits every (q block, kv block) pair; ``blocked_causal``
    the reference's pair list, ``kb * block_kv <= qb * block_q + block_q
    - 1``, in row-major order (attention_impl.py:166-169)."""
    visited = []
    real = attention_impl._block_scores

    def spy(q_blk, k_blk, **kw):
        visited.append((kw["q_pos0"] // 32, kw["k_pos0"] // 16))
        return real(q_blk, k_blk, **kw)

    monkeypatch.setattr(attention_impl, "_block_scores", spy)
    q = torch.zeros(1, 96, 2, 16)
    attention_impl.attend(q, q, q, causal=True, impl=impl, block_q=32,
                          block_kv=16)
    every = [(qi, ki) for qi in range(3) for ki in range(6)]
    lower = [(qi, ki) for qi, ki in every if ki * 16 <= qi * 32 + 31]
    assert visited == (every if impl == "blocked" else lower)


def test_run_settings_block_sizes_reach_attend(monkeypatch):
    """``attn_block_q``/``attn_block_kv`` go from ``RunSettings`` through
    ``_attn_full`` to ``attend``, as in the reference (model_zoo.py:147)."""
    seen = []
    real = model_zoo.attend

    def spy(*args, **kw):
        seen.append((kw["impl"], kw["block_q"], kw["block_kv"]))
        return real(*args, **kw)

    monkeypatch.setattr(model_zoo, "attend", spy)
    assert (RunSettings().attn_block_q, RunSettings().attn_block_kv) == \
        (1024, 1024)
    cfg = get_smoke_config("llama2-7b")
    model = model_zoo.build(cfg, settings=RunSettings(
        attn_impl="blocked", attn_block_q=16, attn_block_kv=8))
    params = model_zoo.init_params(model, seed=0, device="cpu")
    tokens = torch.zeros(1, 32, dtype=torch.long)
    logits, _ = model_zoo.forward(model, params, {"tokens": tokens})
    assert torch.isfinite(logits).all()
    assert seen == [("blocked", 16, 8)] * cfg.num_layers


# ---------------------------------------------------------------------------
# A CPU model of the fp32 kernel's 3xTF32 arithmetic
# ---------------------------------------------------------------------------
def _tf32_rna(x):
    """``cvt.rna.tf32.f32``: x rounded to TF32's 10 mantissa bits, to
    nearest with ties away from zero, as fp32 (13 low bits zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x's fp32 bits with the 13 low bits dropped: TF32 as the tensor
    core reads an fp32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x, hi_of=_tf32_rna):
    hi = hi_of(x)
    return hi, _tf32_rna(x - hi)


def _tf32_product(eq, a, b, products):
    """einsum of two (hi, lo) pairs: hi·lo + lo·hi, then + hi·hi (three
    products), or hi·hi alone (one)."""
    big = torch.einsum(eq, a[0], b[0])
    if products == 1:
        return big
    return (torch.einsum(eq, a[0], b[1]) + torch.einsum(eq, a[1], b[0])) \
        + big


#: the columns of head_dim each consumer warpgroup of the D-split kernel
#: (head_dims above 128) sums S over
D_SPLIT = 128


def _scores_d_split(q, k, products):
    """S of the D-split kernel: each consumer sums its 128 columns as
    hi·hi + (hi·lo + lo·hi) (hi·hi and hi·lo one stacked product, lo·hi
    another), K's hi as it landed, truncated like Q's; the two partials
    are added after."""
    parts = []
    for c in (slice(0, D_SPLIT), slice(D_SPLIT, None)):
        qs, ks = _split(q[..., c], _tf32_trunc), _split(k[..., c], _tf32_trunc)
        hh = torch.einsum("bqhd,bkhd->bhqk", qs[0], ks[0])
        if products == 3:
            hh = hh + (torch.einsum("bqhd,bkhd->bhqk", qs[0], ks[1])
                       + torch.einsum("bqhd,bkhd->bhqk", qs[1], ks[0]))
        parts.append(hh)
    return parts[0] + parts[1]


def _attention_tf32(q, k, v, *, causal, softcap=0.0, products=3):
    """The fp32 kernel's arithmetic on fp32 (B,S,H,D) tensors: Q's hi is
    its bits truncated to TF32, V and P are split with cvt.rna, and K too
    up to head_dim 128, where S is one sum, (hi·lo + lo·hi) + hi·hi;
    above 128 as ``_scores_d_split``.  The softmax is fp32 (unnormalised
    P, divided by its row sum at the end)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    if d > D_SPLIT:
        s = _scores_d_split(q, k, products) * d ** -0.5
    else:
        s = _tf32_product("bqhd,bkhd->bhqk", _split(q, _tf32_trunc),
                          _split(k), products) * d ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _tf32_product("bhqk,bkhd->bqhd", _split(p), _split(v), products)
    return o / p.sum(-1).transpose(1, 2)[..., None]


#: every fp32 case the reference holds to 2e-5 (tests/test_kernels.py's
#: FLASH_CASES 0, 2, 3, 4 and test_flash_softcap), the fp32 cases at the
#: head_dims the kernel takes beyond them (48, 80, 96, 112, 144, 192,
#: 256), FLASH_CASES[4]'s shape at head_dim 256 and Gemma-2-9B's softcap
#: of 50 at 16/8 heads of 256, whose sums run twice as long as at 128:
#: (b, sq, skv, h, hkv, d, causal, softcap, reference block)
TF32_MODEL_CASES = [
    *((*c[:7], 0.0, 64) for c in FLASH_CASES if c[7] == "float32"),
    (1, 64, 64, 2, 2, 32, True, 20.0, 32),
    *((*c[:7], 0.0, 64) for c in WIDENED_HEAD_DIM_CASES + HEAD_DIM_80_CASES
      + WIDE_HEAD_DIM_CASES if c[7] == "float32"),
    (*FLASH_CASES[4][:5], 256, True, 0.0, 64),
    (1, 128, 128, 16, 8, 256, True, 50.0, 64),
]


@functools.lru_cache(maxsize=None)
def _tf32_model_case(case):
    """(inputs, the JAX reference's output) of a TF32_MODEL_CASES entry,
    the reference in interpret mode as tests/test_kernels.py runs it."""
    b, sq, skv, h, hkv, d, causal, softcap, block = case
    q, k, v = _inputs(b, sq, skv, h, hkv, d, seed=9)
    want = _jax(q, k, v, "float32", causal=causal, softcap=softcap,
                block_q=block, block_kv=block)
    return tuple(map(torch.from_numpy, (q, k, v))), want


def _elementwise_ratio(got, want, tol=2e-5):
    """Largest |got - want| over atol + rtol |want| (rtol = atol = tol):
    at most 1 passes the reference's check."""
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


@pytest.mark.parametrize("case", TF32_MODEL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_three_tf32_products_meet_the_fp32_tolerance(case):
    (q, k, v), want = _tf32_model_case(case)
    assert q.shape[-1] in ops.HEAD_DIMS
    got = _attention_tf32(q, k, v, causal=case[6], softcap=case[7])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_one_tf32_product_misses_the_fp32_tolerance():
    """hi·hi alone rounds each input to 10 bits: past 2e-5 on a case
    (read beside the three products' worst)."""
    one, three = [], []
    for case in TF32_MODEL_CASES:
        (q, k, v), want = _tf32_model_case(case)
        for n, out in ((1, one), (3, three)):
            out.append(_elementwise_ratio(_attention_tf32(
                q, k, v, causal=case[6], softcap=case[7], products=n)
                .numpy(), want))
    print(f"\nworst |error| over the 2e-5 allowance: three products "
          f"{max(three):.3f}, one product {min(one):.1f}-{max(one):.1f}")
    assert max(three) <= 1.0 < max(one), (three, one)


@pytest.mark.parametrize("d", [144, 256])
def test_d_split_scores_are_one_sum_reordered(d):
    """Above head_dim 128 the kernel sums S in two halves of head_dim,
    each as hi·hi + (hi·lo + lo·hi), and adds the halves; that is the
    one-sum model's products in another order, so the two agree within
    fp32 rounding of a score (a few 2^-24 of the largest partial sum),
    far below what one dropped product would move."""
    rng = np.random.RandomState(11)
    q, k = (torch.from_numpy(rng.randn(1, 64, 2, d).astype(np.float32))
            for _ in range(2))
    split = _scores_d_split(q, k, 3)
    one = _tf32_product("bqhd,bkhd->bhqk", _split(q, _tf32_trunc),
                        _split(k, _tf32_trunc), 3)
    scale = torch.einsum("bqhd,bkhd->bhqk", q.abs(), k.abs())
    assert ((split - one).abs() <= 2 ** -20 * scale).all()
    hi_only = _scores_d_split(q, k, 1)
    assert ((split - hi_only).abs() > 2 ** -16 * scale).any()


def test_tf32_rounding_model():
    """The model's cvt.rna: ties away from zero at the 13th bit, exact
    TF32 values unchanged, and hi + lo within 2^-21 of x."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1.5, 0.0])
    assert _tf32_rna(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1.5,
                                     0.0]
    assert _tf32_trunc(torch.tensor([1 + 2 ** -11 + 2 ** -12])).item() == 1.0
    y = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    for hi_of in (_tf32_rna, _tf32_trunc):
        hi, lo = _split(y, hi_of)
        assert ((hi + lo - y).abs() <= 2 ** -21 * y.abs()).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fp32_bound_takes_the_faster_route():
    """chip_smoke.py's bound of fp32 work: the faster of fp32 FMAs and
    3xTF32 on the tensor cores.  Causal S 1024, 32/32 heads of 128 (8.6e9
    flops): 0.0521 ms on the tensor cores against 0.128 ms as FMAs, the
    bytes 0.020 ms; bf16 keeps its bound, and a bytes-bound case too."""
    cs = _chip_smoke()
    flops = 4 * 32 * 128 * (1024 * 1025 // 2)
    nbytes = 4 * 1024 * 32 * 128 * 4
    ms, by, route = cs.bound(nbytes, flops, torch.float32)
    assert (by, route) == ("operations", "3xTF32 tensor cores")
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3)
    assert ms == pytest.approx(0.0521, abs=1e-4)
    ms, by, _ = cs.bound(nbytes // 2, flops, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(nbytes / 2 / 3.35e12 * 1e3)
    ms, by, _ = cs.bound(100 * nbytes, flops, torch.float32)
    assert by == "bytes" and ms == pytest.approx(100 * nbytes / 3.35e12 * 1e3)
