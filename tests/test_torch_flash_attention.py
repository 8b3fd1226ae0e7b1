"""repro_torch.kernels.flash_attention against the reference.

On the CPU the wrapper runs the kernel's plain version; it is held to
the JAX wrapper ``repro.kernels.flash_attention.ops.flash_attention``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
on the reference's FLASH_CASES, its softcap case, shapes at the CUDA
kernel's tile edges, and head_dim 80 (with test_kernels.py's
tolerances).  Tolerances: 2e-5 in fp32, 3e-2 in bf16.  The CUDA kernel is held to the plain version on
the card in tests/test_torch_kernels_cuda.py.

The ``blocked`` and ``blocked_causal`` routes of ``attend`` are plain
loops over blocks in both packages; the port's are held to the
reference's ``attend`` with the same impl and blocks of 32, on even
blocks and on the shapes that fall back to ``naive`` (S not a multiple
of the block, and ``sq != skv`` for ``blocked_causal``).  Tolerances:
1e-5 in fp32; in bf16, each output row's largest error within 2e-2 of
its largest |value| (one bf16 rounding of the output is 2^-8).
"""
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


def _inputs(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 2e-5


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


@pytest.mark.parametrize("case", FLASH_CASES + TILE_EDGE_CASES)
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
]
#: tests/test_kernels.py's FLASH_CASES tolerances
KERNEL_TOL = {"bfloat16": 2.5e-2, "float32": 2e-5}


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


def test_wrapper_tables_cover_every_multiple_of_16():
    """The dtypes and head_dims the CUDA kernels take: bf16 and fp32, every
    multiple of 16 from 16 to 128 (the C interface's dtype codes are the
    paged kernel's)."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    assert ops.HEAD_DIMS == paged_ops.HEAD_DIMS == tuple(range(16, 129, 16))
    assert ops.DTYPES == paged_ops.DTYPES == {torch.float32: 0,
                                              torch.bfloat16: 1}


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
