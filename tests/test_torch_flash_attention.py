"""repro_torch.kernels.flash_attention against the reference.

On the CPU the wrapper runs the kernel's plain version; it is held to
the JAX wrapper ``repro.kernels.flash_attention.ops.flash_attention``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
on the reference's FLASH_CASES, its softcap case, and shapes at the CUDA
kernel's tile edges.  Tolerances: 2e-5 in fp32, 3e-2 in bf16.  The CUDA kernel is held to the plain version on
the card in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_flash  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

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

