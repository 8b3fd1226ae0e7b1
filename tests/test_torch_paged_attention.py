"""repro_torch.kernels.paged_attention against the reference.

On the CPU the wrapper runs the kernel's plain version; it is held to
the JAX wrapper ``repro.kernels.paged_attention.ops.paged_attention``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
on the reference's PAGED_CASES, at head_dim 80 and at head_dims 144, 192
and 256.  Tolerances as there:
2e-5 in fp32, 3e-2 in bf16.  fp16, which the reference's wrapper takes
though its tests run none, on the bf16 case's shape and at head_dim 80:
1e-2 (both versions compute in fp32 from the same fp16 inputs and round
the output once).  The CUDA kernel is held to the plain version on the
card in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as jax_paged  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402

#: (b, hq, hkv, d, npages, page, mp, dtype) — tests/test_kernels.py
PAGED_CASES = [
    (2, 4, 2, 64, 16, 16, 4, "float32"),
    (3, 8, 1, 32, 32, 8, 6, "float32"),
    (2, 4, 4, 64, 16, 16, 3, "bfloat16"),
    (1, 16, 2, 128, 8, 32, 2, "float32"),
]
#: fp16 on PAGED_CASES[2]'s shape (the reference's bf16 case)
FP16_CASES = [(*PAGED_CASES[2][:7], "float16")]


def _inputs(case, seed=2):
    b, hq, hkv, d, npages, page, mp, _ = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, d).astype(np.float32)
    kp = rng.randn(npages, page, hkv, d).astype(np.float32)
    vp = rng.randn(npages, page, hkv, d).astype(np.float32)
    bt = rng.randint(0, npages, size=(b, mp)).astype(np.int32)
    cl = rng.randint(1, mp * page + 1, size=(b,)).astype(np.int32)
    return q, kp, vp, bt, cl


def _tol(dtype):
    return {"bfloat16": 3e-2, "float16": 1e-2}.get(dtype, 2e-5)


def _jax(q, kp, vp, bt, cl, dtype):
    jd = getattr(jnp, dtype)
    out = jax_paged.paged_attention(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                                    jnp.asarray(vp, jd), jnp.asarray(bt),
                                    jnp.asarray(cl))
    return np.asarray(out.astype(jnp.float32))


def _torch(q, kp, vp, bt, cl, dtype, device="cpu", softcap=0.0):
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(device=device, dtype=td)
            for a in (q, kp, vp)]
    args += [torch.from_numpy(a).to(device) for a in (bt, cl)]
    return ops.paged_attention(*args, softcap=softcap)


@pytest.mark.parametrize("case", PAGED_CASES + FP16_CASES)
def test_plain_vs_jax(case):
    dtype = case[-1]
    q, kp, vp, bt, cl = _inputs(case)
    got = _torch(q, kp, vp, bt, cl, dtype)
    assert got.dtype == getattr(torch, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(q, kp, vp, bt, cl, dtype),
                               rtol=tol, atol=tol)


#: head_dim 80 (stablelm-3b's decode, 32/32, and GQA), which the CUDA
#: kernel runs with 16 lanes a row
HEAD_DIM_80_CASES = [
    (2, 4, 4, 80, 16, 16, 4, "bfloat16"),
    (2, 4, 4, 80, 16, 16, 4, "float32"),
    (3, 8, 2, 80, 32, 8, 6, "float32"),
    (2, 4, 4, 80, 16, 16, 4, "float16"),
]


@pytest.mark.parametrize("case", HEAD_DIM_80_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_head_dim_80(case):
    dtype = case[-1]
    q, kp, vp, bt, cl = _inputs(case, seed=6)
    got = _torch(q, kp, vp, bt, cl, dtype)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(q, kp, vp, bt, cl, dtype),
                               rtol=tol, atol=tol)


#: the groups and head_dims the CUDA kernel was widened to: group 6,
#: multi-query 16/1 and 32/1 (chunks of 8 q heads a block), 12/1 (two of
#: 6), and head_dims 16, 32, 48, 96, 112
WIDENED_CASES = [
    (2, 12, 2, 64, 16, 16, 4, "float32"),
    (2, 24, 4, 128, 16, 16, 4, "bfloat16"),
    (2, 16, 1, 128, 16, 16, 4, "float32"),
    (2, 32, 1, 64, 16, 16, 4, "bfloat16"),
    (1, 32, 1, 32, 8, 32, 2, "float32"),
    (2, 12, 1, 16, 16, 8, 6, "float32"),
    (3, 4, 2, 16, 32, 8, 6, "bfloat16"),
    (2, 8, 1, 48, 16, 16, 4, "float32"),
    (2, 4, 4, 96, 16, 16, 3, "bfloat16"),
    (1, 16, 2, 112, 8, 32, 2, "float32"),
]


@pytest.mark.parametrize("case", WIDENED_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_widened_shapes(case):
    dtype = case[-1]
    q, kp, vp, bt, cl = _inputs(case, seed=9)
    got = _torch(q, kp, vp, bt, cl, dtype)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(q, kp, vp, bt, cl, dtype),
                               rtol=tol, atol=tol)


#: head_dims above 128 (Gemma's 256, and 144 and 192), which the CUDA
#: kernel runs with a warp of 32 lanes a row, the lanes past head_dim / 8
#: dead: groups 1, 2 and 8 (16/2), multi-query 16/1 (two chunks of 8)
WIDE_HEAD_DIM_CASES = [
    (2, 4, 4, 256, 16, 16, 4, "float32"),
    (2, 4, 4, 256, 16, 16, 4, "bfloat16"),
    (3, 8, 4, 256, 32, 8, 6, "float16"),
    (1, 16, 2, 256, 8, 32, 2, "float32"),
    (2, 16, 1, 256, 16, 16, 4, "bfloat16"),
    (2, 4, 4, 192, 16, 16, 4, "float32"),
    (3, 8, 1, 192, 32, 8, 6, "bfloat16"),
    (2, 4, 2, 144, 16, 16, 4, "float32"),
    (1, 16, 2, 144, 8, 32, 2, "float16"),
]


@pytest.mark.parametrize("case", WIDE_HEAD_DIM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_vs_jax_at_head_dims_above_128(case):
    dtype = case[-1]
    assert case[3] in ops.HEAD_DIMS
    q, kp, vp, bt, cl = _inputs(case, seed=10)
    got = _torch(q, kp, vp, bt, cl, dtype)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(q, kp, vp, bt, cl, dtype),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [16, 64])
def test_block_table_permutation_at(d):
    """tests/test_kernels.py's permutation case (head_dim 16, 2/1) and the
    same at head_dim 64: the same KV content through permuted page
    tables gives the same output, which is the reference's."""
    b, hq, hkv, npages, page, mp = 1, 2, 1, 8, 4, 4
    rng = np.random.RandomState(3)
    q = rng.randn(b, hq, d).astype(np.float32)
    kseq = rng.randn(mp * page, hkv, d).astype(np.float32)
    vseq = rng.randn(mp * page, hkv, d).astype(np.float32)
    outs = []
    for perm in ([0, 1, 2, 3], [3, 1, 0, 2]):
        kp = np.zeros((npages, page, hkv, d), np.float32)
        vp = np.zeros((npages, page, hkv, d), np.float32)
        for logical, phys in enumerate(perm):
            kp[phys] = kseq[logical * page:(logical + 1) * page]
            vp[phys] = vseq[logical * page:(logical + 1) * page]
        bt = np.asarray([perm], np.int32)
        cl = np.asarray([mp * page], np.int32)
        outs.append(_torch(q, kp, vp, bt, cl, "float32").numpy())
        np.testing.assert_allclose(outs[-1],
                                   _jax(q, kp, vp, bt, cl, "float32"),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_block_table_permutation():
    """Same KV content through permuted page tables -> same output."""
    b, hq, hkv, d, npages, page, mp = 1, 2, 1, 64, 8, 4, 4
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32))
    kseq = torch.from_numpy(rng.randn(mp * page, hkv, d).astype(np.float32))
    vseq = torch.from_numpy(rng.randn(mp * page, hkv, d).astype(np.float32))
    outs = []
    for perm in ([0, 1, 2, 3], [3, 1, 0, 2]):
        kp = torch.zeros(npages, page, hkv, d)
        vp = torch.zeros(npages, page, hkv, d)
        for logical, phys in enumerate(perm):
            kp[phys] = kseq[logical * page:(logical + 1) * page]
            vp[phys] = vseq[logical * page:(logical + 1) * page]
        bt = torch.tensor([perm], dtype=torch.int32)
        cl = torch.tensor([mp * page], dtype=torch.int32)
        outs.append(ops.paged_attention(q, kp, vp, bt, cl))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_padded_row_on_trash_page_is_finite():
    """The engine pads the decode batch with rows of length 1 whose table
    points only at the trash page; they must come out finite."""
    case = (3, 4, 2, 64, 9, 16, 4, "float32")
    q, kp, vp, bt, cl = _inputs(case, seed=4)
    trash = kp.shape[0] - 1
    bt[2] = trash
    cl[2] = 1
    got = _torch(q, kp, vp, bt, cl, "float32")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax(q, kp, vp, bt, cl,
                                                 "float32"),
                               rtol=2e-5, atol=2e-5)


def test_softcap_matches_gather_formula():
    """With a softcap the plain version equals the reference's gather-path
    decode attention (which the Pallas kernel does not implement)."""
    _softcap_matches_gather_formula((2, 4, 2, 64, 16, 16, 4, "float32"), 5.0)


def test_softcap_50_at_head_dim_256_matches_gather_formula():
    """Gemma-2-9B's decode: 16 q heads over 8 kv heads of 256, logits
    soft-capped at 50."""
    _softcap_matches_gather_formula((2, 16, 8, 256, 16, 16, 4, "float32"),
                                    50.0)


def _softcap_matches_gather_formula(case, softcap):
    from repro.models.attention_impl import decode_attention
    q, kp, vp, bt, cl = _inputs(case, seed=5)
    got = _torch(q, kp, vp, bt, cl, "float32", softcap=softcap)
    b, mp, page = q.shape[0], bt.shape[1], kp.shape[1]
    kseq = jnp.asarray(kp)[jnp.asarray(bt)].reshape(b, mp * page,
                                                   *kp.shape[2:])
    vseq = jnp.asarray(vp)[jnp.asarray(bt)].reshape(b, mp * page,
                                                   *vp.shape[2:])
    want = decode_attention(jnp.asarray(q)[:, None], kseq, vseq,
                            jnp.asarray(cl), logit_softcap=softcap)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)



def test_build_parts_come_from_the_source():
    """kernels/build.py builds the paged source as the objects its
    ``kParts`` declares, and the source defines one ``launch_part`` for
    each; a source without the declaration builds whole."""
    from repro_torch.kernels import build
    src = (build.CSRC / "paged_attention.cu").read_text()
    parts = build._parts("paged_attention")
    assert parts > 1
    for p in range(parts + 1):
        defined = f"int launch_part<{p}>(int dtype" in src
        assert defined == (p < parts), p
    assert build._parts("flash_attention") == 1
