"""The port's CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA card and skip without one.  This file
imports no JAX, so it runs where the card is:

    python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py imports jax).  The kernel's
output is held against its plain version run in fp32 on the same
values, row by row (one q head of one token): the row's largest error
over its largest |value| stays within 1e-2 in bf16 and 1e-4 in fp32, as
in chip_smoke.py.  The flash kernel takes bf16 alone, so every masking
and softcap case runs in bf16.
``test_relative_limit_catches_an_off_by_one`` plants a fault in a copy
of each kernel's source (a mask or length off by one, the stage of the
flash kernel's K/V ring, the end of a paged split, the paged merge's
rescale) and shows that the limit catches it on long rows; ``-s``
prints both readings.

The ``blocked``/``blocked_causal`` attention routes launch no kernel (they
are plain PyTorch, as the reference's are plain JAX): they are held to
the naive route on the card, with the same row limits, at the shapes
the flash kernel refuses (head_dim 80 in bf16, head_dim 128 in fp32, S
4096 in blocks of 1024, and a ragged S 3000), and one of them is
captured in a CUDA graph and replayed, equal to eager.

The SSD scan (three kernels: chunk state, state passing, chunk scan) is
held to its plain version (run on the CPU, in fp32, on the same values;
two of its runs must agree within rounding) and to an fp64 recurrence
on the card, per row of P, on y and on the final state, within 1e-4:
its products are fp32 FMAs.
``test_ssd_limits_catch_a_planted_fault`` plants a fault in a copy of
its source and shows that this limit, and chip_smoke.py's limits for a
mamba2-130m layer through the kernel against ``impl="recurrent"``,
catch it.
"""
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

REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


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


@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(
    map(str, c[:8])) + "".join(f"-{k}" for k in c[8]))
def test_paged_kernel_vs_plain(cuda, case):
    dtype = case[7]
    args = _paged_case_inputs(case, cuda)
    before = counts.get("paged_attention")
    got = paged.paged_attention(*args)
    torch.cuda.synchronize()
    assert counts.get("paged_attention") == before + 1
    want = _paged_plain(args)
    assert torch.isfinite(got).all()
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]


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


def test_paged_kernel_softcap(cuda):
    args = _paged_inputs(4, 8, 2, 128, 33, 16, 8, torch.float32, cuda)
    got = paged.paged_attention(*args, softcap=5.0)
    want = paged.paged_attention_ref(*args, softcap=5.0)
    assert _row_rel_err(got, want).max() <= REL_TOL[torch.float32]


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
]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
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
    assert torch.isfinite(got).all()
    assert _row_rel_err(got, want).max() <= REL_TOL[dtype]


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


def _serving_shape_case(name, device, hkv=32):
    """Run kernel ``name`` once at the serving path's shape (llama2-7b,
    bf16; paged with ``hkv`` 8, qwen3-14b's 40/8); returns (kernel
    output, fp32 plain output, the long rows).  Long rows: paged, every
    row but the padded one (contexts up to 2048); flash, causal S 2048,
    the rows at positions 512 and later."""
    dtype = torch.bfloat16
    if name == "paged_attention":
        hq = 32 if hkv == 32 else 5 * hkv
        args = _paged_inputs(8, hq, hkv, 128, 1025, 16, 128, dtype, device)
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


@pytest.mark.parametrize("fault", sorted(f for f in FAULTS
                                         if f.startswith("paged")))
def test_relative_limit_catches_an_off_by_one_at_group_5(
        cuda, fault, tmp_path, monkeypatch):
    """The paged faults again at qwen3-14b's decode shape (GQA 40/8)."""
    name, old, new = FAULTS[fault]
    got, want, rows = _serving_shape_case(name, cuda, hkv=8)
    sound = float(_row_rel_err(got, want)[rows].max())
    src = (build.CSRC / f"{name}.cu").read_text()
    (tmp_path / f"{name}.cu").write_text(src.replace(old, new))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_loaded", {})
    got, want, rows = _serving_shape_case(name, cuda, hkv=8)
    planted = float(_row_rel_err(got, want)[rows].max())
    print(f"\n{fault} at G 5: long-row relative error, sound {sound:.3e}, "
          f"planted {planted:.3e}, limit {REL_TOL[torch.bfloat16]:.0e}")
    assert sound <= REL_TOL[torch.bfloat16] < planted


def test_head_dim_80_raises(cuda):
    """stablelm-3b's head_dim (2560/32 = 80): neither kernel takes it, so
    its kernel routes raise on the card; its served routes are the plain
    defaults (``gather``, and ``auto`` prefill attention)."""
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b")
    d, h = cfg.head_dim, cfg.n_heads
    assert d == 80
    q = torch.zeros(2, h, d, device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros(9, 16, cfg.n_kv_heads, d, device=cuda,
                     dtype=torch.bfloat16)
    bt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 80"):
        paged.paged_attention(q, kp, kp, bt, cl)
    x = torch.zeros(1, 64, h, d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 80"):
        flash.flash_attention(x, x, x)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 4, 96, device=cuda)              # head_dim 96
    kp = torch.zeros(8, 16, 2, 96, device=cuda)
    bt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_attention(q, kp, kp, bt, cl)
    q3 = torch.zeros(2, 6, 64, device=cuda)             # group 3
    kp3 = torch.zeros(8, 16, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="6/2"):
        paged.paged_attention(q3, kp3, kp3, bt, cl)
    for dtype in (torch.float16, torch.float32):
        x = torch.zeros(1, 64, 2, 64, device=cuda, dtype=dtype)
        with pytest.raises(TypeError):
            flash.flash_attention(x, x, x)


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
#: (impl, s, h, hkv, d, dtype): stablelm-3b's head_dim 80 in bf16 and
#: head_dim 128 in fp32 (GQA 4), which the flash kernel refuses; S 4096
#: is 4 x 4 blocks of 1024, S 3000 takes the reference's ragged fallback
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
    """The repaired route serves what the flash kernel refuses, and
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
