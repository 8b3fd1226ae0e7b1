"""The port's ServingEngine against the reference's, fp32 smoke models.

For every DENSE/MOE/VLM entry of ``repro.configs.SMOKE_CONFIGS`` (the
reference's weights loaded into the port, ``model_pair`` of
tests/test_torch_model.py), both engines serve the same six requests of
mixed lengths with a page pool small enough to force preemption.  The port must reproduce the
reference exactly where the reference is exact: greedy tokens of every
request, and every iteration record's kind, batch and ``BatchMix``.
This structural test stands in for the class sharing the reference
engine has with the simulator.  Page contents after the run (all pages
but the trash page, whose content is the last of several colliding
writes) must match to 1e-5.

Run once on the plain path (``gather``, naive prefill attention) and
once on the kernel path (``pallas`` decode and prefill): the reference
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions, as it does for any CPU tensor.  The granite MoE models run
on the ``dense_onehot`` route (the default) there, and once more on
``sort``; a decode batch's padded rows go through the MoE as the live
ones do.

llama2-7b's smoke model in fp16 runs on both engines and both paths
too: greedy tokens and records exactly, pages within ``FP16_PAGE_TOL``.

opt's learned positions past the end of the table: a position table of
24 rows, requests decoded to context 30 on both paged paths, with pages
enough that nothing is preempted (a recompute would prefill past the
table, which the reference's ``pos[:S]`` does not take).  The decode
reads the table's last row there, as the reference's gather does.

The slot path (mamba2-130m smoke model, fp32; zamba2-2.7b's, the
hybrid family; whisper-base's smoke model as AUDIO and as ENCDEC) is
held to the same standard: greedy tokens and iteration records exactly,
with preemption forced and prompts whose buckets reach both SSD
branches, and the slot caches (``conv``, ``ssd``; zamba2's ``conv``,
``ssd``, ``k``, ``v``, written by the engine's generic slot write;
``k``, ``v``, ``xk``, ``xv``) after the run to 1e-5.  Each whisper prefill encodes the request's frame embeddings,
which the port's engine draws as the reference's does, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.sampling import sample_token  # noqa: E402
from test_torch_model import (ENCDEC_ARCHS, arch_cases,  # noqa: E402
                              case_pair, model_pair)

PROMPTS = [5, 12, 20, 9, 30, 16]
OUTPUTS = [8, 6, 10, 12, 5, 9]
ENGINE = dict(num_blocks=14, block_size=8, max_batch=4, max_pages_per_seq=8)
#: opt with a position table of 24 rows; prompts bucket to 16
SHORT_POS = 24
POS_PROMPTS = [16, 12]
POS_OUTPUTS = [15, 14]
POS_ENGINE = dict(num_blocks=16, block_size=8, max_batch=2,
                  max_pages_per_seq=8)


def _serve(models, path, prompts, outputs, ecfg, **settings):
    """Both engines on the same requests; returns (port engine, its
    requests, reference engine, its requests)."""
    jmodel, params, tmodel, tparams = models
    impl = "pallas" if path == "pallas" else "auto"
    jm = jmodel.with_settings(attn_impl=impl, attn_block_q=8,
                              attn_block_kv=8, **settings)
    tm = tmodel.with_settings(attn_impl=impl, **settings)

    def requests(cls):
        return [cls(id=i, arrival_time=0.01 * i, prompt_len=p,
                    output_len=o)
                for i, (p, o) in enumerate(zip(prompts, outputs))]

    jreqs = requests(JaxRequest)
    je = jeng.ServingEngine(jm, params,
                            jeng.EngineConfig(attn_path=path, **ecfg))
    for r in jreqs:
        je.add_request(r)
    je.run()

    treqs = requests(Request)
    te = teng.ServingEngine(tm, tparams,
                            teng.EngineConfig(attn_path=path, **ecfg),
                            device="cpu")
    for r in treqs:
        te.add_request(r)
    te.run()
    return te, treqs, je, jreqs


def _same_run(te, treqs, je, jreqs, page_tol=1e-5):
    assert te.paged
    assert len(te.finished) == len(treqs) == len(je.finished)
    assert [r.preempt_count for r in treqs] == \
        [r.preempt_count for r in jreqs]
    assert te.tokens_by_req == je.tokens_by_req

    assert len(te.records) == len(je.records)
    for t, j in zip(te.records, je.records):
        assert t.kind == j.kind
        assert t.batch_ids == j.batch_ids
        assert dataclasses.asdict(t.mix) == dataclasses.asdict(j.mix)

    n = te.trash_page
    for key in ("k", "v"):
        np.testing.assert_allclose(te.pages[key][:, :n].float().numpy(),
                                   np.asarray(je.pages[key],
                                              np.float32)[:, :n],
                                   rtol=page_tol, atol=page_tol)


@pytest.mark.parametrize("arch,path", arch_cases(["gather", "pallas"]))
def test_engine_matches_reference(arch, path):
    te, treqs, je, jreqs = _serve(model_pair(arch), path, PROMPTS, OUTPUTS,
                                  ENGINE)
    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    _same_run(te, treqs, je, jreqs)


#: llama2-7b's smoke model in fp32 at the attention shapes the kernels
#: were widened to: (q heads, kv heads, head_dim) of GQA group 6 at
#: head_dim 16, multi-query 16/1 at head_dim 32, head_dim 48, and the
#: head_dims above 128: GQA 2 at 256 (a q width of 1024 over d_model 64)
#: and 144
WIDENED_SHAPES = [(12, 2, 16), (16, 1, 32), (4, 4, 48), (4, 2, 256),
                  (4, 4, 144)]


@pytest.mark.parametrize("path", ["gather", "pallas"])
@pytest.mark.parametrize("shape", WIDENED_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_engine_matches_reference_fp32_at_widened_shapes(shape, path):
    """The fp32 llama2-7b smoke model with its heads reshaped, served by
    both engines on both attention paths (the reference's Pallas kernels
    in interpret mode on ``pallas``): greedy tokens, iteration records
    and pages as in ``test_engine_matches_reference``."""
    hq, hkv, d = shape
    models = model_pair("llama2-7b", n_heads=hq, n_kv_heads=hkv, head_dim=d)
    tcfg = models[2].cfg
    assert (tcfg.dtype, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim) == \
        ("float32", hq, hkv, d)
    te, treqs, je, jreqs = _serve(models, path, PROMPTS, OUTPUTS, ENGINE)
    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    _same_run(te, treqs, je, jreqs)


#: fp16 pages: K and V as each engine rounds them to fp16.  The first
#: layer's agree to 1e-6; the second's inputs have been through a layer
#: of fp16 activations that the two libraries round in other places, and
#: its pages hold values up to 4.35, where one fp16 rounding step is 2^-8
#: to 2^-7, so 1e-2 (read: 1.95e-3 on ``gather``, 2.93e-3 on ``pallas``)
FP16_PAGE_TOL = 1e-2


@pytest.mark.parametrize("path", ["gather", "pallas"])
def test_engine_matches_reference_fp16(path):
    """llama2-7b's smoke model in fp16 (the dtype of the published
    llama2-7b checkpoint), served by both engines on both attention
    paths (the reference's Pallas kernels in interpret mode on
    ``pallas``): greedy tokens and iteration records exactly, pages
    within FP16_PAGE_TOL."""
    models = model_pair("llama2-7b", dtype="float16")
    assert models[2].cfg.dtype == "float16"
    te, treqs, je, jreqs = _serve(models, path, PROMPTS, OUTPUTS, ENGINE)
    assert te.pages["k"].dtype == torch.float16
    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    _same_run(te, treqs, je, jreqs, page_tol=FP16_PAGE_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m"])
def test_engine_matches_reference_moe_sort(arch):
    te, treqs, je, jreqs = _serve(model_pair(arch), "pallas", PROMPTS,
                                  OUTPUTS, ENGINE, moe_impl="sort")
    assert te.model.settings.moe_impl == "sort"
    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    _same_run(te, treqs, je, jreqs)


@pytest.mark.parametrize("path", ["gather", "pallas"])
def test_learned_positions_past_the_table(path):
    models = model_pair("opt-13b", seed=2, max_seq_len=SHORT_POS)
    assert models[3]["pos"].shape[0] == SHORT_POS
    te, treqs, je, jreqs = _serve(models, path, POS_PROMPTS, POS_OUTPUTS,
                                  POS_ENGINE)
    assert max(r.context_len for r in treqs) > SHORT_POS + 4
    assert sum(r.preempt_count for r in jreqs) == 0
    _same_run(te, treqs, je, jreqs)


def test_sampling_respects_padded_vocab():
    """Greedy takes the first maximum below ``vocab_logical``; temperature
    draws come from the caller's generator, so a seed repeats them."""
    logits = torch.tensor([0.5, 2.0, 2.0, 1.0, 9.0, 9.0])
    assert sample_token(logits, vocab_logical=4) == 1
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        draws.append([sample_token(logits, gen, greedy=False,
                                   temperature=0.5, vocab_logical=4)
                      for _ in range(20)])
    assert draws[0] == draws[1]
    assert set(draws[0]) <= {0, 1, 2, 3} and len(set(draws[0])) > 1


#: prompts of 5 and 12 tokens bucket to 8 and 16, not multiples of the
#: smoke chunk (32): the recurrent scan.  20, 33, 40 and 70 bucket to 32,
#: 64 and 128: the chunked scan.
SSM_PROMPTS = [5, 20, 40, 70, 12, 33]
SSM_OUTPUTS = [8, 6, 10, 12, 5, 9]
SSM_ENGINE = dict(num_blocks=11, block_size=8, max_batch=3,
                  max_pages_per_seq=16)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"]
                         + ENCDEC_ARCHS)
def test_slot_engine_matches_reference(arch):
    jm, params, tm, tparams = case_pair(arch)

    def requests(cls):
        return [cls(id=i, arrival_time=0.01 * i, prompt_len=p, output_len=o)
                for i, (p, o) in enumerate(zip(SSM_PROMPTS, SSM_OUTPUTS))]

    jreqs = requests(JaxRequest)
    je = jeng.ServingEngine(jm, params, jeng.EngineConfig(**SSM_ENGINE))
    for r in jreqs:
        je.add_request(r)
    je.run()
    treqs = requests(Request)
    te = teng.ServingEngine(tm, tparams, teng.EngineConfig(**SSM_ENGINE),
                            device="cpu")
    for r in treqs:
        te.add_request(r)
    te.run()

    assert not te.paged
    assert len(te.finished) == len(treqs) == len(je.finished)
    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    assert [r.preempt_count for r in treqs] == \
        [r.preempt_count for r in jreqs]
    assert te.tokens_by_req == je.tokens_by_req
    assert len(te.records) == len(je.records)
    for t, j in zip(te.records, je.records):
        assert t.kind == j.kind
        assert t.batch_ids == j.batch_ids
        assert dataclasses.asdict(t.mix) == dataclasses.asdict(j.mix)
    assert set(te.cache) == set(je.cache)
    for key in sorted(set(te.cache) - {"len"}):
        np.testing.assert_allclose(te.cache[key].numpy(),
                                   np.asarray(je.cache[key]),
                                   rtol=1e-5, atol=1e-5)
    assert te.cache["len"].tolist() == np.asarray(je.cache["len"]).tolist()
    assert sorted(te.free_slots) == list(range(SSM_ENGINE["max_batch"]))
    if arch == "zamba2-2.7b":
        assert set(te.cache) == {"conv", "ssd", "k", "v", "len"}
    if arch in ENCDEC_ARCHS:
        assert set(te.cache) == {"k", "v", "xk", "xv", "len"}
        for r in treqs:
            want = np.asarray(je._enc_embeds(r))
            got = te._enc_embeds(r)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want)


def test_slot_path_refuses_unported_families():
    """Every family of the registry is served now; the guard still
    refuses one that no config uses (set past ``ArchConfig``'s own check
    of the name)."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"))
    object.__setattr__(cfg, "family", "unregistered")
    model = tzoo.Model(cfg=cfg,
                       plan=tzoo.build(get_smoke_config("mamba2-130m")).plan)
    with pytest.raises(NotImplementedError, match="slot-cache"):
        teng.ServingEngine(model, {}, teng.EngineConfig(), device="cpu")
