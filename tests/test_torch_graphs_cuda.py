"""The serving engine's CUDA graphs against its eager steps, on the card.

The tests need a CUDA card and skip without one.  This file imports no
JAX, so it runs where the card is:

    python -m pytest -q --noconftest tests/test_torch_graphs_cuda.py

Models at full width and head count, cut to two layers, random weights.
One engine runs its steps eagerly (``graphs=False``), the other as CUDA
graphs (the default on the card); both serve the same requests, with a
page pool small enough to force preemption.  They must agree exactly:
greedy tokens, every iteration record's kind, batch and ``BatchMix``,
the kernels' launch counts (the graphs add their launches at every
replay) and the persistent state after the run (the page store but its
trash page, which takes colliding writes in no fixed order; the slot
cache).  llama2-7b runs both attention paths (the paged and flash
kernels inside the graphs on ``pallas``); opt-13b the kernel path
(learned positions, LayerNorm, GELU, MLP biases), once with its table of
2048 positions and preemption forced, and once with the table cut to 64
rows and decodes past it, so the clamped position read runs inside the
decode graph; granite-moe-3b the kernel path (the paged kernel at
group 3, head_dim 64) on each MoE route, so the router's top-k, the
expert products and (``sort``) the argsort and grouped GEMM run inside
the prefill and decode graphs; mamba2-130m the slot path with
buckets of 256 and 512, so the SSD scan's kernels run inside the prefill
graphs; whisper-base at full width and depth (6 encoder and 6 decoder
layers, 1500 frames) the slot path on the kernel route, so each prefill
graph holds the encoder's non-causal flash launches and the decoder's
causal and cross-attention ones, and the slot cache's cross-attention
K/V (``xk``, ``xv``) must be identical too; zamba2-2.7b at full width
cut to 12 layers (two groups of 6 Mamba2 layers, each followed by the
shared block's 32 heads of 80) the slot path on the kernel route, so
each prefill graph holds flash at head_dim 80 and, at buckets of 256 and
512, the SSD scans, and every slot-cache array (``conv``, ``ssd``,
``k``, ``v``) must be identical; stablelm-3b (32 heads of 80) the paged
kernel path, so both kernels run at head_dim 80 inside the graphs.
``test_stale_tables_are_caught`` plants a fault (the decode step's
static block tables left unrefreshed before replay) and shows that the
same comparison catches it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models.common import RunSettings  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

LAYERS = 2
#: 10 pages of 16 tokens force two preemptions; buckets 32, 64 and 128
LLAMA_PROMPTS = [40, 100, 70, 20, 90, 60]
LLAMA_OUTPUTS = [20, 12, 25, 30, 10, 18]
LLAMA_ENGINE = dict(num_blocks=10, block_size=16, max_batch=4,
                    max_pages_per_seq=16)
#: opt-13b with its table cut to 64 positions: buckets 32 and 64 (the
#: prefill reads ``pos[:S]``), decodes to context 80, 15 of 24 pages (no
#: preemption: a recompute would prefill past the table)
OPT_SHORT_POS = 64
OPT_PROMPTS = [40, 60, 30]
OPT_OUTPUTS = [30, 20, 40]
OPT_ENGINE = dict(num_blocks=24, block_size=16, max_batch=4,
                  max_pages_per_seq=16)
#: 24 pages force a preemption; buckets 32, 64, 256 and 512 (the SSD
#: kernel takes 256 and 512, the recurrence the others)
MAMBA_PROMPTS = [300, 20, 200, 140, 60, 260]
MAMBA_OUTPUTS = [12, 20, 10, 16, 8, 14]
MAMBA_ENGINE = dict(num_blocks=24, block_size=16, max_batch=3,
                    max_pages_per_seq=32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, cuda, overrides=None, **settings):
    cfg = dataclasses.replace(get_config(arch),
                              **{"num_layers": LAYERS, **(overrides or {})})
    model = zoo.build(cfg, settings=RunSettings(**settings))
    return model, zoo.init_params(model, seed=0, device=cuda)


@pytest.fixture(scope="module")
def llama(cuda):
    return _model("llama2-7b", cuda, attn_impl="pallas")


@pytest.fixture(scope="module")
def mamba(cuda):
    return _model("mamba2-130m", cuda)


def _serve(model, params, ec, prompts, outputs, graphs, plant=None):
    eng = ServingEngine(model, params, ec, graphs=graphs)
    if plant is not None:
        plant(eng)
    reqs = [Request(id=i, arrival_time=0.01 * i, prompt_len=p, output_len=o)
            for i, (p, o) in enumerate(zip(prompts, outputs))]
    for r in reqs:
        eng.add_request(r)
    counts.reset()
    eng.run()
    torch.cuda.synchronize()
    assert len(eng.finished) == len(reqs)
    return eng, reqs, counts.snapshot()


def _differences(eager, graphed):
    """What differs between two served runs (``_serve``'s results)."""
    (e, e_reqs, e_launches), (g, g_reqs, g_launches) = eager, graphed
    out = []
    if g.tokens_by_req != e.tokens_by_req:
        out.append("tokens")
    if [(r.kind, r.batch_ids, dataclasses.asdict(r.mix)) for r in g.records] \
            != [(r.kind, r.batch_ids, dataclasses.asdict(r.mix))
                for r in e.records]:
        out.append("records")
    if [r.preempt_count for r in g_reqs] != [r.preempt_count for r in e_reqs]:
        out.append("preemptions")
    if g_launches != e_launches:
        out.append("launches")
    if g.paged:
        n = g.trash_page
        state = {k: (g.pages[k][:, :n], e.pages[k][:, :n]) for k in ("k", "v")}
    else:
        state = {k: (g.cache[k], e.cache[k]) for k in g.cache}
    out += [k for k, (a, b) in state.items() if not torch.equal(a, b)]
    return out


@pytest.mark.parametrize("path", ["gather", "pallas"])
def test_graphed_engine_matches_eager(llama, path):
    model, params = llama
    if path == "gather":
        model = model.with_settings(attn_impl="auto")
    ec = EngineConfig(attn_path=path, **LLAMA_ENGINE)
    eager = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, False)
    graphed = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, None)
    g = graphed[0]
    assert eager[0].graphs is None and g.graphs is not None
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    # one graph per bucket and one for decode, each replayed
    assert set(g.graphs.graphs) == {("decode",), ("prefill", 32),
                                    ("prefill", 64), ("prefill", 128)}
    assert g.graphs.graphs[("decode",)].replays > 0
    launches = graphed[2]
    if path == "pallas":
        decodes = sum(r.kind == "decode" for r in g.records)
        assert launches.get("paged_attention", 0) == LAYERS * decodes
        assert launches.get("flash_attention", 0) > 0
        # the decode graph took its merge counters with it, and every
        # replay left them zero
        tickets = g.graphs.graphs[("decode",)].tickets
        assert tickets is not None and int(tickets.abs().sum()) == 0
    else:
        assert launches.get("paged_attention", 0) == 0
        assert launches.get("flash_attention", 0) == 0


@pytest.mark.parametrize("table", ["full", "short"])
def test_graphed_opt_engine_matches_eager(cuda, table):
    short = table == "short"
    model, params = _model("opt-13b", cuda,
                           {"max_seq_len": OPT_SHORT_POS} if short else None,
                           attn_impl="pallas")
    assert params["pos"].shape[0] == (OPT_SHORT_POS if short else 2048)
    prompts, outputs, engine = (OPT_PROMPTS, OPT_OUTPUTS, OPT_ENGINE) \
        if short else (LLAMA_PROMPTS, LLAMA_OUTPUTS, LLAMA_ENGINE)
    ec = EngineConfig(attn_path="pallas", **engine)
    eager = _serve(model, params, ec, prompts, outputs, False)
    graphed = _serve(model, params, ec, prompts, outputs, None)
    g, reqs = graphed[0], graphed[1]
    assert _differences(eager, graphed) == []
    if short:
        assert sum(r.preempt_count for r in reqs) == 0
        assert max(r.context_len for r in reqs) > OPT_SHORT_POS + 8
    else:
        assert sum(r.preempt_count for r in reqs) > 0, \
            "no preemption forced"
    assert g.graphs.graphs[("decode",)].replays > 0
    decodes = sum(r.kind == "decode" for r in g.records)
    assert graphed[2].get("paged_attention", 0) == LAYERS * decodes
    assert graphed[2].get("flash_attention", 0) > 0


@pytest.mark.parametrize("moe_impl", ["dense_onehot", "sort"])
def test_graphed_moe_engine_matches_eager(cuda, moe_impl):
    model, params = _model("granite-moe-3b-a800m", cuda, attn_impl="pallas",
                           moe_impl=moe_impl)
    ec = EngineConfig(attn_path="pallas", **LLAMA_ENGINE)
    eager = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, False)
    graphed = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, None)
    g = graphed[0]
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    assert g.graphs.graphs[("decode",)].replays > 0
    decodes = sum(r.kind == "decode" for r in g.records)
    assert graphed[2].get("paged_attention", 0) == LAYERS * decodes
    assert graphed[2].get("flash_attention", 0) > 0


def test_graphed_slot_engine_matches_eager(mamba):
    model, params = mamba
    ec = EngineConfig(**MAMBA_ENGINE)
    eager = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, False)
    graphed = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, None)
    g = graphed[0]
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    assert {("prefill", 256), ("prefill", 512)} <= set(g.graphs.graphs)
    # the SSD scan ran inside the prefill graphs, once a layer a prefill
    # whose bucket takes it
    assert graphed[2]["ssd_scan"] > 0
    assert graphed[2]["ssd_scan"] % LAYERS == 0
    assert g.cache["len"].tolist() == g.slot_len.tolist()


def test_graphed_whisper_engine_matches_eager(cuda):
    cfg = get_config("whisper-base")
    model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    params = zoo.init_params(model, seed=0, device=cuda)
    ec = EngineConfig(**MAMBA_ENGINE)
    eager = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, False)
    graphed = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, None)
    g = graphed[0]
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    assert set(g.cache) == {"k", "v", "xk", "xv", "len"}
    assert g.graphs.graphs[("decode",)].replays > 0
    # flash once a layer in the encoder, twice a layer in the decoder,
    # every prefill; nothing else launched
    prefills = sum(len(r.batch_ids) for r in g.records
                   if r.kind == "prefill")
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    assert graphed[2].get("flash_attention", 0) == per_prefill * prefills
    assert graphed[2].get(("flash_attention", cfg.enc_seq_len), 0) == \
        cfg.n_enc_layers * prefills
    assert graphed[2].get("paged_attention", 0) == 0
    assert g.cache["len"].tolist() == g.slot_len.tolist()


def test_graphed_stablelm_engine_matches_eager(cuda):
    """head_dim 80 on the paged path: the paged kernel (16 lanes a row)
    in the decode graph, flash (D-128 tiles) in the prefill graphs."""
    model, params = _model("stablelm-3b", cuda, attn_impl="pallas")
    assert model.cfg.head_dim == 80
    ec = EngineConfig(attn_path="pallas", **LLAMA_ENGINE)
    eager = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, False)
    graphed = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, None)
    g = graphed[0]
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    decodes = sum(r.kind == "decode" for r in g.records)
    prefills = sum(len(r.batch_ids) for r in g.records
                   if r.kind == "prefill")
    assert graphed[2].get("paged_attention", 0) == LAYERS * decodes
    assert graphed[2].get("flash_attention", 0) == LAYERS * prefills


#: zamba2-2.7b cut to two groups of its 6 Mamba2 layers
HYBRID_LAYERS = 12


def test_graphed_hybrid_engine_matches_eager(cuda):
    model, params = _model("zamba2-2.7b", cuda,
                           {"num_layers": HYBRID_LAYERS}, attn_impl="pallas")
    groups = HYBRID_LAYERS // model.cfg.attn_period
    assert groups == 2 and model.cfg.head_dim == 80
    ec = EngineConfig(**MAMBA_ENGINE)
    eager = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, False)
    graphed = _serve(model, params, ec, MAMBA_PROMPTS, MAMBA_OUTPUTS, None)
    g = graphed[0]
    assert sum(r.preempt_count for r in graphed[1]) > 0, \
        "no preemption forced"
    assert _differences(eager, graphed) == []
    assert set(g.cache) == {"conv", "ssd", "k", "v", "len"}
    assert {("prefill", 256), ("prefill", 512)} <= set(g.graphs.graphs)
    assert g.graphs.graphs[("decode",)].replays > 0
    # flash once an application of the shared block, every prefill; the
    # SSD scan once a layer, every prefill whose bucket is a multiple of
    # the chunk; no paged launch (the decode attention is the plain one)
    buckets = [ServingEngine._bucket(r.prompt_len) for r in graphed[1]]
    prefills = sum(len(r.batch_ids) for r in g.records
                   if r.kind == "prefill")
    assert graphed[2].get("flash_attention", 0) == groups * prefills
    assert graphed[2]["ssd_scan"] > 0
    assert graphed[2]["ssd_scan"] % HYBRID_LAYERS == 0
    assert any(b % model.cfg.ssm.chunk_size for b in buckets)
    assert graphed[2].get("paged_attention", 0) == 0
    assert g.cache["len"].tolist() == g.slot_len.tolist()


def test_stale_tables_are_caught(llama):
    """Planted fault: once the decode graph exists, the engine stops
    refilling its static block tables, so replays read the first decode
    step's tables.  The comparison must see it."""
    model, params = llama
    ec = EngineConfig(attn_path="pallas", **LLAMA_ENGINE)

    def stale_tables(eng):
        upload = eng._upload

        def skip_tables(dst, host):
            if dst is eng.pages["tables"] and ("decode",) in eng.graphs.graphs:
                return
            upload(dst, host)

        eng._upload = skip_tables

    eager = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, False)
    stale = _serve(model, params, ec, LLAMA_PROMPTS, LLAMA_OUTPUTS, None,
                   plant=stale_tables)
    found = _differences(eager, stale)
    print(f"stale tables: {found} differ")
    assert found, "a decode on stale block tables went unnoticed"


def test_failed_capture_raises(llama, monkeypatch):
    """A step that fails under capture raises out of the engine; the
    engine does not go back to the eager step."""
    model, params = llama
    decode = paged_model.paged_decode_step

    def refuses_capture(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted capture failure")
        return decode(*a, **kw)

    monkeypatch.setattr(paged_model, "paged_decode_step", refuses_capture)
    eng = ServingEngine(model, params,
                        EngineConfig(attn_path="pallas", **LLAMA_ENGINE))
    eng.add_request(Request(id=0, arrival_time=0.0, prompt_len=20,
                            output_len=4))
    assert eng.step().kind == "prefill"
    with pytest.raises(RuntimeError, match="planted capture failure"):
        eng.step()
    assert ("decode",) not in eng.graphs.graphs
