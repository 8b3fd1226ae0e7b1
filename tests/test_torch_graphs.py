"""The engine's static-input steps on the CPU, against the reference.

On the card the port's engine runs its steps as CUDA graphs
(``repro_torch.serving.graphs``); the CPU runs the same steps eagerly,
on the same static inputs: tensors made once at construction and
refilled in place every step, with persistent state (the page store, the
slot cache) written in place.  Here the port's engine serves requests
whose decodes cross page boundaries, with preemption forced, on both
attention paths and on the slot path (mamba2-130m, and zamba2-2.7b on
the flash route), and must reproduce the JAX
engine's greedy tokens and iteration records exactly, while no static
input or persistent tensor is ever replaced (same storage before and
after the run), and the slot engine's host copy of its lengths matches
the card's after every step.  ``graphs=True`` on the CPU raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import graphs as step_graphs  # noqa: E402

#: prompts of 2-5 pages of 8 tokens, outputs crossing pages; 10 pages
#: force preemption
PROMPTS = [22, 9, 35, 14, 27]
OUTPUTS = [11, 17, 6, 13, 9]
ENGINE = dict(num_blocks=10, block_size=8, max_batch=3, max_pages_per_seq=8)
#: buckets 32 and 64 take the chunked scan at the smoke chunk (32), 8 and
#: 16 the recurrence
SSM_PROMPTS = [40, 6, 25, 12, 50]
SSM_OUTPUTS = [9, 14, 7, 12, 6]
SSM_ENGINE = dict(num_blocks=10, block_size=8, max_batch=3,
                  max_pages_per_seq=16)


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jmodel = jzoo.build(jcfg)
    params = jzoo.init_params(jmodel, jax.random.key(1))
    tmodel = tzoo.build(tcfg)
    tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jmodel, params, tmodel, tparams


def _requests(cls, prompts, outputs):
    return [cls(id=i, arrival_time=0.01 * i, prompt_len=p, output_len=o)
            for i, (p, o) in enumerate(zip(prompts, outputs))]


def _static_tensors(eng):
    """Every tensor a graph of the engine's steps would read or write in
    place."""
    out = [eng._tokens, eng._table_row, eng._prompt]
    out += list((eng.pages if eng.paged else eng.cache).values())
    return out


@pytest.mark.parametrize("path", ["gather", "pallas", "slot", "hybrid"])
def test_static_step_matches_reference(path):
    """``slot``: mamba2-130m; ``hybrid``: zamba2-2.7b on the slot path
    with the flash kernel's route in its prefills, as the card serves
    it."""
    slot = path in ("slot", "hybrid")
    arch = {"slot": "mamba2-130m", "hybrid": "zamba2-2.7b"}.get(
        path, "llama2-7b")
    prompts, outputs = (SSM_PROMPTS, SSM_OUTPUTS) if slot \
        else (PROMPTS, OUTPUTS)
    ecfg = SSM_ENGINE if slot else dict(attn_path=path, **ENGINE)
    jmodel, params, tmodel, tparams = _models(arch)
    if path in ("pallas", "hybrid"):
        jmodel = jmodel.with_settings(attn_impl="pallas", attn_block_q=8,
                                      attn_block_kv=8)
        tmodel = tmodel.with_settings(attn_impl="pallas")

    jreqs = _requests(JaxRequest, prompts, outputs)
    je = jeng.ServingEngine(jmodel, params, jeng.EngineConfig(**ecfg))
    for r in jreqs:
        je.add_request(r)
    je.run()

    treqs = _requests(Request, prompts, outputs)
    te = teng.ServingEngine(tmodel, tparams, teng.EngineConfig(**ecfg),
                            device="cpu")
    assert te.graphs is None
    static = [(t, t.data_ptr()) for t in _static_tensors(te)]
    for r in treqs:
        te.add_request(r)
    while te.has_work:
        assert te.step() is not None
        if not te.paged:
            assert te.cache["len"].tolist() == te.slot_len.tolist()

    assert sum(r.preempt_count for r in jreqs) > 0, "no preemption forced"
    assert [r.preempt_count for r in treqs] == \
        [r.preempt_count for r in jreqs]
    assert te.tokens_by_req == je.tokens_by_req
    assert [(r.kind, r.batch_ids, dataclasses.asdict(r.mix))
            for r in te.records] == \
        [(r.kind, r.batch_ids, dataclasses.asdict(r.mix))
         for r in je.records]
    assert all(t.data_ptr() == ptr for t, ptr in static)
    assert all(a is b for (a, _), b in zip(static, _static_tensors(te)))
    if not te.paged:
        assert te.cache["len"].tolist() == \
            np.asarray(je.cache["len"]).tolist()


def test_graphs_need_a_card():
    model = tzoo.build(get_smoke_config("mamba2-130m"))
    params = tzoo.init_params(model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        teng.ServingEngine(model, params, teng.EngineConfig(), device="cpu",
                           graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        step_graphs.StepGraphs("cpu")


def test_launch_counts_add_and_reset():
    """What a graph records at capture and adds at every replay."""
    counts.reset()
    assert counts.snapshot() == {}
    counts.count("paged_attention")
    counts.count("flash_attention", 512)
    assert counts.snapshot() == {"paged_attention": 1, "flash_attention": 1,
                                 ("flash_attention", 512): 1}
    replay = {"paged_attention": 32, "flash_attention": 4,
              ("flash_attention", 512): 4}
    for _ in range(3):
        counts.add(replay)
    assert counts.snapshot() == {"paged_attention": 97, "flash_attention": 13,
                                 ("flash_attention", 512): 13}
    counts.add(replay, -1)
    assert counts.get("paged_attention") == 65
    assert counts.get("ssd_scan") == 0
    counts.reset()
    assert counts.snapshot() == {} and counts.get("paged_attention") == 0
