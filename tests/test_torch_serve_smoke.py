"""The port's serve-then-simulate example
(``repro_torch.examples.serve_smoke``) against the reference's
``examples/serve_smoke.py``.

The reference's values are read from its source with ``ast``, without
running it, and the port's module constants must equal them.  The
reference's loop runs here as its own tests run it: JAX on the CPU, on
the default routes, with the example's weights (``jax.random.key(0)``),
which ``convert.params_from_jax`` loads into the port.  The port's
``serve(..., device="cpu")`` must reproduce the reference engine exactly:
in fp32 the greedy tokens of all 24 requests and every iteration
record's kind, batch and ``BatchMix``; in the example's own bf16 the
records (a request stops at its output length, so the records do not
depend on token values; bf16 greedy tokens may differ between the two
packages).  Fed the reference engine's records, the port's ``simulate``
gives what the reference's ``Simulation``, built as the example builds
it, gives, with tolerance 0.
"""
import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.mem import block_manager as jbm  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costmodel.operators import BatchMix  # noqa: E402
from repro_torch.core.mem.block_manager import MemoryConfig  # noqa: E402
from repro_torch.core.simulator import WorkerSpec  # noqa: E402
from repro_torch.core.workload import WorkloadSpec  # noqa: E402
from repro_torch.examples import serve_smoke as ex  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples" / "serve_smoke.py"
#: the example's iterations on the CPU, both packages and dtypes
ITERATIONS = 64


def _calls(name):
    """The literal keyword (and positional) arguments of every call of
    ``name`` in the reference example's source."""
    tree = ast.parse(REFERENCE.read_text(), filename=str(REFERENCE))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            called = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if called == name:
                out.append((
                    [ast.literal_eval(a) for a in node.args
                     if isinstance(a, ast.Constant)],
                    {k.arg: ast.literal_eval(k.value) for k in node.keywords
                     if isinstance(k.value, ast.Constant)}))
    return out


def _only(name):
    calls = _calls(name)
    assert len(calls) == 1, (name, calls)
    return calls[0]


def _print_formats():
    """A regex per ``print`` of the reference's ``main``, in order: its
    f-string's text, each formatted value read as any text."""
    tree = ast.parse(REFERENCE.read_text(), filename=str(REFERENCE))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = []
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "print":
            (arg,) = node.args
            out.append((node.lineno, "".join(
                re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                for v in arg.values)))
    return [fmt for _, fmt in sorted(out)]


# -- the constants -----------------------------------------------------------
@pytest.mark.parametrize("name,cls,const", [
    ("WorkloadSpec", WorkloadSpec, "WORKLOAD"),
    ("EngineConfig", EngineConfig, "ENGINE"),
    ("WorkerSpec", WorkerSpec, "WORKER"),
    ("MemoryConfig", MemoryConfig, "SIM_MEMORY"),
])
def test_constants_are_the_references(name, cls, const):
    _, kw = _only(name)
    assert getattr(ex, const) == cls(**kw)


def test_simulation_and_model_values_are_the_references():
    _, sim = _only("SimSpec")
    assert {"local_policy": ex.LOCAL_POLICY, "max_batch": ex.SIM_MAX_BATCH,
            "backend": ex.BACKEND, "block_size": ex.SIM_BLOCK_SIZE} == \
        {k: sim[k] for k in ("local_policy", "max_batch", "backend",
                             "block_size")}
    assert _only("get_smoke_config")[0] == [ex.ARCH]
    assert _only("key")[0] == [ex.SEED]


# -- the two packages' runs --------------------------------------------------
def _reference_run(dtype):
    """The reference example's engine at the smoke config (``dtype`` in
    place of the config's, if given): model, weights, engine, requests,
    real results, built from the values in its source."""
    cfg = jax_smoke(_only("get_smoke_config")[0][0])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = jzoo.build(cfg)
    params = jzoo.init_params(model, jax.random.key(_only("key")[0][0]))
    reqs = jwl.generate(jwl.WorkloadSpec(**_only("WorkloadSpec")[1]))
    eng = jeng.ServingEngine(model, params,
                             jeng.EngineConfig(**_only("EngineConfig")[1]))
    for r in reqs:
        eng.add_request(r)
    eng.run()
    return {"cfg": cfg, "params": params, "eng": eng, "reqs": reqs,
            "real": jmetrics.Results(requests=reqs, sim_time=eng.clock)}


def _port_run(ref):
    """The port's ``serve`` on the CPU with the reference's weights."""
    model = tzoo.build(dataclasses.replace(get_smoke_config(ex.ARCH),
                                           dtype=ref["cfg"].dtype))
    params = params_from_jax(model, jax.tree.map(np.asarray, ref["params"]),
                             device="cpu")
    eng, reqs, real = ex.serve(model, params, device="cpu")
    return {"eng": eng, "reqs": reqs, "real": real}


@pytest.fixture(scope="module")
def runs():
    """dtype -> (reference run, port run), each made once: the fp32 smoke
    config, and the example's own (bf16)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            ref = _reference_run(dtype)
            cache[dtype] = ref, _port_run(ref)
        return cache[dtype]

    return get


def _records(eng):
    return [(r.kind, r.batch_ids, dataclasses.asdict(r.mix))
            for r in eng.records]


@pytest.mark.parametrize("dtype", ["float32", None], ids=["fp32", "bf16"])
def test_engine_reproduces_the_reference(runs, dtype):
    """Every request finishes; every record's kind, batch and mix are the
    reference's; fp32 also the greedy tokens of every request."""
    ref, port = runs(dtype)
    assert get_smoke_config(ex.ARCH).dtype == "bfloat16"
    assert len(port["eng"].finished) == len(ref["eng"].finished) == \
        len(port["reqs"]) == 24
    assert len(port["eng"].records) == len(ref["eng"].records) == ITERATIONS
    assert _records(port["eng"]) == _records(ref["eng"])
    assert [(r.id, r.prompt_len, r.output_len) for r in port["reqs"]] == \
        [(r.id, r.prompt_len, r.output_len) for r in ref["reqs"]]
    if dtype == "float32":
        assert port["eng"].tokens_by_req == ref["eng"].tokens_by_req


@pytest.mark.parametrize("dtype", ["float32", None], ids=["fp32", "bf16"])
def test_simulate_equals_the_reference_simulation(runs, dtype):
    """The reference engine's records through the reference's
    ``Simulation``, built as the example builds it, and through the
    port's ``simulate``, their mixes converted field by field: equal
    finished counts, iterations, throughput and error, tolerance 0."""
    ref, _ = runs(dtype)
    samples = [(r.mix, r.wall) for r in ref["eng"].records]
    wl_kw = _only("WorkloadSpec")[1]
    _, sim_kw = _only("SimSpec")
    jspec = jsim.SimSpec(
        arch=ref["cfg"], workers=[jsim.WorkerSpec(**_only("WorkerSpec")[1])],
        workload=jwl.WorkloadSpec(**wl_kw),
        local_policy=sim_kw["local_policy"], max_batch=sim_kw["max_batch"],
        backend=sim_kw["backend"], backend_samples=samples,
        block_size=sim_kw["block_size"])
    jsimulation = jsim.Simulation(jspec)
    jsimulation.workers[0].mem = jbm.BlockManager(
        jbm.MemoryConfig(**_only("MemoryConfig")[1]))
    jres = jsimulation.run()
    real = ref["real"]
    jerr = abs(jres.throughput() - real.throughput()) / real.throughput()

    cfg = dataclasses.replace(get_smoke_config(ex.ARCH),
                              dtype=ref["cfg"].dtype)
    sim, res = ex.simulate(cfg, WorkloadSpec(**wl_kw), [
        (BatchMix(**dataclasses.asdict(m)), w) for m, w in samples])
    assert len(res.finished) == len(jres.finished) == 24
    assert sim.workers[0].iterations == jsimulation.workers[0].iterations \
        == ITERATIONS
    assert res.throughput() == jres.throughput()
    assert ex.throughput_error(res, real) == jerr
    assert np.isfinite(jerr)


def test_main_prints_the_references_lines(capsys):
    err = ex.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    formats = _print_formats()
    assert len(formats) == 4 and len(lines) == len(formats)
    for line, fmt in zip(lines, formats):
        assert re.fullmatch(fmt, line), (line, fmt)
    assert lines[0].startswith("real engine: 24 requests, 64 iterations")
    assert lines[2].startswith("simulator  : 24 requests, 64 iterations")
    assert np.isfinite(err)


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.main([])
