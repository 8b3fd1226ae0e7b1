"""The port's simulator reproduces the reference's results exactly.

``repro_torch.core`` holds copies of the reference's simulator modules
(tests/test_torch_copies.py holds their text to the reference).  This
file holds their behaviour: each case is a plain description of a
``SimSpec`` (dicts, strings and numbers), built into a spec inside each
package by ``_build`` and run by both.  The simulation is a
deterministic event simulation whose randomness comes from seeded
``random.Random`` streams, so the two runs must agree with tolerance 0:
every float is compared with ``==`` (NaN equal to NaN) in
``Results.summary()``, ``sim_time`` and, per request, (id,
arrival_time, t_first_token, t_finish, preempt_count, worker_id); the
observability case also compares ``time_breakdown()``, ``explain()``,
the Chrome trace JSON and the time-series rows.

The cases are built from the reference's own test specs
(tests/test_simulator.py, test_kv_hierarchy.py, test_tenancy.py,
test_spec_decode.py, test_autoscale.py, test_chaos.py,
test_observability.py, test_parallelism.py, test_hetero_fleet.py,
test_prefix_routing.py) and the validation protocol
(benchmarks/validation.py), at about 150 requests each.  Beside them:
the two ``launch.simulate`` CLIs write equal JSON, and
``explore.run_sweep`` gives equal rows.
"""
import functools
import importlib
import json
import math
import multiprocessing
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# one description, built in either package
# ---------------------------------------------------------------------------
def _worker(pkg, d):
    """``WorkerSpec``; ``mem_cap_tokens`` sizes ``mem_cap_override`` as the
    observability tests' undersized pool does: the model's parameters
    plus that many tokens of KV, over 0.9."""
    d = dict(d)
    tokens = d.pop("mem_cap_tokens", None)
    if tokens is not None:
        ops = _mod(pkg, "core.costmodel.operators")
        arch = d.get("arch", "llama2-7b")
        cfg = _mod(pkg, "configs").get_config(arch)
        d["mem_cap_override"] = (ops.param_bytes(cfg, 2) + tokens
                                 * ops.kv_bytes_per_token(cfg, 2)) / 0.9
    return _mod(pkg, "core.simulator").WorkerSpec(**d)


def _workload(pkg, d):
    return _mod(pkg, "core.workload").WorkloadSpec(**d)


def _build(pkg, desc):
    """The ``SimSpec`` that ``desc`` describes, from ``pkg``'s classes."""
    sim = _mod(pkg, "core.simulator")
    kw = {k: v for k, v in desc.items() if not k.startswith("_")}
    if isinstance(kw.get("arch"), dict):
        kw["arch"] = _mod(pkg, "configs").get_smoke_config(
            kw["arch"]["smoke"])
    if "workers" in kw:
        kw["workers"] = [_worker(pkg, w) for w in kw["workers"]]
    if "workload" in kw:
        kw["workload"] = _workload(pkg, kw["workload"])
    if "pool" in kw:
        kw["pool"] = _mod(pkg, "core.mem.memory_pool").PoolConfig(
            **kw["pool"])
    if "remote_kv" in kw:
        kw["remote_kv"] = _mod(pkg, "core.mem.remote_store").RemoteKVSpec(
            **kw["remote_kv"])
    faults = _mod(pkg, "core.faults")
    if "faults" in kw:
        kw["faults"] = [faults.FaultSpec(**f) for f in kw["faults"]]
    if "chaos" in kw:
        chaos = dict(kw["chaos"])
        chaos["processes"] = tuple(faults.FaultProcess(**p)
                                   for p in chaos.get("processes", ()))
        kw["chaos"] = faults.ChaosSpec(**chaos)
    if "tenants" in kw:
        ten = _mod(pkg, "core.tenancy")
        kw["tenants"] = [ten.TenantSpec(t["tenant_id"],
                                        ten.TenantTier(**t["tier"]),
                                        _workload(pkg, t["workload"]))
                         for t in kw["tenants"]]
    if "spec_decode" in kw:
        sd = _mod(pkg, "core.specdecode")
        d = dict(kw["spec_decode"])
        d["acceptance"] = sd.AcceptanceModel(**d["acceptance"])
        kw["spec_decode"] = sd.SpecDecodeSpec(**d)
    if "parallel" in kw:
        kw["parallel"] = _mod(pkg, "core.costmodel.hardware").ParallelSpec(
            **kw["parallel"])
    if "obs" in kw:
        kw["obs"] = _mod(pkg, "obs").ObsSpec(**kw["obs"])
    if "autoscale" in kw:
        kw["autoscale"] = _mod(pkg, "core.autoscale").AutoscaleSpec(
            **kw["autoscale"])
    if "backend_samples" in kw:
        mix = _mod(pkg, "core.costmodel.operators").BatchMix
        kw["backend_samples"] = [(mix.from_batch(prefill, decode), wall)
                                 for (prefill, decode), wall
                                 in kw["backend_samples"]]
    return sim.SimSpec(**kw)


def _run(pkg, desc):
    simulation = _mod(pkg, "core.simulator").Simulation(_build(pkg, desc))
    if "_pages" in desc:
        # the validation protocol sizes the worker's pool as the engine's
        # (benchmarks/validation.py:48-55)
        mem = _mod(pkg, "core.mem.block_manager")
        simulation.workers[0].mem = mem.BlockManager(mem.MemoryConfig(
            **desc["_pages"]))
    return simulation.run()


def _outcome(res, obs):
    out = {"summary": res.summary(ttft_slo=2.0, mtpot_slo=0.2),
           "sim_time": res.sim_time,
           "requests": [(r.id, r.arrival_time, r.t_first_token, r.t_finish,
                         r.preempt_count, r.worker_id)
                        for r in res.requests]}
    if obs:
        out.update(time_breakdown=res.time_breakdown(),
                   explain=res.explain(), trace=res.trace.to_json(),
                   timeseries=res.timeseries.rows())
    return out


def _differences(a, b, path="$"):
    """Where ``a`` and ``b`` differ, floats compared exactly (NaN equal
    to NaN); an empty list when they are the same."""
    if isinstance(a, float) and isinstance(b, float):
        same = a == b or (math.isnan(a) and math.isnan(b))
        return [] if same else [f"{path}: {a!r} != {b!r}"]
    if type(a) is not type(b):
        return [f"{path}: {type(a).__name__} != {type(b).__name__}"]
    if isinstance(a, dict):
        if list(a) != list(b):
            return [f"{path}: keys {list(a)} != {list(b)}"]
        return [d for k in a for d in _differences(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differences(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def _wl(n=150, qps=8.0, seed=0, **kw):
    return dict(num_requests=n, qps=qps, seed=seed, **kw)


A100 = {"hw": "A100"}
SMALL_POOL = {"hw": "A100", "gpu_mem_util": 0.25}
#: (batch, wall) samples for the validation protocol's tabular fit: a
#: batch is its prefill chunks [(chunk, context before)] and its decode
#: contexts; the walls are affine in the tokens plus a little curvature
_CAL = [(([(c, 0)] * p, [c + i for i in range(d)]),
         1e-3 + 2e-6 * c * p + 4e-5 * d + 1e-9 * (c * p) ** 2)
        for c, p, d in [(16, 1, 0), (32, 1, 3), (64, 2, 1), (8, 0, 8),
                        (24, 1, 7), (48, 0, 5), (40, 2, 2), (56, 1, 6),
                        (12, 3, 0), (0, 0, 4)]]

CASES = {
    "continuous": dict(arch="llama2-7b", workers=[A100],
                       workload=_wl(), local_policy="continuous",
                       max_batch=64),
    "static": dict(arch="llama2-7b", workers=[A100], workload=_wl(),
                   local_policy="static", max_batch=16),
    "chunked_prefill": dict(arch="llama2-7b", workers=[A100],
                            workload=_wl(qps=12.0), chunked_prefill=True,
                            prefill_chunk=256, max_batched_tokens=512,
                            max_batch=64),
    "disaggregated": dict(arch="llama2-7b",
                          workers=[{"role": "prefill"}, {"role": "decode"},
                                   {"role": "decode"}],
                          global_policy="disagg", workload=_wl(qps=10.0)),
    "preempt_recompute": dict(
        arch="llama2-7b",
        workers=[{"hw": "A100", "mem_cap_tokens": 10 * 1024 + 4 * 192}],
        workload=_wl(qps=0.0, lengths="fixed", prompt_len=1024,
                     output_len=192),
        preemption_mode="recompute"),
    "preempt_swap": dict(
        arch="llama2-7b",
        workers=[{"hw": "A100", "mem_cap_tokens": 10 * 1024 + 4 * 192}],
        workload=_wl(qps=0.0, lengths="fixed", prompt_len=1024,
                     output_len=192),
        preemption_mode="swap"),
    "prefix_sharing": dict(
        arch="llama2-7b", workers=[SMALL_POOL],
        workload=_wl(qps=20.0, seed=5, lengths="fixed", prompt_len=32,
                     output_len=16, shared_prefix_len=500,
                     shared_prefix_groups=3),
        max_batch=32, prefix_sharing=True),
    "memory_pool": dict(arch="llama2-7b", workers=[A100, A100],
                        workload=_wl(qps=10.0, multi_round_frac=0.5),
                        pool={}),
    "remote_kv": dict(
        arch="llama2-7b", workers=[{"hw": "A100", "gpu_mem_util": 0.3}] * 3,
        workload=_wl(qps=25.0, seed=5, lengths="fixed", prompt_len=64,
                     output_len=32, shared_prefix_len=512,
                     shared_prefix_groups=6),
        prefix_sharing=True, global_policy="prefix_affinity",
        global_policy_kw={"overload_factor": 1.2}, remote_kv={}),
    "validation_protocol": dict(
        arch={"smoke": "llama2-7b"}, workers=[{"hw": "CPU"}],
        workload=_wl(qps=40.0, seed=7, max_prompt_len=64,
                     max_output_len=24),
        local_policy="continuous", max_batch=8, backend="tabular",
        backend_samples=_CAL, block_size=8,
        _pages=dict(num_blocks=160, block_size=8, kv_bytes_per_token=1.0)),
    "faults_and_chaos": dict(
        arch="llama2-7b", workers=[{}, {}], workload=_wl(),
        faults=[{"time": 3.0, "worker": 0, "kind": "fail",
                 "duration": 2.0},
                {"time": 6.0, "worker": 1, "kind": "degrade",
                 "factor": 3.0, "duration": 2.0}],
        chaos={"processes": [{"worker": 0, "mtbf": 6.0, "mttr": 1.0,
                              "seed": 7},
                             {"worker": 1, "mtbf": 9.0, "mttr": 1.0,
                              "seed": 7}],
               "reload_time": 2.0}),
    "tenants_admission": dict(
        arch="llama2-7b", workers=[A100], global_policy="wfq",
        max_batch=64,
        tenants=[{"tenant_id": "gold",
                  "tier": {"name": "gold", "weight": 3.0, "priority": 1},
                  "workload": _wl(75, 6.0, 1, lengths="fixed",
                                  prompt_len=128, output_len=64)},
                 {"tenant_id": "free",
                  "tier": {"name": "free", "rate_tokens_per_s": 1000.0,
                           "burst_tokens": 2000.0,
                           "admission_policy": "shed",
                           "shed_timeout": 1.0},
                  "workload": _wl(75, 12.0, 2, lengths="fixed",
                                  prompt_len=128, output_len=64)}]),
    "spec_decode": dict(
        arch="llama2-7b", workers=[A100], max_batch=8,
        max_batched_tokens=4096, workload=_wl(qps=4.0),
        spec_decode={"draft_arch": "qwen2-0.5b", "lookahead": 4,
                     "acceptance": {"rate": 0.8}}),
    "tp2_pp2": dict(arch="llama2-7b", workers=[{}, {}],
                    workload=_wl(qps=12.0),
                    parallel={"tp": 2, "pp": 2}, cluster="dgx-a100"),
    "hetero_fleet": dict(
        arch="granite-moe-1b-a400m",
        workers=[{"hw": "A100", "arch": "granite-moe-1b-a400m"},
                 {"hw": "L4", "arch": "mamba2-130m"},
                 {"hw": "V100", "arch": "mamba2-130m",
                  "hw_overrides": {"price": 0.3}}],
        global_policy="model_routed",
        tenants=[{"tenant_id": "moe", "tier": {},
                  "workload": _wl(75, 10.0, 11,
                                  model="granite-moe-1b-a400m")},
                 {"tenant_id": "ssm", "tier": {},
                  "workload": _wl(75, 10.0, 12, model="mamba2-130m")}]),
    "streaming": dict(arch="llama2-7b", workers=[A100, A100],
                      workload=_wl(qps=12.0), streaming=True,
                      retain_requests=False, streaming_slo=(2.0, 0.2)),
    "observability": dict(
        arch="llama2-7b", workers=[SMALL_POOL, SMALL_POOL],
        workload=_wl(qps=20.0, seed=3), max_batch=32, preemption_mode="swap",
        obs={"trace": True, "timeseries": True, "attribution": True,
             "sample_interval": 0.5}),
    "autoscale": dict(
        workers=[SMALL_POOL, SMALL_POOL],
        workload=_wl(qps=25.0, seed=9, arrival="diurnal",
                     diurnal_period=15.0, diurnal_amplitude=0.9),
        chaos={"reload_time": 0.5, "warmup_iters": 1,
               "warmup_factor": 2.0},
        autoscale={"policy": "threshold", "min_replicas": 1,
                   "max_replicas": 4, "interval": 1.0, "cooldown": 2.0,
                   "reload_time": 0.5, "warmup_iters": 1,
                   "warmup_factor": 2.0},
        obs={"attribution": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_simulator_matches_reference(name):
    desc = CASES[name]
    want, got = (_outcome(_run(pkg, desc), name == "observability")
                 for pkg in PACKAGES)
    assert want["requests"] or name == "streaming"
    diff = _differences(got, want)
    assert not diff, f"{len(diff)} differences, first: {diff[:5]}"


def test_cases_exercise_their_paths():
    """The cases reach what they are named for (read on the port)."""
    res = {n: _run("repro_torch", CASES[n]) for n in
           ("preempt_recompute", "preempt_swap", "prefix_sharing",
            "memory_pool", "remote_kv", "faults_and_chaos",
            "tenants_admission", "spec_decode", "hetero_fleet",
            "observability", "autoscale")}
    summary = {n: r.summary() for n, r in res.items()}
    assert summary["preempt_recompute"]["preempt_rate"] > 0
    assert summary["preempt_swap"]["swap_preempts"] > 0
    assert summary["observability"]["swap_preempts"] > 0
    assert summary["prefix_sharing"]["prefix_hit_rate"] > 0
    assert summary["memory_pool"]["pool_hits"] > 0
    assert res["remote_kv"].routing_summary()["fetches"] > 0
    kinds = {e.kind for e in res["faults_and_chaos"].fault_events}
    assert {"fail", "recover", "slowdown"} <= kinds
    assert summary["tenants_admission"]["n_rejected"] > 0
    assert summary["spec_decode"]["spec_steps"] > 0
    assert set(res["hetero_fleet"].worker_models.values()) == \
        {"granite-moe-1b-a400m", "mamba2-130m"}
    assert res["autoscale"].scale_events


# ---------------------------------------------------------------------------
# the CLI and the sweep
# ---------------------------------------------------------------------------
def test_simulate_cli_writes_equal_json(tmp_path):
    """Both ``launch.simulate`` CLIs, same arguments, 200 requests; the
    ``wall_time_s`` they add to the summary is the host's time."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for pkg in PACKAGES:
        path = tmp_path / f"{pkg}.json"
        subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.simulate", "--requests",
             "200", "--qps", "10", "--workers", "2", "--memory-pool",
             "--multi-round-frac", "0.3", "--fail-worker", "1",
             "--fail-time", "5", "--seed", "3", "--out", str(path)],
            env=env, check=True, capture_output=True, timeout=120)
        out[pkg] = json.loads(path.read_text())
        assert out[pkg].pop("wall_time_s") > 0
    assert out["repro"]["n_finished"] == 200
    assert not _differences(out["repro_torch"], out["repro"])


def _sweep_builder(pkg, point):
    """Module level, so the sweep's worker process can unpickle it."""
    return _build(pkg, dict(arch="llama2-7b", workers=[{"hw": point["hw"]}],
                            workload=_wl(40, 8.0, 1),
                            max_batch=point["max_batch"]))


def test_sweep_rows_match_reference(tmp_path, monkeypatch):
    rows = {}
    for pkg in PACKAGES:
        # a spawned worker, the start method run_sweep prefers: a test
        # worker may hold torch's or jax's threads, which fork would copy
        monkeypatch.setattr(_mod(pkg, "explore.sweep"), "_mp_context",
                            lambda: multiprocessing.get_context("spawn"))
        explore = _mod(pkg, "explore")
        sweep = explore.SweepSpec(
            name="parity", builder=functools.partial(_sweep_builder, pkg),
            axes={"hw": ["A100", "L4"], "max_batch": [8, 64]})
        result = explore.run_sweep(sweep, str(tmp_path / pkg), processes=1)
        assert result.n_simulated == 4
        rows[pkg] = (result.rows, result.frontier)
    assert not _differences(rows["repro_torch"], rows["repro"])
