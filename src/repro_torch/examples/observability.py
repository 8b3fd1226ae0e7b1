"""Observability demo: trace a memory-pressured TP=2 cluster.

Runs a mixed prefill/decode workload on two tensor-parallel A100
workers whose KV pool is deliberately undersized, so decode growth
forces swap preemptions (host offload) alongside normal batching.
With ``ObsSpec.full()`` enabled the run exports:

* ``results/obs/example_trace.json`` — Chrome trace-event JSON; open
  it in https://ui.perfetto.dev or ``chrome://tracing`` to see
  per-request lifecycle spans and per-worker iteration slices.
* ``results/obs/example_timeseries.csv`` — queue depth, batch size,
  KV utilization, tokens/s ... sampled at a fixed sim-time interval.

and prints the latency-attribution table (``Results.explain()``)
decomposing TTFT and TPOT into components.

    PYTHONPATH=src python -m repro_torch.examples.observability
"""
import json
import os

from repro_torch.configs import get_config
from repro_torch.core import SimSpec, WorkerSpec, simulate
from repro_torch.core.costmodel.operators import (kv_bytes_per_token,
                                                  param_bytes)
from repro_torch.core.workload import WorkloadSpec
from repro_torch.obs import ObsSpec, validate_chrome_trace

OUT_DIR = os.path.join("results", "obs")


def build_spec() -> SimSpec:
    # KV pool sized for ~10 prompts plus a little decode headroom:
    # admission over-commits and decode growth swaps requests to host
    # (the benchmarks/kv_hierarchy.py pressure recipe, on 2 workers).
    # Both params and KV shard across tp=2, so size the cap from the
    # per-shard byte counts or the pool comes out 2x too roomy.
    cfg, tp = get_config("llama2-7b"), 2
    kvt = kv_bytes_per_token(cfg, 2, tp)
    ctx, out = 1024, 192
    kv_budget = (10 * ctx + 4 * out) * kvt
    cap = (param_bytes(cfg, 2, tp) + kv_budget) / 0.9
    wl = WorkloadSpec(num_requests=64, qps=0.0, seed=0, lengths="fixed",
                      prompt_len=ctx, output_len=out)
    return SimSpec(
        arch="llama2-7b",
        workers=[WorkerSpec(hw="A100", tp=tp, mem_cap_override=cap)
                 for _ in range(2)],
        workload=wl,
        local_policy="continuous",
        preemption_mode="swap",
        obs=ObsSpec.full(sample_interval=0.5))


def main():
    res = simulate(build_spec())
    os.makedirs(OUT_DIR, exist_ok=True)

    trace_path = os.path.join(OUT_DIR, "example_trace.json")
    ts_path = os.path.join(OUT_DIR, "example_timeseries.csv")
    res.export_trace(trace_path)
    res.export_timeseries(ts_path)

    with open(trace_path) as f:
        data = json.load(f)
    errors = validate_chrome_trace(data)
    assert not errors, errors

    mem = res.memory_summary()
    print(f"simulated {len(res.finished)} requests in "
          f"{res.wall_time:.2f}s wall ({res.sim_time:.1f}s simulated), "
          f"{mem['swap_preempts']} swap preemptions")
    print(f"trace:      {trace_path}  "
          f"({len(data['traceEvents'])} events, validated)")
    print(f"timeseries: {ts_path}  "
          f"({len(res.timeseries.rows())} rows)")
    print("\nlatency attribution (Results.explain()):\n")
    print(res.explain())


if __name__ == "__main__":
    main()
