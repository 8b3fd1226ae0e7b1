"""Quickstart: simulate an 8xA100 vLLM-style cluster in seconds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core import SimSpec, WorkerSpec, simulate
from repro_torch.core.workload import WorkloadSpec


def main():
    spec = SimSpec(
        arch="llama2-7b",
        workers=[WorkerSpec(hw="A100") for _ in range(8)],
        workload=WorkloadSpec(num_requests=5000, qps=60.0, seed=0),
        global_policy="least_loaded",
        local_policy="continuous",
        max_batch=256, max_batched_tokens=4096)
    res = simulate(spec)

    s = res.summary(ttft_slo=15.0, mtpot_slo=0.3)
    print("simulated", len(res.finished), "requests in",
          f"{res.wall_time:.2f}s wall ({res.sim_time:.1f}s simulated)")
    for k in ("throughput_rps", "latency_p50", "latency_p99",
              "goodput_rps", "preempt_rate"):
        print(f"  {k:16s} = {s[k]:.4f}")

    print("\nlatency CDF (P, seconds):")
    for lat, p in res.latency_cdf(10):
        print(f"  {p:4.1f}  {lat:8.3f}")


if __name__ == "__main__":
    main()
