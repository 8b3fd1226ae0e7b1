"""Multi-tenant QoS demo: three API tiers sharing one A100 cluster.

A free tier (rate-limited, sheddable), a pro tier and an enterprise
tier share two workers under weighted-fair queuing; the gateway
enforces each tier's token bucket and inflight cap, and the report
shows per-tenant latency, SLO attainment, goodput and fairness.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant
"""
from repro_torch.core import SimSpec, TenantSpec, WorkerSpec, simulate
from repro_torch.core.tenancy import ENTERPRISE, FREE, PRO
from repro_torch.core.workload import WorkloadSpec


def main():
    tenants = [
        TenantSpec("free", FREE,
                   WorkloadSpec(num_requests=300, qps=30.0, seed=0)),
        TenantSpec("pro", PRO,
                   WorkloadSpec(num_requests=200, qps=10.0, seed=1)),
        TenantSpec("enterprise", ENTERPRISE,
                   WorkloadSpec(num_requests=100, qps=4.0, seed=2)),
    ]
    spec = SimSpec(
        arch="llama2-7b",
        workers=[WorkerSpec(hw="A100") for _ in range(2)],
        global_policy="wfq",
        local_policy="continuous",
        max_batch=128, max_batched_tokens=4096,
        tenants=tenants)
    res = simulate(spec)

    print(f"simulated {len(res.requests)} requests from "
          f"{len(tenants)} tenants in {res.wall_time:.2f}s wall "
          f"({res.sim_time:.1f}s simulated)")
    cols = ("n_finished", "n_rejected", "token_tps", "ttft_p50",
            "ttft_p99", "latency_p99", "queue_delay_mean",
            "slo_attainment", "goodput_rps")
    print(f"\n{'tenant':12s} " + " ".join(f"{c:>16s}" for c in cols))
    for tid, row in res.tenant_summary().items():
        print(f"{tid:12s} " + " ".join(f"{row[c]:16.3f}" for c in cols))

    s = res.summary()
    print(f"\naggregate: {s['throughput_rps']:.2f} req/s, "
          f"{s['n_rejected']} rejected at the gateway")
    print(f"fairness (Jain): raw={s['fairness_jain']:.3f}  "
          f"weight-normalized={s['fairness_jain_weighted']:.3f}")
    print("admission:", res.admission_stats)


if __name__ == "__main__":
    main()
