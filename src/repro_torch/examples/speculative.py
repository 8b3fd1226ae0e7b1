"""Speculative decoding demo: a 0.5B draft proposing for a 7B target.

Runs the same low-occupancy workload with and without speculation and
prints the acceptance/effective-tokens metrics next to latency.

    PYTHONPATH=src python -m repro_torch.examples.speculative
"""
from repro_torch.core import (AcceptanceModel, SimSpec, SpecDecodeSpec,
                              WorkerSpec, simulate)
from repro_torch.core.workload import WorkloadSpec


def main():
    wl = WorkloadSpec(num_requests=64, qps=0.0, seed=0,
                      lengths="fixed", prompt_len=256, output_len=128)
    base = dict(arch="llama2-7b", workers=[WorkerSpec(hw="A100")],
                workload=wl, max_batch=4, max_batched_tokens=4096)

    off = simulate(SimSpec(**base))
    on = simulate(SimSpec(**base, spec_decode=SpecDecodeSpec(
        draft_arch="qwen2-0.5b", lookahead=4,
        acceptance=AcceptanceModel(kind="geometric", rate=0.85, decay=0.95))))

    for name, res in (("baseline", off), ("speculative", on)):
        s = res.summary()
        line = (f"{name:12s} tok/s={s['throughput_tps']:8.1f} "
                f"latency_p50={s['latency_p50']:.3f}s "
                f"latency_p99={s['latency_p99']:.3f}s")
        if "spec_steps" in s:
            line += (f"  acceptance={s['spec_acceptance_rate']:.2f} "
                     f"tokens/step={s['spec_eff_tokens_per_step']:.2f}")
        print(line)
    print(f"\nspeedup: {on.token_throughput() / off.token_throughput():.2f}x "
          f"token throughput at low batch occupancy")


if __name__ == "__main__":
    main()
