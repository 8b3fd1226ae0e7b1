"""Disaggregated prefill/decode exploration (paper §IV-C).

Sweeps the P:D split of an 8-accelerator node and picks the best split
for a workload — then swaps the decode fleet to GDDR6-AiM PIM devices to
reproduce the cost-efficiency observation (Finding 4).

    PYTHONPATH=src python -m repro_torch.examples.disaggregated_serving
"""
from repro_torch.core import SimSpec, WorkerSpec, simulate
from repro_torch.core.costmodel.hardware import HARDWARE
from repro_torch.core.workload import WorkloadSpec


def goodput(workers, qps=20.0):
    spec = SimSpec(
        arch="llama2-7b", workers=workers, global_policy="disagg",
        workload=WorkloadSpec(num_requests=2000, qps=qps, seed=0,
                              lengths="fixed", prompt_len=256,
                              output_len=128),
        local_policy="continuous", max_batch=256, max_batched_tokens=8192)
    return simulate(spec).slo_goodput(ttft_slo=15.0, mtpot_slo=0.3)


def main():
    print("P:D split sweep (8x A100):")
    best = (0, None)
    for p in (1, 2, 3, 4):
        ws = [WorkerSpec(hw="A100", role="prefill")] * p + \
             [WorkerSpec(hw="A100", role="decode")] * (8 - p)
        gp = goodput(ws)
        print(f"  P{p}-D{8 - p}: goodput {gp:.2f} req/s")
        if gp > best[0]:
            best = (gp, p)
    gp_a100, p = best
    print(f"best split: P{p}-D{8 - p}")

    ws_pim = [WorkerSpec(hw="A100", role="prefill")] * p + \
             [WorkerSpec(hw="G6-AiM", role="decode")] * (8 - p)
    gp_pim = goodput(ws_pim)
    cost_a = p + (8 - p) * HARDWARE["A100"].price
    cost_p = p + (8 - p) * HARDWARE["G6-AiM"].price
    print(f"A100 decode fleet : {gp_a100:.2f} req/s at cost {cost_a:.1f}")
    print(f"PIM  decode fleet : {gp_pim:.2f} req/s at cost {cost_p:.1f}")
    print(f"-> {gp_pim / gp_a100:.2f}x goodput at "
          f"{cost_p / cost_a:.2f}x cost (Finding 4)")


if __name__ == "__main__":
    main()
