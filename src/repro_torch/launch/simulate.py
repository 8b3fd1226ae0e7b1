"""TokenSim CLI: simulate an LLM serving cluster.

Examples:
  # 8xA100, continuous batching, ShareGPT-like workload at 12 QPS
  PYTHONPATH=src python -m repro_torch.launch.simulate --arch llama2-7b \
      --workers 8 --qps 12 --requests 2000
  # disaggregated 2 prefill + 6 decode
  PYTHONPATH=src python -m repro_torch.launch.simulate --arch llama2-7b \
      --prefill-workers 2 --decode-workers 6 --qps 12 --requests 2000

The port's copy of ``repro.launch.simulate``, its imports rewritten.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.mem.memory_pool import PoolConfig
from repro_torch.core.simulator import (FaultSpec, SimSpec, Simulation,
                                        WorkerSpec)
from repro_torch.core.workload import WorkloadSpec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--hw", default="A100")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--prefill-workers", type=int, default=0)
    ap.add_argument("--decode-workers", type=int, default=0)
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--global-policy", default="least_loaded")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-batched-tokens", type=int, default=2048)
    ap.add_argument("--max-mem-ratio", type=float, default=1.0)
    ap.add_argument("--gpu-mem-util", type=float, default=0.9)
    ap.add_argument("--memory-pool", action="store_true")
    ap.add_argument("--multi-round-frac", type=float, default=0.0)
    ap.add_argument("--ttft-slo", type=float, default=15.0)
    ap.add_argument("--mtpot-slo", type=float, default=0.3)
    ap.add_argument("--fail-worker", type=int, default=-1)
    ap.add_argument("--fail-time", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.prefill_workers or args.decode_workers:
        workers = [WorkerSpec(hw=args.hw, role="prefill",
                              gpu_mem_util=args.gpu_mem_util)
                   for _ in range(args.prefill_workers)] + \
                  [WorkerSpec(hw=args.hw, role="decode",
                              gpu_mem_util=args.gpu_mem_util,
                              max_mem_ratio=args.max_mem_ratio)
                   for _ in range(args.decode_workers)]
        gpolicy = "disagg"
    else:
        workers = [WorkerSpec(hw=args.hw, gpu_mem_util=args.gpu_mem_util,
                              max_mem_ratio=args.max_mem_ratio)
                   for _ in range(args.workers)]
        gpolicy = args.global_policy

    faults = []
    if args.fail_worker >= 0:
        faults.append(FaultSpec(time=args.fail_time, worker=args.fail_worker,
                                kind="fail"))

    spec = SimSpec(
        arch=args.arch, workers=workers,
        workload=WorkloadSpec(num_requests=args.requests, qps=args.qps,
                              seed=args.seed,
                              multi_round_frac=args.multi_round_frac),
        global_policy=gpolicy, local_policy=args.local,
        max_batch=args.max_batch,
        max_batched_tokens=args.max_batched_tokens,
        pool=PoolConfig() if args.memory_pool else None,
        faults=faults)
    res = Simulation(spec).run()
    summary = res.summary(ttft_slo=args.ttft_slo, mtpot_slo=args.mtpot_slo)
    summary["wall_time_s"] = res.wall_time
    print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in summary.items()}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)


if __name__ == "__main__":
    main()
