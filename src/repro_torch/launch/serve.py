"""Serving CLI: run the port's engine on a workload.  The port of
``repro.launch.serve``, with the same arguments and defaults plus
``--device``: the CUDA card unless ``--device cpu`` is asked for.

The dense, MoE and VLM archs of the port's registry (llama2-7b,
opt-13b, qwen3-14b, qwen2-0.5b, internlm2-1.8b, stablelm-3b,
granite-moe-1b-a400m, granite-moe-3b-a800m, chameleon-34b) run the
paged path; SSM models (mamba2-130m), the hybrid zamba2-2.7b (54
Mamba2 layers and a shared attention block after every 6) and the
encoder-decoder whisper-base (its encoder over the engine's random frame
embeddings, 1500 frames) the slot path.  ``--attn pallas`` takes the
paged kernel in the decode (the slot path decodes with the plain
attention, as the reference does); the prefill attention is the
reference's default, ``auto``.  Both attention kernels take head_dim
64, 80 and 128, so stablelm-3b (heads of 80) serves on ``--attn
pallas`` too.  On the card
the engine runs its steps as CUDA graphs, as the reference runs them as
``jax.jit`` programs (``serving.graphs``); on the CPU it runs them
eagerly.  Examples:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-13b \\
      --attn pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --requests 16 --prompt-len 600 --output-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --attn pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --requests 16 --prompt-len 600 --output-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --attn pallas

Weights are random, from ``--seed`` (``init_params``).  Prints the
summary of ``Results`` and the number of engine iterations as JSON.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.metrics import Results
from repro_torch.core.workload import WorkloadSpec, generate
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import EngineConfig, ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--qps", type=float, default=0.0)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help=">0 fixes the prompt length")
    ap.add_argument("--output-len", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--attn", default="gather", choices=("gather", "pallas"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    return ap.parse_args(argv)


def make_requests(args):
    """The reference's workload: fixed lengths when ``--prompt-len`` is
    set, else ShareGPT-like lengths capped at 96 prompt and 32 output
    tokens."""
    if args.prompt_len:
        wl = WorkloadSpec(num_requests=args.requests, qps=args.qps,
                          seed=args.seed, lengths="fixed",
                          prompt_len=args.prompt_len,
                          output_len=args.output_len or 16)
    else:
        wl = WorkloadSpec(num_requests=args.requests, qps=args.qps,
                          seed=args.seed, max_prompt_len=96,
                          max_output_len=32)
    return generate(wl)


def build_engine(args) -> ServingEngine:
    """The model and engine ``args`` name, with random weights from
    ``--seed``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = zoo.build(cfg)
    params = zoo.init_params(model, seed=args.seed, device=args.device)
    mp = args.num_blocks // max(4, args.max_batch)
    ec = EngineConfig(num_blocks=args.num_blocks, block_size=args.block_size,
                      max_batch=args.max_batch,
                      max_pages_per_seq=mp, attn_path=args.attn,
                      seed=args.seed)
    return ServingEngine(model, params, ec, device=args.device)


def serve(engine: ServingEngine, reqs) -> dict:
    """Serve ``reqs``, all arriving at time 0; returns the summary."""
    for r in reqs:
        r.arrival_time = 0.0
        engine.add_request(r)
    engine.run()
    summary = Results(requests=reqs, sim_time=engine.clock).summary()
    summary["iterations"] = len(engine.records)
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    summary = serve(build_engine(args), make_requests(args))
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
