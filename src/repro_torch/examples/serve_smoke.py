"""Serve a small model with batched requests on the real engine (paged KV
+ continuous batching), then check that the simulator, its cost model
fitted to the engine's iteration walls, predicts the engine's
throughput: the paper's core loop, end to end.  The port of the
reference's ``examples/serve_smoke.py`` (same values), on the CUDA card
unless ``--device cpu`` is asked for.

    PYTHONPATH=src python -m repro_torch.examples.serve_smoke [--device cpu]

Run as written it reaches no kernel, as the reference does: the smoke
model's ``attn_impl="auto"`` resolves to ``naive`` at these lengths and
the engine's ``attn_path`` is ``gather``.  A caller takes the kernel
routes with a model built with ``RunSettings(attn_impl="pallas")`` and
``serve(..., attn_path="pallas")``.

The simulator replays the engine's own workload with the engine's
scheduler and page pool, so it forms the engine's batches.  Its
``TabularBackend`` is a least-squares fit with an intercept, whose
residuals sum to zero over the engine's records: where no prediction is
clamped at its floor (1e-6 s), the simulated span equals the engine's
clock and the error is zero up to rounding.  What the printed error
reads is the walls the affine fit cannot follow: on the card, the
iterations that captured a CUDA graph (the first decode, the first
prefill of each bucket).
"""
import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.core.mem.block_manager import BlockManager, MemoryConfig
from repro_torch.core.metrics import Results
from repro_torch.core.simulator import SimSpec, Simulation, WorkerSpec
from repro_torch.core.workload import WorkloadSpec, generate
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import EngineConfig, ServingEngine

ARCH = "llama2-7b"
SEED = 0
#: 24 requests, all arriving at t=0
WORKLOAD = WorkloadSpec(num_requests=24, qps=0.0, seed=0,
                        max_prompt_len=48, max_output_len=16)
ENGINE = EngineConfig(num_blocks=160, block_size=8, max_batch=6,
                      max_pages_per_seq=16)
#: the simulated worker; the tabular backend reads no hardware figure
#: for its iteration times
WORKER = WorkerSpec(hw="CPU")
LOCAL_POLICY = "continuous"
SIM_MAX_BATCH = 6
BACKEND = "tabular"
SIM_BLOCK_SIZE = 8
#: the simulated worker's page pool, in place of the one sized from its
#: hardware: the engine's
SIM_MEMORY = MemoryConfig(num_blocks=160, block_size=8,
                          kv_bytes_per_token=1.0)


def serve(model, params, *, attn_path="gather", device=None):
    """Serve the example's workload on a new engine; returns the engine,
    its requests and the real ``Results`` (times on the engine's clock,
    the sum of its iteration walls)."""
    reqs = generate(WORKLOAD)
    eng = ServingEngine(model, params,
                        dataclasses.replace(ENGINE, attn_path=attn_path),
                        device=device)
    for r in reqs:
        eng.add_request(r)
    eng.run()
    return eng, reqs, Results(requests=reqs, sim_time=eng.clock)


def simulate(cfg, workload, samples):
    """Simulate ``workload`` on one worker whose tabular cost model is
    fitted to ``samples`` ((BatchMix, wall) pairs); returns the
    ``Simulation`` and its results."""
    spec = SimSpec(arch=cfg, workers=[WORKER],
                   workload=workload, local_policy=LOCAL_POLICY,
                   max_batch=SIM_MAX_BATCH, backend=BACKEND,
                   backend_samples=list(samples), block_size=SIM_BLOCK_SIZE)
    sim = Simulation(spec)
    sim.workers[0].mem = BlockManager(SIM_MEMORY)
    return sim, sim.run()


def throughput_error(sim_res, real) -> float:
    """The simulator's throughput error relative to the real one."""
    return abs(sim_res.throughput() - real.throughput()) / real.throughput()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(ARCH)
    model = zoo.build(cfg)
    params = zoo.init_params(model, seed=SEED, device=args.device)
    eng, reqs, real = serve(model, params, device=args.device)
    print(f"real engine: {len(eng.finished)} requests, "
          f"{len(eng.records)} iterations, "
          f"{real.throughput():.2f} req/s (virtual)")
    sample = reqs[0]
    print(f"  e.g. request 0: {sample.prompt_len} prompt tokens -> "
          f"{eng.tokens_by_req[0][:8]}... ({sample.output_len} tokens)")

    sim, res = simulate(cfg, WORKLOAD,
                        [(r.mix, r.wall) for r in eng.records])
    print(f"simulator  : {len(res.finished)} requests, "
          f"{sim.workers[0].iterations} iterations, "
          f"{res.throughput():.2f} req/s")
    err = throughput_error(res, real)
    print(f"throughput error: {err * 100:.2f}%")
    return err


if __name__ == "__main__":
    main()
