"""Hardware x software exploration harness (docs/PARALLELISM.md).

The paper's headline — *hardware and software exploration* — as a
first-class package: declare a grid over any SimSpec knobs (parallelism
strategy, cluster topology, chips, batching, workloads), fan it out over
a multiprocessing pool with a resumable per-point JSON cache, and
extract the Pareto frontier over (throughput, P99 TTFT/TBT, $/token).
``benchmarks/parallelism.py`` drives it to reproduce the TP-vs-PP
crossover.

The port's copy of ``repro.explore``, its imports rewritten.
"""
from repro_torch.explore.pareto import (  # noqa: F401
    dominates, pareto_frontier, write_rows_csv)
from repro_torch.explore.sweep import (  # noqa: F401
    DEFAULT_OBJECTIVES, SweepResult, SweepSpec, default_metrics,
    grid_points, point_key, run_sweep, spec_price,
    uptime_weighted_price)
