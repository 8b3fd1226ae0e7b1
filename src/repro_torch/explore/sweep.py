"""Declarative hardware x software sweeps with a resumable result cache.

A :class:`SweepSpec` names the grid axes (``{"tp": [1, 2, 4], ...}``)
and a module-level ``builder(point) -> SimSpec``; :func:`run_sweep` fans
the grid out over a multiprocessing pool (``processes=0`` runs inline)
and extracts one metrics row per point — throughput, P99 TTFT/TBT, and
$/token from ``HardwareSpec.price`` times the devices the point's
``ParallelSpec`` occupies.

Every completed point persists as ``<out_dir>/points/<key>.json`` keyed
by a hash of the point's canonical JSON, written atomically.  Re-running
a half-finished sweep loads the cached points and simulates only the
missing ones (a killed sweep resumes where it died; corrupt or
mismatched cache files are re-simulated).  ``run_sweep`` also writes the
full grid to ``sweep.csv`` and the non-dominated subset to
``pareto.csv`` (see :mod:`repro.explore.pareto`).

The ``builder`` must be a module-level callable so worker processes can
unpickle it; with ``processes=0`` any callable works.  The pool uses
the ``spawn`` start method where possible (fork is unsafe under a
threaded JAX parent), so driver scripts must keep the standard
``if __name__ == "__main__":`` guard.

The port's copy of ``repro.explore.sweep``, its imports rewritten.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import multiprocessing
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.costmodel.hardware import HARDWARE
from repro_torch.core.metrics import Results, percentile
from repro_torch.core.simulator import SimSpec, effective_tp, simulate
from repro_torch.explore.pareto import pareto_frontier, write_rows_csv

#: frontier directions for the default metrics row
DEFAULT_OBJECTIVES = {"throughput": "max", "p99_ttft": "min",
                      "cost_per_1k_tokens": "min"}


@dataclass(frozen=True)
class SweepSpec:
    """A declarative grid sweep: ``axes`` values are crossed into points
    (dicts) which ``builder`` turns into a ``SimSpec`` each."""
    name: str
    builder: Callable[[Dict], SimSpec]
    axes: Dict[str, Sequence]
    #: optional replacement for :func:`default_metrics`
    metrics: Optional[Callable[[SimSpec, Results], Dict]] = None
    #: cache-invalidation tag mixed into every point's cache key: bump
    #: it when the cost model or the builder changes meaning, so cached
    #: results from the old code stop validating (the cache knows
    #: nothing about code versions on its own; ``run_sweep(force=True)``
    #: is the blunt alternative)
    version: str = ""


@dataclass
class SweepResult:
    rows: List[Dict] = field(default_factory=list)
    frontier: List[Dict] = field(default_factory=list)
    n_cached: int = 0
    n_simulated: int = 0
    csv_path: str = ""
    pareto_path: str = ""


def grid_points(axes: Dict[str, Sequence]) -> List[Dict]:
    """Cross-product of the axes, key-sorted for a stable order."""
    names = sorted(axes)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(axes[n] for n in names))]


def point_key(point: Dict, version: str = "") -> str:
    """Stable filename-safe cache key for one grid point (salted with
    the sweep's ``version`` tag)."""
    canon = json.dumps(point, sort_keys=True, default=str)
    if version:
        canon = f"{version}\n{canon}"
    return hashlib.sha1(canon.encode()).hexdigest()[:16]


def worker_price(ws, parallel) -> float:
    """A100-relative price of one worker's devices: its chip price
    (with ``hw_overrides`` applied, matching what the simulator builds)
    times the tp x pp devices it spans.  The tp resolution is the
    simulator's own ``effective_tp``, so the priced worker is the
    simulated one (pinned by tests/test_hetero_fleet.py)."""
    hw = HARDWARE[ws.hw]
    if ws.hw_overrides:
        hw = hw.with_(**ws.hw_overrides)
    return hw.price * effective_tp(ws, parallel) * parallel.pp


def spec_price(spec: SimSpec) -> float:
    """A100-relative price of the cluster a spec occupies: the sum of
    per-worker ``worker_price`` over the worker list, times replicas.
    This is the *static* (fleet-as-configured) rate; for runs where
    the autoscaler changed the fleet, bill with
    ``uptime_weighted_price`` instead."""
    par = spec.parallel
    return sum(worker_price(ws, par) for ws in spec.workers) \
        * par.replicas


def uptime_weighted_price(spec: SimSpec, res: Optional[Results] = None
                          ) -> float:
    """Time-weighted $-per-hour billing (docs/AUTOSCALING.md): the
    effective fleet price rate, with each worker billed only over its
    provisioned-to-retired span —
    ``sum_w price_w * span_w / sim_time``.  A worker alive for half
    the horizon bills half its rate; a static fleet bills exactly
    ``spec_price`` (unit-tested in tests/test_autoscale.py).  Falls
    back to ``spec_price`` when the run carries no span bookkeeping
    (hand-built Results, cached sweep rows)."""
    spans = getattr(res, "worker_spans", None) if res is not None \
        else None
    prices = getattr(res, "worker_prices", None) if res is not None \
        else None
    if not spans or not prices:
        return spec_price(spec)
    T = max(res.sim_time, 1e-12)
    return sum(prices.get(wid, 0.0)
               * (min(e if e is not None else T, T) - s)
               for wid, (s, e) in spans.items()) / T


def default_metrics(spec: SimSpec, res: Results) -> Dict:
    """The (throughput, tail latency, $/token) row the Pareto frontier
    is extracted over.  TBT is the inter-token gap over every finished
    request's decode phase; cost is price-units x sim-seconds per 1k
    generated tokens (relative dollars at A100 = 1.0).

    Streaming/drop-mode specs (``retain_requests=False``) are read from
    the ``StreamingStats`` sketches instead of the (empty) request
    list; per-gap TBT is not sketched, so ``p99_tbt`` is NaN there —
    exclude it from the objectives for streaming sweeps.

    ``price`` is uptime-weighted (docs/AUTOSCALING.md): identical to
    ``spec_price`` for static fleets, but an autoscaled run bills each
    worker only over its provisioned span."""
    price = uptime_weighted_price(spec, res)
    if res.stats is not None:
        st = res.stats
        tokens = st.tokens
        p50_ttft = st.ttft.percentile(50)
        p99_ttft = st.ttft.percentile(99)
        p99_tbt = float("nan")
        finished = st.n_finished
    else:
        gaps: List[float] = []
        for r in res.finished:
            ts = r.token_times
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
        tokens = sum(r.tokens_generated for r in res.finished)
        p50_ttft = percentile(res.ttfts(), 50)
        p99_ttft = percentile(res.ttfts(), 99)
        p99_tbt = percentile(gaps, 99) if gaps else float("nan")
        finished = len(res.finished)
    lat = res.latency_stats()
    row = {
        "throughput": res.throughput(),
        "token_throughput": res.token_throughput(),
        "p50_ttft": p50_ttft,
        "p99_ttft": p99_ttft,
        "p99_tbt": p99_tbt,
        "p99_latency": lat["p99"],
        "finished": finished,
        "price": price,
        "cost_per_1k_tokens": price * res.sim_time / tokens * 1e3
        if tokens else float("nan"),
    }
    if res.parallel_stats:
        row["bubble_fraction"] = res.parallel_summary()["bubble_fraction"]
    if res.routing_stats is not None:
        ro = res.routing_summary()
        row["affinity_hit_rate"] = ro["affinity_hit_rate"]
        row["kv_fetches"] = ro["fetches"]
        row["kv_fetch_time_s"] = ro["fetch_time_s"]
    return row


def _run_point(args) -> Dict:
    """Pool worker: simulate one grid point and persist its cache file
    atomically (tmp + rename), so a killed sweep never leaves a torn
    JSON behind."""
    builder, metrics_fn, point, path = args
    spec = builder(point)
    res = simulate(spec)
    metrics = (metrics_fn or default_metrics)(spec, res)
    payload = {"point": point, "metrics": metrics}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    os.replace(tmp, path)
    return payload


def _mp_context():
    """Prefer ``spawn`` — callers may have JAX (multithreaded) loaded in
    the parent, and forking a threaded process risks deadlocked
    children.  Spawn re-imports the parent's ``__main__`` though, so
    when that module is not importable (stdin / REPL parents) fall back
    to ``fork`` — the sweep jobs themselves never touch JAX."""
    main = sys.modules.get("__main__")
    spawn_safe = main is None \
        or getattr(main, "__spec__", None) is not None \
        or os.path.exists(getattr(main, "__file__", ""))
    if spawn_safe or "fork" not in multiprocessing.get_all_start_methods():
        return multiprocessing.get_context("spawn")
    return multiprocessing.get_context("fork")


def _load_cached(path: str, point: Dict) -> Optional[Dict]:
    """Cached payload for ``point``, or None when missing / corrupt /
    written for a different point (hash collision or edited grid)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or "metrics" not in payload \
            or payload.get("point") != point:
        return None
    return payload


def run_sweep(sweep: SweepSpec, out_dir: str, *, processes: int = 0,
              objectives: Optional[Dict[str, str]] = None,
              force: bool = False, verbose: bool = False) -> SweepResult:
    """Run (or resume) a sweep; returns every row plus the frontier.

    ``processes=0`` simulates inline (deterministic order, picklability
    not required); ``processes=N`` fans the missing points out over a
    pool of N workers.  Only points without a valid cache file are
    simulated — ``SweepResult.n_simulated`` counts them, which the
    resumability test pins.  The cache is keyed by point +
    ``sweep.version`` only — it cannot see code changes, so after
    editing the cost model either bump the version tag or pass
    ``force=True`` to re-simulate everything."""
    points = grid_points(sweep.axes)
    points_dir = os.path.join(out_dir, "points")
    os.makedirs(points_dir, exist_ok=True)

    payloads: Dict[int, Dict] = {}
    missing = []
    for idx, point in enumerate(points):
        path = os.path.join(
            points_dir, f"{point_key(point, sweep.version)}.json")
        cached = None if force else _load_cached(path, point)
        if cached is not None:
            payloads[idx] = cached
        else:
            missing.append((idx, point, path))
    if verbose and missing:
        print(f"sweep {sweep.name}: {len(points)} points, "
              f"{len(payloads)} cached, {len(missing)} to simulate")

    jobs = [(sweep.builder, sweep.metrics, point, path)
            for _, point, path in missing]
    if jobs:
        if processes > 0:
            with _mp_context().Pool(processes) as pool:
                fresh = pool.map(_run_point, jobs)
        else:
            fresh = [_run_point(j) for j in jobs]
        for (idx, _, _), payload in zip(missing, fresh):
            payloads[idx] = payload

    rows = [{**payloads[i]["point"], **payloads[i]["metrics"]}
            for i in range(len(points))]
    result = SweepResult(rows=rows, n_cached=len(points) - len(missing),
                         n_simulated=len(missing))
    result.csv_path = os.path.join(out_dir, "sweep.csv")
    write_rows_csv(rows, result.csv_path)
    result.frontier = pareto_frontier(
        rows, objectives or DEFAULT_OBJECTIVES)
    result.pareto_path = os.path.join(out_dir, "pareto.csv")
    write_rows_csv(result.frontier, result.pareto_path)
    return result
