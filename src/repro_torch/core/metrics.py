"""Metrics: the dynamic outputs the paper argues single-shot simulators
cannot produce — latency distributions, CDFs, SLO goodput, memory-over-
time — computed from the per-request records.

Two accounting modes share one ``Results`` surface:

* **exact** (default): ``Results.requests`` holds every ``Request`` and
  percentiles/CDFs are computed from the full latency lists (sorted once
  and cached per ``Results``);
* **streaming** (``Results.stats`` set, produced by
  ``SimSpec(retain_requests=False)``): finished requests are folded into
  a :class:`StreamingStats` sketch as they retire and then dropped, so
  memory stays O(1) in the number of requests.  Quantiles come from a
  log-binned sketch with bounded relative error (default 0.3%, see
  docs/PERFORMANCE.md for the accuracy model).

The port's copy of ``repro.core.metrics``, its imports rewritten.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import Request

#: every key of ``Results.availability_summary()``;
#: scripts/check_docs.py asserts each is documented in
#: docs/RELIABILITY.md
AVAILABILITY_FIELDS = (
    "service_availability", "capacity_availability",
    "availability_per_worker", "downtime_per_worker",
    "service_downtime_s", "capacity_downtime_s", "degraded_s",
    "n_failures", "mtbf_observed_s", "mttr_observed_s", "target",
    "window_s", "error_budget_s", "budget_consumed_s",
    "budget_remaining_frac", "burn_rate", "request_success_rate",
    "tenants", "models")

#: every key of a ``Results.model_summary()`` row (heterogeneous
#: multi-model fleets); scripts/check_docs.py asserts each is
#: documented in docs/HETEROGENEITY.md
MODEL_SUMMARY_FIELDS = (
    "n_requests", "n_finished", "tokens", "token_tps",
    "latency_p50", "latency_p99", "ttft_p50", "ttft_p99",
    "slo_attainment", "goodput_rps", "preempt_rate", "n_workers")

#: every key of ``Results.scaling_summary()`` (closed-loop autoscaling
#: and cost economics); scripts/check_docs.py asserts each is
#: documented in docs/AUTOSCALING.md
SCALING_SUMMARY_FIELDS = (
    "n_scale_up", "n_scale_down", "fleet_size_min", "fleet_size_max",
    "fleet_size_avg", "fleet_size_final", "fleet_size_series",
    "worker_seconds", "scale_up_lag_s", "billed_cost",
    "cost_per_1m_tokens", "cost_per_1m_prefill_tokens",
    "cost_per_1m_decode_tokens", "events")

#: every key of ``Results.routing_summary()`` (cache-aware prefix
#: routing + remote KV tier); scripts/check_docs.py asserts each is
#: documented in docs/ROUTING.md
ROUTING_SUMMARY_FIELDS = (
    "prefix_requests", "fetches", "fetched_tokens",
    "affinity_hits", "affinity_misses", "affinity_hit_rate",
    "overload_diversions", "fetch_hints",
    "peer_fetches", "remote_fetches", "fetch_bytes", "fetch_time_s",
    "fetch_misses", "fetch_recomputes",
    "registry_prefixes", "registry_entries", "registry_publishes",
    "registry_invalidations", "registry_expirations",
    "registry_evictions",
    "remote_capacity_bytes", "remote_used_bytes",
    "remote_peak_used_bytes", "remote_entries", "remote_stores",
    "remote_hits", "remote_misses", "remote_evictions",
    "remote_rejects")


def _interp_percentile(s: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile of an already-sorted sequence."""
    if not s:
        return float("nan")
    k = (len(s) - 1) * p / 100.0
    lo, hi = int(math.floor(k)), int(math.ceil(k))
    if lo == hi:
        return s[lo]
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def percentile(xs: Sequence[float], p: float) -> float:
    return _interp_percentile(sorted(xs), p)


def _cdf_points_sorted(s: Sequence[float],
                       n: int) -> List[Tuple[float, float]]:
    """CDF sampled at n+1 evenly spaced fractions of a sorted sequence."""
    if not s:
        return []
    return [(s[min(len(s) - 1, int(i * len(s) / n))], i / n)
            for i in range(n + 1)]


def cdf_points(xs: Sequence[float], n: int = 100) -> List[Tuple[float, float]]:
    return _cdf_points_sorted(sorted(xs), n)


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index: (Σx)² / (n·Σx²) ∈ (0, 1], 1 = equal."""
    xs = [x for x in xs if x == x]        # drop NaNs
    if not xs:
        return float("nan")
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return sum(xs) ** 2 / (len(xs) * sq)


# ---------------------------------------------------------------------------
# streaming sketches
# ---------------------------------------------------------------------------
class QuantileSketch:
    """Log-binned quantile sketch (DDSketch-style) with bounded relative
    error: every reported quantile q satisfies |q - q*| <= alpha * q*
    for the true quantile q*.  Positive values map to geometric buckets
    ``ceil(log_gamma(x))`` with gamma = (1+alpha)/(1-alpha); bucket
    count is O(log(max/min)/alpha), independent of sample count."""

    __slots__ = ("gamma", "_lg", "bins", "n_zero", "count",
                 "sum", "min", "max")

    def __init__(self, alpha: float = 0.003):
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self.gamma)
        self.bins: Dict[int, int] = {}
        self.n_zero = 0                  # values <= 0 collapse to one bin
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x <= 0.0:
            self.n_zero += 1
            return
        i = math.ceil(math.log(x) / self._lg)
        self.bins[i] = self.bins.get(i, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return float("nan")
        if p <= 0.0:
            return self.min
        if p >= 100.0:
            return self.max
        # nearest-rank target: empirically the closest convention to the
        # interpolating exact percentile() (floor/ceil bias a half order
        # statistic, which at the distribution tails costs more than the
        # sketch's own alpha)
        rank = round(p / 100.0 * (self.count - 1))
        if rank < self.n_zero:
            return min(self.min, 0.0)
        seen = self.n_zero
        for i in sorted(self.bins):
            seen += self.bins[i]
            if seen > rank:
                # bucket midpoint in log space: 2γ^i/(γ+1)
                v = 2.0 * self.gamma ** i / (self.gamma + 1.0)
                return min(max(v, self.min), self.max)
        return self.max

    def cdf_points(self, n: int = 100) -> List[Tuple[float, float]]:
        """Approximate CDF sampled at n+1 evenly spaced fractions —
        drop-in for ``cdf_points`` on the folded values.  One pass over
        the sorted bins serves every fraction (percentile() per point
        would re-sort and re-scan n+1 times)."""
        if self.count == 0:
            return []
        mids = [(seen, 2.0 * self.gamma ** i / (self.gamma + 1.0))
                for seen, i in self._cumulative_bins()]
        out: List[Tuple[float, float]] = []
        j = 0
        for k in range(n + 1):
            p = 100.0 * k / n
            if p <= 0.0:
                out.append((self.min, 0.0))
                continue
            if p >= 100.0:
                out.append((self.max, 1.0))
                continue
            rank = round(p / 100.0 * (self.count - 1))
            if rank < self.n_zero:
                out.append((min(self.min, 0.0), k / n))
                continue
            while j < len(mids) and mids[j][0] <= rank:
                j += 1
            v = mids[j][1] if j < len(mids) else self.max
            out.append((min(max(v, self.min), self.max), k / n))
        return out

    def _cumulative_bins(self) -> List[Tuple[int, int]]:
        """(cumulative count, bin index) in value order, zeros included
        in the running count."""
        out = []
        seen = self.n_zero
        for i in sorted(self.bins):
            seen += self.bins[i]
            out.append((seen, i))
        return out

    def stats(self) -> Dict[str, float]:
        return {"p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99),
                "max": self.max if self.count else float("nan"),
                "mean": self.mean}


class StreamingStats:
    """Constant-memory aggregate of retired requests.

    ``Simulation`` folds every finished (or rejected) request in as it
    retires; ``Results`` reads summaries from here when the request list
    was not retained.  Counters/min/max/mean are exact; quantiles carry
    the sketch's bounded relative error.  ``tenant_slos`` maps tenant_id
    to its (ttft_slo, tpot_slo) so per-tenant SLO attainment can be
    counted at fold time (once a request is dropped, SLOs cannot be
    re-evaluated against new thresholds).
    """

    def __init__(self, alpha: float = 0.003,
                 slo: Optional[Tuple[float, float]] = None,
                 tenant_slos: Optional[Dict[str, Tuple[float, float]]] = None):
        self.alpha = alpha
        self.slo = slo
        self.latency = QuantileSketch(alpha)
        self.norm_latency = QuantileSketch(alpha)
        self.ttft = QuantileSketch(alpha)
        self.queue_delay = QuantileSketch(alpha)
        self.n_finished = 0
        self.n_rejected = 0
        self.n_folded = 0
        self.tokens = 0
        self.preempts = 0
        self.n_slo_ok = 0
        self.first_arrival = math.inf
        self.last_finish = -math.inf
        # speculative decoding counters
        self.spec_steps = 0
        self.spec_tokens = 0
        self.draft_proposed = 0
        self.draft_accepted = 0
        # hierarchical KV memory counters (docs/MEMORY.md): folded here
        # so retain_requests=False keeps swap/prefix accounting exact
        self.swap_outs = 0
        self.swap_ins = 0
        self.shared_tokens = 0
        self.cow_copies = 0
        # cache-aware routing counters (docs/ROUTING.md)
        self.fetches = 0
        self.fetched_tokens = 0
        self.prefix_requests = 0
        #: latency-attribution sums (docs/OBSERVABILITY.md): per-
        #: component totals of the finalized TTFT / decode / per-token
        #: breakdowns, folded at retire time so drop-mode keeps the
        #: conserved decomposition without retaining requests
        self.attrib = {"n": 0, "ttft": {}, "decode": {}, "tpot": {}}
        self._tenant_slos = tenant_slos or {}
        self.tenants: Dict[str, "StreamingStats"] = {}
        #: per-model sub-sketches (docs/HETEROGENEITY.md), keyed by the
        #: concrete model name the dispatcher stamped; each inherits the
        #: global streaming SLO so per-model goodput works in drop mode
        self.models: Dict[str, "StreamingStats"] = {}

    # ------------------------------------------------------------------
    def _tenant(self, tid: str) -> "StreamingStats":
        sub = self.tenants.get(tid)
        if sub is None:
            sub = StreamingStats(self.alpha,
                                 slo=self._tenant_slos.get(tid))
            self.tenants[tid] = sub
        return sub

    def _model(self, model: str) -> "StreamingStats":
        sub = self.models.get(model)
        if sub is None:
            sub = StreamingStats(self.alpha, slo=self.slo)
            self.models[model] = sub
        return sub

    def fold(self, req: Request, *, _recurse: bool = True) -> None:
        """Fold one retired request (finished or rejected) and forget it."""
        if _recurse and req.tenant_id is not None:
            self._tenant(req.tenant_id).fold(req, _recurse=False)
        if _recurse and req.model is not None:
            self._model(req.model).fold(req, _recurse=False)
        self.n_folded += 1
        self.preempts += req.preempt_count
        self.spec_steps += req.spec_steps
        self.spec_tokens += req.spec_tokens
        self.draft_proposed += req.draft_proposed
        self.draft_accepted += req.draft_accepted
        self.swap_outs += req.swap_out_count
        self.swap_ins += req.swap_in_count
        self.shared_tokens += req.shared_tokens
        self.cow_copies += req.cow_copies
        self.fetches += req.fetch_count
        self.fetched_tokens += req.fetched_tokens
        if req.prefix_id is not None:
            self.prefix_requests += 1
        ro = getattr(req, "obs", None)
        if ro is not None and ro.final is not None:
            a = self.attrib
            a["n"] += 1
            f = ro.final
            t = a["ttft"]
            for k, v in f["ttft"].items():
                t[k] = t.get(k, 0.0) + v
            d, tp = a["decode"], a["tpot"]
            scale = 1.0 / max(1, f["tokens"] - 1)
            for k, v in f["decode"].items():
                d[k] = d.get(k, 0.0) + v
                tp[k] = tp.get(k, 0.0) + v * scale
        if req.rejected or req.t_finish is None:
            self.n_rejected += 1
            return
        self.n_finished += 1
        self.tokens += req.tokens_generated
        if req.arrival_time < self.first_arrival:
            self.first_arrival = req.arrival_time
        if req.t_finish > self.last_finish:
            self.last_finish = req.t_finish
        self.latency.add(req.latency)
        self.norm_latency.add(req.normalized_latency)
        if req.ttft is not None:
            self.ttft.add(req.ttft)
        if req.queue_delay is not None:
            self.queue_delay.add(req.queue_delay)
        if self.slo is not None and req.meets_slo(*self.slo):
            self.n_slo_ok += 1

    # ------------------------------------------------------------------
    @property
    def span(self) -> float:
        if self.n_finished == 0:
            return 0.0
        return self.last_finish - self.first_arrival

    def throughput(self) -> float:
        return self.n_finished / max(self.span, 1e-9) \
            if self.n_finished else 0.0

    def token_throughput(self) -> float:
        return self.tokens / max(self.span, 1e-9) if self.n_finished else 0.0

    def goodput(self) -> float:
        """Requests/s that met the configured SLO (needs ``slo`` set at
        construction: SLOs are evaluated at fold time)."""
        if self.slo is None or self.n_finished == 0:
            return float("nan") if self.slo is None else 0.0
        return self.n_slo_ok / max(self.span, 1e-9)


@dataclass
class Results:
    requests: List[Request]
    sim_time: float
    worker_mem: Dict[int, list] = field(default_factory=dict)
    pool_stats: Optional[dict] = None
    #: per-worker BlockManager.stats() (prefix sharing / occupancy)
    mem_stats: Optional[Dict[int, dict]] = None
    #: per-worker SwapManager.stats() when preemption_mode="swap"
    swap_stats: Optional[Dict[int, dict]] = None
    wall_time: float = 0.0
    events: int = 0
    #: tenant_id -> TenantSpec when the sim ran with tenants (tenancy)
    tenant_specs: Optional[Dict[str, object]] = None
    #: AdmissionController.stats() snapshot at end of sim
    admission_stats: Optional[Dict[str, Dict[str, float]]] = None
    #: per-worker pipeline-parallel accounting (docs/PARALLELISM.md):
    #: {wid: {"pp_bubble_time", "pp_comm_time", "pp_span_time",
    #: "busy_time", "iterations"}} when the sim ran with pp > 1
    parallel_stats: Optional[Dict[int, Dict[str, float]]] = None
    #: streaming aggregates when the sim ran with retain_requests=False;
    #: ``requests`` then holds only the (few) never-finished leftovers
    stats: Optional[StreamingStats] = None
    #: peak simultaneously-live Request objects (streaming memory model)
    max_live: int = 0
    #: repro.obs.TraceRecorder when the sim ran with ObsSpec(trace=True)
    trace: Optional[object] = field(default=None, repr=False)
    #: repro.obs.TimeSeriesRecorder when ObsSpec(timeseries=True)
    timeseries: Optional[object] = field(default=None, repr=False)
    #: injected-fault log (repro.core.faults.FaultEvent) when the sim
    #: ran with faults or a chaos spec; availability_summary() derives
    #: all availability accounting from it
    fault_events: Optional[list] = None
    #: worker count (after replica expansion) for capacity availability
    n_workers: int = 0
    #: wid -> hosted model name when the sim ran heterogeneous fleets
    #: (docs/HETEROGENEITY.md); drives per-model availability and
    #: ``model_summary`` worker counts
    worker_models: Optional[Dict[int, str]] = None
    #: the arch requests defaulted to when they arrived unstamped
    default_model: Optional[str] = None
    #: autoscaler action log (repro.core.autoscale.ScaleEvent) when the
    #: sim ran with SimSpec.autoscale enabled; scaling_summary() and
    #: the byte-identity tests derive everything from it
    scale_events: Optional[list] = None
    #: wid -> (t_provisioned, t_retired-or-None): the span each worker
    #: actually existed for.  Filled by every simulate() run (static
    #: fleets get (0.0, None)); drives time-weighted billing and the
    #: time-varying capacity accounting in availability_summary()
    worker_spans: Optional[Dict[int, Tuple[float, Optional[float]]]] = None
    #: wid -> device price (A100-relative $/s units, matching
    #: explore.worker_price) for uptime-weighted cost
    worker_prices: Optional[Dict[int, float]] = None
    #: wid -> {"prefill_time", "decode_time", "prefill_tokens",
    #: "decode_tokens", "busy_time"}: busy time split by phase, the
    #: basis of the prefill/decode $/1M-tokens split
    phase_stats: Optional[Dict[int, Dict[str, float]]] = None
    #: cluster-wide cache-aware routing counters (docs/ROUTING.md):
    #: Simulation.fetch_prefix fetch accounting merged with the
    #: prefix_affinity policy's and PrefixRegistry's stats(); None when
    #: neither prefix routing nor a remote KV tier was active
    routing_stats: Optional[Dict[str, float]] = None
    #: RemoteKVStore.stats() snapshot when SimSpec.remote_kv was set
    remote_stats: Optional[Dict[str, float]] = None
    #: per-Results caches: finished list and sorted metric lists are
    #: computed once (the repeated-full-sort fix); safe because Results
    #: is read after the simulation has finished mutating requests
    _cache: Dict[str, list] = field(default_factory=dict, repr=False,
                                    compare=False)

    # ------------------------------------------------------------------
    @property
    def finished(self) -> List[Request]:
        fin = self._cache.get("finished")
        if fin is None:
            fin = [r for r in self.requests if r.t_finish is not None]
            self._cache["finished"] = fin
        return fin

    def _sorted(self, name: str, values) -> List[float]:
        s = self._cache.get(name)
        if s is None:
            s = sorted(values)
            self._cache[name] = s
        return s

    def throughput(self) -> float:
        """Finished requests per second of simulated time."""
        if self.stats is not None:
            return self.stats.throughput()
        f = self.finished
        if not f:
            return 0.0
        span = max(r.t_finish for r in f) - min(r.arrival_time for r in f)
        return len(f) / max(span, 1e-9)

    def token_throughput(self) -> float:
        if self.stats is not None:
            return self.stats.token_throughput()
        f = self.finished
        if not f:
            return 0.0
        span = max(r.t_finish for r in f) - min(r.arrival_time for r in f)
        return sum(r.tokens_generated for r in f) / max(span, 1e-9)

    def latencies(self) -> List[float]:
        return [r.latency for r in self.finished]

    def normalized_latencies(self) -> List[float]:
        return [r.normalized_latency for r in self.finished]

    def ttfts(self) -> List[float]:
        return [r.ttft for r in self.finished if r.ttft is not None]

    def latency_stats(self) -> Dict[str, float]:
        if self.stats is not None:
            return self.stats.latency.stats()
        lats = self._sorted("latencies", self.latencies())
        return {"p50": _interp_percentile(lats, 50),
                "p90": _interp_percentile(lats, 90),
                "p99": _interp_percentile(lats, 99),
                "max": lats[-1] if lats else float("nan"),
                "mean": sum(lats) / len(lats) if lats else float("nan")}

    def latency_cdf(self, n: int = 100):
        if self.stats is not None:
            return self.stats.latency.cdf_points(n)
        return _cdf_points_sorted(
            self._sorted("latencies", self.latencies()), n)

    def slo_goodput(self, *, ttft_slo: float = 0.0,
                    mtpot_slo: float = 0.0) -> float:
        """Requests/s that met their SLOs (paper's goodput metric).  In
        streaming mode SLOs are evaluated at fold time, so this requires
        the thresholds configured up front (StreamingStats.slo)."""
        if self.stats is not None:
            if self.stats.slo == (ttft_slo, mtpot_slo):
                return self.stats.goodput()
            return float("nan")
        ok = [r for r in self.finished
              if r.meets_slo(ttft_slo, mtpot_slo)]
        if not ok:
            return 0.0
        span = max(r.t_finish for r in self.finished) - \
            min(r.arrival_time for r in self.finished)
        return len(ok) / max(span, 1e-9)

    # ---- observability (repro.obs, docs/OBSERVABILITY.md) -------------
    def export_trace(self, path: str) -> str:
        """Write the Chrome trace-event JSON (Perfetto-loadable)."""
        if self.trace is None:
            raise ValueError("tracing was not enabled: run with "
                             "SimSpec(obs=ObsSpec(trace=True))")
        return self.trace.export(path)

    def export_timeseries(self, path: str) -> str:
        """Write the sampled time series; ``.json`` suffix selects JSON,
        anything else CSV."""
        if self.timeseries is None:
            raise ValueError("time series was not enabled: run with "
                             "SimSpec(obs=ObsSpec(timeseries=True))")
        if path.endswith(".json"):
            return self.timeseries.export_json(path)
        return self.timeseries.export_csv(path)

    def time_breakdown(self) -> dict:
        """Mean (and, in exact mode, P99-tail) decomposition of TTFT,
        decode-phase and per-token latency into attribution components
        (repro.obs.attribution.COMPONENTS).  Requires the sim to have
        run with ``ObsSpec(attribution=True)``; works in streaming
        drop-mode via the sums folded into ``StreamingStats``."""
        from repro_torch.obs.attribution import (aggregate_exact,
                                                 aggregate_streaming)
        if self.stats is not None and self.stats.attrib["n"]:
            return aggregate_streaming(self.stats.attrib)
        return aggregate_exact(self.finished)

    def explain(self) -> str:
        """``time_breakdown()`` rendered as a table."""
        from repro_torch.obs.attribution import format_breakdown
        return format_breakdown(self.time_breakdown())

    def preemption_rate(self) -> float:
        if self.stats is not None:
            n = self.stats.n_folded + len(self.requests)
            pre = self.stats.preempts + sum(r.preempt_count
                                            for r in self.requests)
            return pre / max(1, n)
        n = len(self.requests)
        return sum(r.preempt_count for r in self.requests) / max(1, n)

    # ---- hierarchical KV memory (repro.core.mem) ----------------------
    def memory_summary(self) -> Dict[str, float]:
        """Hierarchical-memory accounting (docs/MEMORY.md): the
        preemption-mode breakdown (how many evictions swapped vs
        recomputed), PCIe swap volume, and prefix-sharing/copy-on-write
        activity.  Works in both exact and streaming modes — leftover
        in-flight requests are added to the folded counters."""
        if self.stats is not None:
            preempts = self.stats.preempts + sum(
                r.preempt_count for r in self.requests)
            swap_outs = self.stats.swap_outs + sum(
                r.swap_out_count for r in self.requests)
            swap_ins = self.stats.swap_ins + sum(
                r.swap_in_count for r in self.requests)
            shared_tokens = self.stats.shared_tokens + sum(
                r.shared_tokens for r in self.requests)
            cow = self.stats.cow_copies + sum(
                r.cow_copies for r in self.requests)
        else:
            preempts = sum(r.preempt_count for r in self.requests)
            swap_outs = sum(r.swap_out_count for r in self.requests)
            swap_ins = sum(r.swap_in_count for r in self.requests)
            shared_tokens = sum(r.shared_tokens for r in self.requests)
            cow = sum(r.cow_copies for r in self.requests)
        out = {"preempts": preempts,
               "swap_preempts": swap_outs,
               "recompute_preempts": preempts - swap_outs,
               "swap_ins": swap_ins,
               "shared_tokens": shared_tokens,
               "cow_copies": cow}
        if self.swap_stats:
            vals = self.swap_stats.values()
            out["swap_bytes_out"] = sum(s["bytes_out"] for s in vals)
            out["swap_bytes_in"] = sum(s["bytes_in"] for s in vals)
            out["host_peak_bytes"] = max(
                s["peak_used_bytes"] for s in vals)
            out["swap_fallbacks"] = sum(s["fallbacks"] for s in vals)
        if self.mem_stats:
            hits = sum(s["shared_hits"] for s in self.mem_stats.values())
            misses = sum(s["shared_misses"]
                         for s in self.mem_stats.values())
            out["prefix_hit_rate"] = hits / (hits + misses) \
                if hits + misses else 0.0
        return out

    # ---- cache-aware routing (docs/ROUTING.md) ------------------------
    def routing_summary(self) -> Dict[str, float]:
        """Cache-aware prefix-routing and remote-KV-tier accounting:
        affinity hit rate at the global scheduler, cross-worker /
        remote-tier KV fetch volume and pricing, registry churn, and
        remote-store occupancy.  ``ROUTING_SUMMARY_FIELDS`` lists every
        returned key.  Works in both exact and streaming modes —
        per-request fetch counters are folded at retire time, cluster
        counters come from ``routing_stats``/``remote_stats``."""
        if self.stats is not None:
            prefix_requests = self.stats.prefix_requests + sum(
                1 for r in self.requests if r.prefix_id is not None)
            fetches = self.stats.fetches + sum(
                r.fetch_count for r in self.requests)
            fetched_tokens = self.stats.fetched_tokens + sum(
                r.fetched_tokens for r in self.requests)
        else:
            prefix_requests = sum(1 for r in self.requests
                                  if r.prefix_id is not None)
            fetches = sum(r.fetch_count for r in self.requests)
            fetched_tokens = sum(r.fetched_tokens for r in self.requests)
        out: Dict[str, float] = {
            "prefix_requests": prefix_requests,
            "fetches": fetches,
            "fetched_tokens": fetched_tokens,
        }
        rs = self.routing_stats or {}
        for k in ("affinity_hits", "affinity_misses",
                  "overload_diversions", "fetch_hints",
                  "peer_fetches", "remote_fetches", "fetch_bytes",
                  "fetch_time_s", "fetch_misses", "fetch_recomputes",
                  "registry_prefixes", "registry_entries",
                  "registry_publishes", "registry_invalidations",
                  "registry_expirations", "registry_evictions"):
            out[k] = rs.get(k, 0)
        routed = out["affinity_hits"] + out["affinity_misses"]
        out["affinity_hit_rate"] = out["affinity_hits"] / routed \
            if routed else 0.0
        rem = self.remote_stats or {}
        out["remote_capacity_bytes"] = rem.get("capacity_bytes", 0.0)
        out["remote_used_bytes"] = rem.get("used_bytes", 0.0)
        out["remote_peak_used_bytes"] = rem.get("peak_used_bytes", 0.0)
        out["remote_entries"] = rem.get("n_entries", 0)
        out["remote_stores"] = rem.get("stores", 0)
        out["remote_hits"] = rem.get("hits", 0)
        out["remote_misses"] = rem.get("misses", 0)
        out["remote_evictions"] = rem.get("evictions", 0)
        out["remote_rejects"] = rem.get("rejects", 0)
        return out

    # ---- parallelism (docs/PARALLELISM.md) ----------------------------
    def parallel_summary(self) -> Dict[str, float]:
        """Pipeline-parallel accounting across workers: total fill/drain
        bubble and stage-boundary comm time, and their fractions of the
        pipeline span (step time x steps, framework overhead excluded).
        ``bubble_fraction`` matches the closed form
        ``(pp-1)/(microbatches+pp-1)`` when every iteration fills its
        configured micro-batch count (tail iterations shrink it)."""
        if not self.parallel_stats:
            return {"pp_bubble_time": 0.0, "pp_comm_time": 0.0,
                    "pp_span_time": 0.0, "bubble_fraction": 0.0,
                    "comm_fraction": 0.0}
        vals = self.parallel_stats.values()
        bubble = sum(s["pp_bubble_time"] for s in vals)
        comm = sum(s["pp_comm_time"] for s in vals)
        span = sum(s["pp_span_time"] for s in vals)
        return {"pp_bubble_time": bubble, "pp_comm_time": comm,
                "pp_span_time": span,
                "bubble_fraction": bubble / span if span else 0.0,
                "comm_fraction": comm / span if span else 0.0}

    # ---- speculative decoding (repro.core.specdecode) -----------------
    def spec_summary(self) -> Dict[str, float]:
        """Aggregate speculative-decoding counters: acceptance rate of
        draft tokens, effective tokens emitted per verify step (the
        speedup lever: 1.0 means speculation bought nothing), and the
        fraction of tokens produced speculatively."""
        if self.stats is not None:
            steps, proposed = self.stats.spec_steps, self.stats.draft_proposed
            accepted, spec_tokens = self.stats.draft_accepted, \
                self.stats.spec_tokens
            total_tokens = self.stats.tokens
        else:
            steps = sum(r.spec_steps for r in self.requests)
            proposed = sum(r.draft_proposed for r in self.requests)
            accepted = sum(r.draft_accepted for r in self.requests)
            spec_tokens = sum(r.spec_tokens for r in self.requests)
            total_tokens = sum(r.tokens_generated for r in self.requests)
        return {
            "spec_steps": steps,
            "acceptance_rate": accepted / proposed if proposed
            else float("nan"),
            "eff_tokens_per_step": spec_tokens / steps if steps
            else float("nan"),
            "spec_token_frac": spec_tokens / total_tokens if total_tokens
            else 0.0,
        }

    # ---- multi-tenant breakdowns (repro.core.tenancy) -----------------
    def tenant_ids(self) -> List[str]:
        if self.tenant_specs:
            return sorted(self.tenant_specs)
        if self.stats is not None:
            return sorted(self.stats.tenants)
        return sorted({r.tenant_id for r in self.requests
                       if r.tenant_id is not None})

    def for_tenant(self, tenant_id: str) -> "Results":
        """A Results view restricted to one tenant's requests (shares the
        simulation span, so rates remain comparable across tenants)."""
        return Results(
            requests=[r for r in self.requests if r.tenant_id == tenant_id],
            sim_time=self.sim_time,
            tenant_specs=self.tenant_specs,
            stats=self.stats.tenants.get(tenant_id)
            if self.stats is not None else None)

    def tenant_token_throughputs(self) -> Dict[str, float]:
        """Generated tokens/s per tenant over the shared finished-span —
        the quantity WFQ shares by weight."""
        if self.stats is not None:
            span = self.stats.span
            return {t: self.stats.tenants[t].tokens / max(span, 1e-9)
                    if t in self.stats.tenants else 0.0
                    for t in self.tenant_ids()}
        f = self.finished
        if not f:
            return {t: 0.0 for t in self.tenant_ids()}
        span = max(r.t_finish for r in f) - min(r.arrival_time for r in f)
        out = {}
        for t in self.tenant_ids():
            toks = sum(r.tokens_generated for r in f if r.tenant_id == t)
            out[t] = toks / max(span, 1e-9)
        return out

    def fairness_index(self, *, weighted: bool = False) -> float:
        """Jain index over per-tenant token throughput; ``weighted``
        normalizes each tenant by its tier weight first, so 1.0 means
        throughput shares match configured weights exactly."""
        tps = self.tenant_token_throughputs()
        xs = []
        for t, v in sorted(tps.items()):
            w = 1.0
            if weighted and self.tenant_specs and t in self.tenant_specs:
                w = max(getattr(self.tenant_specs[t].tier, "weight", 1.0),
                        1e-9)
            xs.append(v / w)
        return jain_index(xs)

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant latency/TTFT percentiles, SLO attainment, goodput,
        rejects and gateway queueing delay.  Per-tenant counters sum to
        the aggregate (property-tested in tests/test_tenancy.py)."""
        if self.stats is not None:
            return self._tenant_summary_streaming()
        out: Dict[str, Dict[str, float]] = {}
        tps = self.tenant_token_throughputs()
        for t in self.tenant_ids():
            sub = self.for_tenant(t)
            spec = (self.tenant_specs or {}).get(t)
            ttft_slo = getattr(getattr(spec, "tier", None), "ttft_slo", 0.0)
            tpot_slo = getattr(getattr(spec, "tier", None), "tpot_slo", 0.0)
            fin = sub.finished
            n_ok = sum(1 for r in fin if r.meets_slo(ttft_slo, tpot_slo))
            qd = [r.queue_delay for r in sub.requests
                  if r.queue_delay is not None]
            lats = sub._sorted("latencies", sub.latencies())
            tt = sub._sorted("ttfts", sub.ttfts())
            row = {
                "n_requests": len(sub.requests),
                "n_finished": len(fin),
                "n_rejected": sum(1 for r in sub.requests if r.rejected),
                "tokens": sum(r.tokens_generated for r in fin),
                "token_tps": tps.get(t, 0.0),
                "latency_p50": _interp_percentile(lats, 50),
                "latency_p99": _interp_percentile(lats, 99),
                "ttft_p50": _interp_percentile(tt, 50),
                "ttft_p99": _interp_percentile(tt, 99),
                "queue_delay_mean": sum(qd) / len(qd) if qd
                else 0.0,
                "slo_attainment": n_ok / len(sub.requests)
                if sub.requests else float("nan"),
                "goodput_rps": sub.slo_goodput(
                    ttft_slo=ttft_slo, mtpot_slo=tpot_slo),
                "preempt_rate": sub.preemption_rate(),
            }
            out[t] = row
        return out

    def _tenant_summary_streaming(self) -> Dict[str, Dict[str, float]]:
        """tenant_summary from folded per-tenant sketches (drop mode):
        same keys, span shared with the aggregate so rates compare."""
        out: Dict[str, Dict[str, float]] = {}
        span = self.stats.span
        for t in self.tenant_ids():
            s = self.stats.tenants.get(t)
            if s is None:
                s = StreamingStats(self.stats.alpha)
            out[t] = {
                "n_requests": s.n_folded,
                "n_finished": s.n_finished,
                "n_rejected": s.n_rejected,
                "tokens": s.tokens,
                "token_tps": s.tokens / max(span, 1e-9),
                "latency_p50": s.latency.percentile(50),
                "latency_p99": s.latency.percentile(99),
                "ttft_p50": s.ttft.percentile(50),
                "ttft_p99": s.ttft.percentile(99),
                "queue_delay_mean": s.queue_delay.mean
                if s.queue_delay.count else 0.0,
                "slo_attainment": s.n_slo_ok / s.n_folded
                if s.slo is not None and s.n_folded else float("nan"),
                "goodput_rps": s.n_slo_ok / max(span, 1e-9)
                if s.slo is not None else float("nan"),
                "preempt_rate": s.preempts / max(1, s.n_folded),
            }
        return out

    # ---- heterogeneous multi-model fleets (docs/HETEROGENEITY.md) -----
    def model_ids(self) -> List[str]:
        """Every model served or hosted, in sorted order."""
        out = set()
        if self.worker_models:
            out.update(m for m in self.worker_models.values()
                       if m is not None)
        if self.stats is not None:
            out.update(self.stats.models)
        out.update(r.model for r in self.requests if r.model is not None)
        return sorted(out)

    def for_model(self, model: str) -> "Results":
        """A Results view restricted to one model's requests (shares the
        simulation span, so rates remain comparable across models)."""
        return Results(
            requests=[r for r in self.requests if r.model == model],
            sim_time=self.sim_time,
            tenant_specs=self.tenant_specs,
            stats=self.stats.models.get(model)
            if self.stats is not None else None,
            worker_models={wid: m for wid, m
                           in (self.worker_models or {}).items()
                           if m == model} or None,
            default_model=self.default_model)

    def model_summary(self, *, ttft_slo: float = 0.0,
                      mtpot_slo: float = 0.0
                      ) -> Dict[str, Dict[str, float]]:
        """Per-model latency/TTFT percentiles, SLO attainment (fraction
        of *finished* requests meeting the SLO), goodput and hosting
        worker count — the multi-model mirror of ``tenant_summary``.
        ``MODEL_SUMMARY_FIELDS`` lists every row key.  In streaming mode
        SLO columns require the thresholds configured up front
        (``SimSpec.streaming_slo``), like ``slo_goodput``."""
        if self.stats is not None:
            return self._model_summary_streaming(ttft_slo, mtpot_slo)
        out: Dict[str, Dict[str, float]] = {}
        f = self.finished
        span = (max(r.t_finish for r in f)
                - min(r.arrival_time for r in f)) if f else 0.0
        hosts = self.worker_models or {}
        for m in self.model_ids():
            sub = self.for_model(m)
            fin = sub.finished
            n_ok = sum(1 for r in fin if r.meets_slo(ttft_slo, mtpot_slo))
            lats = sub._sorted("latencies", sub.latencies())
            tt = sub._sorted("ttfts", sub.ttfts())
            out[m] = {
                "n_requests": len(sub.requests),
                "n_finished": len(fin),
                "tokens": sum(r.tokens_generated for r in fin),
                "token_tps": sum(r.tokens_generated for r in fin)
                / max(span, 1e-9) if fin else 0.0,
                "latency_p50": _interp_percentile(lats, 50),
                "latency_p99": _interp_percentile(lats, 99),
                "ttft_p50": _interp_percentile(tt, 50),
                "ttft_p99": _interp_percentile(tt, 99),
                "slo_attainment": n_ok / len(fin) if fin
                else float("nan"),
                "goodput_rps": n_ok / max(span, 1e-9) if fin else 0.0,
                "preempt_rate": sub.preemption_rate(),
                "n_workers": sum(1 for v in hosts.values() if v == m),
            }
        return out

    def _model_summary_streaming(self, ttft_slo: float, mtpot_slo: float
                                 ) -> Dict[str, Dict[str, float]]:
        """model_summary from folded per-model sketches (drop mode):
        same keys, span shared with the aggregate so rates compare."""
        out: Dict[str, Dict[str, float]] = {}
        span = self.stats.span
        hosts = self.worker_models or {}
        for m in self.model_ids():
            s = self.stats.models.get(m)
            if s is None:
                s = StreamingStats(self.stats.alpha)
            slo_match = s.slo == (ttft_slo, mtpot_slo) \
                and s.slo is not None
            out[m] = {
                "n_requests": s.n_folded,
                "n_finished": s.n_finished,
                "tokens": s.tokens,
                "token_tps": s.tokens / max(span, 1e-9),
                "latency_p50": s.latency.percentile(50),
                "latency_p99": s.latency.percentile(99),
                "ttft_p50": s.ttft.percentile(50),
                "ttft_p99": s.ttft.percentile(99),
                "slo_attainment": s.n_slo_ok / s.n_finished
                if slo_match and s.n_finished else float("nan"),
                "goodput_rps": s.n_slo_ok / max(span, 1e-9)
                if slo_match else float("nan"),
                "preempt_rate": s.preempts / max(1, s.n_folded),
                "n_workers": sum(1 for v in hosts.values() if v == m),
            }
        return out

    # ---- closed-loop autoscaling (docs/AUTOSCALING.md) ----------------
    def scaling_summary(self) -> dict:
        """Scale-event and cost-economics accounting for a (possibly)
        time-varying fleet.  ``SCALING_SUMMARY_FIELDS`` lists every
        returned key.

        Billing is time-weighted: each worker bills its price over its
        provisioned-to-retired span (``worker_spans``), so
        ``billed_cost`` equals ``spec_price * sim_time`` only for
        static fleets.  ``cost_per_1m_*_tokens`` splits the billed
        cost by each worker's prefill/decode busy-time share (idle
        time allocated pro rata; workers that never ran are excluded
        from the split but still appear in ``billed_cost``)."""
        T = max(self.sim_time, 1e-12)
        spans = self.worker_spans or {
            wid: (0.0, None)
            for wid in range(self.n_workers or len(self.worker_mem)
                             or 1)}
        prices = self.worker_prices or {}
        span_s = {wid: max(0.0, min(e if e is not None else T, T) - s)
                  for wid, (s, e) in spans.items()}
        worker_seconds = sum(span_s.values())
        billed = sum(prices.get(wid, 0.0) * sp
                     for wid, sp in span_s.items())
        # fleet size as a step series over provision/retire breakpoints
        deltas: List[Tuple[float, int]] = []
        for wid, (s, e) in sorted(spans.items()):
            deltas.append((min(s, T), 1))
            if e is not None:
                deltas.append((min(e, T), -1))
        deltas.sort()
        series: List[Tuple[float, int]] = []
        size = 0
        for t, d in deltas:
            size += d
            if series and series[-1][0] == t:
                series[-1] = (t, size)
            else:
                series.append((t, size))
        sizes = [s for _, s in series] or [0]
        ph = self.phase_stats or {}
        p_tok = sum(d["prefill_tokens"] for d in ph.values())
        d_tok = sum(d["decode_tokens"] for d in ph.values())
        if self.stats is not None:
            tokens = self.stats.tokens
        else:
            tokens = sum(r.tokens_generated for r in self.finished)
        p_cost = d_cost = 0.0
        for wid, d in ph.items():
            busy = d.get("busy_time", 0.0)
            if busy <= 0:
                continue
            c = prices.get(wid, 0.0) * span_s.get(wid, 0.0)
            p_cost += c * d["prefill_time"] / busy
            d_cost += c * d["decode_time"] / busy
        events = self.scale_events or []
        n_up = sum(1 for e in events if e.action == "up_request")
        n_down = sum(1 for e in events if e.action == "down_drain")
        req_t: Dict[int, float] = {}
        lags: List[float] = []
        for e in events:
            if e.action == "up_request":
                req_t[e.worker] = e.time
            elif e.action == "up_ready" and e.worker in req_t:
                lags.append(e.time - req_t.pop(e.worker))
        return {
            "n_scale_up": n_up,
            "n_scale_down": n_down,
            "fleet_size_min": min(sizes),
            "fleet_size_max": max(sizes),
            "fleet_size_avg": worker_seconds / T,
            "fleet_size_final": sizes[-1],
            "fleet_size_series": series,
            "worker_seconds": worker_seconds,
            "scale_up_lag_s": sum(lags) / len(lags) if lags else 0.0,
            "billed_cost": billed,
            "cost_per_1m_tokens": billed / tokens * 1e6
            if tokens else float("nan"),
            "cost_per_1m_prefill_tokens": p_cost / p_tok * 1e6
            if p_tok else float("nan"),
            "cost_per_1m_decode_tokens": d_cost / d_tok * 1e6
            if d_tok else float("nan"),
            "events": list(events),
        }

    # ------------------------------------------------------------------
    def availability_summary(self, *, target: float = 0.995,
                             window: Optional[float] = None) -> dict:
        """Availability and error-budget accounting derived from the
        injected-fault log (docs/RELIABILITY.md).

        Definitions (``AVAILABILITY_FIELDS`` lists every returned key):

        * **service availability** — fraction of the observation span
          with at least one worker alive (the cluster could serve);
          ``service_downtime_s`` is the complementary all-down time,
        * **capacity availability** — mean per-worker uptime fraction,
          i.e. ``1 - sum(worker downtime) / (n_workers * span)``; it
          penalizes every lost replica, not just total outages,
        * **error budget** — ``(1 - target) * window_s`` seconds of
          allowed service downtime; the observed all-down time is
          rate-extrapolated from the simulated span to the window
          (pass e.g. ``window=30 * 86400`` for a 30-day budget), and
          ``burn_rate`` is observed unavailability over allowed
          unavailability (1.0 = exactly on budget).

        Downtime intervals open at a ``fail`` event and close at the
        matching ``recover`` (which lands *after* the repair draw and
        the model reload, so recovery cost counts as downtime); an
        interval still open at the end of the run is clipped to
        ``sim_time``.  Degraded (slowdown != 1) spans are tracked
        separately — a straggler serves, slowly.

        With a time-varying fleet (autoscaling), capacity accounting
        is over each worker's *provisioned* span (``worker_spans``),
        not ``n_workers * sim_time``: a replica that existed for half
        the run contributes half a worker-run of capacity, and its
        not-yet-provisioned / already-retired time counts as absent
        for service availability but is not charged as downtime.
        Static fleets reduce to the historical fixed-``n_workers``
        formulas exactly."""
        T = max(self.sim_time, 1e-12)
        spans = self.worker_spans
        if spans:
            wids = sorted(spans)
            span_of = {
                wid: max(0.0, min(e if e is not None else T, T) - s)
                for wid, (s, e) in spans.items()}
        else:
            # legacy surface (hand-built Results): fixed fleet, every
            # worker provisioned for the whole run
            wids = list(range(self.n_workers or len(self.worker_mem)
                              or 1))
            span_of = {wid: T for wid in wids}
        n = len(wids)
        provisioned_s = sum(span_of.values()) or T
        events = sorted(self.fault_events or [],
                        key=lambda e: (e.time, e.worker))
        down: Dict[int, List[Tuple[float, float]]] = {}
        open_down: Dict[int, float] = {}
        deg_open: Dict[int, float] = {}
        degraded = 0.0
        n_failures = 0
        for ev in events:
            if ev.kind == "fail":
                if ev.worker not in open_down:
                    open_down[ev.worker] = ev.time
                    n_failures += 1
            elif ev.kind == "recover":
                t0 = open_down.pop(ev.worker, None)
                if t0 is not None:
                    down.setdefault(ev.worker, []).append(
                        (t0, min(ev.time, T)))
            elif ev.kind == "slowdown":
                if ev.factor != 1.0:
                    deg_open.setdefault(ev.worker, ev.time)
                else:
                    t0 = deg_open.pop(ev.worker, None)
                    if t0 is not None:
                        degraded += max(0.0, min(ev.time, T) - t0)
            # "drain" is not downtime: the worker serves its queue
        for wid, t0 in open_down.items():
            down.setdefault(wid, []).append((t0, T))
        for t0 in deg_open.values():
            degraded += max(0.0, T - t0)
        downtime_per_worker = {
            wid: sum(b - a for a, b in down.get(wid, ()))
            for wid in wids}
        capacity_down = sum(downtime_per_worker.values())
        # service downtime: sweep the interval deltas, accumulate the
        # spans where every one of the nn workers is down at once
        def _all_down(iv_lists, nn: int) -> float:
            deltas: List[Tuple[float, int]] = []
            for ivs in iv_lists:
                for a, b in ivs:
                    deltas.append((a, 1))
                    deltas.append((b, -1))
            deltas.sort()
            total = 0.0
            cnt = 0
            t_all: Optional[float] = None
            for t, d in deltas:
                was_all = cnt == nn
                cnt += d
                if not was_all and cnt == nn:
                    t_all = t
                elif was_all and cnt < nn and t_all is not None:
                    total += t - t_all
                    t_all = None
            return total

        # for service availability a worker is also "absent" outside
        # its provisioned span: before a scale-up lands and after a
        # retirement the replica cannot serve (static fleets add no
        # intervals here, preserving the historical numbers)
        service_iv = {wid: list(down.get(wid, ())) for wid in wids}
        if spans:
            for wid, (s, e) in spans.items():
                if s > 0:
                    service_iv[wid].append((0.0, min(s, T)))
                if e is not None and e < T:
                    service_iv[wid].append((e, T))
        service_down = _all_down(service_iv.values(), n)
        window_s = window if window is not None else T
        scale = window_s / T
        error_budget_s = (1.0 - target) * window_s
        budget_consumed_s = service_down * scale
        if self.stats is not None:
            n_total = self.stats.n_folded + len(self.requests)
            n_fin = self.stats.n_finished
        else:
            n_total = len(self.requests)
            n_fin = len(self.finished)
        tenants: Dict[str, dict] = {}
        if self.tenant_specs:
            for tid, row in self.tenant_summary().items():
                nreq = row.get("n_requests", 0) or 0
                tenants[tid] = {
                    "success_rate": row.get("n_finished", 0) / nreq
                    if nreq else 1.0,
                    "slo_attainment": row.get("slo_attainment",
                                              float("nan"))}
        # per-model availability over each model's hosting workers
        # (docs/HETEROGENEITY.md): a model is serviceable while at least
        # one of its hosts is up, regardless of the rest of the fleet
        models: Dict[str, dict] = {}
        if self.worker_models:
            for m in sorted(set(self.worker_models.values())):
                wids = [wid for wid, name in self.worker_models.items()
                        if name == m]
                m_down = _all_down([down.get(wid, ()) for wid in wids],
                                   len(wids))
                m_cap = sum(downtime_per_worker.get(wid, 0.0)
                            for wid in wids)
                m_span = sum(span_of.get(wid, T) for wid in wids)
                models[m] = {
                    "service_availability": 1.0 - m_down / T,
                    "capacity_availability":
                        1.0 - m_cap / max(m_span, 1e-12),
                    "n_workers": len(wids)}
        return {
            "service_availability": 1.0 - service_down / T,
            "capacity_availability":
                1.0 - capacity_down / provisioned_s,
            "availability_per_worker": {
                wid: 1.0 - dt / max(span_of.get(wid, T), 1e-12)
                for wid, dt in downtime_per_worker.items()},
            "downtime_per_worker": downtime_per_worker,
            "service_downtime_s": service_down,
            "capacity_downtime_s": capacity_down,
            "degraded_s": degraded,
            "n_failures": n_failures,
            "mtbf_observed_s": (provisioned_s - capacity_down)
            / n_failures if n_failures else None,
            "mttr_observed_s": capacity_down / n_failures
            if n_failures else None,
            "target": target,
            "window_s": window_s,
            "error_budget_s": error_budget_s,
            "budget_consumed_s": budget_consumed_s,
            "budget_remaining_frac":
                1.0 - budget_consumed_s / error_budget_s
                if error_budget_s > 0 else float("nan"),
            "burn_rate": (service_down / T) / (1.0 - target)
            if target < 1.0 else float("nan"),
            "request_success_rate": n_fin / n_total if n_total else 1.0,
            "tenants": tenants,
            "models": models,
        }

    def summary(self, *, ttft_slo: float = 0.0,
                mtpot_slo: float = 0.0) -> Dict[str, float]:
        stats = self.stats
        n_finished = stats.n_finished if stats is not None \
            else len(self.finished)
        out = {"throughput_rps": self.throughput(),
               "throughput_tps": self.token_throughput(),
               "n_finished": n_finished,
               "preempt_rate": self.preemption_rate(),
               "sim_time": self.sim_time}
        out.update({f"latency_{k}": v
                    for k, v in self.latency_stats().items()})
        if stats is not None:
            out["ttft_p50"] = stats.ttft.percentile(50)
            out["ttft_p99"] = stats.ttft.percentile(99)
        else:
            tt = self._sorted("ttfts", self.ttfts())
            out["ttft_p50"] = _interp_percentile(tt, 50)
            out["ttft_p99"] = _interp_percentile(tt, 99)
        if ttft_slo or mtpot_slo:
            out["goodput_rps"] = self.slo_goodput(
                ttft_slo=ttft_slo, mtpot_slo=mtpot_slo)
        if self.pool_stats:
            out.update({f"pool_{k}": v for k, v in self.pool_stats.items()})
        if self.swap_stats or (self.mem_stats and any(
                s["shared_hits"] + s["shared_misses"]
                for s in self.mem_stats.values())):
            mem = self.memory_summary()
            for k in ("swap_preempts", "recompute_preempts",
                      "swap_bytes_out", "prefix_hit_rate", "cow_copies"):
                if k in mem:
                    out[k] = mem[k]
        has_spec = stats.spec_steps if stats is not None \
            else any(r.spec_steps for r in self.requests)
        if has_spec:
            out.update({f"spec_{k}" if not k.startswith("spec_") else k: v
                        for k, v in self.spec_summary().items()})
        if self.tenant_specs:
            out["n_rejected"] = stats.n_rejected if stats is not None \
                else sum(1 for r in self.requests if r.rejected)
            out["fairness_jain"] = self.fairness_index()
            out["fairness_jain_weighted"] = self.fairness_index(
                weighted=True)
        return out
