"""Workload generation: lazy request streams sampled from datasets.

The paper samples 2k–50k requests from ShareGPT.  ShareGPT itself is not
available offline, so the default workload is a **calibrated synthetic**:
log-normal prompt/output length marginals whose moments match the
published ShareGPT statistics used by the vLLM paper (mean prompt ≈ 161
tokens with a heavy tail clipped at 1024, mean output ≈ 338 — see
EXPERIMENTS.md for the exact calibration note).  A JSONL trace loader
with the identical interface covers users who do have real traces, and
fixed-length workloads reproduce the paper's Table II / Fig. 7 setups.

Arrival processes (``WorkloadSpec.arrival``, see docs/WORKLOADS.md)
cover the serving-survey taxonomy: plain Poisson, bursty MMPP on-off,
diurnal sinusoid (thinned Poisson), and trace replay.

The primary interface is the lazy :class:`RequestSource` iterator
protocol — ``make_source(spec)`` / ``make_tenant_source(tenants)``
yield ``Request`` objects in nondecreasing arrival order with O(live
sessions) memory, so million-request simulations never materialize the
full list.  ``generate()`` / ``generate_multi()`` remain as thin
materializing wrappers for callers that want the full sorted list.
"""
from __future__ import annotations

import heapq
import json
import math
import random
import zlib
from dataclasses import dataclass, replace
from typing import Iterator, List, Optional, Sequence

from repro_torch.core.request import Request

# Log-normal parameterization calibrated to ShareGPT moments:
#   prompt:  median exp(mu)=110, sigma=1.0  -> mean ~181, P99 ~1.1k
#   output:  median exp(mu)=215, sigma=0.95 -> mean ~338
SHAREGPT_PROMPT = (math.log(110.0), 1.0)
SHAREGPT_OUTPUT = (math.log(215.0), 0.95)

#: length models accepted by ``WorkloadSpec.lengths`` (docs/WORKLOADS.md)
LENGTH_KINDS = ("sharegpt", "lognormal", "fixed", "trace")
#: arrival processes accepted by ``WorkloadSpec.arrival``
ARRIVAL_KINDS = ("poisson", "bursty", "diurnal", "trace")


@dataclass
class WorkloadSpec:
    num_requests: int = 1000
    qps: float = 4.0                     # mean arrival rate; 0 => all at t=0
    seed: int = 0

    #: model this traffic targets (docs/HETEROGENEITY.md): stamped on
    #: every generated request so a model-aware global policy only
    #: dispatches it to workers hosting that model.  None = the
    #: simulation's default arch.  Multi-model mixes merge per-model
    #: workloads through the tenant-source machinery
    #: (``make_tenant_source``), each tenant carrying its own ``model``
    model: Optional[str] = None

    # arrival process: "poisson" | "bursty" | "diurnal" | "trace"
    arrival: str = "poisson"
    # bursty (MMPP on-off): exponential phase durations; the arrival rate
    # is qps*burst_on_scale during ON phases, qps*burst_off_scale during
    # OFF phases (defaults keep the long-run mean rate at ~qps when
    # on/off phases have equal mean duration)
    burst_on_mean: float = 10.0
    burst_off_mean: float = 10.0
    burst_on_scale: float = 1.8
    burst_off_scale: float = 0.2
    # diurnal sinusoid: rate(t) = qps * (1 + amplitude*sin(2πt/period)),
    # sampled exactly via Lewis-Shedler thinning
    diurnal_period: float = 3600.0
    diurnal_amplitude: float = 0.8

    # length model: "sharegpt" | "fixed" | "lognormal" | "trace"
    lengths: str = "sharegpt"
    prompt_len: int = 128                # fixed mode
    output_len: int = 128
    prompt_lognormal: tuple = SHAREGPT_PROMPT
    output_lognormal: tuple = SHAREGPT_OUTPUT
    max_prompt_len: int = 1024
    max_output_len: int = 1024
    trace_path: Optional[str] = None

    # multi-round conversations (Fig. 14): fraction of sessions with >1
    # round; rounds ~ Uniform[min,max]; think time between rounds.
    multi_round_frac: float = 0.0
    rounds_min: int = 2
    rounds_max: int = 7
    think_time_mean: float = 2.0

    # shared-prefix workloads (docs/MEMORY.md): every session carries a
    # common system prompt of ``shared_prefix_len`` tokens (added to its
    # first-round prompt) drawn from one of ``shared_prefix_groups``
    # distinct prefixes; requests expose it as (prefix_id, prefix_len)
    # so a prefix-sharing BlockManager can share the resident blocks
    shared_prefix_len: int = 0
    shared_prefix_groups: int = 1


def _sample_len(rng: random.Random, spec: WorkloadSpec, which: str) -> int:
    if spec.lengths == "fixed":
        return spec.prompt_len if which == "prompt" else spec.output_len
    mu, sigma = (spec.prompt_lognormal if which == "prompt"
                 else spec.output_lognormal)
    cap = spec.max_prompt_len if which == "prompt" else spec.max_output_len
    return max(1, min(cap, int(rng.lognormvariate(mu, sigma))))


# ---------------------------------------------------------------------------
# arrival processes: iterators of absolute arrival times
# ---------------------------------------------------------------------------
def _poisson_times(rng: random.Random, spec: WorkloadSpec) -> Iterator[float]:
    t = 0.0
    while True:
        if spec.qps > 0:
            t += rng.expovariate(spec.qps)
        yield t


def _bursty_times(rng: random.Random, spec: WorkloadSpec) -> Iterator[float]:
    """MMPP on-off: Poisson arrivals whose rate switches between
    qps*burst_on_scale and qps*burst_off_scale at exponential phase
    boundaries.  Memorylessness makes redrawing the gap at each phase
    switch an exact simulation of the modulated process."""
    if spec.qps <= 0:
        while True:
            yield 0.0
    t = 0.0
    on = True
    phase_end = rng.expovariate(1.0 / max(spec.burst_on_mean, 1e-9))
    while True:
        rate = spec.qps * (spec.burst_on_scale if on
                           else spec.burst_off_scale)
        if rate <= 0:
            t = phase_end
        else:
            gap = rng.expovariate(rate)
            if t + gap <= phase_end:
                t += gap
                yield t
                continue
            t = phase_end
        on = not on
        mean = spec.burst_on_mean if on else spec.burst_off_mean
        phase_end = t + rng.expovariate(1.0 / max(mean, 1e-9))


def _diurnal_times(rng: random.Random, spec: WorkloadSpec) -> Iterator[float]:
    """Sinusoid-modulated Poisson via Lewis-Shedler thinning: propose at
    the peak rate, accept with probability rate(t)/peak."""
    if spec.qps <= 0:
        while True:
            yield 0.0
    amp = min(max(spec.diurnal_amplitude, 0.0), 0.999)
    peak = spec.qps * (1.0 + amp)
    omega = 2.0 * math.pi / max(spec.diurnal_period, 1e-9)
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        rate = spec.qps * (1.0 + amp * math.sin(omega * t))
        if rng.random() * peak <= rate:
            yield t


_ARRIVAL_ITERS = {"poisson": _poisson_times, "bursty": _bursty_times,
                  "diurnal": _diurnal_times}


# ---------------------------------------------------------------------------
# RequestSource protocol: lazy, arrival-ordered request iterators
# ---------------------------------------------------------------------------
class RequestSource:
    """Iterable of ``Request`` objects in nondecreasing arrival order.

    Sources are lazy: the dispatcher pulls one request at a time, so
    memory stays O(live sessions) rather than O(num_requests).  Iterating
    a source twice restarts it from its seed (pure function of the spec).
    """

    def __iter__(self) -> Iterator[Request]:
        raise NotImplementedError


class SyntheticSource(RequestSource):
    """Sampled workload: a configured arrival process plus length model,
    with multi-round sessions held in a small pending heap (future
    rounds re-enter the stream at their think-time arrival)."""

    def __init__(self, spec: WorkloadSpec):
        if spec.arrival not in _ARRIVAL_ITERS:
            hint = " (trace replay is TraceSource; build via " \
                "make_source)" if spec.arrival == "trace" else ""
            raise ValueError(f"SyntheticSource cannot sample arrival "
                             f"kind {spec.arrival!r}{hint}; have "
                             f"{sorted(_ARRIVAL_ITERS)}")
        if spec.lengths not in LENGTH_KINDS or spec.lengths == "trace":
            raise ValueError(f"SyntheticSource cannot sample length "
                             f"model {spec.lengths!r}")
        self.spec = spec

    def __iter__(self) -> Iterator[Request]:
        spec = self.spec
        rng = random.Random(spec.seed)
        times = _ARRIVAL_ITERS[spec.arrival](rng, spec)
        # (arrival, generation order, request): sessions arrive at
        # nondecreasing base times, so once the next session's base
        # arrival is known every pending entry at or before it is final
        pending: List[tuple] = []
        rid = 0
        sid = 0
        out_id = 0
        n_emitted = 0
        while n_emitted < spec.num_requests:
            arrival = next(times)
            while pending and pending[0][0] <= arrival:
                _, _, req = heapq.heappop(pending)
                req.id = out_id
                out_id += 1
                yield req

            n_rounds = 1
            if spec.multi_round_frac > 0 \
                    and rng.random() < spec.multi_round_frac:
                n_rounds = rng.randint(spec.rounds_min, spec.rounds_max)
            sid += 1
            prefix_id = None
            if spec.shared_prefix_len > 0:
                # one system prompt per session; groups share content
                prefix_id = rng.randrange(
                    max(1, spec.shared_prefix_groups))
            history = 0
            rt = arrival
            for r in range(n_rounds):
                if n_emitted >= spec.num_requests:
                    break
                p = _sample_len(rng, spec, "prompt")
                if r == 0 and prefix_id is not None:
                    p += spec.shared_prefix_len   # system prompt up front
                o = _sample_len(rng, spec, "output")
                heapq.heappush(pending, (rt, rid, Request(
                    id=rid, arrival_time=rt, prompt_len=history + p,
                    output_len=o, session_id=sid, round_idx=r,
                    history_len=history, prefix_id=prefix_id,
                    prefix_len=spec.shared_prefix_len
                    if prefix_id is not None else 0,
                    model=spec.model)))
                rid += 1
                n_emitted += 1
                history += p + o
                rt += rng.expovariate(1.0 / spec.think_time_mean) \
                    if spec.think_time_mean > 0 else 0.0
        while pending:
            _, _, req = heapq.heappop(pending)
            req.id = out_id
            out_id += 1
            yield req


def _parse_trace_record(i: int, rec: dict,
                        model: Optional[str] = None) -> Request:
    """One JSONL trace line -> Request (the ``save_trace`` field set);
    shared by streaming replay and the materializing ``generate()`` so
    the two modes cannot drift on trace semantics.  A per-record
    ``model`` field wins over the workload-level default."""
    return Request(
        id=i, arrival_time=float(rec.get("arrival", 0.0)),
        prompt_len=int(rec["prompt_len"]),
        output_len=int(rec["output_len"]),
        session_id=rec.get("session_id"),
        round_idx=int(rec.get("round", 0)),
        prefix_id=rec.get("prefix_id"),
        prefix_len=int(rec.get("prefix_len", 0)),
        model=rec.get("model", model))


class TraceSource(RequestSource):
    """Replay a JSONL trace lazily (one line per request; fields
    ``arrival``, ``prompt_len``, ``output_len``, optional ``session_id``
    / ``round`` — the ``save_trace`` format).  Streaming replay requires
    nondecreasing arrivals; for unsorted traces use ``generate()``,
    which materializes and sorts."""

    def __init__(self, spec: WorkloadSpec):
        assert spec.trace_path, "trace workload needs trace_path"
        self.spec = spec

    def __iter__(self) -> Iterator[Request]:
        spec = self.spec
        last = -math.inf
        with open(spec.trace_path) as f:
            for i, line in enumerate(f):
                if i >= spec.num_requests:
                    break
                req = _parse_trace_record(i, json.loads(line), spec.model)
                if req.arrival_time < last:
                    raise ValueError(
                        f"{spec.trace_path}:{i + 1}: arrivals not sorted "
                        f"({req.arrival_time} after {last}); sort the "
                        f"trace or use workload.generate()")
                last = req.arrival_time
                yield req


class MergedSource(RequestSource):
    """Heap-merge of per-tenant sources into one arrival-ordered stream.

    Each tenant's sub-stream keeps its internal order (per-tenant ids
    are strictly increasing within a tenant); ties at equal arrival time
    break by tenant declaration order, then per-tenant id — the same
    total order ``generate_multi`` produces by sorting.  Global ids are
    reassigned sequentially in emission order, so ids are stable and
    dense regardless of how many requests are ultimately pulled.
    """

    def __init__(self, tenants: Sequence):
        order = {t.tenant_id: i for i, t in enumerate(tenants)}
        if len(order) != len(tenants):
            raise ValueError("duplicate tenant_id in tenant specs")
        self.tenants = list(tenants)
        self._order = order

    def _tenant_stream(self, t) -> Iterator[Request]:
        ws = t.workload
        sub_spec = replace(ws, seed=ws.seed ^ zlib.crc32(
            t.tenant_id.encode()))
        if ws.lengths == "trace" or ws.arrival == "trace":
            # traces may be unsorted on disk and the merge needs each
            # tenant stream arrival-ordered: materialize-and-sort this
            # tenant (the pre-streaming generate_multi behaviour); the
            # other tenants stay lazy
            sub = iter(generate(sub_spec))
        else:
            sub = make_source(sub_spec)
        n = len(self.tenants)
        for r in sub:
            r.tenant_id = t.tenant_id
            r.priority = t.tier.priority
            r.weight = t.tier.weight
            if r.session_id is not None:
                # keep sessions distinct across tenants
                r.session_id = r.session_id * n + self._order[t.tenant_id]
            if r.prefix_id is not None:
                # system prompts are tenant-private: never share across
                r.prefix_id = r.prefix_id * n + self._order[t.tenant_id]
            yield r

    def __iter__(self) -> Iterator[Request]:
        order = self._order
        merged = heapq.merge(
            *(self._tenant_stream(t) for t in self.tenants),
            key=lambda r: (r.arrival_time, order[r.tenant_id], r.id))
        for i, r in enumerate(merged):
            r.id = i
            yield r


def make_source(spec: WorkloadSpec) -> RequestSource:
    """Build the lazy request source for a workload spec."""
    if spec.lengths == "trace" or spec.arrival == "trace":
        return TraceSource(spec)
    return SyntheticSource(spec)


def make_tenant_source(tenants: Sequence) -> RequestSource:
    """Heap-merged lazy source over per-tenant workloads.

    ``tenants`` is a sequence of ``repro.core.tenancy.TenantSpec`` (held
    duck-typed here to keep the workload layer tenancy-agnostic).  Each
    tenant's stream is generated with a seed decorrelated by a stable
    hash of its id and stamped with the tenant's identity and QoS tags.
    """
    return MergedSource(tenants)


# ---------------------------------------------------------------------------
# materializing wrappers (backward-compatible list interface)
# ---------------------------------------------------------------------------
def generate(spec: WorkloadSpec) -> List[Request]:
    """Materialize the full request list (sorted by arrival time)."""
    if spec.lengths == "trace" or spec.arrival == "trace":
        # traces may be unsorted on disk: materialize then sort, keeping
        # line-index ids (the seed behaviour streaming replay forbids)
        assert spec.trace_path, "trace workload needs trace_path"
        reqs: List[Request] = []
        with open(spec.trace_path) as f:
            for i, line in enumerate(f):
                if i >= spec.num_requests:
                    break
                reqs.append(_parse_trace_record(i, json.loads(line),
                                                spec.model))
        reqs.sort(key=lambda r: (r.arrival_time, r.id))
        return reqs
    return list(SyntheticSource(spec))


def generate_multi(tenants: Sequence) -> List[Request]:
    """Materialize the merged multi-tenant stream (see MergedSource)."""
    return list(MergedSource(tenants))


def save_trace(reqs: List[Request], path: str) -> None:
    with open(path, "w") as f:
        for r in reqs:
            rec = {"arrival": r.arrival_time, "prompt_len": r.prompt_len,
                   "output_len": r.output_len, "session_id": r.session_id,
                   "round": r.round_idx}
            if r.prefix_id is not None:
                # shared-prefix tags round-trip (docs/MEMORY.md); plain
                # workloads keep the seed trace format byte-identical
                rec["prefix_id"] = r.prefix_id
                rec["prefix_len"] = r.prefix_len
            if r.model is not None:
                # model tags round-trip (docs/HETEROGENEITY.md); plain
                # workloads keep the seed trace format byte-identical
                rec["model"] = r.model
            f.write(json.dumps(rec) + "\n")
