"""Global (cluster) schedulers: request -> worker dispatch (paper §III-A).

Policies receive the full worker list (hardware type, role flags, queue
and memory state — "all system information") and may keep their own state
(the record-book pattern from the paper).

The port's copy of ``repro.core.sched.global_sched``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.request import Request


class GlobalScheduler:
    """Base class for cluster-level dispatch policies.

    Subclasses override ``assign`` (and optionally ``reassign`` for the
    disaggregated prefill→decode hand-off and ``discipline`` for
    worker-queue ordering); they may keep internal state — the paper's
    "record book" pattern.
    """

    def assign(self, req: Request, workers: List) -> int:
        """Pick the worker for a new request (prefill side)."""
        raise NotImplementedError

    def reassign(self, req: Request, workers: List) -> int:
        """Pick the decode worker after prefill hand-off (disagg). The
        default keeps the request where it is."""
        return req.worker_id

    def discipline(self):
        """Queue discipline the workers should order their waiting queues
        by, or None for FIFO.  Tenant-aware policies override this so the
        cluster-wide ordering (repro.core.tenancy.qos) stays consistent
        with the dispatch-side record book."""
        return None

    def eligible_for(self, req: Request, workers: List) -> List:
        """Workers this policy would ever consider for ``req`` — the
        dispatcher parks a request when none of them is alive.  The
        default (every worker) keeps model-blind policies exactly as
        they were; model-aware policies narrow it to the request's
        hosts (docs/HETEROGENEITY.md)."""
        return workers

    # ---- observability (repro.obs) -----------------------------------
    def observe_assign(self, req: Request, wid: int) -> None:
        """Record one dispatch decision in a per-worker record book the
        time-series recorder samples (load-balance observability).  The
        Simulation calls this only when observability is enabled, so
        the default dispatch path stays untouched."""
        book = getattr(self, "_assign_book", None)
        if book is None:
            book = self._assign_book = {}
        book[wid] = book.get(wid, 0) + 1

    def assign_counts(self) -> Dict[int, int]:
        """Cumulative dispatches per worker id (empty when observability
        never recorded any)."""
        return dict(getattr(self, "_assign_book", None) or {})


def _eligible(workers, *, prefill=None, decode=None):
    out = []
    for w in workers:
        if not w.alive or getattr(w, "draining", False):
            # draining (repro.core.faults): finishes its queue but
            # takes no new dispatches — like dead for placement
            continue
        if prefill is not None and w.run_prefill != prefill:
            continue
        if decode is not None and w.run_decode != decode:
            continue
        out.append(w)
    # role/drain fallback: with nothing eligible, any live worker beats
    # dropping the request (a fully-draining cluster still serves)
    return out or [w for w in workers if w.alive]


@dataclass
class RoundRobin(GlobalScheduler):
    """Cycle new requests over prefill-capable workers in worker order —
    the stateless baseline every study compares against."""

    _next: int = 0

    def assign(self, req, workers):
        ws = _eligible(workers, prefill=True)
        w = ws[self._next % len(ws)]
        self._next += 1
        return w.wid


@dataclass
class LeastLoaded(GlobalScheduler):
    """Dispatch to the worker with the fewest queued+running tokens —
    also the straggler mitigation policy: a slowed worker drains and
    stops receiving new work."""

    def assign(self, req, workers):
        ws = _eligible(workers, prefill=True)
        return min(ws, key=lambda w: (w.load_tokens(), w.wid)).wid

    def reassign(self, req, workers):
        ws = _eligible(workers, decode=True)
        return min(ws, key=lambda w: (w.load_tokens(), w.wid)).wid


@dataclass
class DisaggPD(GlobalScheduler):
    """Disaggregated prefill/decode: new requests round-robin over
    prefill workers; after the first token they move to the least-loaded
    decode worker (the paper's Fig. 3 user-defined example)."""

    _next_p: int = 0

    def assign(self, req, workers):
        ws = _eligible(workers, prefill=True)
        w = ws[self._next_p % len(ws)]
        self._next_p += 1
        return w.wid

    def reassign(self, req, workers):
        ws = _eligible(workers, decode=True)
        return min(ws, key=lambda w: (w.load_tokens(), w.wid)).wid


@dataclass
class SessionAffinity(GlobalScheduler):
    """Multi-round conversations stick to the worker that holds their KV
    in the pool tier (locality-aware, MemServe-style)."""

    fallback: GlobalScheduler = field(default_factory=LeastLoaded)
    _session_map: Dict[int, int] = field(default_factory=dict)

    def assign(self, req, workers):
        if req.session_id is not None and req.session_id in self._session_map:
            wid = self._session_map[req.session_id]
            if any(w.wid == wid and w.alive for w in workers):
                return wid
        wid = self.fallback.assign(req, workers)
        if req.session_id is not None:
            self._session_map[req.session_id] = wid
        return wid

    def reassign(self, req, workers):
        return self.fallback.reassign(req, workers)


@dataclass
class HeterogeneityAware(GlobalScheduler):
    """Weights prefill dispatch by FLOPs and decode dispatch by memory
    bandwidth — the cross-stack policy the paper motivates for clusters
    of mixed accelerators (A100 + PIM, Fig. 12)."""

    def assign(self, req, workers):
        ws = _eligible(workers, prefill=True)
        return min(ws, key=lambda w:
                   (w.load_tokens() / max(w.hw.flops, 1.0), w.wid)).wid

    def reassign(self, req, workers):
        ws = _eligible(workers, decode=True)
        return min(ws, key=lambda w:
                   (w.load_tokens() / max(w.hw.mem_bw, 1.0), w.wid)).wid


@dataclass
class WeightedFairQueuing(GlobalScheduler):
    """Weighted fair queuing over tenants via virtual finish times
    (start-time fair queuing variant).

    Each request is tagged ``vft = max(V, last_vft[tenant]) +
    cost/weight`` at dispatch; workers admit waiting requests in vft
    order (WFQDiscipline), so backlogged tenants receive token service
    proportional to their weights.  The virtual clock ``V`` advances to
    the start tag of each request entering service, which denies idle
    tenants retroactive credit (a returning tenant resumes at the
    current frontier instead of monopolizing the cluster)."""

    fallback: GlobalScheduler = field(default_factory=LeastLoaded)
    _v: float = 0.0
    _last_vft: Dict[str, float] = field(default_factory=dict)

    def assign(self, req, workers):
        if req.vft == 0.0:
            # stamp exactly once: failure redispatch sends orphans back
            # through assign(), which must not re-charge the tenant's
            # virtual clock for work it was already billed for
            tid = req.tenant_id or "_default"
            cost = float(req.prompt_len + req.output_len)
            start = max(self._v, self._last_vft.get(tid, 0.0))
            req.vft = start + cost / max(req.weight, 1e-9)
            self._last_vft[tid] = req.vft
        return self.fallback.assign(req, workers)

    def reassign(self, req, workers):
        return self.fallback.reassign(req, workers)

    def on_service_start(self, req) -> None:
        cost = float(req.prompt_len + req.output_len)
        self._v = max(self._v, req.vft - cost / max(req.weight, 1e-9))

    def discipline(self):
        from repro_torch.core.tenancy.qos import WFQDiscipline
        return WFQDiscipline(self)


@dataclass
class PriorityAging(GlobalScheduler):
    """Strict priority across tenant tiers with linear aging: workers
    admit the highest effective priority first, where effective priority
    grows by ``aging_rate`` points per second of queueing (starvation
    guard).  Under memory pressure the preemption path evicts the lowest
    tier first, so low-tier requests yield KV blocks to high-tier ones."""

    aging_rate: float = 0.0
    fallback: GlobalScheduler = field(default_factory=LeastLoaded)

    def assign(self, req, workers):
        return self.fallback.assign(req, workers)

    def reassign(self, req, workers):
        return self.fallback.reassign(req, workers)

    def discipline(self):
        from repro_torch.core.tenancy.qos import PriorityAgingDiscipline
        return PriorityAgingDiscipline(self.aging_rate)


class ModelRouted(GlobalScheduler):
    """Model-aware routing for heterogeneous multi-model fleets
    (docs/HETEROGENEITY.md): restrict dispatch to the workers hosting
    the request's model, then delegate the choice among them to any
    inner policy.

    ``inner`` is a policy name (``make_global_scheduler`` spelling) or
    instance; it sees only the host subset, so the role/drain fallback
    in ``_eligible`` can never leak a request onto a worker serving a
    different model.  A worker whose ``model`` attribute is unset hosts
    everything (homogeneous fleets — where this wrapper is a byte-exact
    pass-through of its inner policy)."""

    def __init__(self, inner="least_loaded", **inner_kw):
        if isinstance(inner, str):
            inner = make_global_scheduler(inner, **inner_kw)
        elif inner_kw:
            raise ValueError("inner_kw only applies when inner is a name")
        self.inner = inner

    @staticmethod
    def _hosts(req, workers):
        model = getattr(req, "model", None)
        if model is None:
            return workers
        out = [w for w in workers
               if getattr(w, "model", None) in (None, model)]
        if not out:
            raise ValueError(
                f"no worker hosts model {model!r} (request {req.id})")
        return out

    def eligible_for(self, req, workers):
        return self._hosts(req, workers)

    def assign(self, req, workers):
        return self.inner.assign(req, self._hosts(req, workers))

    def reassign(self, req, workers):
        return self.inner.reassign(req, self._hosts(req, workers))

    def discipline(self):
        return self.inner.discipline()

    def on_service_start(self, req) -> None:
        hook = getattr(self.inner, "on_service_start", None)
        if hook is not None:
            hook(req)


class PrefixAffinity(GlobalScheduler):
    """Cache-aware routing (docs/ROUTING.md): send a request to the
    worker already holding its longest shared prefix, llm-d style.

    Consults a cluster-wide :class:`~repro.core.sched.prefix_registry.
    PrefixRegistry` (attached by the ``Simulation``, which also ages and
    invalidates entries so the router never assumes immortal cache).
    Requests without a ``prefix_id`` — and prefixes nobody holds — fall
    through to the inner policy untouched; among equally-warm holders
    the inner policy breaks the tie, so ``least_loaded`` inside gives a
    load-aware tiebreak for free.  When every warm worker is overloaded
    (``overload_factor`` x the lightest eligible worker), the request
    routes by the inner policy instead and — if ``fetch_on_overload`` —
    carries a fetch hint so the target worker pulls the prefix from the
    warm peer over the ``SimSpec.kv_link`` rather than re-prefilling
    (the cross-worker KV transfer, priced by ``Simulation.
    fetch_prefix`` with a fetch-vs-recompute break-even).

    Wrappable like ``model_routed`` and composes with it in either
    direction: ``inner`` is a policy name or instance."""

    def __init__(self, inner="least_loaded", *, registry=None,
                 registry_ttl: float = 30.0, overload_factor: float = 3.0,
                 fetch_on_overload: bool = True, **inner_kw):
        if isinstance(inner, str):
            inner = make_global_scheduler(inner, **inner_kw)
        elif inner_kw:
            raise ValueError("inner_kw only applies when inner is a name")
        self.inner = inner
        self.registry = registry        # attached by the Simulation
        self.registry_ttl = registry_ttl
        self.overload_factor = overload_factor
        self.fetch_on_overload = fetch_on_overload
        self.affinity_hits = 0          # routed to a warm holder
        self.affinity_misses = 0        # no fresh holder: inner decided
        self.overload_diversions = 0    # warm but too hot: inner decided
        self.fetch_hints = 0            # diversions stamped with a hint

    def assign(self, req, workers):
        reg = self.registry
        pid = getattr(req, "prefix_id", None)
        if reg is None or pid is None or req.prefix_len <= 0:
            return self.inner.assign(req, workers)
        held = reg.holders(pid)
        ws = _eligible(workers, prefill=True)
        warm = [w for w in ws if held.get(w.wid, 0) > 0]
        if not warm:
            self.affinity_misses += 1
            wid = self.inner.assign(req, workers)
            reg.publish(pid, wid, req.prefix_len)
            return wid
        best = max(held[w.wid] for w in warm)
        warm = [w for w in warm if held[w.wid] == best]
        light = min(w.load_tokens() for w in ws)
        warm_load = min(w.load_tokens() for w in warm)
        if warm_load > self.overload_factor * max(light, 1.0):
            # every warm holder is hot: dispatch by load, but tell the
            # target where the prefix lives so it can fetch, not recompute
            self.overload_diversions += 1
            wid = self.inner.assign(req, workers)
            if self.fetch_on_overload and wid not in held:
                src = min((w for w in warm), key=lambda w:
                          (w.load_tokens(), w.wid))
                req.fetch_src = src.wid
                req.fetch_tokens = min(best, req.prefix_len)
                self.fetch_hints += 1
            reg.publish(pid, wid, req.prefix_len)
            return wid
        self.affinity_hits += 1
        wid = self.inner.assign(req, warm)
        reg.touch(pid, wid)
        reg.publish(pid, wid, req.prefix_len)
        return wid

    def eligible_for(self, req, workers):
        return self.inner.eligible_for(req, workers)

    def reassign(self, req, workers):
        return self.inner.reassign(req, workers)

    def discipline(self):
        return self.inner.discipline()

    def on_service_start(self, req) -> None:
        hook = getattr(self.inner, "on_service_start", None)
        if hook is not None:
            hook(req)

    def stats(self) -> Dict[str, int]:
        return {"affinity_hits": self.affinity_hits,
                "affinity_misses": self.affinity_misses,
                "overload_diversions": self.overload_diversions,
                "fetch_hints": self.fetch_hints}


def _hetero_routed(**kw):
    """The ``hetero`` policy upgraded for multi-model fleets: model
    routing wrapped around the FLOPs/bandwidth-weighted chooser.  For a
    single-model fleet the wrapper is inert, so existing runs keep
    their exact dispatch sequence."""
    return ModelRouted(inner=HeterogeneityAware(**kw))


#: every accepted ``SimSpec.global_policy`` name (aliases included);
#: scripts/check_docs.py asserts each key is documented in docs/POLICIES.md
GLOBAL_POLICIES = {"round_robin": RoundRobin, "least_loaded": LeastLoaded,
                   "disagg": DisaggPD, "disagg_pd": DisaggPD,
                   "session_affinity": SessionAffinity,
                   "hetero": _hetero_routed,
                   "heterogeneity_aware": _hetero_routed,
                   "wfq": WeightedFairQueuing, "priority": PriorityAging,
                   "model_routed": ModelRouted,
                   "prefix_affinity": PrefixAffinity}


def make_global_scheduler(kind: str, **kw) -> GlobalScheduler:
    """Build a global policy by name (see docs/POLICIES.md for the full
    reference table).  ``disagg_pd`` and ``heterogeneity_aware`` are
    long-form aliases of ``disagg`` / ``hetero``."""
    try:
        cls = GLOBAL_POLICIES[kind]
    except KeyError:
        raise ValueError(f"unknown global scheduler {kind!r}; "
                         f"have {sorted(GLOBAL_POLICIES)}")
    return cls(**kw)
