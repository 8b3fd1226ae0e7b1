"""Admission control: simulated API-gateway rate limiting.

Citations: token-bucket limiting as in Limitador/Kuadrant and cloud LLM
gateways; reject/queue/shed mirror RFC 6585 (429) semantics.

One DES process per tenant sits between the dispatcher and the global
scheduler (the Limitador/Kuadrant position in a production stack).  Each
tenant has a token bucket over ``prompt+output`` tokens and an optional
in-flight cap; over-limit traffic is rejected, queued, or shed according
to the tier's ``admission_policy``.

Everything is deterministic: buckets are pure functions of (arrival
times, costs), tenant processes are created in sorted tenant order, and
ties resolve through the engine's (time, priority, seq) ordering.

The port's copy of ``repro.core.tenancy.admission``, its imports rewritten.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Sequence

from repro_torch.core.engine import Environment, Event
from repro_torch.core.request import Request, State
from repro_torch.core.tenancy.spec import REJECT, SHED, TenantSpec


@dataclass
class TokenBucket:
    """Classic token bucket; refilled lazily at observation times."""

    rate: float                      # tokens per second; 0 = unlimited
    burst: float                     # capacity
    tokens: float = field(default=0.0)
    t_last: float = 0.0

    def __post_init__(self):
        self.tokens = self.burst     # start full

    def _refill(self, now: float) -> None:
        if now > self.t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
            self.t_last = now

    def available(self, now: float) -> float:
        self._refill(now)
        return self.tokens

    def wait_time(self, now: float, cost: float) -> float:
        """Seconds until ``cost`` tokens can be consumed.  Requests larger
        than the burst wait for a full bucket and run the balance into
        debt (classic borrowing), so they are delayed, never deadlocked."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        need = min(cost, self.burst)
        if self.tokens >= need:
            return 0.0
        return (need - self.tokens) / self.rate

    def consume(self, now: float, cost: float) -> None:
        self._refill(now)
        self.tokens -= cost          # may go negative (burst debt)


class AdmissionController:
    """Per-tenant gateway queues feeding the cluster's global scheduler."""

    def __init__(self, env: Environment, tenants: Sequence[TenantSpec],
                 cluster) -> None:
        self.env = env
        self.cluster = cluster
        self.tenants: Dict[str, TenantSpec] = {
            t.tenant_id: t for t in tenants}
        self.buckets: Dict[str, TokenBucket] = {}
        self.queues: Dict[str, Deque[Request]] = {}
        self.inflight: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}
        self._wake: Dict[str, Optional[Event]] = {}
        for tid in sorted(self.tenants):
            tier = self.tenants[tid].tier
            self.buckets[tid] = TokenBucket(tier.rate_tokens_per_s,
                                            tier.burst_tokens)
            self.queues[tid] = deque()
            self.inflight[tid] = 0
            self.rejected[tid] = 0
            self._wake[tid] = None
            env.process(self._gateway(tid), name=f"admission:{tid}")

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Dispatcher entry point; called at the request's arrival time."""
        tid = req.tenant_id
        spec = self.tenants.get(tid)
        if spec is None:             # unknown tenant: pass through
            self._release(req)
            return
        tier = spec.tier
        cost = spec.request_cost(req)
        if tier.admission_policy == REJECT:
            # reject iff the bucket cannot cover the queued backlog plus
            # this request right now (simultaneous arrivals within the
            # burst are all admitted), or the inflight cap is exhausted
            over_rate = self._projected_wait(tid, cost) > 0.0
            over_cap = bool(tier.max_inflight and self.inflight[tid]
                            + len(self.queues[tid]) >= tier.max_inflight)
            if over_rate or over_cap:
                self._reject(req)
                return
        elif tier.admission_policy == SHED:
            if self._projected_wait(tid, cost) > tier.shed_timeout:
                self._reject(req)
                return
        self.queues[tid].append(req)
        self._wakeup(tid)

    def on_finish(self, req: Request) -> None:
        tid = req.tenant_id
        if tid in self.inflight:
            self.inflight[tid] = max(0, self.inflight[tid] - 1)
            self._wakeup(tid)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {tid: {"rejected": self.rejected[tid],
                      "queued": len(self.queues[tid]),
                      "inflight": self.inflight[tid]}
                for tid in sorted(self.tenants)}

    # ------------------------------------------------------------------
    def _projected_wait(self, tid: str, cost: float) -> float:
        """Bucket-refill time for the backlog ahead of (and including) a
        candidate request — the shed decision signal."""
        bucket = self.buckets[tid]
        if bucket.rate <= 0:
            return 0.0
        spec = self.tenants[tid]
        backlog = sum(spec.request_cost(r) for r in self.queues[tid])
        need = backlog + min(cost, bucket.burst)
        avail = bucket.available(self.env.now)
        if avail >= need:
            return 0.0
        return (need - avail) / bucket.rate

    def _reject(self, req: Request) -> None:
        req.state = State.REJECTED
        self.rejected[req.tenant_id] += 1
        on_rejected = getattr(self.cluster, "on_request_rejected", None)
        if on_rejected is not None:
            on_rejected(req)

    def _release(self, req: Request) -> None:
        req.t_admitted = self.env.now
        obs = getattr(self.cluster, "obs", None)
        if obs is not None:
            # gateway span ends here; the request enters a worker queue
            obs.on_release(req, self.env.now)
        place = getattr(self.cluster, "_place", None)
        if place is not None:
            # the cluster's placement path: same assign/observe/submit
            # sequence, plus outage parking — a request released while
            # every eligible worker is down waits at the dispatcher
            # instead of crashing the scheduler
            place(req)
            return
        wid = self.cluster.global_sched.assign(req, self.cluster.workers)
        if obs is not None:
            self.cluster.global_sched.observe_assign(req, wid)
        self.cluster.workers[wid].submit(req)

    def _wakeup(self, tid: str) -> None:
        ev = self._wake[tid]
        if ev is not None and not ev.triggered:
            ev.succeed()

    def _gateway(self, tid: str):
        env = self.env
        spec = self.tenants[tid]
        tier = spec.tier
        bucket = self.buckets[tid]
        q = self.queues[tid]
        while True:
            if not q or (tier.max_inflight
                         and self.inflight[tid] >= tier.max_inflight):
                self._wake[tid] = env.event()
                yield self._wake[tid]
                continue
            req = q[0]
            cost = spec.request_cost(req)
            wait = bucket.wait_time(env.now, cost)
            if tier.admission_policy == SHED and env.now + wait \
                    - req.arrival_time > tier.shed_timeout:
                # would be delivered past its deadline (stalled behind
                # the inflight cap and/or bucket debt): shed instead of
                # releasing a stale request
                q.popleft()
                self._reject(req)
                continue
            if wait > 0:
                # safe to consume right after the wait without re-checking:
                # this process is the bucket's only consumer, the head is
                # stable (submit appends), and inflight only drops while
                # we sleep.  Re-checking would spin on float residue.
                yield env.timeout(wait)
            bucket.consume(env.now, cost)
            q.popleft()
            self.inflight[tid] += 1
            self._release(req)
