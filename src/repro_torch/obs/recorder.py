"""ObsRecorder: one object tying the three recorders to the simulator.

The recorder rides the breakpoint registry (paper §III-A) for every
worker-side lifecycle event — ``on_admit``, ``on_first_token``,
``on_finish`` and ``after_iteration`` are ordinary hooks registered on
each worker's ``Hooks`` — and takes direct calls from the simulator for
the cluster-side events the registry does not cover (arrival, gateway
release, rejection, preemption, re-dispatch, migration).  With
``ObsSpec()`` all-off, the ``Simulation`` never constructs a recorder
at all and every tap collapses to one ``is None`` check.

The port's copy of ``repro.obs.recorder``, its imports rewritten.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.request import State
from repro_torch.obs.attribution import (RequestObs, add_component, charge,
                                         finalize_request)
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.timeseries import TimeSeriesRecorder
from repro_torch.obs.trace import TraceRecorder, WORKER_PID_BASE


class ObsRecorder:
    """Per-simulation observability hub (see docs/OBSERVABILITY.md)."""

    def __init__(self, spec: ObsSpec):
        self.spec = spec
        self.trace: Optional[TraceRecorder] = \
            TraceRecorder(spec.max_trace_events) if spec.trace else None
        self.ts: Optional[TimeSeriesRecorder] = \
            TimeSeriesRecorder(spec.sample_interval,
                               spec.timeseries_cap) \
            if spec.timeseries else None
        self.attribution = spec.attribution

    # ------------------------------------------------------------------
    def install(self, worker) -> None:
        """Attach to one worker: set its ``obs`` back-reference and, when
        tracing, register the lifecycle hooks on its breakpoint registry
        and tap its SwapManager."""
        worker.obs = self
        tr = self.trace
        if tr is None:
            return
        tr.register_worker(worker.wid)
        worker.hooks.on("on_admit", self._hook_admit)
        worker.hooks.on("on_first_token", self._hook_first_token)
        worker.hooks.on("on_finish", self._hook_finish)
        worker.hooks.on("after_iteration", self._hook_iteration)
        swap = getattr(worker, "swap", None)
        if swap is not None:
            env, wid = worker.env, worker.wid

            def on_event(kind, rid, tokens, nbytes,
                         _tr=tr, _env=env, _wid=wid):
                _tr.swap_event(_wid, kind, _env.now,
                               {"req": rid, "tokens": tokens,
                                "bytes": nbytes})

            swap.on_event = on_event

    # ---- hook callbacks (breakpoint registry) -------------------------
    def _hook_admit(self, worker, req) -> None:
        self.trace.req_phase(
            req, "prefill" if req.remaining_prefill else "decode",
            worker.env.now)

    def _hook_first_token(self, worker, req) -> None:
        # the disagg hand-off hook runs first (registered at worker
        # construction), so a migrating request is already MIGRATING here
        phase = "migrate" if req.state is State.MIGRATING else "decode"
        self.trace.req_phase(req, phase, worker.env.now)

    def _hook_finish(self, worker, req) -> None:
        self.trace.req_close(req, worker.env.now)

    def _hook_iteration(self, worker, plan, t) -> None:
        now = worker.env.now
        args = {"prefill": len(plan.prefill),
                "decode": len(plan.decode),
                "spec_decode": len(plan.spec_decode),
                "preempted": len(plan.preempted)}
        other = 0.0
        for key, val in (("comm", plan.comm_latency),
                         ("bubble", plan.pp_bubble),
                         ("swap", plan.swap_latency),
                         ("retrieve", plan.retrieve_latency),
                         ("fetch", plan.fetch_latency),
                         ("draft", plan.draft_latency)):
            if val:
                args[key] = val
                other += val
        args["compute"] = t - other
        self.trace.iteration(worker.wid, now - t, t, args)

    # ---- direct calls from the Simulation -----------------------------
    def on_arrival(self, req, gated: bool) -> None:
        if self.trace is not None:
            self.trace.req_phase(
                req, "gateway" if gated else "queue", req.arrival_time)

    def on_release(self, req, now: float) -> None:
        """Admission gateway released the request toward a worker."""
        if self.trace is not None:
            self.trace.req_phase(req, "queue", now)

    def on_reject(self, req, now: float) -> None:
        if self.trace is not None:
            self.trace.req_close(req, now, outcome="rejected")

    def on_preempt(self, req, now: float) -> None:
        if self.trace is not None:
            self.trace.req_phase(req, "preempted", now)

    def on_requeue(self, req, now: float) -> None:
        """Failure re-dispatch / migration landing: back to a queue."""
        if self.trace is not None:
            self.trace.req_phase(req, "queue", now)

    def on_fault(self, wid: int, kind: str, now: float,
                 args=None) -> None:
        """Fault-injection instant (repro.core.faults) on the worker's
        trace lane: ``fault.fail`` / ``fault.recover`` /
        ``fault.slowdown`` / ``fault.drain``."""
        if self.trace is not None:
            self.trace.instant(f"fault.{kind}", now,
                               WORKER_PID_BASE + wid, args or {})

    def on_scale(self, wid: int, action: str, now: float) -> None:
        """Autoscaler instant (repro.core.autoscale) on the worker's
        trace lane: ``scale.up_request`` / ``scale.up_ready`` /
        ``scale.down_drain`` / ``scale.down_retired``."""
        if self.trace is not None:
            self.trace.instant(f"scale.{action}", now,
                               WORKER_PID_BASE + wid, {})

    def on_fetch(self, wid: int, req, via: str, tokens: int,
                 nbytes: float, now: float) -> None:
        """Cross-worker / remote-tier KV fetch instant
        (docs/ROUTING.md) on the fetching worker's trace lane:
        ``fetch.peer`` / ``fetch.remote``."""
        if self.trace is not None:
            self.trace.instant(f"fetch.{via}", now,
                               WORKER_PID_BASE + wid,
                               {"req": req.id, "tokens": tokens,
                                "bytes": nbytes})

    def on_migrate_done(self, req, now: float, dur: float) -> None:
        if self.trace is not None:
            self.trace.req_phase(req, "queue", now)
        if self.attribution:
            add_component(req, "migrate", dur, post=True)

    # ---- attribution hot path (called by the worker per iteration) ----
    def attribute(self, plan, t: float) -> None:
        """Bank this iteration's cost components on every participant.
        Runs after the iteration's timeout but before token emission, so
        a prefill that produces the first token still banks pre-token.

        The overwhelmingly common iteration has no comm/bubble/swap/
        retrieve/draft time, so that case inlines the single "compute"
        bank update instead of paying a ``charge()`` call per request
        (the difference is a measurable share of total sim cost on
        token-light workloads — see benchmarks/sim_speed.py's
        ``run_obs_overhead`` gate)."""
        other = plan.comm_latency + plan.pp_bubble + plan.swap_latency \
            + plan.retrieve_latency + plan.fetch_latency \
            + plan.draft_latency
        if not other:
            for req in plan.decode:
                ro = req.obs
                if ro is None:
                    ro = req.obs = RequestObs()
                if req.t_first_token is None:
                    ro.pre_compute += t
                else:
                    ro.post_compute += t
            for req, _chunk, _ctx in plan.prefill:
                ro = req.obs
                if ro is None:
                    ro = req.obs = RequestObs()
                if req.t_first_token is None:
                    ro.pre_compute += t
                else:
                    ro.post_compute += t
            for req in plan.spec_decode:
                ro = req.obs
                if ro is None:
                    ro = req.obs = RequestObs()
                if req.t_first_token is None:
                    ro.pre_compute += t
                else:
                    ro.post_compute += t
            return
        comps = [("compute", t - other)]
        for key, val in (("comm", plan.comm_latency),
                         ("bubble", plan.pp_bubble),
                         ("swap", plan.swap_latency),
                         ("retrieve", plan.retrieve_latency),
                         ("fetch", plan.fetch_latency),
                         ("draft", plan.draft_latency)):
            if val:
                comps.append((key, val))
        for req, _chunk, _ctx in plan.prefill:
            charge(req, comps)
        for req in plan.decode:
            charge(req, comps)
        for req in plan.spec_decode:
            charge(req, comps)

    def finalize(self, req) -> None:
        if self.attribution:
            finalize_request(req)
