"""Failure injection and availability simulation (docs/RELIABILITY.md).

TokenSim's exploration claim extends to *unhealthy* clusters: this
module turns the original one-shot scheduled ``FaultSpec`` into a
family of fault processes so availability questions ("how much
redundancy buys how many nines at what $/token" — see
benchmarks/chaos_sweep.py) become simulable.

Three injection styles, freely mixable:

* **scheduled** — a list of ``FaultSpec(time, worker, kind)`` entries,
  exactly the pre-existing surface (plus an optional ``duration`` that
  auto-restores the worker),
* **stochastic** — ``FaultProcess`` draws exponential uptime (MTBF) and
  repair (MTTR) times from a private deterministic RNG, so fault
  timelines are reproducible and *independent of simulation content*
  (the property the replica-monotonicity CI gate relies on),
* **trace-driven** — ``load_fault_trace`` reads a JSONL failure log
  into a scheduled list.

Recovery is costly when a ``ChaosSpec`` is active: a revived worker
first pays the model-reload latency (``HardwareSpec.reload_time`` or
the spec override) and then runs its first ``warmup_iters`` iterations
at ``warmup_factor``x cost (cold caches / recompiled kernels).  The
legacy path — ``SimSpec.faults`` with ``chaos=None`` — keeps the
historical free-and-instant recovery, byte-identical.

Degrade faults reuse the straggler semantics of
``repro.distributed.fault.StragglerDetector``: a degraded worker runs
at ``factor``x iteration time, which is exactly the signal the
detector flags (``seconds > factor * median``) and the ``least_loaded``
dispatch policy drains around.

The port's copy of ``repro.core.faults``, its imports rewritten.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

from repro_torch.distributed.fault import StragglerDetector

#: every fault kind the injector understands — scheduled ``FaultSpec``
#: entries use the first five, ``FaultProcess`` uses ``fail`` /
#: ``degrade`` / ``oom_crash_loop``; scripts/check_docs.py asserts each
#: is documented in docs/RELIABILITY.md
FAULT_KINDS = ("fail", "recover", "slowdown", "degrade", "drain",
               "oom_crash_loop")

#: scheduled kinds accepted by ``FaultSpec.kind``
SCHEDULED_KINDS = ("fail", "recover", "slowdown", "degrade", "drain")

#: stochastic kinds accepted by ``FaultProcess.kind``
PROCESS_KINDS = ("fail", "degrade", "oom_crash_loop")

#: default degrade slowdown: the multiplicative threshold
#: ``StragglerDetector`` fires at, so an injected straggler is exactly
#: what the mitigation layer is tuned to catch
DEFAULT_DEGRADE_FACTOR = StragglerDetector.factor


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``kind`` is one of ``SCHEDULED_KINDS``:
    ``fail`` kills the worker (device KV lost, queue re-dispatched),
    ``recover`` revives it (paying the reload/warm-up cost when a
    ``ChaosSpec`` is active; free and instant otherwise — the legacy
    contract), ``slowdown``/``degrade`` multiply iteration time by
    ``factor``, and ``drain`` stops new dispatches while running work
    completes.  A positive ``duration`` auto-restores the worker that
    many seconds later without needing an explicit ``recover`` entry."""
    time: float
    worker: int
    kind: str                     # see SCHEDULED_KINDS
    factor: float = 1.0
    duration: float = 0.0         # 0 = until an explicit recover


@dataclass(frozen=True)
class FaultProcess:
    """A stochastic fault stream for one worker.

    Uptime and repair times are exponential draws (classic
    MTBF / MTTR renewal model) from ``random.Random`` seeded by
    ``(seed, worker, kind)`` only — never by simulation state — so the
    same process produces the same fault timeline regardless of
    workload, replica count, or scheduler (reproducibility and the
    monotone-replicas gate both depend on this).

    ``oom_crash_loop`` models the pathology where a worker comes back
    only to OOM again: each triggering draws ``crash_loops``
    consecutive fail/repair cycles separated by ``loop_uptime`` seconds
    of apparent health before the loop clears."""
    worker: int
    kind: str = "fail"            # see PROCESS_KINDS
    mtbf: float = 300.0           # mean seconds between failures
    mttr: float = 10.0            # mean seconds to repair (pre-reload)
    seed: int = 0
    factor: float = DEFAULT_DEGRADE_FACTOR   # degrade slowdown
    start: float = 0.0            # injection holdoff from t=0
    max_events: int = 0           # 0 = unbounded
    crash_loops: int = 3          # fail/repair cycles per oom trigger
    loop_uptime: float = 1.0      # healthy gap inside a crash loop
    #: target a model instead of a worker id (docs/HETEROGENEITY.md):
    #: with ``worker=-1`` the injector expands this process into one
    #: per worker hosting ``model`` (each with its own timeline, since
    #: the RNG is seeded per worker); with ``worker >= 0`` it validates
    #: that the worker actually hosts the model
    model: Optional[str] = None


@dataclass(frozen=True)
class ChaosSpec:
    """Chaos configuration for a simulation (``SimSpec.chaos``).

    Setting it (even empty) opts the run into the *costly recovery*
    model: revived workers pay ``reload_time`` (``None`` = the worker's
    ``HardwareSpec.reload_time``) and run ``warmup_iters`` iterations
    at ``warmup_factor``x.  ``host_kv_survives`` makes worker failure
    KV-aware: device KV is always lost, but victims whose KV sits in
    the host-DRAM swap tier (``preemption_mode="swap"``) keep it — the
    re-dispatch adopts the host copy into the new worker's tier and the
    request resumes from swap instead of re-prefilling.

    ``ChaosSpec()`` with no processes and no scheduled faults changes
    nothing: the zero-fault run is byte-identical to ``chaos=None``
    (a chaos_sweep --smoke CI gate)."""
    processes: Sequence[FaultProcess] = ()
    reload_time: Optional[float] = None
    warmup_iters: int = 2
    warmup_factor: float = 2.0
    host_kv_survives: bool = True


@dataclass(frozen=True)
class FaultEvent:
    """One injected-fault record in ``Results.fault_events`` — the
    availability accounting in ``Results.availability_summary`` is
    derived entirely from these."""
    time: float
    worker: int
    kind: str                     # "fail" | "recover" | "slowdown" | "drain"
    factor: float = 1.0


def load_fault_trace(path: str) -> List[FaultSpec]:
    """Read a JSONL failure trace into a scheduled fault list.  Each
    line is an object with ``time``, ``worker``, ``kind`` and optional
    ``factor`` / ``duration`` — the format ``chaos_sweep`` can replay
    real incident logs through."""
    out: List[FaultSpec] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(FaultSpec(
                time=float(d["time"]), worker=int(d["worker"]),
                kind=str(d["kind"]), factor=float(d.get("factor", 1.0)),
                duration=float(d.get("duration", 0.0))))
    return out


class FaultInjector:
    """DES process(es) applying scheduled and stochastic faults to a
    ``Simulation``.

    The scheduled generator reproduces the legacy ``_fault_injector``
    yield-for-yield when ``chaos`` is ``None`` (no extra engine events,
    so pre-chaos runs stay byte-identical).  Stochastic processes use
    *daemon* timeouts for their healthy-uptime waits — an unbounded
    fault stream must not keep the simulation alive — but plain
    timeouts for the repair/reload chain, so a cluster that is entirely
    down still advances time toward the recovery that un-parks the
    waiting requests."""

    def __init__(self, sim, chaos: Optional[ChaosSpec],
                 faults: Sequence[FaultSpec]):
        self.sim = sim
        self.env = sim.env
        self.chaos = chaos
        self.faults = tuple(faults)
        self.events: List[FaultEvent] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        n = len(self.sim.workers)
        for f in self.faults:
            if not 0 <= f.worker < n:
                raise ValueError(f"FaultSpec.worker {f.worker} out of "
                                 f"range for {n} workers")
        if self.faults:
            self.env.process(self._scheduled(), name="faults")
        if self.chaos is not None:
            for p in self.chaos.processes:
                for q in self._expand(p, n):
                    if not 0 <= q.worker < n:
                        raise ValueError(f"FaultProcess.worker {q.worker} "
                                         f"out of range for {n} workers")
                    if q.kind not in PROCESS_KINDS:
                        raise ValueError(f"unknown FaultProcess.kind "
                                         f"{q.kind!r}; have {PROCESS_KINDS}")
                    self.env.process(self._stochastic(q),
                                     name=f"chaos-w{q.worker}-{q.kind}")

    def _expand(self, p: FaultProcess, n: int) -> List[FaultProcess]:
        """Resolve model-targeted processes (docs/HETEROGENEITY.md) into
        per-worker ones; worker-targeted processes pass through."""
        if p.model is None:
            return [p]
        hosts = [w.wid for w in self.sim.workers
                 if getattr(w, "model", None) == p.model]
        if not hosts:
            raise ValueError(f"FaultProcess.model {p.model!r} matches no "
                             f"worker in this fleet")
        if p.worker >= 0:
            if p.worker not in hosts:
                raise ValueError(f"FaultProcess.worker {p.worker} does "
                                 f"not host model {p.model!r}")
            return [p]
        return [replace(p, worker=wid) for wid in hosts]

    # ------------------------------------------------------------------
    def _log(self, wid: int, kind: str, factor: float = 1.0) -> None:
        now = self.env.now
        self.events.append(FaultEvent(now, wid, kind, factor))
        obs = self.sim.obs
        if obs is not None:
            obs.on_fault(wid, kind, now,
                         {"factor": factor} if factor != 1.0 else None)

    def _reload_time(self, w) -> float:
        if self.chaos is None:
            return 0.0            # legacy contract: recovery is free
        if self.chaos.reload_time is not None:
            return self.chaos.reload_time
        return w.hw.reload_time

    # ---- primitive fault actions -------------------------------------
    def _fail(self, w) -> bool:
        if not w.alive:
            return False          # idempotent: already down
        kv = self.chaos.host_kv_survives if self.chaos is not None \
            else False
        orphans = w.fail(kv_survives=kv)
        self._log(w.wid, "fail")
        # cache-aware routing (docs/ROUTING.md): the dead worker's KV is
        # gone, so its prefix-registry claims must die with it — stale
        # entries would route requests at a cold (or still-down) worker.
        # The remote object store deliberately survives: it is off-host.
        reg = getattr(self.sim, "prefix_registry", None)
        if reg is not None:
            reg.invalidate_worker(w.wid)
        self.sim.redispatch(orphans, from_worker=w)
        return True

    def _slowdown(self, w, factor: float) -> None:
        w.slowdown = factor
        self._log(w.wid, "slowdown", factor)

    def _drain(self, w) -> None:
        w.draining = True
        self._log(w.wid, "drain")

    def _undrain(self, w) -> None:
        if getattr(w, "retiring", False):
            return                # retirement drains are not fault drains
        w.draining = False
        if w.alive:
            # a dead worker's drain ending is not a recovery: logging
            # one would spuriously close its open downtime interval
            self._log(w.wid, "recover")
            w._wakeup()

    def _finish_recover(self, w) -> None:
        w.slowdown = 1.0
        w.draining = False
        if self.chaos is not None:
            w.recover(warmup_iters=self.chaos.warmup_iters,
                      warmup_factor=self.chaos.warmup_factor)
        else:
            w.recover()
        self._log(w.wid, "recover")
        self.sim.on_worker_recovered(w)

    def _revive(self, w):
        """Repair completed: pay the model reload, then serve warm-up
        iterations.  Downtime (fail -> recover in the event log) thus
        includes the reload — recovery is not free."""
        rt = self._reload_time(w)
        if rt > 0:
            yield self.env.timeout(rt)
        self._finish_recover(w)

    # ---- scheduled faults --------------------------------------------
    def _scheduled(self):
        env = self.env
        for f in sorted(self.faults, key=lambda f: f.time):
            delay = f.time - env.now
            if delay > 0:
                yield env.timeout(delay)
            w = self.sim.workers[f.worker]
            if f.kind in ("slowdown", "degrade"):
                self._slowdown(w, f.factor)
                if f.duration > 0:
                    env.process(self._after(f.duration, self._slowdown,
                                            w, 1.0))
            elif f.kind == "drain":
                self._drain(w)
                if f.duration > 0:
                    env.process(self._after(f.duration, self._undrain, w))
            elif f.kind == "fail":
                if self._fail(w) and f.duration > 0:
                    env.process(self._after(f.duration,
                                            self._start_revive, w))
            elif f.kind == "recover":
                if self._reload_time(w) > 0:
                    env.process(self._revive(w))
                else:
                    self._finish_recover(w)
            else:
                raise ValueError(f.kind)

    def _after(self, delay: float, fn, *args):
        yield self.env.timeout(delay)
        fn(*args)

    def _start_revive(self, w) -> None:
        self.env.process(self._revive(w))

    # ---- stochastic processes ----------------------------------------
    def _stochastic(self, p: FaultProcess):
        env = self.env
        w = self.sim.workers[p.worker]
        rng = random.Random(f"chaos:{p.seed}:{p.worker}:{p.kind}")
        if p.start > 0:
            yield env.timeout(p.start, daemon=True)
        n = 0
        while p.max_events <= 0 or n < p.max_events:
            yield env.timeout(rng.expovariate(1.0 / p.mtbf), daemon=True)
            n += 1
            if p.kind == "degrade":
                self._slowdown(w, p.factor)
                yield env.timeout(rng.expovariate(1.0 / p.mttr))
                self._slowdown(w, 1.0)
            elif p.kind == "fail":
                if not self._fail(w):
                    continue      # raced another process: skip the cycle
                yield env.timeout(rng.expovariate(1.0 / p.mttr))
                yield from self._revive(w)
            else:                 # oom_crash_loop
                loops = max(1, p.crash_loops)
                for i in range(loops):
                    if self._fail(w):
                        yield env.timeout(rng.expovariate(1.0 / p.mttr))
                        yield from self._revive(w)
                    if i + 1 < loops:
                        yield env.timeout(p.loop_uptime, daemon=True)
