"""Deterministic discrete-event simulation kernel.

The paper builds TokenSim on SimPy; SimPy is unavailable offline, so this
is our own implementation of the same generator-process model.  It is
intentionally a strict subset of SimPy's API (``Environment``, ``process``,
``timeout``, ``event``, ``Store``) with one upgrade: **deterministic
tie-breaking**.  Events scheduled for the same simulated time fire in
``(time, priority, seq)`` order, where ``seq`` is a global monotonically
increasing counter — so a simulation is a pure function of its inputs,
which the validation tests (structural trace equality vs. the real engine)
rely on.

**Daemon events** (beyond the SimPy subset): events scheduled with
``daemon=True`` do not keep the simulation alive — ``run()`` exits once
only daemon events remain in the heap.  This is how the observability
sampler (repro.obs) ticks periodically without extending the
simulation: its wake-ups fire while real work is pending and evaporate
with it.  All pre-existing events are non-daemon, so simulations
without daemon users are untouched.

The port's copy of ``repro.core.engine``, its imports rewritten.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Generator, List, Optional

NORMAL = 0
URGENT = -1  # fires before NORMAL events at the same timestamp


class Event:
    """A one-shot event; processes waiting on it resume when it succeeds."""

    __slots__ = ("env", "callbacks", "_value", "triggered", "processed", "ok")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: List[Callable[["Event"], None]] = []
        self._value: Any = None
        self.triggered = False
        self.processed = False
        self.ok = True

    def wait(self, cb: Callable[["Event"], None]) -> None:
        """Attach a callback; fires immediately (rescheduled) if already
        processed — the SimPy semantics processes rely on.  Re-pushing
        ``self`` (the run loop swaps the callback list out on every pop)
        keeps the same (time, priority, seq) firing order as scheduling
        a fresh wrapper event, without allocating one — a measurable win
        on the million-wait hot path (see docs/PERFORMANCE.md)."""
        self.callbacks.append(cb)
        if self.processed:
            self.env._schedule(self, 0.0, NORMAL)

    @property
    def value(self):
        return self._value

    def succeed(self, value: Any = None, priority: int = NORMAL) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self._value = value
        self.env._schedule(self, 0.0, priority)
        return self

    def fail(self, exc: BaseException, priority: int = NORMAL) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.ok = False
        self._value = exc
        self.env._schedule(self, 0.0, priority)
        return self


class Timeout(Event):
    def __init__(self, env: "Environment", delay: float, value: Any = None,
                 priority: int = NORMAL, *, daemon: bool = False):
        super().__init__(env)
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        self.triggered = True
        self._value = value
        env._schedule(self, delay, priority, daemon)


class Process(Event):
    """Drives a generator; the yielded events resume it."""

    __slots__ = ("gen", "name")

    def __init__(self, env: "Environment", gen: Generator, name: str = "",
                 daemon: bool = False):
        super().__init__(env)
        self.gen = gen
        self.name = name or getattr(gen, "__name__", "proc")
        init = Timeout(env, 0.0, priority=URGENT, daemon=daemon)
        init.callbacks.append(self._resume)

    def _resume(self, trigger: Event):
        try:
            if trigger.ok:
                target = self.gen.send(trigger.value)
            else:
                target = self.gen.throw(trigger.value)
        except StopIteration as stop:
            if not self.triggered:
                self.succeed(stop.value)
            return
        if not isinstance(target, Event):
            raise RuntimeError(
                f"process {self.name} yielded non-event {target!r}")
        target.wait(self._resume)


class Store:
    """FIFO store with blocking get, deterministic wakeup order."""

    __slots__ = ("env", "items", "_getters")

    def __init__(self, env: "Environment"):
        self.env = env
        self.items: List[Any] = []
        self._getters: List[Event] = []

    def put(self, item: Any) -> None:
        self.items.append(item)
        while self._getters and self.items:
            getter = self._getters.pop(0)
            getter.succeed(self.items.pop(0))

    def get(self) -> Event:
        ev = Event(self.env)
        if self.items:
            ev.succeed(self.items.pop(0))
        else:
            self._getters.append(ev)
        return ev

    def __len__(self):
        return len(self.items)


class Environment:
    def __init__(self):
        self.now: float = 0.0
        self._heap: List = []
        self._seq = itertools.count()
        #: pending non-daemon events; run() exits when this hits zero
        self._live = 0

    def _schedule(self, event: Event, delay: float, priority: int = NORMAL,
                  daemon: bool = False):
        if not daemon:
            self._live += 1
        # seq is globally unique, so the daemon flag is never compared
        heapq.heappush(self._heap,
                       (self.now + delay, priority, next(self._seq),
                        daemon, event))

    # -- SimPy-compatible surface ---------------------------------------
    def timeout(self, delay: float, value: Any = None, *,
                daemon: bool = False) -> Timeout:
        return Timeout(self, delay, value, daemon=daemon)

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator, name: str = "",
                daemon: bool = False) -> Process:
        return Process(self, gen, name, daemon)

    def run(self, until: Optional[float] = None) -> None:
        while self._heap and self._live:
            t, _, _, daemon, event = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            if not daemon:
                self._live -= 1
            self.now = t
            event.processed = True
            callbacks, event.callbacks = event.callbacks, []
            for cb in callbacks:
                cb(event)
        if until is not None:
            self.now = until


def all_of(env: Environment, events: List[Event]) -> Event:
    """Condition event that succeeds when every input event has."""
    done = env.event()
    remaining = [len(events)]
    if not events:
        return done.succeed([])

    def on_fire(_ev):
        remaining[0] -= 1
        if remaining[0] == 0:
            done.succeed([e.value for e in events])

    for e in events:
        if e.processed:
            remaining[0] -= 1
        else:
            e.wait(on_fire)
    if remaining[0] == 0 and not done.triggered:
        done.succeed([e.value for e in events])
    return done
