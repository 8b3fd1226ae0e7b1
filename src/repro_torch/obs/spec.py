"""Observability configuration (docs/OBSERVABILITY.md).

``SimSpec(obs=ObsSpec(...))`` switches on any combination of the three
recorders; the default ``obs=None`` keeps the simulator on its original
zero-instrumentation path (no recorder objects exist, workers guard
every tap with one ``is None`` check, and the breakpoint registry's
empty fast path makes hook dispatch a dict miss).

The port's copy of ``repro.obs.spec``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ObsSpec:
    """What to record and how much memory recording may use.

    All three recorders are bounded: the trace caps its event list at
    ``max_trace_events`` (excess events are counted, not stored), and
    the time series doubles its sampling stride whenever it hits
    ``timeseries_cap`` frames, so memory stays O(cap) on arbitrarily
    long runs.
    """

    #: request-lifecycle spans + per-worker iteration slices, exported
    #: as Chrome trace-event JSON (Perfetto / chrome://tracing)
    trace: bool = False
    #: periodic gauges/counters (queue depth, batch size, KV blocks,
    #: tokens/s, preemptions, rejections), CSV/JSON export
    timeseries: bool = False
    #: per-request latency attribution feeding Results.time_breakdown()
    #: / Results.explain(); works in streaming drop-mode too
    attribution: bool = False
    #: simulated seconds between time-series samples (doubles on
    #: decimation)
    sample_interval: float = 1.0
    #: frame count at which the time series halves itself
    timeseries_cap: int = 4096
    #: hard cap on stored trace events; overflow increments
    #: ``TraceRecorder.dropped`` instead of growing the list
    max_trace_events: int = 100_000

    @property
    def enabled(self) -> bool:
        return self.trace or self.timeseries or self.attribution

    @classmethod
    def full(cls, **kw) -> "ObsSpec":
        """Everything on — the examples/benchmarks shorthand."""
        return cls(trace=True, timeseries=True, attribution=True, **kw)
