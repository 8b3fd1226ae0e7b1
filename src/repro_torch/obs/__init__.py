"""Deep observability for the simulator (docs/OBSERVABILITY.md).

Three recorders behind one ``SimSpec(obs=ObsSpec(...))`` knob:

* :class:`TraceRecorder` — request-lifecycle spans and per-worker
  iteration slices as Chrome trace-event JSON (Perfetto-loadable);
* :class:`TimeSeriesRecorder` — bounded-memory gauges/counters sampled
  over simulated time, CSV/JSON export;
* latency attribution — per-request component banks surfaced by
  ``Results.time_breakdown()`` / ``Results.explain()``, conserved to
  the measured latency in exact and streaming drop-mode.

The port's copy of ``repro.obs``, its imports rewritten.
"""
from repro_torch.obs.attribution import (COMPONENTS, RequestObs, add_component,
                                         aggregate_exact, aggregate_streaming,
                                         charge, finalize_request,
                                         format_breakdown)
from repro_torch.obs.recorder import ObsRecorder
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.timeseries import (BoundedSeries, TS_FIELDS,
                                        TimeSeriesRecorder)
from repro_torch.obs.trace import (SPAN_PHASES, TraceRecorder,
                                   validate_chrome_trace)

__all__ = ["COMPONENTS", "RequestObs", "add_component", "aggregate_exact",
           "aggregate_streaming", "charge", "finalize_request",
           "format_breakdown", "ObsRecorder", "ObsSpec", "BoundedSeries",
           "TS_FIELDS", "TimeSeriesRecorder", "SPAN_PHASES",
           "TraceRecorder", "validate_chrome_trace"]
