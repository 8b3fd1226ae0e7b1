"""Chrome trace-event recording and validation (docs/OBSERVABILITY.md).

``TraceRecorder`` emits the subset of the Trace Event Format that
Perfetto and ``chrome://tracing`` render natively:

* ``ph="X"`` complete events — request lifecycle phase spans (one lane
  per request id under the ``requests`` process) and per-worker
  iteration slices with the ``IterationPlan`` cost breakdown in
  ``args``;
* ``ph="i"`` instant events — swap-out/swap-in markers on worker lanes;
* ``ph="C"`` counter events — cluster gauges mirrored from the time
  series (when both recorders are on);
* ``ph="M"`` metadata — process names, emitted at export time.

Timestamps are simulated seconds scaled to microseconds (the format's
unit).  Request phase spans are contiguous by construction: each
transition closes the previous span at the instant the next one opens,
and a whole-request umbrella span (``cat="request.total"``) runs from
arrival to finish — so the phase durations sum to the request's
measured latency, which :func:`validate_chrome_trace` checks to 1e-6 s.

The port's copy of ``repro.obs.trace``, its imports rewritten.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

#: trace lane layout: one synthetic "process" per concern
REQUESTS_PID = 1
CLUSTER_PID = 2
WORKER_PID_BASE = 10

#: every request-lifecycle span name the recorder can emit;
#: scripts/check_docs.py asserts each is documented in
#: docs/OBSERVABILITY.md
SPAN_PHASES = ("gateway", "queue", "prefill", "decode", "preempted",
               "migrate")

_US = 1e6                                # seconds -> microseconds


class TraceRecorder:
    """Bounded in-memory Chrome trace; one instance per simulation.

    The hot path appends compact ``(ph, name, cat, ts, dur, pid, tid,
    args)`` tuples (times still in simulated seconds); :meth:`to_json`
    expands them to trace-event dicts once, at export — one tuple
    allocation per event beats an 8-key dict literal several-fold, and
    export cost is off the simulated clock."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self._raw: List[tuple] = []
        self.dropped = 0
        #: req id -> (phase, start_time, request) for the open span;
        #: entries only outlive the request while it is in flight, so
        #: drop-mode memory stays bounded by the live population
        self._open: Dict[int, Tuple[str, float, object]] = {}
        self._workers: List[int] = []

    # ------------------------------------------------------------------
    def _emit(self, ev: tuple) -> None:
        if len(self._raw) >= self.max_events:
            self.dropped += 1
            return
        self._raw.append(ev)

    def __len__(self) -> int:
        return len(self._raw)

    @property
    def events(self) -> List[dict]:
        """Recorded events as trace-event dicts (metadata excluded)."""
        return [self._expand(ev) for ev in self._raw]

    def register_worker(self, wid: int) -> None:
        if wid not in self._workers:
            self._workers.append(wid)

    # ---- request lifecycle -------------------------------------------
    def req_phase(self, req, phase: str, now: float) -> None:
        """Transition ``req`` into ``phase``, closing the previous span.
        A transition into the current phase is a no-op (keeps the
        original span start)."""
        rid = req.id
        cur = self._open.get(rid)
        if cur is not None:
            prev, start, _ = cur
            if prev == phase:
                return
            self._emit(("X", prev, "request", start, now - start,
                        REQUESTS_PID, rid, None))
        self._open[rid] = (phase, now, req)

    def req_close(self, req, now: float,
                  outcome: str = "finished") -> None:
        """Close the open span and emit the whole-request umbrella."""
        rid = req.id
        cur = self._open.pop(rid, None)
        if cur is not None:
            prev, start, _ = cur
            self._emit(("X", prev, "request", start, now - start,
                        REQUESTS_PID, rid, None))
        self._emit(("X", f"req{rid}", "request.total", req.arrival_time,
                    now - req.arrival_time, REQUESTS_PID, rid,
                    {"prompt_len": req.prompt_len,
                     "output_len": req.output_len,
                     "preempts": req.preempt_count,
                     "outcome": outcome}))

    def flush_open(self, now: float) -> None:
        """Close spans of requests still in flight at the horizon."""
        for rid in sorted(self._open):
            _, _, req = self._open[rid]
            self.req_close(req, now, outcome="inflight")

    # ---- worker-side events ------------------------------------------
    def iteration(self, wid: int, start: float, dur: float,
                  args: dict) -> None:
        self._emit(("X", "iteration", "iteration", start, dur,
                    WORKER_PID_BASE + wid, 1, args))

    def instant(self, name: str, now: float, pid: int,
                args: dict) -> None:
        self._emit(("i", name, "event", now, 0.0, pid, 1, args))

    def swap_event(self, wid: int, kind: str, now: float,
                   args: dict) -> None:
        self.instant(kind, now, WORKER_PID_BASE + wid, args)

    def counter(self, name: str, now: float, values: dict) -> None:
        self._emit(("C", name, None, now, 0.0, CLUSTER_PID, 0, values))

    # ---- export -------------------------------------------------------
    @staticmethod
    def _expand(ev: tuple) -> dict:
        ph, name, cat, ts, dur, pid, tid, args = ev
        out = {"name": name, "ph": ph, "ts": ts * _US,
               "pid": pid, "tid": tid, "args": args if args is not None
               else {}}
        if cat is not None:
            out["cat"] = cat
        if ph == "X":
            out["dur"] = dur * _US
        elif ph == "i":
            out["s"] = "t"
        return out

    def to_json(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "ts": 0.0,
                 "pid": pid, "tid": 0, "args": {"name": pname}}
                for pid, pname in
                [(REQUESTS_PID, "requests"), (CLUSTER_PID, "cluster")]
                + [(WORKER_PID_BASE + w, f"worker{w}")
                   for w in sorted(self._workers)]]
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms",
                "otherData": {"generator": "repro.obs",
                              "dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


# ---------------------------------------------------------------------------
# validation (used by the CI smoke and tests)
# ---------------------------------------------------------------------------
_PHASES_OK = {"X", "M", "i", "C"}
#: tolerance for span arithmetic, microseconds (= the acceptance
#: criterion's 1e-6 seconds)
_EPS_US = 1.0


def validate_chrome_trace(data: dict) -> List[str]:
    """Structural checks on an exported trace.  Returns a list of error
    strings (empty = valid): well-formed trace-event JSON, phase spans
    per request contiguous and nested inside the umbrella span, and the
    phase durations summing to the umbrella (= measured latency) within
    1e-6 s."""
    errors: List[str] = []
    if not isinstance(data, dict) or not isinstance(
            data.get("traceEvents"), list):
        return ["top level must be a dict with a 'traceEvents' list"]
    events = data["traceEvents"]
    req_pid: Optional[int] = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not a dict")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i} ({ev.get('name')!r}): "
                              f"missing {key!r}")
        ph = ev.get("ph")
        if ph not in _PHASES_OK:
            errors.append(f"event {i}: unknown ph {ph!r}")
        if ph == "X" and not (isinstance(ev.get("dur"), (int, float))
                              and ev["dur"] >= 0):
            errors.append(f"event {i} ({ev.get('name')!r}): X event "
                          f"needs dur >= 0, got {ev.get('dur')!r}")
        if ph == "M" and ev.get("name") == "process_name" \
                and ev.get("args", {}).get("name") == "requests":
            req_pid = ev.get("pid")
    if errors:
        return errors
    if req_pid is None:
        req_pid = REQUESTS_PID
    # per-request span tree
    by_tid: Dict[int, Dict[str, list]] = {}
    for ev in events:
        if ev.get("pid") != req_pid or ev.get("ph") != "X":
            continue
        slot = by_tid.setdefault(ev["tid"], {"total": [], "phases": []})
        slot["total" if ev.get("cat") == "request.total"
             else "phases"].append(ev)
    for tid in sorted(by_tid):
        slot = by_tid[tid]
        if len(slot["total"]) != 1:
            errors.append(f"request {tid}: expected exactly one umbrella "
                          f"span, got {len(slot['total'])}")
            continue
        u = slot["total"][0]
        u0, u1 = u["ts"], u["ts"] + u["dur"]
        phases = sorted(slot["phases"], key=lambda e: e["ts"])
        if not phases:
            errors.append(f"request {tid}: umbrella without phase spans")
            continue
        for ev in phases:
            if ev["ts"] < u0 - _EPS_US or \
                    ev["ts"] + ev["dur"] > u1 + _EPS_US:
                errors.append(f"request {tid}: phase {ev['name']!r} "
                              f"outside umbrella span")
        if abs(phases[0]["ts"] - u0) > _EPS_US:
            errors.append(f"request {tid}: first phase starts "
                          f"{abs(phases[0]['ts'] - u0):.3f}us after "
                          f"arrival")
        last = phases[-1]
        if abs(last["ts"] + last["dur"] - u1) > _EPS_US:
            errors.append(f"request {tid}: last phase does not end at "
                          f"the umbrella end")
        for a, b in zip(phases, phases[1:]):
            if abs(a["ts"] + a["dur"] - b["ts"]) > _EPS_US:
                errors.append(f"request {tid}: gap/overlap between "
                              f"{a['name']!r} and {b['name']!r}")
        total = sum(e["dur"] for e in phases)
        if abs(total - u["dur"]) > _EPS_US:
            errors.append(
                f"request {tid}: phase durations sum to {total:.3f}us, "
                f"umbrella is {u['dur']:.3f}us")
    return errors
