"""Bounded time-series metrics (docs/OBSERVABILITY.md).

``TimeSeriesRecorder`` samples cluster and per-worker gauges/counters at
a configurable simulated-time interval.  Memory is bounded by the same
stride-doubling decimation the worker's ``mem_timeline`` pioneered: when
the frame list hits its cap, every other frame is dropped (keeping the
t~0 anchor) and the sampling interval doubles, so a run of any length
stores at most ``cap`` frames at progressively coarser resolution.

:class:`BoundedSeries` is that decimation policy factored out as a
container; ``worker.py`` now uses it for ``mem_timeline`` instead of
carrying its own stride/tick fields.

The port's copy of ``repro.obs.timeseries``, its imports rewritten.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional

#: every column in the exported time series; scripts/check_docs.py
#: asserts each is documented in docs/OBSERVABILITY.md.  Worker rows
#: leave the cluster-only tail columns (n_live, n_finished, n_rejected)
#: empty; ``n_alive`` is 0/1 per worker and the live-worker count on
#: the cluster row (the downtime gauge, docs/RELIABILITY.md)
TS_FIELDS = ("t", "scope", "queue_depth", "n_running", "kv_used_blocks",
             "kv_util", "swap_used_bytes", "tokens", "tokens_per_s",
             "preempts", "iterations", "assigns", "n_alive", "n_live",
             "n_finished", "n_rejected")


class BoundedSeries:
    """Append-only sample list with stride-doubling decimation: when
    ``rows`` reaches ``cap``, odd indices are dropped (the t~0 sample
    survives every halving) and the recording stride doubles, so
    sub-cap runs record every sample and long runs stay O(cap)."""

    __slots__ = ("rows", "cap", "stride", "_tick")

    def __init__(self, cap: int = 8192):
        self.rows: List = []
        self.cap = cap
        self.stride = 1
        self._tick = 0

    def should_record(self) -> bool:
        """One call per candidate sample; True every ``stride`` calls."""
        self._tick += 1
        return self._tick % self.stride == 0

    def append(self, row) -> None:
        self.rows.append(row)
        if len(self.rows) >= self.cap:
            del self.rows[1::2]
            self.stride *= 2

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)


class TimeSeriesRecorder:
    """Periodic cluster/worker samples with bounded memory."""

    def __init__(self, interval: float = 1.0, cap: int = 4096):
        #: current simulated seconds between samples (doubles when the
        #: frame list is decimated)
        self.interval = interval
        self.cap = cap
        #: each frame is the list of row dicts for one sample time
        #: (one per worker + one cluster row)
        self.frames: List[List[dict]] = []
        self._last: Dict[str, tuple] = {}   # scope -> (t, tokens)

    # ------------------------------------------------------------------
    def _rate(self, scope: str, now: float, tokens: int) -> float:
        t0, tok0 = self._last.get(scope, (0.0, 0))
        self._last[scope] = (now, tokens)
        dt = now - t0
        return (tokens - tok0) / dt if dt > 0 else 0.0

    def sample(self, now: float, workers, extra: dict) -> dict:
        """Record one frame; returns the cluster row (for counters)."""
        assigns = extra.get("assigns") or {}
        rows: List[dict] = []
        tot = {"queue_depth": 0, "n_running": 0, "kv_used_blocks": 0,
               "kv_used": 0, "kv_total": 0, "swap_used_bytes": 0.0,
               "tokens": 0, "preempts": 0, "iterations": 0, "assigns": 0,
               "n_alive": 0}
        for w in workers:
            used, free = w.mem.num_used, w.mem.num_free
            row = {"t": now, "scope": f"worker{w.wid}",
                   "queue_depth": len(w.waiting),
                   "n_running": len(w.running),
                   "kv_used_blocks": used,
                   "kv_util": used / max(1, used + free),
                   "swap_used_bytes": w.swap.used_bytes
                   if w.swap is not None else 0.0,
                   "tokens": w.tokens_emitted,
                   "tokens_per_s": self._rate(
                       f"worker{w.wid}", now, w.tokens_emitted),
                   "preempts": w.preempt_events,
                   "iterations": w.iterations,
                   "assigns": assigns.get(w.wid, 0),
                   "n_alive": 1 if w.alive else 0}
            rows.append(row)
            tot["queue_depth"] += row["queue_depth"]
            tot["n_running"] += row["n_running"]
            tot["kv_used_blocks"] += used
            tot["kv_used"] += used
            tot["kv_total"] += used + free
            tot["swap_used_bytes"] += row["swap_used_bytes"]
            tot["tokens"] += row["tokens"]
            tot["preempts"] += row["preempts"]
            tot["iterations"] += row["iterations"]
            tot["assigns"] += row["assigns"]
            tot["n_alive"] += row["n_alive"]
        cluster = {"t": now, "scope": "cluster",
                   "queue_depth": tot["queue_depth"],
                   "n_running": tot["n_running"],
                   "kv_used_blocks": tot["kv_used_blocks"],
                   "kv_util": tot["kv_used"] / max(1, tot["kv_total"]),
                   "swap_used_bytes": tot["swap_used_bytes"],
                   "tokens": tot["tokens"],
                   "tokens_per_s": self._rate("cluster", now,
                                              tot["tokens"]),
                   "preempts": tot["preempts"],
                   "iterations": tot["iterations"],
                   "assigns": tot["assigns"],
                   "n_alive": tot["n_alive"],
                   "n_live": extra.get("n_live", 0),
                   "n_finished": extra.get("n_finished", 0),
                   "n_rejected": extra.get("n_rejected", 0)}
        rows.append(cluster)
        self.frames.append(rows)
        if len(self.frames) >= self.cap:
            del self.frames[1::2]
            self.interval *= 2
        return cluster

    # ------------------------------------------------------------------
    def rows(self, scope: Optional[str] = None) -> List[dict]:
        """Flat sample list, optionally filtered to one scope
        (``"cluster"``, ``"worker0"``, ...)."""
        out = [row for frame in self.frames for row in frame]
        if scope is not None:
            out = [r for r in out if r["scope"] == scope]
        return out

    def export_csv(self, path: str) -> str:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(TS_FIELDS),
                               restval="")
            w.writeheader()
            for row in self.rows():
                w.writerow(row)
        return path

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"interval": self.interval, "fields":
                       list(TS_FIELDS), "samples": self.rows()}, f)
        return path
