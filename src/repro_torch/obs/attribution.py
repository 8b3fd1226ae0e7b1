"""Latency attribution: where did each request's time go?

Every iteration a request participates in is decomposed into the cost
components the worker already computes (``IterationPlan``): compute, TP
all-reduce / pipeline p2p ``comm``, pipeline ``bubble``, PCIe ``swap``,
memory-pool ``retrieve`` and speculative ``draft`` time.  Components are
banked per request on one of two accounts — before the first token
(feeds TTFT) or after it (feeds TPOT) — and two residuals are derived at
finish time:

* ``queue``  = TTFT - gateway - sum(pre-token components): time the
  request spent waiting (global + local queues, preemption gaps) before
  its first token;
* ``stall``  = decode span - sum(post-token components): decode-phase
  time the request was not in any iteration (preempted, swapped out,
  migrating, or batching gaps).

Because the residuals are defined by subtraction, the attributed
components sum to the measured latency *exactly* (to float addition
error), in both exact and streaming drop-mode — the conservation
property ``tests/test_observability.py`` pins at 1e-6.

Note: post-first-token compute is labeled ``decode`` even when it is
re-prefill work after a recompute-preemption — the time is real decode-
phase latency; the preemption itself is visible in ``stall`` and in the
trace's ``preempted`` span.

The port's copy of ``repro.obs.attribution``, its imports rewritten.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: every component name that can appear in ``Results.time_breakdown()``;
#: scripts/check_docs.py asserts each is documented in
#: docs/OBSERVABILITY.md
COMPONENTS = ("gateway", "queue", "prefill", "decode", "comm", "bubble",
              "swap", "retrieve", "fetch", "draft", "migrate", "stall")


class RequestObs:
    """Per-request component banks, attached lazily as ``Request.obs``.

    The dominant component by call volume — iteration ``compute`` time,
    banked once per participant per iteration — lives in two scalar
    slots (``pre_compute`` / ``post_compute``); a float in-place add is
    severalfold cheaper than a dict update and this is the single
    hottest line of the whole observability stack (see the
    ``run_obs_overhead`` gate in benchmarks/sim_speed.py).  The rare
    components (comm, bubble, swap, ...) go in the ``pre``/``post``
    dicts."""

    __slots__ = ("pre", "post", "pre_compute", "post_compute", "final")

    def __init__(self):
        self.pre: Dict[str, float] = {}    # before the first token
        self.post: Dict[str, float] = {}   # after the first token
        self.pre_compute = 0.0
        self.post_compute = 0.0
        #: set by finalize_request: {"ttft": {...}, "decode": {...},
        #: "tokens": n} — the conserved decomposition
        self.final: Optional[dict] = None


def charge(req, comps: Sequence[Tuple[str, float]]) -> None:
    """Bank one iteration's components on ``req`` (the caller builds
    ``comps`` once per iteration, shared by every participant)."""
    ro = req.obs
    if ro is None:
        ro = req.obs = RequestObs()
    pre = req.t_first_token is None
    bank = ro.pre if pre else ro.post
    for k, v in comps:
        if k == "compute":
            if pre:
                ro.pre_compute += v
            else:
                ro.post_compute += v
        else:
            bank[k] = bank.get(k, 0.0) + v


def add_component(req, name: str, value: float, *, post: bool = True) -> None:
    """Bank a single out-of-iteration component (e.g. migration time)."""
    ro = req.obs
    if ro is None:
        ro = req.obs = RequestObs()
    bank = ro.post if post else ro.pre
    bank[name] = bank.get(name, 0.0) + value


def finalize_request(req) -> None:
    """Turn the banks into the conserved TTFT/decode decomposition.
    Called once when the request finishes (before any streaming fold)."""
    if req.t_finish is None or req.t_first_token is None:
        return
    ro = req.obs
    if ro is None:
        ro = req.obs = RequestObs()
    if ro.final is not None:
        return
    ttft = req.t_first_token - req.arrival_time
    gateway = (req.t_admitted - req.arrival_time) \
        if req.t_admitted is not None else 0.0
    ttft_c: Dict[str, float] = {}
    if gateway:
        ttft_c["gateway"] = gateway
    if ro.pre_compute:
        ttft_c["prefill"] = ro.pre_compute
    ttft_c.update(ro.pre)
    # residual: waiting anywhere before the first token (not clamped,
    # so the decomposition sums to TTFT exactly)
    ttft_c["queue"] = ttft - gateway - ro.pre_compute \
        - sum(ro.pre.values())
    decode_span = req.t_finish - req.t_first_token
    dec_c: Dict[str, float] = {}
    if ro.post_compute:
        dec_c["decode"] = ro.post_compute
    dec_c.update(ro.post)
    dec_c["stall"] = decode_span - ro.post_compute \
        - sum(ro.post.values())
    ro.final = {"ttft": ttft_c, "decode": dec_c,
                "tokens": req.tokens_generated}


# ---------------------------------------------------------------------------
# aggregation (Results.time_breakdown / Results.explain)
# ---------------------------------------------------------------------------
def _acc(dst: Dict[str, float], src: Dict[str, float],
         scale: float = 1.0) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0.0) + v * scale


def _mean(sums: Dict[str, float], n: int) -> Dict[str, float]:
    return {k: v / n for k, v in sums.items()}


def aggregate_exact(requests) -> dict:
    """Mean and P99-tail breakdowns from retained finished requests."""
    recs = [r for r in requests
            if getattr(r, "obs", None) is not None
            and r.obs.final is not None]
    if not recs:
        raise ValueError(
            "no attribution data: run with "
            "SimSpec(obs=ObsSpec(attribution=True))")
    n = len(recs)
    ttft_s: Dict[str, float] = {}
    dec_s: Dict[str, float] = {}
    tpot_s: Dict[str, float] = {}
    for r in recs:
        f = r.obs.final
        _acc(ttft_s, f["ttft"])
        _acc(dec_s, f["decode"])
        _acc(tpot_s, f["decode"], 1.0 / max(1, f["tokens"] - 1))
    # P99 tail: the worst ~1% by the respective phase duration, so the
    # tail breakdown explains what makes the slow requests slow
    k = max(1, n // 100)
    tail_t = sorted(recs, key=lambda r: (r.ttft, r.id))[-k:]
    tail_d = sorted(recs, key=lambda r: (r.t_finish - r.t_first_token,
                                         r.id))[-k:]
    ttft_p99: Dict[str, float] = {}
    dec_p99: Dict[str, float] = {}
    tpot_p99: Dict[str, float] = {}
    for r in tail_t:
        _acc(ttft_p99, r.obs.final["ttft"])
    for r in tail_d:
        f = r.obs.final
        _acc(dec_p99, f["decode"])
        _acc(tpot_p99, f["decode"], 1.0 / max(1, f["tokens"] - 1))
    return {"n": n, "mode": "exact", "tail_n": k,
            "ttft_mean": _mean(ttft_s, n),
            "decode_mean": _mean(dec_s, n),
            "tpot_mean": _mean(tpot_s, n),
            "ttft_p99": _mean(ttft_p99, len(tail_t)),
            "decode_p99": _mean(dec_p99, len(tail_d)),
            "tpot_p99": _mean(tpot_p99, len(tail_d))}


def aggregate_streaming(attrib: dict) -> dict:
    """Mean breakdowns from the per-component sums folded into
    ``StreamingStats`` (drop-mode keeps no per-request tails, so the
    P99 breakdowns are ``None`` there)."""
    n = attrib["n"]
    if not n:
        raise ValueError(
            "no attribution data: run with "
            "SimSpec(obs=ObsSpec(attribution=True))")
    return {"n": n, "mode": "streaming", "tail_n": 0,
            "ttft_mean": _mean(attrib["ttft"], n),
            "decode_mean": _mean(attrib["decode"], n),
            "tpot_mean": _mean(attrib["tpot"], n),
            "ttft_p99": None, "decode_p99": None, "tpot_p99": None}


def format_breakdown(bd: dict) -> str:
    """Human-readable table for ``Results.explain()``."""
    lines: List[str] = [
        f"latency attribution ({bd['n']} finished requests, "
        f"{bd['mode']} mode)"]

    def section(title: str, mean: Dict[str, float],
                p99: Optional[Dict[str, float]]) -> None:
        lines.append(f"-- {title} --")
        hdr = f"  {'component':<10} {'mean (s)':>12}"
        if p99 is not None:
            hdr += f" {'p99-tail (s)':>13}"
        lines.append(hdr)
        keys = [k for k in COMPONENTS
                if k in mean or (p99 and k in p99)]
        for k in keys:
            row = f"  {k:<10} {mean.get(k, 0.0):>12.6f}"
            if p99 is not None:
                row += f" {p99.get(k, 0.0):>13.6f}"
            lines.append(row)
        row = f"  {'total':<10} {sum(mean.values()):>12.6f}"
        if p99 is not None:
            row += f" {sum(p99.values()):>13.6f}"
        lines.append(row)

    section("TTFT", bd["ttft_mean"], bd["ttft_p99"])
    section("decode phase", bd["decode_mean"], bd["decode_p99"])
    section("TPOT (per token)", bd["tpot_mean"], bd["tpot_p99"])
    if bd["ttft_p99"] is None:
        lines.append("  (p99-tail breakdowns need exact mode: "
                     "retain_requests=True)")
    return "\n".join(lines)
