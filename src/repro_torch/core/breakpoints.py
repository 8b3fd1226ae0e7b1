"""Operator/iteration-level breakpoints (paper §III-A).

A ``Hooks`` registry maps breakpoint names to user callables.  Workers
invoke them at the documented points; the disaggregation behavior ships
as a two-hook definition (``disagg_hooks``), mirroring the paper's claim
that PD-separation is "two lines of code" on top of the breakpoint API.

Hook points (args):
  before_sched(worker)                 — before each scheduling decision
  on_admit(worker, req)                — request admitted to the batch
  after_prefill(worker, req)           — prompt KV complete (before token)
  on_first_token(worker, req)          — first output token emitted
  after_token(worker, req)             — every generated token
  after_iteration(worker, plan, t)     — iteration retired (t = duration)
  on_finish(worker, req)               — request completed

The port's copy of ``repro.core.breakpoints``, its imports rewritten.
"""
from __future__ import annotations

from typing import Callable, Dict, List

#: the seven breakpoints; each is fired by the worker loop (see the
#: module docstring for arguments) and audited ≥1-fire by
#: tests/test_observability.py.  scripts/check_docs.py asserts each
#: name is documented in docs/OBSERVABILITY.md
HOOK_POINTS = ("before_sched", "on_admit", "after_prefill",
               "on_first_token", "after_token", "after_iteration",
               "on_finish")


class Hooks:
    """Breakpoint registry with an O(1) empty fast path: ``fire`` on a
    point with no callbacks is a plain dict miss — no list is allocated
    or inserted (the previous defaultdict grew one empty list per
    distinct miss), so the worker's per-token hot loop pays nothing
    when observability is off."""

    __slots__ = ("_hooks",)

    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = {}

    def on(self, point: str, fn: Callable) -> "Hooks":
        if point not in HOOK_POINTS:
            raise KeyError(f"unknown breakpoint {point!r}; "
                           f"have {HOOK_POINTS}")
        self._hooks.setdefault(point, []).append(fn)
        return self

    def fire(self, point: str, *args) -> None:
        fns = self._hooks.get(point)
        if fns is None:
            return
        for fn in fns:
            fn(*args)


def disagg_hooks() -> Hooks:
    """PD disaggregation in two hooks: after the first token on a
    prefill-only worker, hand the request back to the global scheduler
    (which sends it to a decode worker, moving the KV over the link)."""
    hooks = Hooks()

    def submit_back(worker, req):
        if worker.run_prefill and not worker.run_decode and not req.finished:
            worker.cluster.migrate(req, worker)

    hooks.on("on_first_token", submit_back)
    return hooks
