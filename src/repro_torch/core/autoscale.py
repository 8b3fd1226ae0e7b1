"""Closed-loop autoscaling inside the DES (docs/AUTOSCALING.md).

The fleet the dispatcher sees is no longer fixed: an :class:`Autoscaler`
daemon process samples queue depth, per-worker utilization and (when an
SLO is configured) windowed TTFT attainment every
``AutoscaleSpec.interval`` simulated seconds and grows or shrinks the
replica set between ``min_replicas`` and ``max_replicas``.

Scale-up is not free: a new worker clones the template ``WorkerSpec``
and pays the same recovery cost model as a fault revival
(docs/RELIABILITY.md) — model-reload latency
(``HardwareSpec.reload_time`` or the spec override) followed by
``warmup_iters`` iterations at ``warmup_factor``x — before it becomes
dispatch-eligible.  Scale-down reuses the drain path: the victim stops
taking new dispatches, finishes (or swaps out and re-admits) the work
it holds, and only then retires, so no request is ever lost to a
scaling decision.  Retired workers stay in the registry with their
stats frozen; billing stops at retirement
(``explore.uptime_weighted_price``).

Policies (``AUTOSCALE_POLICIES``):

* ``threshold`` — scale up when mean queue depth per serving worker
  exceeds ``queue_high`` (or windowed SLO attainment drops below
  ``slo_target``); scale down when the queue is below ``queue_low``
  *and* utilization below ``util_low``,
* ``target_utilization`` — track ``ceil(n * util / target_util)``
  serving replicas, the classic CPU-style target tracker,
* ``predictive_ema`` — linear trend extrapolation of an exponentially
  weighted queue-depth average: scale on where the queue is *heading*,
  buying back the provisioning lag that reactive policies eat.

Every decision is a pure function of sampled simulation state and the
spec, so autoscaled runs remain deterministic: the scale-event log is
part of the byte-identity contract (tests/test_autoscale.py).

The port's copy of ``repro.core.autoscale``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import ceil, inf
from typing import List, Optional

#: every pluggable scaling policy ``AutoscaleSpec.policy`` accepts;
#: scripts/check_docs.py asserts each is documented in
#: docs/AUTOSCALING.md
AUTOSCALE_POLICIES = ("threshold", "target_utilization", "predictive_ema")

#: every ``ScaleEvent.action`` the autoscaler logs
SCALE_ACTIONS = ("up_request", "up_ready", "down_drain", "down_retired")


@dataclass(frozen=True)
class AutoscaleSpec:
    """Configuration for the closed-loop autoscaler (``SimSpec.autoscale``).

    ``template`` is the ``WorkerSpec`` scale-up clones; ``None`` uses
    the first entry of ``SimSpec.workers``.  The autoscaler *manages*
    exactly the workers built from a spec equal to the template (other
    entries — e.g. other models in a heterogeneous fleet — are never
    scaled), and ``min_replicas``/``max_replicas`` bound the managed
    count including replicas still provisioning.

    ``enabled=False`` makes the spec inert: no daemon process is
    created and the run is byte-identical to ``autoscale=None``
    (golden-pinned in tests/golden/autoscale_pin.json)."""
    enabled: bool = True
    policy: str = "threshold"
    #: sampling period of the control loop, simulated seconds
    interval: float = 2.0
    min_replicas: int = 1
    max_replicas: int = 4
    #: minimum seconds between consecutive scale actions (hysteresis)
    cooldown: float = 10.0
    #: managed replicas added/retired per control decision
    scale_step: int = 1
    #: mean waiting requests per serving worker that triggers scale-up
    queue_high: float = 4.0
    #: queue level below which scale-down becomes permissible
    queue_low: float = 0.5
    #: utilization below which ``threshold``/``predictive_ema`` shrink
    util_low: float = 0.35
    #: utilization the ``target_utilization`` policy tracks
    target_util: float = 0.7
    #: in-flight requests (running + queued) one worker is considered
    #: full at — the denominator of the sampled utilization.  Busy-time
    #: fraction is useless under continuous batching (a single decoding
    #: request keeps the iteration loop 100% busy while throughput can
    #: still grow an order of magnitude with batching), so utilization
    #: here is *occupancy*: ``min(1, in_flight / capacity_concurrency)``
    #: averaged over serving workers
    capacity_concurrency: int = 64
    #: EMA smoothing for ``predictive_ema`` (1.0 = no smoothing)
    ema_alpha: float = 0.5
    #: when set, windowed TTFT attainment below ``slo_target`` is a
    #: scale-up signal for the ``threshold`` policy
    ttft_slo: Optional[float] = None
    slo_target: float = 0.99
    #: WorkerSpec to clone on scale-up; None = SimSpec.workers[0]
    template: Optional[object] = None
    #: provisioning lag before a new worker serves; None = the
    #: template hardware's ``HardwareSpec.reload_time``
    reload_time: Optional[float] = None
    #: post-provisioning warm-up, same model as fault recovery
    warmup_iters: int = 2
    warmup_factor: float = 2.0

    def validate(self) -> None:
        if self.policy not in AUTOSCALE_POLICIES:
            raise ValueError(f"unknown autoscale policy {self.policy!r}; "
                             f"have {AUTOSCALE_POLICIES}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.interval <= 0:
            raise ValueError("AutoscaleSpec.interval must be > 0")
        if self.scale_step < 1:
            raise ValueError("AutoscaleSpec.scale_step must be >= 1")


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler action in ``Results.scale_events`` — the scaling
    summary and the byte-identity tests derive everything from these.
    ``fleet_size`` is the managed provisioned count (serving +
    provisioning, retired excluded) *after* the action; ``signal`` is
    the policy input that triggered it (queue depth or utilization)."""
    time: float
    worker: int
    action: str                   # see SCALE_ACTIONS
    fleet_size: int
    signal: float = 0.0


class Autoscaler:
    """DES daemon scaling a ``Simulation``'s fleet at runtime.

    Follows the ``FaultInjector``/``TimeSeriesRecorder`` pattern: the
    control loop runs on *daemon* timeouts, so an idle autoscaler never
    keeps the simulation alive nor extends ``sim_time`` — but a
    provisioning worker's reload wait is a plain timeout, so capacity
    that was paid for always comes up (and can un-park requests even
    if every other worker died meanwhile)."""

    def __init__(self, sim, spec: AutoscaleSpec):
        spec.validate()
        self.sim = sim
        self.env = sim.env
        self.spec = spec
        self.template = spec.template if spec.template is not None \
            else sim.spec.workers[0]
        #: backends_by_worker keys follow the original spec position;
        #: clones inherit the template's slot
        try:
            self.template_base_i = list(sim.spec.workers).index(
                self.template)
        except ValueError:
            self.template_base_i = 0
        self.managed: List = [w for w in sim.workers
                              if w.spec_ws == self.template]
        if not self.managed:
            raise ValueError(
                "AutoscaleSpec.template matches no worker in the fleet; "
                "scale-up would add a worker the workload never targets")
        if len(self.managed) < spec.min_replicas:
            raise ValueError(
                f"fleet starts with {len(self.managed)} managed "
                f"worker(s) but min_replicas={spec.min_replicas}")
        self.events: List[ScaleEvent] = []
        self.n_scale_up = 0
        self.n_scale_down = 0
        self._last_action_t = -inf
        self._ema: Optional[float] = None
        self._prev_ema: Optional[float] = None
        #: windowed SLO attainment counters, reset every tick
        self._win_finished = 0
        self._win_slo_ok = 0

    # ------------------------------------------------------------------
    def start(self) -> None:
        self.env.process(self._loop(), name="autoscaler", daemon=True)

    def on_finish(self, req) -> None:
        """Simulation tap: count windowed TTFT attainment at retire
        time (works in streaming drop-mode — the request may be garbage
        one call later)."""
        if self.spec.ttft_slo is None:
            return
        ttft = req.ttft
        if ttft is None:
            return
        self._win_finished += 1
        if ttft <= self.spec.ttft_slo:
            self._win_slo_ok += 1

    # ------------------------------------------------------------------
    def _loop(self):
        env = self.env
        while True:
            yield env.timeout(self.spec.interval, daemon=True)
            self._tick()

    def _provisioned(self) -> List:
        return [w for w in self.managed if not w.retired]

    def _serving(self) -> List:
        return [w for w in self.managed
                if w.alive and not w.draining and not w.provisioning]

    def _tick(self) -> None:
        now = self.env.now
        self._finalize_retirements(now)
        serving = self._serving()
        provisioned = self._provisioned()
        n_prov = len(provisioned)
        # ---- sample control signals ----------------------------------
        cap = max(1, self.spec.capacity_concurrency)
        if serving:
            q = sum(len(w.waiting) for w in serving) / len(serving)
            util = sum(
                min(1.0, (len(w.running) + len(w.waiting)) / cap)
                for w in serving) / len(serving)
        else:
            # nothing serving (all provisioning or down): pressure is
            # whatever queued on the managed set; treat util as high
            q = float(sum(len(w.waiting) for w in provisioned) or 0)
            util = 1.0
        slo_att = None
        if self.spec.ttft_slo is not None and self._win_finished:
            slo_att = self._win_slo_ok / self._win_finished
        self._win_finished = self._win_slo_ok = 0
        delta = self._decide(q, util, slo_att, len(serving), n_prov)
        # ---- apply, under cooldown and the replica bounds ------------
        if delta == 0 or now - self._last_action_t < self.spec.cooldown:
            return
        if delta > 0:
            k = min(delta, self.spec.scale_step,
                    self.spec.max_replicas - n_prov)
            if k <= 0:
                return
            self._last_action_t = now
            for _ in range(k):
                self._scale_up(now, signal=q)
        else:
            # already-retiring workers still count as provisioned but
            # are guaranteed to leave: bound the step by the fleet that
            # will remain, or min_replicas can be transiently violated
            n_leaving = sum(1 for w in provisioned if w.retiring)
            k = min(-delta, self.spec.scale_step,
                    n_prov - n_leaving - self.spec.min_replicas)
            victims = self._pick_victims(k)
            if not victims:
                return
            self._last_action_t = now
            for w in victims:
                self._scale_down(w, now, signal=util)

    # ------------------------------------------------------------------
    def _decide(self, q: float, util: float, slo_att: Optional[float],
                n_serving: int, n_prov: int) -> int:
        """Desired change to the managed provisioned count.  Pure in
        (sampled state, spec): determinism of the scale-event log —
        and thus same-seed byte-identity — rests here."""
        s = self.spec
        if s.policy == "threshold":
            if q > s.queue_high or (slo_att is not None
                                    and slo_att < s.slo_target):
                return 1
            if q < s.queue_low and util < s.util_low:
                return -1
            return 0
        if s.policy == "target_utilization":
            if n_serving == 0:
                return 1 if q > 0 else 0
            desired = ceil(n_serving * util / s.target_util)
            if desired > n_prov:
                return desired - n_prov
            if desired < n_prov and q <= s.queue_low:
                return desired - n_prov
            return 0
        # predictive_ema: first-order trend on the smoothed queue depth
        a = s.ema_alpha
        ema = q if self._ema is None else a * q + (1.0 - a) * self._ema
        prev = self._ema if self._ema is not None else ema
        self._prev_ema, self._ema = prev, ema
        predicted = ema + (ema - prev)
        if predicted > s.queue_high:
            return 1
        if predicted < s.queue_low and util < s.util_low:
            return -1
        return 0

    # ------------------------------------------------------------------
    def _scale_up(self, now: float, *, signal: float) -> None:
        w = self.sim.add_worker(self.template,
                                base_i=self.template_base_i,
                                provisioning=True)
        self.managed.append(w)
        self.n_scale_up += 1
        self._log(w.wid, "up_request", signal)
        self.env.process(self._provision(w), name=f"provision-w{w.wid}")

    def _provision(self, w):
        """Pay the model-load lag, then join the serving set warm —
        the same recovery cost model a fault revival uses."""
        s = self.spec
        rt = s.reload_time if s.reload_time is not None \
            else w.hw.reload_time
        if rt > 0:
            yield self.env.timeout(rt)
        w.provisioning = False
        w.recover(warmup_iters=s.warmup_iters,
                  warmup_factor=s.warmup_factor)
        self._log(w.wid, "up_ready")
        self.sim.on_worker_recovered(w)

    def _pick_victims(self, k: int) -> List:
        """Least-loaded serving workers first (ties: youngest wid), so
        draining finishes fastest and the original fleet is the last
        to go."""
        if k <= 0:
            return []
        cands = sorted(self._serving(),
                       key=lambda w: (w.load_tokens(), -w.wid))
        return cands[:k]

    def _scale_down(self, w, now: float, *, signal: float) -> None:
        w.begin_retire()
        self.n_scale_down += 1
        self._log(w.wid, "down_drain", signal)
        self._finalize_retirements(now)   # an idle victim retires now

    def _finalize_retirements(self, now: float) -> None:
        for w in self.managed:
            if w.retiring and not w.retired and not w.waiting \
                    and not w.running:
                w.finish_retire(now)
                self._log(w.wid, "down_retired")

    def _log(self, wid: int, action: str, signal: float = 0.0) -> None:
        ev = ScaleEvent(self.env.now, wid, action,
                        len(self._provisioned()), signal)
        self.events.append(ev)
        obs = self.sim.obs
        if obs is not None:
            obs.on_scale(wid, action, self.env.now)
