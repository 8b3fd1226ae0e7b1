"""Simulated inference worker: one accelerator running an iteration loop.

The worker is a DES process: it asks its local scheduler for an
``IterationPlan``, charges the cost model for the batch, advances
simulated time, then applies the plan's effects (token emission, KV
growth, finishes, preemptions) and fires breakpoints.

The port's copy of ``repro.core.worker``, its imports rewritten.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

from repro_torch.core.breakpoints import Hooks
from repro_torch.core.costmodel.backends import CostBackend
from repro_torch.core.costmodel.hardware import HardwareSpec
from repro_torch.core.costmodel.operators import BatchMix
from repro_torch.core.engine import Environment, Event
from repro_torch.core.mem.block_manager import BlockManager, MemoryConfig
from repro_torch.core.mem.memory_pool import MemoryPool
from repro_torch.core.mem.swap import SwapManager
from repro_torch.core.request import Request, State
from repro_torch.core.sched.local import LocalScheduler
from repro_torch.obs.timeseries import BoundedSeries


#: mem_timeline length at which the sampling stride doubles (bounds the
#: timeline's memory on long runs; sub-cap runs record every iteration)
MEM_TIMELINE_CAP = 8192


@dataclass
class MemSample:
    t: float
    used_blocks: int
    used_bytes: float
    n_running: int


class Worker:
    def __init__(self, env: Environment, wid: int, hw: HardwareSpec,
                 backend: CostBackend, mem_cfg: MemoryConfig,
                 sched: LocalScheduler, *, run_prefill: bool = True,
                 run_decode: bool = True, cluster=None,
                 pool: Optional[MemoryPool] = None,
                 hooks: Optional[Hooks] = None,
                 enc_tokens_per_req: int = 0,
                 discipline=None, spec_decode=None,
                 draft_backend: Optional[CostBackend] = None,
                 swap: Optional[SwapManager] = None,
                 obs=None, model: Optional[str] = None, tp: int = 1):
        self.env = env
        self.wid = wid
        self.hw = hw
        #: model this worker hosts (docs/HETEROGENEITY.md); None = hosts
        #: anything (homogeneous fleets and bare unit-test workers)
        self.model = model
        #: resolved tensor-parallel degree (per-worker override wins
        #: over the cluster ParallelSpec) — mirrored here so the price
        #: model can be pinned against the built fleet
        self.tp = tp
        self.backend = backend
        self.mem = BlockManager(mem_cfg)
        self.sched = sched
        self.run_prefill = run_prefill
        self.run_decode = run_decode
        self.cluster = cluster
        self.pool = pool
        self.hooks = hooks or Hooks()
        self.enc_tokens_per_req = enc_tokens_per_req
        #: tenant-aware queue ordering (repro.core.tenancy.qos); None=FIFO
        self.discipline = discipline
        #: speculative decoding (repro.core.specdecode); None = disabled
        self.spec_decode = spec_decode
        self.draft_backend = draft_backend
        #: host-DRAM KV tier (repro.core.mem.swap); when set, preemption
        #: swaps victims' KV out over PCIe instead of discarding it
        self.swap = swap
        #: observability hub (repro.obs.ObsRecorder); None = all taps
        #: collapse to one attribute load + is-None check per iteration
        self.obs = obs
        self._spec_rng = spec_decode.rng_for_worker(wid) \
            if spec_decode is not None else None

        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        #: every distinct request model ever submitted here — the
        #: no-cross-model-dispatch invariant in tests/test_hetero_fleet.py
        #: asserts this stays within {self.model}
        self.served_models: set = set()
        self.alive = True
        self.slowdown = 1.0
        #: draining (repro.core.faults): alive and finishing its queue,
        #: but skipped by the global scheduler for new dispatches
        self.draining = False
        #: autoscaler lifecycle (repro.core.autoscale): a provisioning
        #: worker was just added and is paying its model-load lag
        #: (alive=False keeps it out of every dispatch path, including
        #: the _eligible alive-fallback); retiring = draining toward
        #: permanent removal; retired = out of the serving set for
        #: good, stats frozen, billing stopped
        self.provisioning = False
        self.retiring = False
        self.retired = False
        #: billing surface (explore.uptime_weighted_price): per-device
        #: price x devices, stamped by the simulator's worker builder,
        #: and the provisioned-to-retired span actually billed
        self.price = 0.0
        self.t_provisioned = env.now
        self.t_retired: Optional[float] = None
        #: the WorkerSpec this worker was built from (None for bare
        #: unit-test workers); the autoscaler manages template-equal ones
        self.spec_ws = None
        #: post-recovery warm-up (docs/RELIABILITY.md): the next
        #: ``_warmup_left`` iterations cost ``_warmup_factor``x
        self._warmup_left = 0
        self._warmup_factor = 1.0
        #: bumped by fail(); an iteration in flight across a failure
        #: compares epochs after its timeout and discards its effects
        #: (the batch died with the device)
        self._fail_epoch = 0
        #: memory-over-time samples under stride-doubling decimation
        #: (repro.obs.timeseries.BoundedSeries): bounded on
        #: million-iteration runs, every iteration below the cap
        self._mem_series = BoundedSeries(MEM_TIMELINE_CAP)
        #: incrementally maintained load_tokens halves; each tracked
        #: request stores its charge so enqueue/dequeue stay O(1) even
        #: if its prefill/context state changes while tracked (e.g. a
        #: pool prefix hit before admission)
        self._waiting_load = 0
        self._running_load = 0
        self.iterations = 0
        self.busy_time = 0.0
        #: busy_time split by phase, each iteration's cost allocated
        #: proportionally to its prefill vs decode token counts — the
        #: basis of the $/1M-tokens prefill/decode split
        #: (Results.scaling_summary, docs/AUTOSCALING.md)
        self.prefill_time = 0.0
        self.decode_time = 0.0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        #: cheap cumulative counters the time-series recorder samples
        self.tokens_emitted = 0
        self.preempt_events = 0
        #: pipeline-parallel accounting (docs/PARALLELISM.md): cumulative
        #: fill/drain bubble, stage-boundary p2p comm, and pipeline span
        #: (step time x steps, framework overhead excluded) — so
        #: bubble/span can be checked against the closed-form fraction
        self.pp_bubble_time = 0.0
        self.pp_comm_time = 0.0
        self.pp_span_time = 0.0
        self._wake: Optional[Event] = None
        self.proc = env.process(self._run(), name=f"worker{wid}")

    @property
    def mem_timeline(self) -> List[MemSample]:
        return self._mem_series.rows

    # ------------------------------------------------------------------
    def _enqueue(self, req: Request, *, front: bool = False) -> None:
        charge = max(1, req.remaining_prefill) + 1
        req._load_charge = charge
        self._waiting_load += charge
        if front:
            self.waiting.appendleft(req)
        else:
            self.waiting.append(req)

    def submit(self, req: Request) -> None:
        req.worker_id = self.wid
        req.state = State.WAITING
        if req.model is not None:
            self.served_models.add(req.model)
        self._enqueue(req)
        self._wakeup()

    def receive_migrated(self, req: Request) -> None:
        """Request arrives with its KV already computed elsewhere: blocks
        for the full context are allocated at admission; no prefill."""
        req.worker_id = self.wid
        req.state = State.WAITING
        if req.model is not None:
            self.served_models.add(req.model)
        req.prefill_done_len = req.prefill_target
        self._enqueue(req)
        self._wakeup()

    def next_waiting(self) -> Optional[Request]:
        """Head of the waiting queue under the active discipline."""
        if not self.waiting:
            return None
        if self.discipline is None:
            return self.waiting[0]
        return self.discipline.select(self.waiting, self.env.now)

    def pop_waiting(self, req: Request) -> None:
        self.waiting.remove(req)
        self._waiting_load -= req._load_charge
        req._load_charge = 0

    def victim_sort_key(self):
        """Ascending sort key such that the END of the sorted running
        list is the first preemption victim."""
        if self.discipline is None:
            return lambda r: (r.arrival_time, r.id)
        return self.discipline.victim_key(self.env.now)

    def load_tokens(self) -> int:
        """Dispatch-load heuristic: queued work plus running context
        pressure, both maintained incrementally so the global
        scheduler's per-request scan of all workers stays O(1) each."""
        return self._waiting_load + self._running_load

    def _charge_running(self, req: Request) -> None:
        c = 1 + req.context_len // 256
        req._run_charge = c
        self._running_load += c

    def _uncharge_running(self, req: Request) -> None:
        self._running_load -= req._run_charge
        req._run_charge = 0

    def _wakeup(self):
        if self._wake is not None and not self._wake.triggered:
            self._wake.succeed()

    # ------------------------------------------------------------------
    def _run(self):
        env = self.env
        while True:
            if not self.alive:
                self._wake = env.event()
                yield self._wake
                continue
            self.hooks.fire("before_sched", self)
            plan = self.sched.plan(self)
            if plan.empty:
                self._wake = env.event()
                yield self._wake
                continue

            for req in plan.admitted:
                req.state = State.PREFILL if req.remaining_prefill else \
                    State.DECODE
                if req not in self.running:
                    self.running.append(req)
                    self._charge_running(req)
                if self.discipline is not None:
                    self.discipline.on_service_start(req, env.now)
                self.hooks.fire("on_admit", self, req)
            obs = self.obs
            for req in plan.preempted:
                req.state = State.PREEMPTED
                self.preempt_events += 1
                if obs is not None:
                    obs.on_preempt(req, env.now)
                if req in self.running:
                    self.running.remove(req)
                    self._uncharge_running(req)
                self._enqueue(req, front=True)  # retry first (vLLM order)

            # KV must grow before the decode step executes; speculative
            # requests book the whole draft window, the rejected suffix
            # is rolled back after verification
            for req in plan.decode:
                self.mem.append_tokens(req, 1)
            verify = []
            if plan.spec_decode:
                k1 = self.spec_decode.verify_tokens
                for req in plan.spec_decode:
                    self.mem.append_tokens(req, k1)
                    # K+1 causal query positions over the live context:
                    # costed like a prefill chunk in the target's mix
                    verify.append((k1, req.context_len))

            mix = BatchMix.from_batch(
                [(c, b) for _, c, b in plan.prefill] + verify,
                [r.context_len for r in plan.decode],
                enc_tokens=self.enc_tokens_per_req * sum(
                    1 for r, c, b in plan.prefill
                    if b == 0))
            # swap transfers are PCIe-bound, not compute: they bill at
            # face value rather than scaling with the worker slowdown
            t_compute = self.backend.iteration_time(mix)
            if self._warmup_left > 0:
                # cold caches / recompiled kernels after a restart
                t_compute *= self._warmup_factor
                self._warmup_left -= 1
            breakdown = getattr(self.backend, "last_breakdown", None)
            if breakdown is not None:
                # scale by the worker slowdown like the billed time, so
                # bubble/comm/span share busy_time's time base
                sd = self.slowdown
                bubble, comm, span = breakdown
                plan.pp_bubble = bubble * sd
                plan.comm_latency = comm * sd
                self.pp_bubble_time += bubble * sd
                self.pp_comm_time += comm * sd
                self.pp_span_time += span * sd
            t = t_compute * self.slowdown \
                + plan.retrieve_latency + plan.swap_latency \
                + plan.fetch_latency
            if plan.spec_decode:
                plan.draft_latency = \
                    self._draft_time(plan.spec_decode) * self.slowdown
                t += plan.draft_latency
            epoch = self._fail_epoch
            yield env.timeout(t)
            if self._fail_epoch != epoch:
                # the worker failed while this iteration was in flight:
                # the batch is gone (orphans already re-dispatched), so
                # applying its effects would double-emit tokens for
                # requests now living on another worker
                continue
            now = env.now
            self.iterations += 1
            self.busy_time += t
            p_tok = sum(c for _r, c, _b in plan.prefill)
            d_tok = len(plan.decode)
            if plan.spec_decode:
                d_tok += len(plan.spec_decode) \
                    * self.spec_decode.verify_tokens
            tot = p_tok + d_tok
            if tot:
                self.prefill_time += t * (p_tok / tot)
                self.decode_time += t * (d_tok / tot)
                self.prefill_tokens += p_tok
                self.decode_tokens += d_tok
            if obs is not None and obs.attribution:
                # before token emission, so an iteration that produces
                # the first token still banks on the TTFT side
                obs.attribute(plan, t)

            # ---- apply effects ---------------------------------------
            for req, chunk, _ctx in plan.prefill:
                req.prefill_done_len = max(req.cached_len,
                                           req.prefill_done_len) + chunk
                if req.remaining_prefill == 0:
                    self.hooks.fire("after_prefill", self, req)
                    self._emit_token(req, now)
            for req in plan.decode:
                self._emit_token(req, now)
            for req in plan.spec_decode:
                self._apply_spec_step(req, now)

            ms = self._mem_series
            if ms.should_record():
                ms.append(MemSample(
                    now, self.mem.num_used, self.mem.used_bytes(),
                    len(self.running)))
            self.hooks.fire("after_iteration", self, plan, t)

    # ------------------------------------------------------------------
    def estimate_prefill_time(self, tokens: int) -> float:
        """Analytic cost of prefilling ``tokens`` from scratch as one
        chunk on this worker — the recompute side of the fetch-vs-
        recompute break-even (docs/ROUTING.md), mirroring the swap
        crossover's use of the cost model."""
        if tokens <= 0:
            return 0.0
        mix = BatchMix.from_batch([(tokens, 0)], [])
        return self.backend.iteration_time(mix) * self.slowdown

    def _draft_time(self, spec_reqs: List[Request]) -> float:
        """Cost of the draft model proposing K tokens: K sequential
        decode iterations of the draft backend over the speculative
        sub-batch (context grows by one per draft position)."""
        cfg = self.spec_decode
        t = 0.0
        for k in range(cfg.lookahead):
            mix = BatchMix.from_batch(
                [], [r.context_len + k for r in spec_reqs])
            t += self.draft_backend.iteration_time(mix)
        return t

    def _apply_spec_step(self, req: Request, now: float) -> None:
        """Sample the verify outcome: keep the accepted draft prefix plus
        the bonus token, roll rejected tokens' KV blocks back, emit."""
        cfg = self.spec_decode
        accepted = cfg.acceptance.sample_accepted(
            self._spec_rng, cfg.lookahead)
        emitted = min(accepted + 1, req.output_len - req.tokens_generated)
        req.spec_steps += 1
        req.spec_tokens += emitted
        req.draft_proposed += cfg.lookahead
        req.draft_accepted += accepted
        self.mem.rollback_tokens(req, cfg.verify_tokens - emitted)
        for _ in range(emitted):
            self._emit_token(req, now)

    def _emit_token(self, req: Request, now: float) -> None:
        first = req.tokens_generated == 0
        req.tokens_generated += 1
        self.tokens_emitted += 1
        req.token_times.append(now)
        c = 1 + req.context_len // 256
        if c != req._run_charge:
            self._running_load += c - req._run_charge
            req._run_charge = c
        if first:
            req.t_first_token = now
            self.hooks.fire("on_first_token", self, req)
            if req.state == State.MIGRATING:
                return                      # handed off to a decode worker
        req.state = State.DECODE
        self.hooks.fire("after_token", self, req)
        if req.finished:
            self._finish(req, now)

    def _finish(self, req: Request, now: float) -> None:
        req.state = State.FINISHED
        req.t_finish = now
        if req in self.running:
            self.running.remove(req)
            self._uncharge_running(req)
        self.mem.free(req)
        if self.pool is not None:
            self.pool.store(req.session_id, req.context_len)
        self.hooks.fire("on_finish", self, req)
        if self.cluster is not None:
            self.cluster.on_request_finished(req)

    # ------------------------------------------------------------------
    def release(self, req: Request) -> None:
        """Remove a request from this worker (migration/failure)."""
        if req in self.running:
            self.running.remove(req)
            self._uncharge_running(req)
        if req in self.waiting:
            self.pop_waiting(req)
        self.mem.free(req)
        if self.swap is not None and self.swap.drop(req):
            # host copy is gone with the worker binding: re-prefill
            req.swapped_tokens = 0
            req.prefill_done_len = 0
            req.cached_len = 0

    def fail(self, *, kv_survives: bool = False) -> List[Request]:
        """Kill the worker; returns requests needing re-dispatch.

        Device KV always dies with the worker.  With ``kv_survives``
        (``ChaosSpec.host_kv_survives``) victims whose KV is parked in
        the host-DRAM swap tier keep their entry and progress — the
        host memory outlives the worker process — so the re-dispatch
        can adopt the copy into the new worker's tier instead of
        re-prefilling (docs/RELIABILITY.md)."""
        self.alive = False
        self._fail_epoch += 1
        self._warmup_left = 0
        orphans = list(self.running) + list(self.waiting)
        for r in orphans:
            self.mem.free(r)
            if kv_survives and self.swap is not None \
                    and self.swap.holds(r):
                r.preempt_count += 1
                r.state = State.QUEUED
                continue
            if self.swap is not None:
                self.swap.drop(r)
            # restart from scratch (device and host KV lost)
            r.swapped_tokens = 0
            r.prefill_done_len = 0
            r.cached_len = 0
            r.preempt_count += 1
            r.state = State.QUEUED
        self.running.clear()
        self.waiting.clear()
        self._waiting_load = 0
        self._running_load = 0
        return orphans

    def recover(self, warmup_iters: int = 0,
                warmup_factor: float = 1.0) -> None:
        if self.retired:
            # a revival landing after the autoscaler retired the worker
            # must not resurrect it into the serving set
            return
        self.alive = True
        # a retiring worker stays out of dispatch even across a
        # fault-recovery cycle: retirement is not cancellable by repair
        self.draining = self.retiring
        self._warmup_left = warmup_iters
        self._warmup_factor = warmup_factor
        self._wakeup()

    # ---- autoscaler lifecycle (repro.core.autoscale) -----------------
    def begin_retire(self) -> None:
        """Scale-down: stop taking dispatches, finish what's queued."""
        self.retiring = True
        self.draining = True

    def finish_retire(self, now: float) -> None:
        """Queue drained: leave the serving set permanently.  The
        worker object stays in the registry so per-worker stats and
        wid indexing survive; billing stops here."""
        self.retired = True
        self.alive = False
        self.t_retired = now
