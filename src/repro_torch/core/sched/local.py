"""Local (per-worker) schedulers: batching policies for one accelerator.

Citations: static vs continuous batching follows Orca/vLLM (paper
Fig. 8); chunked prefill is Sarathi-style; speculative-decode budgeting
follows Leviathan et al. 2023 (see repro.core.specdecode).

A policy builds an ``IterationPlan`` from the worker's waiting queue,
running set and memory manager — the full system state, per the paper's
"scheduler function API provides all system information".
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import List, Optional, Tuple

from repro_torch.core.request import Request, State


@dataclass
class IterationPlan:
    #: (req, chunk_len, ctx_before) — prompt tokens computed this iteration
    prefill: List[Tuple[Request, int, int]] = field(default_factory=list)
    decode: List[Request] = field(default_factory=list)
    #: requests decoding speculatively this iteration (draft + verify);
    #: disjoint from ``decode``
    spec_decode: List[Request] = field(default_factory=list)
    admitted: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    retrieve_latency: float = 0.0        # memory-pool fetches this iter
    #: PCIe time of this iteration's KV swap-outs/-ins (docs/MEMORY.md);
    #: billed serially into the iteration by the worker
    swap_latency: float = 0.0
    #: cross-worker / remote-tier prefix-KV fetch time this iteration
    #: (docs/ROUTING.md); billed serially like swap_latency
    fetch_latency: float = 0.0
    #: pipeline-parallel accounting (docs/PARALLELISM.md), filled by the
    #: worker after costing: fill/drain bubble time and stage-boundary
    #: p2p activation-transfer time of this iteration
    pp_bubble: float = 0.0
    comm_latency: float = 0.0
    #: speculative-decode draft-model time of this iteration, filled by
    #: the worker after costing (slowdown-scaled like the billed time) —
    #: the draft/verify split the attribution layer reports
    draft_latency: float = 0.0

    @property
    def empty(self) -> bool:
        # preempted counts as work: the worker must still apply the
        # eviction side effects (state change, re-enqueue) even when a
        # full-eviction cascade leaves nothing to compute — otherwise
        # victims strand in ``running`` with their KV already freed
        return not (self.prefill or self.decode or self.spec_decode
                    or self.preempted)


class LocalScheduler:
    """Override ``plan``.  Subclasses may keep state (paper: "stateful")."""

    def plan(self, worker) -> IterationPlan:   # worker: core.worker.Worker
        raise NotImplementedError


# Waiting-queue protocol with FIFO fallback: full workers (core.worker,
# serving.engine) expose tenant-aware ordering; minimal stub workers
# (tests, user schedulers) only need ``waiting``/``running``/``mem``.
def _next_waiting(worker) -> Optional[Request]:
    get = getattr(worker, "next_waiting", None)
    if get is not None:
        return get()
    return worker.waiting[0] if worker.waiting else None


def _pop_waiting(worker, req: Request) -> None:
    pop = getattr(worker, "pop_waiting", None)
    if pop is not None:
        pop(req)
    else:
        worker.waiting.remove(req)


def _victim_sort_key(worker):
    f = getattr(worker, "victim_sort_key", None)
    return f() if f is not None else (lambda r: (r.arrival_time, r.id))


def _preempt(worker, victim: Request, plan: IterationPlan) -> None:
    """Evict ``victim``'s KV from the device.  In swap mode
    (``worker.swap`` set) the KV parks in host DRAM over the PCIe
    channel and prefill progress survives; when the host tier is full —
    or in recompute mode — the KV is discarded and the victim
    re-prefills on re-admission.  The swap covers the full resident
    context, vLLM-style (no dedup against prefix blocks other holders
    keep resident — see docs/MEMORY.md), so a swapped victim can always
    be restored regardless of what its prefix sharers do meanwhile."""
    mem = worker.mem
    tokens = mem.resident_tokens(victim)
    mem.free(victim)
    swap = getattr(worker, "swap", None)
    if swap is not None and tokens > 0 and swap.can_swap_out(tokens):
        plan.swap_latency += swap.swap_out(victim, tokens)
        victim.swapped_tokens = tokens
        victim.swap_out_count += 1
    else:
        if swap is not None:
            swap.fallbacks += 1
        victim.prefill_done_len = 0
        victim.cached_len = 0
    victim.preempt_count += 1
    plan.preempted.append(victim)


def _prefill_sort_key(worker):
    """Order competing prefills inside one iteration: FIFO by default,
    discipline order (priority / virtual finish time) when the worker
    has a tenant-aware queue discipline."""
    disc = getattr(worker, "discipline", None)
    if disc is None:
        return lambda r: (r.arrival_time, r.id)
    return disc.admit_key(worker.env.now if hasattr(worker, "env")
                          else getattr(worker, "clock", 0.0))


@dataclass
class StaticBatching(LocalScheduler):
    """Classic static batching: fill a batch, run it to completion, only
    then admit the next batch (the paper's Fig. 8 upper timeline)."""

    max_batch: int = 32

    def plan(self, worker) -> IterationPlan:
        plan = IterationPlan()
        running = [r for r in worker.running if not r.finished]
        if not running:
            # batch finished: admit a fresh one (reserving room for each
            # request's full output — static batching predates paging)
            while worker.waiting and len(plan.admitted) < self.max_batch:
                req = _next_waiting(worker)
                ctx = max(1, req.context_len)
                if not worker.mem.can_allocate(
                        ctx, headroom_tokens=req.output_len, req=req):
                    break
                _pop_waiting(worker, req)
                worker.mem.allocate(req, ctx, reserve=req.output_len)
                plan.admitted.append(req)
            running = plan.admitted
        for r in running:
            if r.remaining_prefill > 0:
                plan.prefill.append((r, r.remaining_prefill,
                                     max(r.cached_len, r.prefill_done_len)))
            else:
                plan.decode.append(r)
        # static batching: prefill everything first, then pure decode
        if plan.prefill:
            plan.decode = []
        return plan


@dataclass
class ContinuousBatching(LocalScheduler):
    """vLLM-style continuous batching with optional chunked prefill.

    * admits new requests whenever batch slots + memory allow, respecting
      the ``max_mem_ratio`` admission cap (Fig. 10's knob: the watermark
      lives in the worker's MemoryConfig),
    * prefill-prioritized iterations (vLLM v0) unless ``chunked_prefill``
      mixes one prefill chunk with running decodes (Sarathi-style —
      beyond-paper option),
    * preempts the newest running request on decode OOM — discarding its
      KV (recompute mode) or parking it in host DRAM when the worker
      carries a ``SwapManager`` (swap mode, docs/MEMORY.md).
    """

    max_batch: int = 256
    max_batched_tokens: int = 2048
    chunked_prefill: bool = False
    prefill_chunk: int = 512

    def plan(self, worker) -> IterationPlan:
        plan = IterationPlan()
        mem = worker.mem

        # ---- admission (swap-aware: see docs/MEMORY.md) ----------------
        swap = getattr(worker, "swap", None)
        n_running = len(worker.running)
        while worker.waiting and n_running + len(plan.admitted) < self.max_batch:
            req = _next_waiting(worker)
            need = max(1, req.context_len)
            swapped = swap is not None and swap.holds(req)
            if req.cached_len == 0 and not swapped \
                    and worker.pool is not None and req.history_len > 0:
                reuse, lat = worker.pool.lookup(req)
                req.cached_len = reuse
                plan.retrieve_latency = max(plan.retrieve_latency, lat)
            if not mem.can_allocate(need, respect_watermark=True, req=req):
                break
            _pop_waiting(worker, req)
            mem.allocate(req, need)
            if swapped:
                # restore the parked KV before the step; decode resumes
                # where it left off (no re-prefill)
                plan.swap_latency += swap.swap_in(req)
                req.swap_in_count += 1
                req.swapped_tokens = 0
            elif req.fetch_src is not None:
                # cache-aware routing stamped a fetch hint (docs/
                # ROUTING.md): pull the shared prefix from the peer (or
                # the remote tier) instead of re-prefilling; the cluster
                # prices it and may decline at the break-even point
                cluster = getattr(worker, "cluster", None)
                if cluster is not None:
                    plan.fetch_latency += cluster.fetch_prefix(worker, req)
                req.fetch_src = None
            plan.admitted.append(req)

        # MIGRATING requests' KV is in flight to another worker: they
        # stay in ``running`` until the transfer completes but must not
        # be planned (their blocks are released mid-iteration)
        # single pass: ``remaining_prefill`` is a non-trivial property,
        # evaluate it once per request per iteration
        prefills = []
        decodes = []
        for r in worker.running:
            if r.finished or r.state is State.MIGRATING:
                continue
            (prefills if r.remaining_prefill > 0 else decodes).append(r)
        for r in plan.admitted:
            (prefills if r.remaining_prefill > 0 else decodes).append(r)

        # ---- build the iteration ---------------------------------------
        budget = self.max_batched_tokens
        if prefills and not self.chunked_prefill:
            # prefill-prioritized iteration (no decodes mixed in)
            for r in sorted(prefills, key=_prefill_sort_key(worker)):
                chunk = min(r.remaining_prefill, budget)
                if chunk <= 0:
                    break
                plan.prefill.append(
                    (r, chunk, max(r.cached_len, r.prefill_done_len)))
                budget -= chunk
            return plan

        if self.chunked_prefill and prefills:
            budget -= len(decodes)        # decodes cost 1 token each
            r = min(prefills, key=_prefill_sort_key(worker))
            chunk = min(r.remaining_prefill, self.prefill_chunk,
                        max(0, budget))
            if chunk > 0:
                plan.prefill.append(
                    (r, chunk, max(r.cached_len, r.prefill_done_len)))

        # ---- decodes, preempting on OOM -------------------------------
        # Victim order comes from the worker's queue discipline: FIFO
        # evicts the newest arrival (seed behaviour); tenant-aware
        # disciplines evict the lowest tier / least-entitled first, so
        # low-tier requests yield KV blocks to high-tier ones.  The
        # eviction itself follows the worker's preemption mode: swap to
        # host DRAM when a SwapManager is attached (falling back to
        # recompute if the host tier is full), discard otherwise.
        decodes.sort(key=_victim_sort_key(worker))
        survivors: List[Request] = list(decodes)

        # check appends feasible (incl. copy-on-write copies of shared
        # prefix blocks); evict newest until they are
        def total_new_blocks(reqs):
            return sum(mem.growth_blocks(r, 1) for r in reqs
                       if mem.resident(r))

        while survivors and total_new_blocks(survivors) > mem.num_free:
            victim = survivors.pop()       # newest arrival
            if victim in plan.admitted:
                plan.admitted.remove(victim)
            _preempt(worker, victim, plan)
        plan.decode = survivors
        self._assign_speculative(worker, plan)
        return plan

    def _assign_speculative(self, worker, plan: IterationPlan) -> None:
        """Upgrade planned decodes to speculative mode where they fit.

        Each speculative request bills K+1 verify tokens against
        ``max_batched_tokens`` (a normal decode bills 1) and may need
        extra KV blocks for its draft window.  Requests that don't fit
        the token budget or the remaining free blocks stay on the normal
        decode path, so mixed spec/non-spec batches schedule correctly
        and speculation never triggers a preemption by itself."""
        spec_cfg = getattr(worker, "spec_decode", None)
        if spec_cfg is None or not plan.decode:
            return
        mem = worker.mem
        k1 = spec_cfg.verify_tokens
        budget = self.max_batched_tokens \
            - sum(c for _, c, _ in plan.prefill) - len(plan.decode)
        # blocks already committed to the +1 growth of every planned
        # decode (growth_blocks includes any copy-on-write copy)
        committed = sum(mem.growth_blocks(r, 1)
                        for r in plan.decode if mem.resident(r))
        free = mem.num_free - committed
        chosen = []
        for r in plan.decode:              # already in discipline order
            if budget < k1 - 1:
                break
            if not mem.resident(r):
                continue
            extra = mem.growth_blocks(r, k1) - mem.growth_blocks(r, 1)
            if extra > free:
                continue
            free -= extra
            budget -= k1 - 1
            chosen.append(r)
        if chosen:
            ids = {r.id for r in chosen}
            plan.spec_decode = chosen
            plan.decode = [r for r in plan.decode if r.id not in ids]


#: every accepted ``SimSpec.local_policy`` name; scripts/check_docs.py
#: asserts each key is documented in docs/POLICIES.md
LOCAL_POLICIES = {"static": StaticBatching, "continuous": ContinuousBatching}


def make_local_scheduler(kind: str, **kw) -> LocalScheduler:
    try:
        cls = LOCAL_POLICIES[kind]
    except KeyError:
        raise ValueError(f"unknown local scheduler {kind!r}; "
                         f"have {sorted(LOCAL_POLICIES)}")
    # each policy takes the subset of SimSpec batching knobs it declares
    allowed = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in allowed})
