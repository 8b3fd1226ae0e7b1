"""Request objects and lifecycle states."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class State(enum.Enum):
    QUEUED = "queued"          # at global scheduler
    WAITING = "waiting"        # in a worker's local queue
    PREFILL = "prefill"
    MIGRATING = "migrating"    # KV in flight between workers (disagg)
    DECODE = "decode"
    PREEMPTED = "preempted"    # swapped out / pending recompute
    FINISHED = "finished"
    REJECTED = "rejected"      # dropped by admission control (429)


@dataclass(eq=False)
class Request:
    # eq=False: identity semantics, so hot-path ``in``/``remove`` on
    # worker queues are pointer comparisons instead of a 25-field
    # structural compare (which also mis-identifies distinct requests
    # that happen to share every field value)
    id: int
    arrival_time: float
    prompt_len: int
    output_len: int                      # target new tokens (incl. first)

    # multi-round conversation support
    session_id: Optional[int] = None
    round_idx: int = 0
    history_len: int = 0                 # tokens of prior rounds (KV reusable)

    # heterogeneous fleet serving (docs/HETEROGENEITY.md): the model this
    # request must run on.  None means "the simulation's default arch";
    # the dispatcher stamps the concrete name at arrival so routing and
    # per-model metrics never see the sentinel
    model: Optional[str] = None

    # multi-tenant QoS (repro.core.tenancy)
    tenant_id: Optional[str] = None
    priority: int = 0                    # tier priority (larger = higher)
    weight: float = 1.0                  # WFQ share
    vft: float = 0.0                     # virtual finish time (WFQ tag)

    # hierarchical KV memory (repro.core.mem, docs/MEMORY.md): requests
    # with the same prefix_id share their first prefix_len prompt tokens
    # (a system prompt); the BlockManager content-keys those blocks
    prefix_id: Optional[int] = None
    prefix_len: int = 0

    # runtime state
    state: State = State.QUEUED
    tokens_generated: int = 0
    cached_len: int = 0                  # prefix KV reused from a pool
    prefill_done_len: int = 0            # chunked prefill progress
    worker_id: Optional[int] = None
    preempt_count: int = 0

    # speculative decoding (repro.core.specdecode)
    spec_steps: int = 0                  # verify steps taken
    spec_tokens: int = 0                 # tokens emitted by spec steps
    draft_proposed: int = 0              # draft tokens proposed (Σ K)
    draft_accepted: int = 0              # draft tokens accepted by target

    # hierarchical KV memory counters (docs/MEMORY.md)
    shared_tokens: int = 0               # tokens backed by shared blocks
    cow_copies: int = 0                  # copy-on-write block copies
    swapped_tokens: int = 0              # KV tokens parked in host DRAM
    swap_out_count: int = 0              # preemptions taken in swap mode
    swap_in_count: int = 0               # host->device restores

    # cache-aware routing (docs/ROUTING.md): the prefix_affinity router
    # stamps a one-shot hint — "worker fetch_src holds fetch_tokens of
    # your prefix" — that the target worker's admission consumes via
    # Simulation.fetch_prefix; the counters record consummated fetches
    fetch_src: Optional[int] = field(default=None, repr=False)
    fetch_tokens: int = field(default=0, repr=False)
    fetch_count: int = 0                 # peer/remote KV fetches taken
    fetched_tokens: int = 0              # prefix tokens obtained by fetch

    #: latency-attribution banks (repro.obs.attribution.RequestObs),
    #: attached lazily by the observability layer when
    #: SimSpec(obs=ObsSpec(attribution=True)); None otherwise
    obs: Optional[object] = field(default=None, repr=False)

    # incremental worker-load accounting (core.worker): the exact amount
    # this request last charged against its worker's waiting/running
    # load, so dequeue/finish can reverse it in O(1)
    _load_charge: int = field(default=0, repr=False)
    _run_charge: int = field(default=0, repr=False)

    # timestamps
    t_admitted: Optional[float] = None   # released by admission control
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def context_len(self) -> int:
        """Tokens whose KV must be resident to decode the next token."""
        return self.prompt_len + self.tokens_generated

    @property
    def prefill_target(self) -> int:
        """Tokens that must be prefilled before decode: the prompt, plus
        previously generated tokens after a recompute-preemption (vLLM
        recompute mode re-prefills them as part of the context)."""
        base = self.prompt_len
        if self.prefill_done_len < self.prompt_len and self.tokens_generated:
            base += self.tokens_generated
        return base

    @property
    def remaining_prefill(self) -> int:
        # open-coded prefill_target minus max(cached, done): this is the
        # hottest property in the scheduler loop (called once per running
        # request per iteration)
        done = self.prefill_done_len
        base = self.prompt_len
        if done < base and self.tokens_generated:
            base += self.tokens_generated
        if self.cached_len > done:
            done = self.cached_len
        rem = base - done
        return rem if rem > 0 else 0

    @property
    def finished(self) -> bool:
        return self.tokens_generated >= self.output_len

    @property
    def rejected(self) -> bool:
        return self.state == State.REJECTED

    # -- metrics ---------------------------------------------------------
    @property
    def latency(self) -> Optional[float]:
        return None if self.t_finish is None \
            else self.t_finish - self.arrival_time

    @property
    def normalized_latency(self) -> Optional[float]:
        """vLLM's metric: end-to-end latency / output length."""
        lat = self.latency
        return None if lat is None else lat / max(1, self.output_len)

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None \
            else self.t_first_token - self.arrival_time

    @property
    def queue_delay(self) -> Optional[float]:
        """Time held at the admission gateway (rate limit / inflight cap)."""
        return None if self.t_admitted is None \
            else self.t_admitted - self.arrival_time

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of draft tokens the target accepted (spec decode)."""
        if self.draft_proposed == 0:
            return None
        return self.draft_accepted / self.draft_proposed

    @property
    def max_tpot(self) -> Optional[float]:
        """Max inter-token interval (mTPOT) over the decode phase."""
        if len(self.token_times) < 2:
            return 0.0 if self.token_times else None
        return max(b - a for a, b in zip(self.token_times,
                                         self.token_times[1:]))

    def meets_slo(self, ttft_slo: float, mtpot_slo: float) -> bool:
        if self.t_finish is None:
            return False
        if self.ttft is not None and ttft_slo and self.ttft > ttft_slo:
            return False
        if mtpot_slo:
            mt = self.max_tpot
            if mt is not None and mt > mtpot_slo:
                return False
        return True
