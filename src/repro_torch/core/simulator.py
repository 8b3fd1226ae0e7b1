"""TokenSim facade: configure a cluster, run a workload, get Results.

Mirrors the paper's Fig. 1/2: a dispatcher feeds a global scheduler that
assigns requests to concurrently running workers; local schedulers batch
between iterations; memory managers track device memory; a communication
model prices inter-worker KV movement (disaggregation, Fig. 7); an
optional memory pool serves multi-round conversations (Fig. 14); fault /
straggler injection exercises the mitigation policies.

Hierarchical KV memory (docs/MEMORY.md): ``preemption_mode="swap"``
attaches a per-worker host-DRAM ``SwapManager`` so preemption parks
victim KV over PCIe instead of recomputing it, and
``prefix_sharing=True`` makes the ``BlockManager`` share content-keyed
prefix blocks between concurrent requests with refcounted
copy-on-write — both costed against ``HardwareSpec.pcie_bw`` /
``host_mem_cap``.

Scale (docs/PERFORMANCE.md): ``SimSpec(streaming=True)`` makes the
dispatcher pull arrivals lazily from a ``workload.RequestSource``
instead of materializing the request list, and
``retain_requests=False`` folds finished requests into constant-memory
``StreamingStats`` sketches — together they bound live ``Request``
objects by the in-flight population, enabling million-request runs.

Parallelism & topology (docs/PARALLELISM.md): ``SimSpec.parallel``
(``ParallelSpec(tp, pp, replicas)``) maps each worker onto ``tp * pp``
devices of a ``SimSpec.cluster`` topology — tensor-parallel all-reduces
priced per ring step over the link the TP group occupies, pipeline
stages fed micro-batches with explicit bubble + p2p activation
accounting, and data-parallel replicas of the whole worker set.  The
defaults (tp=pp=replicas=1, cluster=None) are byte-identical to the
pre-parallelism cost model.

Multi-tenant QoS layer (repro.core.tenancy, beyond paper): when
``SimSpec.tenants`` is set, per-tenant workloads are merged into one
deterministic arrival stream and an ``AdmissionController`` — a
simulated API gateway with per-tenant token buckets and in-flight caps —
sits between the dispatcher and the global scheduler.  Tenant-aware
global policies ("wfq", "priority") hand every worker a shared queue
discipline, so weighted-fair / strict-priority ordering applies both at
dispatch and inside each worker's waiting queue, and the preemption path
evicts low-tier KV first.  ``Results`` then offers per-tenant latency /
SLO-attainment / goodput breakdowns and Jain's fairness index.

The port's copy of ``repro.core.simulator``, its imports rewritten.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm as comm_mod
from repro_torch.core.autoscale import Autoscaler, AutoscaleSpec
from repro_torch.core.breakpoints import Hooks, disagg_hooks
from repro_torch.core.costmodel.backends import (CostBackend, PipelineBackend,
                                                 RooflineBackend, TabularBackend)
from repro_torch.core.costmodel.hardware import (CLUSTERS, ClusterSpec, DGX_A100,
                                                 HARDWARE, HardwareSpec,
                                                 ParallelSpec)
from repro_torch.core.costmodel.operators import kv_bytes_per_token, \
    state_bytes_per_seq
from repro_torch.core.engine import Environment
from repro_torch.core.faults import (ChaosSpec, FaultEvent, FaultInjector,
                                     FaultProcess, FaultSpec, load_fault_trace)
from repro_torch.core.mem.block_manager import MemoryConfig
from repro_torch.core.mem.memory_pool import MemoryPool, PoolConfig
from repro_torch.core.mem.remote_store import RemoteKVSpec, RemoteKVStore
from repro_torch.core.mem.swap import PREEMPTION_MODES, SwapConfig, SwapManager
from repro_torch.core.metrics import Results, StreamingStats
from repro_torch.core.request import Request, State
from repro_torch.core.sched.global_sched import (GlobalScheduler, PrefixAffinity,
                                                 make_global_scheduler)
from repro_torch.core.sched.local import make_local_scheduler
from repro_torch.core.sched.prefix_registry import PrefixRegistry
from repro_torch.core.specdecode import SpecDecodeSpec
from repro_torch.core.tenancy import AdmissionController, TenantSpec
from repro_torch.core.worker import Worker
from repro_torch.core.workload import (WorkloadSpec, generate, generate_multi,
                                       make_source, make_tenant_source)
from repro_torch.obs import ObsRecorder, ObsSpec


@dataclass(frozen=True)
class WorkerSpec:
    hw: str = "A100"
    role: str = "both"                  # both | prefill | decode
    tp: int = 1
    gpu_mem_util: float = 0.9
    max_mem_ratio: float = 1.0          # admission cap (Fig. 10)
    mem_cap_override: Optional[float] = None  # bytes (Fig. 13/15 sweeps)
    hw_overrides: Dict[str, float] = field(default_factory=dict)
    slowdown: float = 1.0
    #: model this worker hosts (docs/HETEROGENEITY.md): a config name or
    #: ArchConfig; None inherits ``SimSpec.arch``.  The worker's memory
    #: sizing, cost backend and KV-transfer pricing all resolve against
    #: this arch, so one fleet can serve several models at once (pair
    #: with the ``model_routed`` global policy)
    arch: Optional[Union[str, ArchConfig]] = None


def effective_tp(ws: WorkerSpec, parallel: ParallelSpec) -> int:
    """Tensor degree a worker actually runs at: the per-worker
    ``WorkerSpec.tp`` override (Fig. 12-style heterogeneous setups)
    wins over the cluster-wide ``ParallelSpec.tp``.  Shared by the
    worker builder and the exploration harness's price model so the
    two can never disagree."""
    return ws.tp if ws.tp != 1 else parallel.tp


# FaultSpec grew into a family of fault processes and moved to
# repro.core.faults (docs/RELIABILITY.md); re-exported here so the
# original import path keeps working
__all_faults__ = (ChaosSpec, FaultEvent, FaultInjector, FaultProcess,
                  FaultSpec, load_fault_trace)


@dataclass
class SimSpec:
    arch: Union[str, ArchConfig] = "llama2-7b"
    workers: Sequence[WorkerSpec] = (WorkerSpec(),)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    global_policy: str = "least_loaded"
    #: extra kwargs for make_global_scheduler (e.g. {"aging_rate": 2.0})
    global_policy_kw: Dict[str, object] = field(default_factory=dict)
    local_policy: str = "continuous"
    max_batch: int = 256
    max_batched_tokens: int = 2048
    chunked_prefill: bool = False
    prefill_chunk: int = 512
    block_size: int = 16
    dtype_bytes: int = 2
    #: preemption mode (docs/MEMORY.md): "recompute" discards a victim's
    #: KV and re-prefills it on re-admission; "swap" parks it in host
    #: DRAM over the worker's PCIe link and restores it later
    preemption_mode: str = "recompute"
    #: shared-prefix copy-on-write caching in the BlockManager: requests
    #: with equal (prefix_id, prefix_len) share resident prefix blocks
    prefix_sharing: bool = False
    #: host DRAM bytes available for swapped KV; None = the worker
    #: hardware's ``HardwareSpec.host_mem_cap``
    host_mem_cap: Optional[float] = None
    #: third cache tier (docs/ROUTING.md): a cluster-wide capacity-
    #: bounded remote/object KV store under host DRAM.  Prefill
    #: hand-offs publish shared prefixes into it, the swap tier spills
    #: victims when host DRAM fills, and workers fetch at
    #: ``remote_setup + bytes / remote_bw`` (per-worker HardwareSpec
    #: fields, overridable on the spec).  None — the default — is
    #: byte-identical to the two-tier model
    remote_kv: Optional[RemoteKVSpec] = None
    #: parallelism strategy applied to every worker (docs/PARALLELISM.md):
    #: tensor degree (per-worker ``WorkerSpec.tp`` != 1 still wins),
    #: pipeline stages with micro-batched iterations, and data-parallel
    #: replicas of the whole worker set.  The default is the pre-existing
    #: single-device cost model, byte-identical.
    parallel: ParallelSpec = field(default_factory=ParallelSpec)
    #: interconnect topology for collective costing: a ClusterSpec, a
    #: name from ``CLUSTERS``, or None for the legacy flat TP term
    #: (volume / hw.link_bw, latency-free).  Pipeline parallelism needs
    #: a topology; pp > 1 with ``cluster=None`` assumes ``dgx-a100``.
    cluster: Optional[Union[str, ClusterSpec]] = None
    pool: Optional[PoolConfig] = None
    kv_link: comm_mod.LinkSpec = comm_mod.NVLINK
    faults: Sequence[FaultSpec] = ()
    #: chaos layer (docs/RELIABILITY.md): stochastic MTBF/MTTR fault
    #: processes plus the costly-recovery model (model reload, warm-up
    #: iterations, host-KV survival).  None keeps the legacy contract:
    #: scheduled ``faults`` with free, instant recovery
    chaos: Optional[ChaosSpec] = None
    backend: str = "roofline"
    backend_samples: Optional[list] = None   # for tabular
    backends_by_worker: Optional[Dict[int, CostBackend]] = None
    until: Optional[float] = None
    #: multi-tenant QoS: when set, each tenant's workload is merged into
    #: one stream and admission control gates the dispatcher
    #: (``workload`` above is then ignored)
    tenants: Sequence[TenantSpec] = ()
    #: speculative decoding (repro.core.specdecode): when set, decode
    #: iterations draft ``lookahead`` tokens with the draft model and
    #: verify them in one target forward (continuous batching only)
    spec_decode: Optional[SpecDecodeSpec] = None
    #: streaming mode (docs/PERFORMANCE.md): the dispatcher pulls
    #: arrivals lazily from a RequestSource instead of materializing the
    #: whole request list up front — required for million-request runs.
    #: With a finite ``until`` horizon, Results.requests covers only the
    #: requests actually dispatched before the cut (exact mode lists all
    #: num_requests), so count-normalized metrics can differ there
    streaming: bool = False
    #: False folds finished requests into a StreamingStats sketch and
    #: drops them (Results then reads summaries from ``Results.stats``);
    #: True (default) keeps the exact per-request list
    retain_requests: bool = True
    #: relative quantile error of the streaming sketches
    sketch_alpha: float = 0.003
    #: (ttft_slo, tpot_slo) evaluated at fold time so ``slo_goodput``
    #: works with retain_requests=False (per-tenant SLOs come from the
    #: tenant tiers automatically)
    streaming_slo: Optional[tuple] = None
    #: observability (docs/OBSERVABILITY.md): request-lifecycle tracing
    #: (Chrome trace-event export), bounded time-series sampling, and
    #: latency attribution.  None (default) is the zero-cost path: no
    #: recorder objects exist and every tap is a single is-None check
    obs: Optional[ObsSpec] = None
    #: closed-loop autoscaling (docs/AUTOSCALING.md): a daemon process
    #: samples queue depth / utilization / SLO attainment and scales the
    #: fleet between min_replicas and max_replicas at runtime, paying
    #: model-reload + warm-up lag on the way up and draining on the way
    #: down.  None (or a disabled spec) keeps the fleet static,
    #: byte-identical to the pre-autoscaling simulator
    autoscale: Optional[AutoscaleSpec] = None


class WorkerRegistry(list):
    """The fleet as a *dynamic* worker registry (docs/AUTOSCALING.md).

    A list subclass, so every pre-autoscaling consumer — global
    schedulers iterating the fleet, ``workers[wid]`` indexing, the
    fault injector, the obs sampler — keeps working unchanged, while
    the autoscaler can grow it at runtime through ``add``.  The
    registry is append-only: wids are dense list positions (asserted
    on add), and scale-down retires a worker *in place*
    (``Worker.retired``) instead of removing it, so wid indexing and
    per-worker stats stay stable for the whole run."""

    def add(self, worker) -> None:
        if worker.wid != len(self):
            raise ValueError(f"worker wid {worker.wid} breaks dense "
                             f"indexing (registry holds {len(self)})")
        self.append(worker)

    def n_serving(self) -> int:
        """Workers currently accepting dispatches."""
        return sum(1 for w in self if w.alive and not w.draining)


class Simulation:
    def __init__(self, spec: SimSpec):
        self.spec = spec
        self.cfg = spec.arch if isinstance(spec.arch, ArchConfig) \
            else get_config(spec.arch)
        #: concrete name stamped on requests arriving with model=None,
        #: so routing and per-model metrics never see the sentinel
        self.default_model: str = self.cfg.name
        #: model name -> ArchConfig for every arch hosted by the fleet
        #: (filled by _build_workers; the default arch is always present)
        self._model_cfgs: Dict[str, ArchConfig] = {self.cfg.name: self.cfg}
        self.env = Environment()
        self.link = comm_mod.Link(self.env, spec.kv_link)
        self.pool = MemoryPool(spec.pool) if spec.pool else None
        if spec.streaming:
            # lazy arrival stream: the dispatcher pulls one request at a
            # time; ``requests`` fills as requests are dispatched (and
            # stays empty of retired ones when retain_requests=False)
            self.source = iter(make_tenant_source(spec.tenants)
                               if spec.tenants
                               else make_source(spec.workload))
            self.requests: List[Request] = []
        else:
            self.source = None
            self.requests = generate_multi(spec.tenants) \
                if spec.tenants else generate(spec.workload)
        self.stats: Optional[StreamingStats] = None
        if not spec.retain_requests:
            tenant_slos = {t.tenant_id: (t.tier.ttft_slo, t.tier.tpot_slo)
                           for t in spec.tenants}
            self.stats = StreamingStats(
                spec.sketch_alpha, slo=spec.streaming_slo,
                tenant_slos=tenant_slos)
        self._n_live = 0
        self.max_live = 0
        #: observability hub; built before the workers so install() can
        #: register its breakpoint hooks on each one
        self.obs: Optional[ObsRecorder] = \
            ObsRecorder(spec.obs) \
            if spec.obs is not None and spec.obs.enabled else None
        self.global_sched: GlobalScheduler = make_global_scheduler(
            spec.global_policy, **spec.global_policy_kw)
        #: cache-aware routing (docs/ROUTING.md): attach a cluster-wide
        #: prefix registry to any PrefixAffinity router in the policy
        #: chain (wrappers expose ``.inner``, fallbacks ``.fallback``);
        #: both stay None for prefix-blind policies — zero extra state
        self.prefix_registry: Optional[PrefixRegistry] = None
        self._prefix_router: Optional[PrefixAffinity] = None
        node = self.global_sched
        while node is not None:
            if isinstance(node, PrefixAffinity):
                if node.registry is None:
                    node.registry = PrefixRegistry(
                        self.env, ttl=node.registry_ttl)
                self.prefix_registry = node.registry
                self._prefix_router = node
                break
            node = getattr(node, "inner", None) \
                or getattr(node, "fallback", None)
        #: remote/object KV tier shared by the whole cluster
        #: (docs/ROUTING.md); built before the workers so their swap
        #: managers can spill into it
        self.remote_store: Optional[RemoteKVStore] = \
            RemoteKVStore(spec.remote_kv.capacity_bytes) \
            if spec.remote_kv is not None else None
        #: cluster-level fetch counters (Results.routing_summary)
        self.fetch_stats: Dict[str, float] = {
            "fetches": 0, "peer_fetches": 0, "remote_fetches": 0,
            "fetch_bytes": 0.0, "fetch_time_s": 0.0,
            "fetch_misses": 0, "fetch_recomputes": 0}
        self.admission: Optional[AdmissionController] = \
            AdmissionController(self.env, spec.tenants, self) \
            if spec.tenants else None
        self.workers: WorkerRegistry = WorkerRegistry()
        self._build_workers()
        self._validate_models()
        #: requests held at the dispatcher during a cluster-wide outage
        #: (every worker dead), re-placed on the first recovery; each
        #: entry is (request, source SwapManager or None)
        self._parked: List[tuple] = []
        self.fault_injector: Optional[FaultInjector] = \
            FaultInjector(self, spec.chaos, spec.faults) \
            if spec.faults or (spec.chaos is not None
                               and spec.chaos.processes) else None
        self._n_finished = 0
        #: closed-loop autoscaler (docs/AUTOSCALING.md); None (or a
        #: disabled spec) keeps the fleet static — no daemon process,
        #: no extra events, byte-identical to the pre-autoscale path
        self.autoscaler: Optional[Autoscaler] = \
            Autoscaler(self, spec.autoscale) \
            if spec.autoscale is not None and spec.autoscale.enabled \
            else None
        #: model -> (kv_bytes_per_token, state_bytes_per_seq) so the
        #: migration path prices the KV transfer against the request's
        #: own arch, not the fleet default
        self._kv_by_model = {
            name: (kv_bytes_per_token(cfg, spec.dtype_bytes),
                   state_bytes_per_seq(cfg, spec.dtype_bytes))
            for name, cfg in self._model_cfgs.items()}

    # ------------------------------------------------------------------
    def _build_workers(self) -> None:
        spec = self.spec
        if spec.preemption_mode not in PREEMPTION_MODES:
            raise ValueError(f"unknown preemption_mode "
                             f"{spec.preemption_mode!r}; have "
                             f"{PREEMPTION_MODES}")
        disagg = any(w.role != "both" for w in spec.workers)
        draft_cfg = None
        if spec.spec_decode is not None:
            da = spec.spec_decode.draft_arch
            draft_cfg = da if isinstance(da, ArchConfig) else get_config(da)
        par = spec.parallel
        cluster = spec.cluster
        if isinstance(cluster, str):
            try:
                cluster = CLUSTERS[cluster]
            except KeyError:
                raise ValueError(f"unknown cluster {cluster!r}; "
                                 f"have {sorted(CLUSTERS)}")
        if cluster is None and par.pp > 1:
            cluster = DGX_A100         # pp needs a topology for p2p links
        if par.pp > 1 and spec.backend != "roofline":
            # only the roofline backend knows how to split into stages;
            # a tabular/xla model would silently cost a 4-device
            # pipeline as one device while the KV pool scales by pp
            raise ValueError(
                f"ParallelSpec(pp={par.pp}) requires backend='roofline' "
                f"(got {spec.backend!r}); supply a pipeline-aware "
                f"backend via backends_by_worker instead")
        # per-sim invariants reused by runtime worker additions
        # (add_worker): a scaled-up clone must be built exactly like an
        # initial worker
        self._disagg = disagg
        self._draft_cfg = draft_cfg
        self._cluster = cluster
        #: data parallelism: replicate the whole worker set, each copy a
        #: full tp x pp serving instance behind the global scheduler
        worker_specs = list(spec.workers) * par.replicas
        for i, ws in enumerate(worker_specs):
            #: replicas clone the original worker set, so per-worker
            #: config keyed by index (backends_by_worker) follows the
            #: original position, not the expanded one
            self._make_worker(ws, i, i % len(spec.workers))

    def _make_worker(self, ws: WorkerSpec, wid: int,
                     base_i: int) -> Worker:
        """Build one worker from its spec and register it — shared by
        the initial fleet construction and runtime scale-up
        (``add_worker``), so the two can never diverge."""
        spec = self.spec
        par = spec.parallel
        cluster = self._cluster
        tp = effective_tp(ws, par)
        # per-worker arch (docs/HETEROGENEITY.md): None inherits the
        # fleet default; everything below — memory sizing, cost
        # backend, encoder tokens — resolves against this config
        if ws.arch is None:
            wcfg = self.cfg
        elif isinstance(ws.arch, ArchConfig):
            wcfg = ws.arch
        else:
            wcfg = get_config(ws.arch)
        self._model_cfgs.setdefault(wcfg.name, wcfg)
        hw = HARDWARE[ws.hw]
        if ws.hw_overrides:
            hw = hw.with_(**ws.hw_overrides)
        price = hw.price * tp * par.pp   # mirrors explore.worker_price
        if ws.mem_cap_override is not None:
            hw = hw.with_(mem_cap=ws.mem_cap_override)
        # a pp-stage worker owns pp devices: its aggregate KV budget
        # is pp device capacities minus one full (tp-sharded) copy of
        # the weights, which the stages hold 1/pp each
        mem_cfg = MemoryConfig.from_model(
            wcfg, hw.mem_cap * par.pp, block_size=spec.block_size,
            dtype_bytes=spec.dtype_bytes, tp=tp,
            gpu_mem_util=ws.gpu_mem_util,
            watermark=max(0.0, 1.0 - ws.max_mem_ratio),
            prefix_sharing=spec.prefix_sharing)
        swap = None
        if spec.preemption_mode == "swap":
            rbw, rsetup = self._remote_cost(hw)
            swap = SwapManager(SwapConfig(
                pcie_bw=hw.pcie_bw,
                host_capacity_bytes=spec.host_mem_cap
                if spec.host_mem_cap is not None else hw.host_mem_cap,
                kv_bytes_per_token=mem_cfg.kv_bytes_per_token,
                state_bytes_per_seq=mem_cfg.state_bytes_per_seq,
                block_size=mem_cfg.block_size,
                remote_bw=rbw, remote_setup_latency=rsetup),
                remote=self.remote_store)
        if spec.backends_by_worker and base_i in spec.backends_by_worker:
            backend = spec.backends_by_worker[base_i]
        elif spec.backend == "tabular":
            backend = TabularBackend.fit(spec.backend_samples)
        elif par.pp > 1:
            backend = PipelineBackend.for_model(
                wcfg, hw,
                ParallelSpec(tp=tp, pp=par.pp,
                             microbatches=par.microbatches),
                cluster, dtype_bytes=spec.dtype_bytes)
        else:
            backend = RooflineBackend.for_model(
                wcfg, hw, tp=tp, dtype_bytes=spec.dtype_bytes,
                cluster=cluster)
        sched = make_local_scheduler(
            spec.local_policy, max_batch=spec.max_batch,
            max_batched_tokens=spec.max_batched_tokens,
            chunked_prefill=spec.chunked_prefill,
            prefill_chunk=spec.prefill_chunk)
        hooks = disagg_hooks() if self._disagg else Hooks()
        enc_tokens = wcfg.enc_seq_len \
            if wcfg.family in ("audio", "encdec") else 0
        draft_backend = None
        if self._draft_cfg is not None:
            # draft model runs on the same chip as its worker (with
            # optional overrides, e.g. a dedicated draft unit)
            dhw = hw.with_(**spec.spec_decode.draft_hw_overrides) \
                if spec.spec_decode.draft_hw_overrides else hw
            draft_backend = RooflineBackend.for_model(
                self._draft_cfg, dhw, tp=tp,
                dtype_bytes=spec.dtype_bytes, cluster=cluster)
        w = Worker(self.env, wid, hw, backend, mem_cfg, sched,
                   run_prefill=ws.role in ("both", "prefill"),
                   run_decode=ws.role in ("both", "decode"),
                   cluster=self, pool=self.pool, hooks=hooks,
                   enc_tokens_per_req=enc_tokens,
                   discipline=self.global_sched.discipline(),
                   spec_decode=spec.spec_decode,
                   draft_backend=draft_backend, swap=swap,
                   obs=self.obs, model=wcfg.name, tp=tp)
        w.slowdown = ws.slowdown
        w.spec_ws = ws
        w.price = price
        if self.obs is not None:
            self.obs.install(w)
        self.workers.add(w)
        return w

    def add_worker(self, ws: WorkerSpec, *, base_i: int = 0,
                   provisioning: bool = False) -> Worker:
        """Grow the fleet at runtime (autoscaler scale-up): build a
        worker from ``ws`` exactly as the initial fleet was built, at
        the next dense wid.  With ``provisioning=True`` it starts
        outside every dispatch path (``alive=False``, so even the
        eligibility fallback skips it) until the model load finishes
        and ``Worker.recover`` brings it up."""
        w = self._make_worker(ws, len(self.workers), base_i)
        if provisioning:
            w.alive = False
            w.provisioning = True
        if w.model not in self._kv_by_model:
            # a runtime-added model must be migration-priceable too
            cfg = self._model_cfgs[w.model]
            self._kv_by_model[w.model] = (
                kv_bytes_per_token(cfg, self.spec.dtype_bytes),
                state_bytes_per_seq(cfg, self.spec.dtype_bytes))
        return w

    def _validate_models(self) -> None:
        """Fail fast on fleet/workload model mismatches: every model the
        workload declares must be hosted by at least one worker, and a
        multi-model fleet needs a model-aware global policy (one that
        overrides ``eligible_for``) — a model-blind policy would happily
        dispatch a request onto a worker serving a different model."""
        spec = self.spec
        hosted = {w.model for w in self.workers}
        if spec.tenants:
            wanted = {t.workload.model or self.default_model
                      for t in spec.tenants}
        else:
            wanted = {spec.workload.model or self.default_model}
        missing = sorted(wanted - hosted)
        if missing:
            raise ValueError(
                f"workload targets model(s) {missing} but the fleet "
                f"hosts only {sorted(hosted)}; add a WorkerSpec with "
                f"arch=<model> (docs/HETEROGENEITY.md)")
        if len(hosted) > 1 and type(self.global_sched).eligible_for \
                is GlobalScheduler.eligible_for:
            raise ValueError(
                f"fleet hosts multiple models {sorted(hosted)} but "
                f"global_policy={spec.global_policy!r} is model-blind; "
                f"use 'model_routed' (wrapping it via "
                f"global_policy_kw={{'inner': {spec.global_policy!r}}}) "
                f"or 'hetero' (docs/HETEROGENEITY.md)")

    # ------------------------------------------------------------------
    # cluster callbacks (used by workers/hooks)
    def _remote_cost(self, hw: HardwareSpec) -> tuple:
        """(bw, setup) the remote tier charges this hardware
        (docs/ROUTING.md): spec-level overrides win over the per-worker
        HardwareSpec fields."""
        rk = self.spec.remote_kv
        if rk is None:
            return hw.remote_bw, hw.remote_setup
        return (rk.bw if rk.bw is not None else hw.remote_bw,
                rk.setup_latency if rk.setup_latency is not None
                else hw.remote_setup)

    def fetch_prefix(self, worker: Worker, req: Request) -> float:
        """Price pulling ``req``'s shared prefix from the peer named by
        its fetch hint — a ``p2p_time`` transfer over ``SimSpec.
        kv_link`` — or from the remote tier when the peer is gone
        (docs/ROUTING.md).  Applies a fetch-vs-recompute break-even
        mirroring the swap crossover: when re-prefilling the missing
        tokens is cheaper than the wire, the fetch is declined and the
        request prefills as routed.  Returns the latency to bill into
        ``IterationPlan.fetch_latency`` (0.0 when nothing fetched)."""
        want = req.fetch_tokens
        have = max(req.cached_len, req.prefill_done_len)
        if want <= have:
            return 0.0                      # local cache already covers it
        st = self.fetch_stats
        kvt, sbs = self._kv_by_model[req.model or self.default_model]
        cost = via = None
        tokens = want
        src_wid = req.fetch_src
        if src_wid is not None and 0 <= src_wid < len(self.workers):
            src = self.workers[src_wid]
            if src.alive and not src.retired and src is not worker:
                nbytes = (kvt * tokens) if kvt else sbs
                cost = comm_mod.p2p_time(nbytes, self.spec.kv_link)
                via = "peer"
        if cost is None and self.remote_store is not None \
                and req.prefix_id is not None:
            hit = self.remote_store.get(("prefix", req.prefix_id))
            if hit is not None and min(want, hit[0]) > have:
                tokens = min(want, hit[0])
                nbytes = (kvt * tokens) if kvt else sbs
                rbw, rsetup = self._remote_cost(worker.hw)
                cost = rsetup + nbytes / max(rbw, 1.0)
                via = "remote"
        if cost is None:
            st["fetch_misses"] += 1         # peer dead, remote cold
            return 0.0
        if cost >= worker.estimate_prefill_time(tokens - have):
            st["fetch_recomputes"] += 1     # recompute wins the break-even
            return 0.0
        req.cached_len = max(req.cached_len, tokens)
        req.fetch_count += 1
        req.fetched_tokens += tokens - have
        st["fetches"] += 1
        st["peer_fetches" if via == "peer" else "remote_fetches"] += 1
        st["fetch_bytes"] += nbytes
        st["fetch_time_s"] += cost
        if via == "peer":
            if self.prefix_registry is not None \
                    and req.prefix_id is not None:
                self.prefix_registry.touch(req.prefix_id, src_wid)
            if self.remote_store is not None and req.prefix_id is not None \
                    and self.spec.remote_kv.publish_prefixes:
                # write-through: a prefix worth moving between peers is
                # worth making cluster-visible
                self.remote_store.put(("prefix", req.prefix_id),
                                      tokens, nbytes)
        if self.obs is not None:
            self.obs.on_fetch(worker.wid, req, via, tokens, nbytes,
                              self.env.now)
        return cost

    def migrate(self, req: Request, from_worker: Worker) -> None:
        """Move a prefilled request to a decode worker (KV over the link)."""
        target_id = self.global_sched.reassign(req, self.workers)
        if self.remote_store is not None and req.prefix_id is not None \
                and req.prefix_len > 0 \
                and self.spec.remote_kv.publish_prefixes:
            # disagg publish (docs/ROUTING.md): the prefill worker has
            # the shared prefix computed at hand-off time; pushing it to
            # the object store is an async write-back off the serving
            # path, so no latency is billed here
            pkvt, psbs = self._kv_by_model[req.model or self.default_model]
            ptok = min(req.prefix_len, req.context_len)
            self.remote_store.put(("prefix", req.prefix_id), ptok,
                                  (pkvt * ptok) if pkvt else psbs)
        if target_id == from_worker.wid:
            return                          # stays: nothing to move
        req.state = State.MIGRATING
        kvt, sbs = self._kv_by_model[req.model or self.default_model]
        nbytes = kvt * max(1, req.context_len) if kvt else sbs
        done = self.link.transfer(nbytes)
        target = self.workers[target_id]
        obs = self.obs
        if obs is not None:
            self.global_sched.observe_assign(req, target_id)
        t_start = self.env.now

        def on_done(_ev, req=req, fw=from_worker, tw=target):
            if req.state is not State.MIGRATING:
                # the source worker died mid-transfer: fail() already
                # reset the request and re-dispatched it, so the partial
                # KV never arrived — delivering it now would duplicate
                # the request on two workers
                return
            fw.release(req)
            if obs is not None:
                obs.on_migrate_done(req, self.env.now,
                                    self.env.now - t_start)
            if not tw.alive:
                # target died while the KV was on the wire: the copy is
                # lost with the device, so re-prefill from scratch
                req.swapped_tokens = 0
                req.prefill_done_len = 0
                req.cached_len = 0
                req.state = State.QUEUED
                self.redispatch([req])
                return
            tw.receive_migrated(req)

        done.wait(on_done)

    def on_request_finished(self, req: Request) -> None:
        self._n_finished += 1
        self._n_live -= 1
        if self.autoscaler is not None:
            self.autoscaler.on_finish(req)
        if self.obs is not None:
            # derive the conserved component breakdown while the
            # timestamps are final, before any streaming fold drops it
            self.obs.finalize(req)
        if self.admission is not None:
            self.admission.on_finish(req)
        if self.stats is not None:
            # fold-and-forget: the request's numbers enter the sketches
            # and nothing else holds a reference (workers have already
            # released it), so it is garbage the moment we return
            self.stats.fold(req)

    def on_request_rejected(self, req: Request) -> None:
        """Admission control dropped the request (429): account for it
        so streaming mode can forget it."""
        self._n_live -= 1
        if self.obs is not None:
            self.obs.on_reject(req, self.env.now)
        if self.stats is not None:
            self.stats.fold(req)

    def redispatch(self, orphans: List[Request],
                   from_worker: Optional[Worker] = None) -> None:
        obs = self.obs
        src_swap = from_worker.swap if from_worker is not None else None
        for req in sorted(orphans, key=lambda r: r.id):
            if obs is not None:
                obs.on_requeue(req, self.env.now)
            self._place(req, src_swap)

    def _place(self, req: Request, src_swap=None) -> None:
        """Assign one request to a worker.  During a cluster-wide outage
        (no worker alive) the request parks at the dispatcher and is
        re-placed by the first recovery.  ``src_swap`` is a failed
        worker's host-DRAM tier: a surviving KV entry there follows the
        request into the new worker's tier (no PCIe transfer — the
        bytes never left host memory), falling back to re-prefill when
        the new tier has no room."""
        # park against the policy's eligible subset: a model whose hosts
        # are all down waits at the dispatcher even while workers of
        # other models keep serving (model-blind policies see the full
        # fleet here, exactly as before)
        hosts = self.global_sched.eligible_for(req, self.workers)
        if not any(w.alive for w in hosts):
            self._parked.append((req, src_swap))
            return
        wid = self.global_sched.assign(req, self.workers)
        if self.obs is not None:
            self.global_sched.observe_assign(req, wid)
        target = self.workers[wid]
        if self.remote_store is not None and req.fetch_src is None \
                and req.prefix_id is not None and req.prefix_len > 0 \
                and self.remote_store.has(("prefix", req.prefix_id)):
            # the cluster store holds this prefix (published by a disagg
            # prefill hand-off or a peer-fetch write-through): hint the
            # target to fetch instead of re-prefilling.  fetch_src=-1
            # means "no peer, remote tier only"; the local-cache check
            # and the break-even in fetch_prefix still apply
            req.fetch_src = -1
            req.fetch_tokens = req.prefix_len
        if src_swap is not None and src_swap.holds(req):
            tokens = src_swap.drop(req)
            tswap = target.swap
            if tswap is None or not tswap.adopt(req, tokens):
                # host copy has nowhere to live on the new worker:
                # fall back to re-prefilling from scratch
                req.swapped_tokens = 0
                req.prefill_done_len = 0
                req.cached_len = 0
        target.submit(req)

    def on_worker_recovered(self, worker: Worker) -> None:
        """Fault injector finished reviving ``worker``: re-place any
        requests parked during a cluster-wide outage."""
        if self._parked:
            parked, self._parked = self._parked, []
            for req, src_swap in parked:
                self._place(req, src_swap)

    # ------------------------------------------------------------------
    def _dispatcher(self):
        env = self.env
        streaming = self.source is not None
        retain = self.spec.retain_requests
        obs = self.obs
        it = self.source if streaming else self.requests
        default_model = self.default_model
        for req in it:
            if req.model is None:
                # stamp the concrete default so routing, per-model
                # metrics and the migration path never see the sentinel
                req.model = default_model
            if streaming and retain:
                self.requests.append(req)
            delay = req.arrival_time - env.now
            if delay > 0:
                yield env.timeout(delay)
            self._n_live += 1
            if self._n_live > self.max_live:
                self.max_live = self._n_live
            if obs is not None:
                obs.on_arrival(req, gated=self.admission is not None)
            if self.admission is not None:
                self.admission.submit(req)
            else:
                self._place(req)

    # ------------------------------------------------------------------
    def _sampler(self):
        """Periodic time-series tick.  A daemon process: its timeouts
        never keep the simulation alive, so sampling neither extends
        ``sim_time`` nor prevents ``env.run()`` from terminating."""
        env = self.env
        while True:
            yield env.timeout(self.obs.ts.interval, daemon=True)
            self._sample_obs(env.now)

    def _sample_obs(self, now: float) -> None:
        obs = self.obs
        extra = {"n_live": self._n_live, "n_finished": self._n_finished,
                 "n_rejected": sum(self.admission.rejected.values())
                 if self.admission is not None else 0,
                 "assigns": self.global_sched.assign_counts()}
        cluster = obs.ts.sample(now, self.workers, extra)
        if obs.trace is not None:
            obs.trace.counter("cluster", now, {
                "queue_depth": cluster["queue_depth"],
                "n_running": cluster["n_running"],
                "kv_used_blocks": cluster["kv_used_blocks"]})

    # ------------------------------------------------------------------
    def run(self) -> Results:
        t0 = _time.perf_counter()
        self.env.process(self._dispatcher(), name="dispatcher")
        if self.fault_injector is not None:
            self.fault_injector.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.obs is not None and self.obs.ts is not None:
            self.env.process(self._sampler(), name="obs-sampler",
                             daemon=True)
        self.env.run(until=self.spec.until)
        wall = _time.perf_counter() - t0
        if self.autoscaler is not None:
            # a drained victim idle at the horizon retires now, so its
            # billing span closes at the time it stopped working
            self.autoscaler._finalize_retirements(self.env.now)
        if self.obs is not None:
            if self.obs.ts is not None:
                # closing frame at the horizon (also covers sims shorter
                # than one sampling interval)
                self._sample_obs(self.env.now)
            if self.obs.trace is not None:
                self.obs.trace.flush_open(self.env.now)
        requests = self.requests
        if self.stats is not None:
            # retired requests live only in the sketches; report the
            # (bounded) leftovers still in flight at the horizon
            leftovers = {id(r): r for w in self.workers
                         for r in list(w.waiting) + list(w.running)}
            if self.admission is not None:
                for q in self.admission.queues.values():
                    leftovers.update((id(r), r) for r in q)
            requests = sorted(leftovers.values(), key=lambda r: r.id)
        return Results(
            requests=requests,
            sim_time=self.env.now,
            worker_mem={w.wid: w.mem_timeline for w in self.workers},
            pool_stats=self.pool.stats() if self.pool else None,
            mem_stats={w.wid: w.mem.stats() for w in self.workers},
            swap_stats={w.wid: w.swap.stats() for w in self.workers
                        if w.swap is not None} or None,
            wall_time=wall,
            events=sum(w.iterations for w in self.workers),
            tenant_specs={t.tenant_id: t for t in self.spec.tenants}
            if self.spec.tenants else None,
            admission_stats=self.admission.stats()
            if self.admission else None,
            parallel_stats={
                w.wid: {"pp_bubble_time": w.pp_bubble_time,
                        "pp_comm_time": w.pp_comm_time,
                        "pp_span_time": w.pp_span_time,
                        "busy_time": w.busy_time,
                        "iterations": w.iterations}
                for w in self.workers}
            if self.spec.parallel.pp > 1
            or any(w.pp_span_time for w in self.workers) else None,
            stats=self.stats,
            max_live=self.max_live,
            worker_models={w.wid: w.model for w in self.workers},
            default_model=self.default_model,
            fault_events=self.fault_injector.events
            if self.fault_injector is not None else None,
            n_workers=len(self.workers),
            scale_events=self.autoscaler.events
            if self.autoscaler is not None else None,
            worker_spans={w.wid: (w.t_provisioned, w.t_retired)
                          for w in self.workers},
            worker_prices={w.wid: w.price for w in self.workers},
            phase_stats={
                w.wid: {"prefill_time": w.prefill_time,
                        "decode_time": w.decode_time,
                        "prefill_tokens": w.prefill_tokens,
                        "decode_tokens": w.decode_tokens,
                        "busy_time": w.busy_time}
                for w in self.workers},
            routing_stats=self._routing_stats(),
            remote_stats=self.remote_store.stats()
            if self.remote_store is not None else None,
            trace=self.obs.trace if self.obs is not None else None,
            timeseries=self.obs.ts if self.obs is not None else None)

    def _routing_stats(self) -> Optional[dict]:
        """Cluster-level cache-aware-routing counters (docs/ROUTING.md),
        None unless a prefix router or remote tier is active."""
        if self._prefix_router is None and self.remote_store is None:
            return None
        out = dict(self.fetch_stats)
        if self._prefix_router is not None:
            out.update(self._prefix_router.stats())
            out.update(self.prefix_registry.stats())
        return out


def simulate(spec: SimSpec) -> Results:
    return Simulation(spec).run()
