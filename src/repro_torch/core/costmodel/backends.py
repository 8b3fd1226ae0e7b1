"""Compute-cost backends: pluggable "compute simulators" (paper §III).

* ``RooflineBackend``       — GenZ-style operator-granular roofline over
                              the ``OperatorGraph``; the default.
* ``TabularBackend``        — calibrated from measured iterations of the
                              *real* JAX engine (repro.serving): piecewise
                              linear in the mix aggregates.  This is how
                              the validation studies hold the simulator to
                              the <1% bar without A100s.
* ``XLACalibratedBackend``  — roofline with per-op FLOPs/bytes replaced by
                              ``compiled.cost_analysis()`` totals from the
                              multi-pod dry-run (beyond paper: ties the
                              simulator to the compiled HLO).
* ``PipelineBackend``       — wraps per-stage rooflines into an
                              iteration-synchronous pipeline: micro-batch
                              fill/drain bubbles and stage-boundary p2p
                              activation hand-off (docs/PARALLELISM.md).

The port's copy of ``repro.core.costmodel.backends``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.comm import (LinkSpec, p2p_time, ring_allreduce_time,
                                   stage_boundary_link, tp_group_link)
from repro_torch.core.costmodel.hardware import (ClusterSpec, HardwareSpec,
                                                 ParallelSpec)
from repro_torch.core.costmodel.operators import BatchMix, OperatorGraph


class CostBackend:
    """iteration_time(mix) -> seconds on one worker."""

    def iteration_time(self, mix: BatchMix) -> float:
        raise NotImplementedError


@dataclass
class RooflineBackend(CostBackend):
    hw: HardwareSpec
    graph: OperatorGraph
    #: interconnect topology (docs/PARALLELISM.md).  ``None`` keeps the
    #: legacy flat TP term (collective volume / hw.link_bw, latency-free)
    #: byte-identical to the pre-topology cost model; a ``ClusterSpec``
    #: prices each per-layer all-reduce as a ring over the link the TP
    #: group actually occupies, so TP stops being free at high degree
    #: and across node boundaries.
    cluster: Optional[ClusterSpec] = None
    #: pipeline-stage index of this backend under the consecutive
    #: placement model (stage s owns devices [s*tp, (s+1)*tp)) — decides
    #: whether this stage's TP ring straddles a node boundary
    stage: int = 0

    @staticmethod
    def for_model(cfg: ArchConfig, hw: HardwareSpec, tp: int = 1,
                  dtype_bytes: int = 2,
                  cluster: Optional[ClusterSpec] = None
                  ) -> "RooflineBackend":
        return RooflineBackend(
            hw=hw, graph=OperatorGraph.from_config(cfg, tp, dtype_bytes),
            cluster=cluster)

    def iteration_time(self, mix: BatchMix) -> float:
        if mix.new_tokens == 0 and mix.enc_tokens == 0:
            return 0.0
        hw = self.hw
        t = hw.iter_overhead
        fpeak = hw.flops * hw.flops_eff
        bpeak = hw.mem_bw * hw.bw_eff
        for op in self.graph.ops:
            f = op.flops(mix)
            b = op.bytes(mix)
            if f or b:
                t += max(f / fpeak, b / bpeak)
        t += self.collective_time(mix)
        return t

    def collective_time(self, mix: BatchMix) -> float:
        """TP all-reduce cost for one iteration's token batch."""
        g = self.graph
        if not g.collective_bytes_per_token:
            return 0.0
        # legacy flat term: no topology given, or a hand-built graph
        # that only carries the flat volume (allreduce metadata unset) —
        # the latter must not become free just because a cluster is set
        if self.cluster is None or not g.allreduce_count:
            return g.collective_bytes_per_token * mix.new_tokens \
                / self.hw.link_bw
        link = tp_group_link(self.cluster, g.tp, self.stage)
        nbytes = g.allreduce_bytes_per_token * mix.new_tokens
        return g.allreduce_count * ring_allreduce_time(nbytes, g.tp, link)


@dataclass
class TabularBackend(CostBackend):
    """Least-squares affine fit  t ≈ c0 + c1·padded_tokens + c2·attn_units
    + c3·kv_read_tokens + c4·n_seqs  over calibration samples.

    ``padded_tokens`` (bucketed prefill chunks) rather than raw tokens:
    the real engine pads prompts to power-of-two shape buckets, so that
    is the feature its wall-clock actually follows."""

    coef: Tuple[float, float, float, float, float]
    samples: List[Tuple[BatchMix, float]] = field(default_factory=list)

    @staticmethod
    def _features(m: BatchMix):
        padded = m.padded_tokens or m.new_tokens
        return [1.0, padded, m.attn_units, m.kv_read_tokens, m.n_seqs]

    @staticmethod
    def fit(samples: List[Tuple[BatchMix, float]]) -> "TabularBackend":
        import numpy as np
        X = np.array([TabularBackend._features(m) for m, _ in samples])
        y = np.array([t for _, t in samples])
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        return TabularBackend(coef=tuple(float(c) for c in coef),
                              samples=list(samples))

    def iteration_time(self, mix: BatchMix) -> float:
        if mix.new_tokens == 0 and mix.enc_tokens == 0:
            return 0.0
        f = self._features(mix)
        t = sum(c * x for c, x in zip(self.coef, f))
        return max(t, 1e-6)


def cost_analysis_dict(cost) -> dict:
    """Normalize ``Compiled.cost_analysis()`` across JAX versions: older
    releases return a one-element list of dicts (one per program), newer
    ones the dict itself.  Every producer/consumer of cost records
    (launch.dryrun, benchmarks.roofline_report, the calibration tests)
    goes through this so the artifact schema stays a flat dict."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return dict(cost)


@dataclass
class XLACalibratedBackend(CostBackend):
    """Roofline on dry-run HLO totals.

    ``flops_per_token`` / ``bytes_per_token`` come from
    ``compiled.cost_analysis()`` of the real lowered step divided by the
    step's token count; attention terms are added from the graph (HLO
    numbers are shape-specific, attention scales quadratically)."""

    hw: HardwareSpec
    flops_per_token: float
    bytes_fixed: float
    bytes_per_token: float
    graph: Optional[OperatorGraph] = None

    def iteration_time(self, mix: BatchMix) -> float:
        if mix.new_tokens == 0 and mix.enc_tokens == 0:
            return 0.0
        hw = self.hw
        f = self.flops_per_token * mix.new_tokens
        b = self.bytes_fixed + self.bytes_per_token * mix.new_tokens
        if self.graph is not None:
            for op in self.graph.ops:
                if op.f_attn or op.b_kv:
                    f += op.f_attn * mix.attn_units * op.count
                    b += op.b_kv * mix.kv_read_tokens * op.count
        return hw.iter_overhead + max(f / (hw.flops * hw.flops_eff),
                                      b / (hw.mem_bw * hw.bw_eff))


@dataclass
class PipelineBackend(CostBackend):
    """Iteration-synchronous pipeline parallelism over per-stage
    backends (docs/PARALLELISM.md).

    One iteration's batch splits into ``microbatches`` equal micro-
    batches that flow through the ``pp`` stages; the step period is the
    slowest stage's micro-batch time plus the slowest stage-boundary
    activation hand-off, so

        span   = (m + pp - 1) * step         (fill + steady + drain)
        bubble = (pp - 1) * step             -> bubble/span = the
                                                closed-form fraction
                                                (pp-1)/(m+pp-1)

    Framework/launch overhead (``overhead``) is charged once per
    iteration — stages run as persistent workers, not per-step
    relaunches — and excluded from the bubble-fraction denominator.
    The wrapped stage backends keep their own TP collective terms, so
    TP x PP composes.  ``last_breakdown`` holds the most recent
    iteration's ``(bubble, comm, span)`` for the worker to account into
    its ``IterationPlan``.
    """

    stages: List[CostBackend]
    boundary_links: List[LinkSpec]       # len == pp - 1
    act_bytes_per_token: float           # hidden state across a boundary
    microbatches: int = 2
    overhead: float = 0.0                # once-per-iteration framework cost
    last_breakdown: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @staticmethod
    def for_model(cfg: ArchConfig, hw: HardwareSpec,
                  parallel: ParallelSpec, cluster: ClusterSpec,
                  dtype_bytes: int = 2) -> "PipelineBackend":
        graph = OperatorGraph.from_config(cfg, parallel.tp, dtype_bytes)
        stage_hw = hw.with_(iter_overhead=0.0)
        stages = [RooflineBackend(hw=stage_hw, graph=g, cluster=cluster,
                                  stage=s)
                  for s, g in enumerate(graph.split_stages(parallel.pp))]
        links = [stage_boundary_link(cluster, parallel.tp, s)
                 for s in range(parallel.pp - 1)]
        return PipelineBackend(
            stages=stages, boundary_links=links,
            act_bytes_per_token=graph.act_bytes_per_token,
            microbatches=parallel.microbatches,
            overhead=hw.iter_overhead)

    @property
    def pp(self) -> int:
        return len(self.stages)

    def iteration_time(self, mix: BatchMix) -> float:
        self.last_breakdown = (0.0, 0.0, 0.0)
        if mix.new_tokens == 0 and mix.enc_tokens == 0:
            return 0.0
        pp = self.pp
        # a micro-batch needs at least one token; tail iterations with
        # fewer tokens than configured micro-batches shrink m
        m = max(1, min(self.microbatches, int(mix.new_tokens)))
        s = 1.0 / m
        micro = BatchMix(new_tokens=mix.new_tokens * s,
                         attn_units=mix.attn_units * s,
                         kv_read_tokens=mix.kv_read_tokens * s,
                         n_seqs=mix.n_seqs * s,
                         enc_tokens=mix.enc_tokens * s,
                         padded_tokens=mix.padded_tokens * s)
        t_stage = max(b.iteration_time(micro) for b in self.stages)
        act = self.act_bytes_per_token * micro.new_tokens
        t_comm = max((p2p_time(act, link) for link in self.boundary_links),
                     default=0.0)
        step = t_stage + t_comm
        span = (m + pp - 1) * step
        self.last_breakdown = ((pp - 1) * step, (m + pp - 1) * t_comm, span)
        return self.overhead + span


def make_backend(kind: str, cfg: ArchConfig, hw: HardwareSpec,
                 tp: int = 1, *, cluster: Optional[ClusterSpec] = None,
                 parallel: Optional[ParallelSpec] = None,
                 **kw) -> CostBackend:
    if kind == "roofline":
        if parallel is not None and parallel.pp > 1:
            from dataclasses import replace as _replace

            from repro_torch.core.costmodel.hardware import DGX_A100
            # explicit tp argument wins over parallel.tp (same
            # precedence as the pp == 1 branch / simulator wiring)
            eff = parallel if tp == 1 else _replace(parallel, tp=tp)
            return PipelineBackend.for_model(
                cfg, hw, eff, cluster or DGX_A100, **kw)
        eff_tp = parallel.tp if parallel is not None and tp == 1 else tp
        return RooflineBackend.for_model(cfg, hw, tp=eff_tp,
                                         cluster=cluster, **kw)
    if kind == "tabular":
        return TabularBackend.fit(kw["samples"])
    if kind == "xla":
        return XLACalibratedBackend(hw=hw, **kw)
    raise ValueError(f"unknown backend {kind!r}")
