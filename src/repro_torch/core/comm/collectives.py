"""Topology-aware collective cost model (docs/PARALLELISM.md).

Analytic alpha-beta costs for the collectives the parallelism layer
charges: ring all-reduce for tensor-parallel activation reduction and
point-to-point send/recv for pipeline-stage activation hand-off.  Each
primitive is costed against one :class:`~repro.core.comm.LinkSpec`
(latency + bytes/bandwidth per hop); *which* link applies is a topology
question answered by ``ClusterSpec`` placement helpers below, so tensor
parallelism stops being free at high degree: a TP group that spills past
``gpus_per_node`` pays inter-node latency and bandwidth on every hop.

Placement model (documented assumption): devices of one replica are
numbered consecutively, pipeline stage ``s`` of a ``tp x pp`` replica
owns devices ``[s*tp, (s+1)*tp)``, and nodes hold ``gpus_per_node``
consecutive devices — the standard "TP innermost, PP across" layout.

The port's copy of ``repro.core.comm.collectives``, its imports rewritten.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core.comm import LinkSpec

if TYPE_CHECKING:                        # avoid cycle: hardware imports comm
    from repro_torch.core.costmodel.hardware import ClusterSpec


def p2p_time(nbytes: float, link: LinkSpec) -> float:
    """One point-to-point message: latency + bytes/bandwidth.

    Zero-byte sends cost nothing (no message is posted) — the
    engine-level :class:`~repro.core.comm.Link` keeps its "latency even
    for empty payloads" semantics for explicit transfers; this analytic
    model is called per planned hand-off and must not charge for stages
    that exchange no activations."""
    if nbytes <= 0:
        return 0.0
    return link.latency + nbytes / link.bandwidth


def ring_allreduce_time(nbytes: float, n_ranks: int,
                        link: LinkSpec) -> float:
    """Ring all-reduce of ``nbytes`` (the full tensor) over ``n_ranks``.

    2*(n-1) pipelined steps (reduce-scatter + all-gather), each moving
    ``nbytes / n`` per rank over the slowest link in the ring:

        T = 2 * (n - 1) * (link.latency + nbytes / n / link.bandwidth)

    The bandwidth term equals the classic ``2*(n-1)/n * nbytes / bw``
    optimal-ring volume; the latency term is what makes high TP degree
    expensive on high-latency links."""
    if n_ranks <= 1 or nbytes <= 0:
        return 0.0
    return 2 * (n_ranks - 1) * (link.latency
                                + nbytes / n_ranks / link.bandwidth)


def tp_group_link(cluster: "ClusterSpec", tp: int,
                  stage: int = 0) -> LinkSpec:
    """Link the TP ring of pipeline stage ``stage`` traverses: under the
    consecutive-placement model the stage owns devices
    ``[stage*tp, (stage+1)*tp)``, and the ring pays the inter-node link
    as soon as that range straddles a node boundary (the slowest hop
    bounds every pipelined ring step) — which also covers mis-aligned
    groups where ``tp`` does not divide ``gpus_per_node``."""
    gpn = max(1, cluster.gpus_per_node)
    if (stage * tp) // gpn != ((stage + 1) * tp - 1) // gpn:
        return cluster.inter_link
    return cluster.intra_link


def stage_boundary_link(cluster: "ClusterSpec", tp: int,
                        stage: int) -> LinkSpec:
    """Link carrying activations from pipeline stage ``stage`` to
    ``stage + 1`` under the consecutive-placement model: the hand-off is
    from the last device of ``stage`` to the first device of
    ``stage + 1``, so it crosses nodes exactly when those two adjacent
    devices live on different nodes."""
    gpn = max(1, cluster.gpus_per_node)
    last_dev = (stage + 1) * tp - 1
    if last_dev // gpn != (last_dev + 1) // gpn:
        return cluster.inter_link
    return cluster.intra_link
