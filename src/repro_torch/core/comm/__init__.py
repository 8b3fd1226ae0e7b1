"""Communication model: inter-worker data movement (paper §III-B).

Models links by (bandwidth, latency); a transfer's duration is
``latency + bytes / bandwidth``.  Transfers run as engine processes, so
they naturally overlap with compute, and a link can be configured to
serialize (one transfer at a time, the paper's "default method") or to
pipeline through a bounded preload buffer (the paper's overlap study):
with ``buffer_chunks > 1`` up to that many chunks are in flight at once.

:mod:`repro.core.comm.collectives` builds on the same ``LinkSpec``
abstraction to price parallelism collectives analytically — ring
all-reduce for tensor parallelism and p2p send/recv for pipeline-stage
hand-off — with topology (intra-node vs inter-node link selection)
supplied by ``costmodel.hardware.ClusterSpec`` (docs/PARALLELISM.md).

The port's copy of ``repro.core.comm``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.engine import Environment, Event


@dataclass(frozen=True)
class LinkSpec:
    name: str
    bandwidth: float              # bytes/s
    latency: float = 5e-6         # per-message
    serialize: bool = True        # one transfer at a time (default)
    buffer_chunks: int = 1        # >1 enables preload-buffer pipelining
    chunk_bytes: float = 16 * 2 ** 20


NVLINK = LinkSpec("NVLink", 300e9, 3e-6)
PCIE4 = LinkSpec("PCIe4x16", 32e9, 8e-6)
ETH100G = LinkSpec("Eth100G", 12.5e9, 30e-6)
ICI = LinkSpec("ICI", 50e9, 2e-6)
DCN = LinkSpec("DCN", 6.25e9, 50e-6)

LINKS = {l.name: l for l in [NVLINK, PCIE4, ETH100G, ICI, DCN]}


class Link:
    """A shared link with optional serialization and chunk pipelining."""

    def __init__(self, env: Environment, spec: LinkSpec):
        self.env = env
        self.spec = spec
        self._busy_until = 0.0
        self.bytes_moved = 0.0
        self.transfers = 0

    def transfer_time(self, nbytes: float) -> float:
        s = self.spec
        if s.buffer_chunks <= 1 or nbytes <= s.chunk_bytes:
            return s.latency + nbytes / s.bandwidth
        # pipelined chunks: receiver-side store overlaps next load; with a
        # deep enough buffer the pipeline is bandwidth-bound + one fill.
        n_chunks = -(-nbytes // s.chunk_bytes)
        fill = min(n_chunks, s.buffer_chunks) * s.latency
        return fill + nbytes / s.bandwidth

    def transfer(self, nbytes: float) -> Event:
        """Schedule a transfer; returns the completion event."""
        t = self.transfer_time(nbytes)
        now = self.env.now
        if self.spec.serialize:
            start = max(now, self._busy_until)
            self._busy_until = start + t
            done_in = (start + t) - now
        else:
            done_in = t
        self.bytes_moved += nbytes
        self.transfers += 1
        return self.env.timeout(done_in)


# imported last: collectives pulls LinkSpec back out of this module
from repro_torch.core.comm.collectives import (  # noqa: E402,F401
    p2p_time, ring_allreduce_time, stage_boundary_link, tp_group_link)
