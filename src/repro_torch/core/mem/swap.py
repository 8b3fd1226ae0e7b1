"""Host-DRAM swap tier for preempted KV (docs/MEMORY.md).

Citations: vLLM's swap preemption mode and the LLMServingSim /
Miao et al. serving-survey treatment of KV offload across a memory
hierarchy.  When a local scheduler preempts a request in
``preemption_mode="swap"``, the victim's resident KV moves to host DRAM
over a PCIe-bandwidth-costed channel instead of being discarded; on
re-admission it moves back and decoding resumes without re-prefill.

Cost model (billed into the worker's iteration time by the event loop):

    transfer_time(tokens) = setup_latency
                          + blocks * per_block_latency
                          + tokens * kv_bytes_per_token / pcie_bw

The per-block term models the scattered per-layer DMA descriptors a
paged KV layout forces (small non-contiguous copies run far below peak
PCIe bandwidth), which is why recompute beats swap for short contexts
while swap wins for long ones — the crossover
``benchmarks/kv_hierarchy.py`` sweeps.  Host capacity is bounded by
``HardwareSpec.host_mem_cap``; when the host tier is full the scheduler
falls back to recompute preemption for that victim — unless a third,
cluster-wide remote/object tier is attached (``SimSpec.remote_kv``,
docs/ROUTING.md), in which case the victim *spills* there first:

    remote transfer_time(tokens) = remote_setup_latency
                                 + bytes / remote_bw

(one GET/PUT per object — the store is not block-granular, so no
per-block descriptor term).  Spilled entries are pinned in the store
(they hold the only copy of live progress) and freed on swap-in /
release; only when neither tier fits does the scheduler fall back to
recompute.

The port's copy of ``repro.core.mem.swap``, its imports rewritten.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.mem.remote_store import RemoteKVStore
from repro_torch.core.request import Request

#: every accepted ``SimSpec.preemption_mode``; scripts/check_docs.py
#: asserts each entry is documented in docs/MEMORY.md
PREEMPTION_MODES = ("recompute", "swap")


@dataclass(frozen=True)
class SwapConfig:
    pcie_bw: float = 32e9               # host link bytes/s
    host_capacity_bytes: float = 256e9  # DRAM reserved for swapped KV
    kv_bytes_per_token: float = 1.0     # 0 => SSM constant per-seq state
    state_bytes_per_seq: float = 0.0
    block_size: int = 16
    #: fixed DMA/driver setup per transfer, seconds
    setup_latency: float = 50e-6
    #: per-block descriptor cost of scattered paged-KV copies, seconds
    per_block_latency: float = 50e-6
    #: remote-tier link (docs/ROUTING.md), from HardwareSpec.remote_bw /
    #: remote_setup; consumed only when a RemoteKVStore is attached
    remote_bw: float = 6.25e9
    remote_setup_latency: float = 2e-3


class SwapManager:
    """Accounting for KV parked in host DRAM, one instance per worker.

    Holds (req id -> tokens) for swapped-out requests, bounds host
    usage, and prices each direction of the transfer.  Pure accounting:
    the local scheduler decides *when* to swap, the worker bills the
    returned latencies into simulated time.
    """

    def __init__(self, sc: SwapConfig,
                 remote: Optional[RemoteKVStore] = None):
        self.sc = sc
        self.remote = remote             # shared cluster tier (or None)
        self.host: Dict[int, int] = {}   # req id -> tokens held in DRAM
        self._remote: Dict[int, int] = {}  # req id -> tokens spilled
        self.used_bytes = 0.0
        self.peak_used_bytes = 0.0
        self.swap_out_events = 0
        self.swap_in_events = 0
        self.bytes_out = 0.0
        self.bytes_in = 0.0
        self.remote_out_events = 0
        self.remote_in_events = 0
        self.remote_bytes_out = 0.0
        self.remote_bytes_in = 0.0
        self.fallbacks = 0               # no tier fits: recompute instead
        self.adopted = 0                 # failover entries taken over
        #: observability tap (repro.obs): when set, called as
        #: on_event(kind, req_id, tokens, nbytes) for every swap_out /
        #: swap_in so the trace can mark transfers on the worker lane
        self.on_event = None

    # -- cost model -------------------------------------------------------
    def bytes_for(self, tokens: int) -> float:
        if self.sc.kv_bytes_per_token > 0:
            return tokens * self.sc.kv_bytes_per_token
        return self.sc.state_bytes_per_seq

    def transfer_time(self, tokens: int, tier: str = "host") -> float:
        """One direction (swap-out or swap-in) of ``tokens`` of KV."""
        if tier == "remote":
            return self.sc.remote_setup_latency \
                + self.bytes_for(tokens) / max(self.sc.remote_bw, 1.0)
        blocks = max(1, math.ceil(max(1, tokens) / self.sc.block_size))
        return self.sc.setup_latency \
            + blocks * self.sc.per_block_latency \
            + self.bytes_for(tokens) / max(self.sc.pcie_bw, 1.0)

    # -- state ------------------------------------------------------------
    def _host_fits(self, nbytes: float) -> bool:
        return self.used_bytes + nbytes <= self.sc.host_capacity_bytes

    def can_swap_out(self, tokens: int) -> bool:
        nbytes = self.bytes_for(tokens)
        if self._host_fits(nbytes):
            return True
        return self.remote is not None and self.remote.can_fit(nbytes)

    def holds(self, req: Request) -> bool:
        if req.id in self.host:
            return True
        if req.id in self._remote:
            # pinned spill entries are never LRU-evicted, but a drop by
            # another owner (adoption churn) invalidates the binding
            if self.remote is not None \
                    and self.remote.has(("swap", req.id)):
                return True
            del self._remote[req.id]
        return False

    def tokens_held(self, req: Request) -> int:
        return self.host.get(req.id, 0) or self._remote.get(req.id, 0)

    def swap_out(self, req: Request, tokens: int) -> float:
        """Park ``tokens`` of req's KV in host DRAM (or spill to the
        remote tier when the host is full); returns latency."""
        assert req.id not in self.host and req.id not in self._remote, \
            f"req {req.id} already swapped"
        assert tokens > 0
        nbytes = self.bytes_for(tokens)
        if not self._host_fits(nbytes):
            assert self.remote is not None \
                and self.remote.put(("swap", req.id), tokens, nbytes,
                                    pinned=True), \
                "no tier fits (call can_swap_out first)"
            self._remote[req.id] = tokens
            self.remote_out_events += 1
            self.remote_bytes_out += nbytes
            if self.on_event is not None:
                self.on_event("remote_out", req.id, tokens, nbytes)
            return self.transfer_time(tokens, tier="remote")
        self.host[req.id] = tokens
        self.used_bytes += nbytes
        self.peak_used_bytes = max(self.peak_used_bytes, self.used_bytes)
        self.swap_out_events += 1
        self.bytes_out += nbytes
        if self.on_event is not None:
            self.on_event("swap_out", req.id, tokens, nbytes)
        return self.transfer_time(tokens)

    def swap_in(self, req: Request) -> float:
        """Restore req's KV to the device; returns latency."""
        if req.id in self._remote:
            tokens = self._remote.pop(req.id)
            self.remote.drop(("swap", req.id))
            nbytes = self.bytes_for(tokens)
            self.remote_in_events += 1
            self.remote_bytes_in += nbytes
            if self.on_event is not None:
                self.on_event("remote_in", req.id, tokens, nbytes)
            return self.transfer_time(tokens, tier="remote")
        tokens = self.host.pop(req.id)
        nbytes = self.bytes_for(tokens)
        self.used_bytes -= nbytes
        self.swap_in_events += 1
        self.bytes_in += nbytes
        if self.on_event is not None:
            self.on_event("swap_in", req.id, tokens, nbytes)
        return self.transfer_time(tokens)

    def adopt(self, req: Request, tokens: int) -> bool:
        """Take ownership of a KV entry that already lives off-device
        (failover re-dispatch, docs/RELIABILITY.md): no transfer — the
        bytes never moved — just capacity accounting in the adopting
        worker's tiers (host DRAM first, remote spill second).  Returns
        False (and counts a fallback) when no tier has room; the caller
        then re-prefills."""
        if tokens <= 0 or req.id in self.host or req.id in self._remote:
            return False
        nbytes = self.bytes_for(tokens)
        if not self._host_fits(nbytes):
            if self.remote is not None \
                    and self.remote.put(("swap", req.id), tokens, nbytes,
                                        pinned=True):
                self._remote[req.id] = tokens
                self.adopted += 1
                if self.on_event is not None:
                    self.on_event("adopt", req.id, tokens, nbytes)
                return True
            self.fallbacks += 1
            return False
        self.host[req.id] = tokens
        self.used_bytes += nbytes
        self.peak_used_bytes = max(self.peak_used_bytes, self.used_bytes)
        self.adopted += 1
        if self.on_event is not None:
            self.on_event("adopt", req.id, tokens, nbytes)
        return True

    def drop(self, req: Request) -> int:
        """Discard req's off-device copy without a transfer (finish,
        failure, migration); idempotent.  Frees the remote object too —
        spill entries are pinned, so this is their only exit.  Returns
        tokens released."""
        tokens = self.host.pop(req.id, 0)
        if tokens:
            self.used_bytes -= self.bytes_for(tokens)
            return tokens
        tokens = self._remote.pop(req.id, 0)
        if tokens and self.remote is not None:
            self.remote.drop(("swap", req.id))
        return tokens

    def stats(self) -> Dict[str, float]:
        out = {"swap_out_events": self.swap_out_events,
               "swap_in_events": self.swap_in_events,
               "bytes_out": self.bytes_out,
               "bytes_in": self.bytes_in,
               "used_bytes": self.used_bytes,
               "peak_used_bytes": self.peak_used_bytes,
               "fallbacks": self.fallbacks,
               "adopted": self.adopted}
        if self.remote is not None:
            # keys appear only with the tier attached, so two-tier runs
            # (and their golden pins) stay byte-identical
            out.update(remote_out_events=self.remote_out_events,
                       remote_in_events=self.remote_in_events,
                       remote_bytes_out=self.remote_bytes_out,
                       remote_bytes_in=self.remote_bytes_in)
        return out
