"""Cluster-wide remote/object KV store — the third cache tier
(docs/ROUTING.md).

Sits under host DRAM in the hierarchy device HBM -> host DRAM
(``SwapManager``) -> remote store: a capacity-bounded LRU shared by
every worker, in the LMCache / Mooncake mold.  Two kinds of entries
live here:

* **prefix publications** (``("prefix", prefix_id)``) — shared-prefix
  KV that disagg prefill workers (and peer-fetch write-through)
  publish so other workers retrieve instead of re-prefilling.  These
  are cache entries: evictable under LRU pressure, and the prefix
  registry / fetch path must tolerate a miss.
* **swap spill** (``("swap", request_id)``) — preemption victims that
  overflowed a worker's host tier.  These hold the only copy of live
  prefill progress, so they are *pinned*: LRU never evicts them; they
  are freed explicitly via :meth:`drop` on swap-in / release.  If a
  pinned entry does not fit even after evicting every unpinned entry,
  the put fails and the caller falls back to recompute — the same
  no-lost-progress contract as the host tier.

Retrieve cost is priced per accessing worker as
``remote_setup + bytes / remote_bw`` from its ``HardwareSpec`` (the
object store is bandwidth- not block-granular: one GET per object), so
the store itself only does byte accounting.  Unlike worker state, the
store survives worker death — that is what makes the disagg
publish-then-fetch path serviceable after the prefill worker fails.

The port's copy of ``repro.core.mem.remote_store``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class RemoteKVSpec:
    """Enables the remote tier when set on ``SimSpec.remote_kv``
    (``None`` keeps the simulator byte-identical to the two-tier
    model)."""
    #: object-store capacity shared by the whole cluster
    capacity_bytes: float = 1e12
    #: override ``HardwareSpec.remote_bw`` for every worker (None =
    #: per-worker hardware value)
    bw: Optional[float] = None
    #: override ``HardwareSpec.remote_setup`` likewise
    setup_latency: Optional[float] = None
    #: disagg prefill hand-off (``Simulation.migrate``) and peer-fetch
    #: write-through publish shared prefixes into the store
    publish_prefixes: bool = True


class RemoteKVStore:
    """Capacity-bounded LRU object store keyed by opaque tuples."""

    def __init__(self, capacity_bytes: float):
        self.capacity_bytes = float(capacity_bytes)
        # key -> (tokens, nbytes, pinned); dict order is LRU order
        # (oldest first) maintained by re-insertion on touch
        self._entries: Dict[Tuple, Tuple[int, float, bool]] = {}
        self.used_bytes = 0.0
        self.peak_used_bytes = 0.0
        self.stores = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0

    # -- capacity -----------------------------------------------------
    def _evictable_bytes(self) -> float:
        return sum(nb for _, nb, pinned in self._entries.values()
                   if not pinned)

    def can_fit(self, nbytes: float) -> bool:
        """Would a put of ``nbytes`` succeed (evicting unpinned LRU
        entries if needed)?"""
        free = self.capacity_bytes - self.used_bytes
        return nbytes <= free + self._evictable_bytes()

    def _make_room(self, nbytes: float) -> bool:
        if nbytes > self.capacity_bytes:
            return False
        while self.used_bytes + nbytes > self.capacity_bytes:
            victim = next((k for k, (_, _, pinned) in
                           self._entries.items() if not pinned), None)
            if victim is None:
                return False
            _, nb, _ = self._entries.pop(victim)
            self.used_bytes -= nb
            self.evictions += 1
        return True

    # -- object API ---------------------------------------------------
    def put(self, key: Tuple, tokens: int, nbytes: float, *,
            pinned: bool = False) -> bool:
        """Store (or refresh) an object; returns False when it cannot
        fit without evicting a pinned entry."""
        old = self._entries.pop(key, None)
        if old is not None:
            self.used_bytes -= old[1]
        if not self._make_room(nbytes):
            self.rejects += 1
            return False
        self._entries[key] = (tokens, nbytes, pinned)
        self.used_bytes += nbytes
        self.peak_used_bytes = max(self.peak_used_bytes, self.used_bytes)
        self.stores += 1
        return True

    def get(self, key: Tuple) -> Optional[Tuple[int, float]]:
        """(tokens, nbytes) on hit — touches LRU order — else None."""
        ent = self._entries.pop(key, None)
        if ent is None:
            self.misses += 1
            return None
        self._entries[key] = ent            # re-insert = most recent
        self.hits += 1
        return ent[0], ent[1]

    def has(self, key: Tuple) -> bool:
        return key in self._entries

    def drop(self, key: Tuple) -> int:
        """Free an object (idempotent); returns the tokens it held."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return 0
        self.used_bytes -= ent[1]
        return ent[0]

    # -- reporting ----------------------------------------------------
    def stats(self) -> dict:
        return {"capacity_bytes": self.capacity_bytes,
                "used_bytes": self.used_bytes,
                "peak_used_bytes": self.peak_used_bytes,
                "n_entries": len(self._entries),
                "stores": self.stores,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejects": self.rejects}
