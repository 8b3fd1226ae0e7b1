"""Cluster-wide prefix registry for cache-aware routing
(docs/ROUTING.md).

Tracks which workers hold KV for which shared ``prefix_id``s — the
record book the ``prefix_affinity`` global policy consults before
dispatch, in the llm-d ext_proc mold: the *router* records where each
prefix was sent (publication happens at assign time, off the worker
hot loop), and two mechanisms keep it honest about cache mortality:

* **staleness (TTL)** — an entry not re-touched within ``ttl``
  simulated seconds is treated as evicted and pruned lazily at lookup;
  a worker that stopped seeing a prefix has almost certainly recycled
  its blocks.
* **invalidation** — ``FaultInjector`` calls
  :meth:`invalidate_worker` when a worker dies, so registry entries
  die with the worker instead of routing traffic at a ghost.

Entries are hints, never guarantees: a stale-but-fresh-looking entry
just means the request re-prefills at the target (exactly what a
prefix-blind router would have done), so correctness never depends on
the registry being right.  A bounded LRU over prefix ids
(``max_prefixes``) keeps the registry itself from growing without
bound on million-prefix workloads.

The port's copy of ``repro.core.sched.prefix_registry``, its imports rewritten.
"""
from __future__ import annotations

from typing import Dict, Tuple


class PrefixRegistry:
    """prefix_id -> {worker id -> (tokens held, last-touch time)}."""

    def __init__(self, env=None, *, ttl: float = 30.0,
                 max_prefixes: int = 65536):
        self.env = env                  # sim clock source (None in tests)
        self.ttl = float(ttl)
        self.max_prefixes = int(max_prefixes)
        # dict order over prefix ids is LRU order (oldest first),
        # maintained by re-insertion on publish/lookup
        self._entries: Dict[int, Dict[int, Tuple[int, float]]] = {}
        self.publishes = 0
        self.invalidations = 0
        self.expirations = 0
        self.evictions = 0

    @property
    def now(self) -> float:
        return self.env.now if self.env is not None else 0.0

    def publish(self, prefix_id: int, wid: int, tokens: int) -> None:
        """Record that worker ``wid`` (now) holds ``tokens`` of KV for
        ``prefix_id``."""
        holders = self._entries.pop(prefix_id, None)
        if holders is None:
            holders = {}
            while len(self._entries) >= self.max_prefixes:
                self._entries.pop(next(iter(self._entries)))
                self.evictions += 1
        holders[wid] = (max(tokens, holders.get(wid, (0, 0.0))[0]),
                        self.now)
        self._entries[prefix_id] = holders
        self.publishes += 1

    def holders(self, prefix_id: int) -> Dict[int, int]:
        """Fresh holders of ``prefix_id`` as {wid: tokens}; prunes
        TTL-expired entries as a side effect."""
        holders = self._entries.get(prefix_id)
        if not holders:
            return {}
        cutoff = self.now - self.ttl
        stale = [w for w, (_, t) in holders.items() if t < cutoff]
        for w in stale:
            del holders[w]
            self.expirations += 1
        if not holders:
            del self._entries[prefix_id]
            return {}
        return {w: tok for w, (tok, _) in holders.items()}

    def tokens_at(self, prefix_id: int, wid: int) -> int:
        """Fresh token count ``wid`` holds for ``prefix_id`` (0 if
        absent or expired)."""
        return self.holders(prefix_id).get(wid, 0)

    def touch(self, prefix_id: int, wid: int) -> None:
        """Refresh the TTL of an entry that just served a hit."""
        holders = self._entries.get(prefix_id)
        if holders and wid in holders:
            holders[wid] = (holders[wid][0], self.now)

    def invalidate_worker(self, wid: int) -> int:
        """Drop every entry held by ``wid`` (worker death); returns the
        number of prefixes invalidated."""
        n = 0
        dead = []
        for pid, holders in self._entries.items():
            if holders.pop(wid, None) is not None:
                n += 1
                if not holders:
                    dead.append(pid)
        for pid in dead:
            del self._entries[pid]
        self.invalidations += n
        return n

    def n_entries(self) -> int:
        return sum(len(h) for h in self._entries.values())

    def stats(self) -> dict:
        return {"registry_prefixes": len(self._entries),
                "registry_entries": self.n_entries(),
                "registry_publishes": self.publishes,
                "registry_invalidations": self.invalidations,
                "registry_expirations": self.expirations,
                "registry_evictions": self.evictions}
