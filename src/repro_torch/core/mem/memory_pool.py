"""Multi-round KV memory pool and prompt-prefix trie (docs/MEMORY.md).

Citations: CachedAttention / MemServe (paper §IV-E, Fig. 14).

Finished conversations park their KV in a tiered pool (host DRAM or a
disaggregated memory pool); a follow-up round of the same session reuses
the cached prefix instead of recomputing prefill.  A prompt-prefix trie
gives MemServe-style cross-request locality for identical prefixes —
both for global-scheduler routing (worker payloads) and inside the
``BlockManager`` allocation path (physical-block payloads backing
shared-prefix copy-on-write caching).

Costs: retrieval latency per block (MemServe quotes ~800 ns/block for
pooled memory) plus optional bandwidth-limited transfer handled by the
simulator's comm model.

The port's copy of ``repro.core.mem.memory_pool``, its imports rewritten.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import Request

#: every accepted ``PoolConfig.eviction`` policy; scripts/check_docs.py
#: asserts each entry is documented in docs/MEMORY.md
EVICTION_KINDS = ("lru",)


@dataclass(frozen=True)
class PoolConfig:
    capacity_tokens: int = 4_000_000
    block_size: int = 16
    retrieve_latency_per_block: float = 800e-9   # MemServe figure
    store_latency_per_block: float = 800e-9
    eviction: str = "lru"                # see EVICTION_KINDS
    enabled: bool = True


class MemoryPool:
    """LRU pool of per-session KV prefixes (token granularity)."""

    def __init__(self, pc: PoolConfig):
        if pc.eviction not in EVICTION_KINDS:
            raise ValueError(f"unknown pool eviction policy "
                             f"{pc.eviction!r}; have {EVICTION_KINDS}")
        self.pc = pc
        self._entries: "OrderedDict[int, int]" = OrderedDict()
        self.used_tokens = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- store / lookup ---------------------------------------------------
    def store(self, session_id: Optional[int], context_len: int) -> float:
        """Park `context_len` tokens of KV for the session; returns the
        simulated store latency."""
        if not self.pc.enabled or session_id is None:
            return 0.0
        prev = self._entries.pop(session_id, 0)
        self.used_tokens -= prev
        keep = max(prev, context_len)
        while self.used_tokens + keep > self.pc.capacity_tokens \
                and self._entries:
            _, ev = self._entries.popitem(last=False)
            self.used_tokens -= ev
            self.evictions += 1
        if self.used_tokens + keep > self.pc.capacity_tokens:
            return 0.0                    # doesn't fit at all
        self._entries[session_id] = keep
        self.used_tokens += keep
        blocks = -(-keep // self.pc.block_size)
        return blocks * self.pc.store_latency_per_block

    def lookup(self, req: Request) -> Tuple[int, float]:
        """Returns (reusable_prefix_tokens, retrieve_latency)."""
        if not self.pc.enabled or req.session_id is None:
            return 0, 0.0
        cached = self._entries.get(req.session_id, 0)
        if cached <= 0:
            self.misses += 1
            return 0, 0.0
        self._entries.move_to_end(req.session_id)   # LRU touch
        reuse = min(cached, req.history_len, req.prompt_len)
        if reuse <= 0:
            self.misses += 1
            return 0, 0.0
        self.hits += 1
        blocks = -(-reuse // self.pc.block_size)
        return reuse, blocks * self.pc.retrieve_latency_per_block

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "used_tokens": self.used_tokens,
                "evictions": self.evictions}


class PrefixTrie:
    """MemServe-style global prompt tree at block granularity.

    Keys are per-block content hashes (here: the workload's deterministic
    pseudo-token block keys).  Two payload kinds share the node
    structure, serving the two prefix-locality layers of the stack:

    * ``_workers`` sets — the session-affinity global scheduler routes
      requests to the worker most likely to hold their prefix
      (``insert`` / ``best_worker``);
    * ``_block`` physical-block ids — the ``BlockManager`` allocation
      path resolves a request's shared-prefix keys to resident device
      blocks for refcounted copy-on-write sharing (``insert_block`` /
      ``match_blocks`` / ``remove_block``).
    """

    #: node payload keys (everything else in a node dict is a child edge)
    _META = ("_workers", "_block")

    def __init__(self, block_size: int = 16):
        self.block_size = block_size
        self.root: Dict = {}

    # -- worker-routing payloads (global scheduler) ----------------------
    def insert(self, key_blocks: Tuple[int, ...], worker_id: int) -> None:
        node = self.root
        for kb in key_blocks:
            node = node.setdefault(kb, {})
            node.setdefault("_workers", set()).add(worker_id)

    def best_worker(self, key_blocks: Tuple[int, ...]) -> Tuple[Optional[int], int]:
        """(worker with longest shared prefix, matched blocks)."""
        node = self.root
        last_workers, depth = None, 0
        for kb in key_blocks:
            if kb not in node:
                break
            node = node[kb]
            last_workers = node.get("_workers")
            depth += 1
        if not last_workers:
            return None, 0
        return min(last_workers), depth

    # -- physical-block payloads (BlockManager allocation path) ----------
    def insert_block(self, key_path: Sequence, block_id: int) -> None:
        """Register a resident device block under its content-key path."""
        node = self.root
        for k in key_path:
            node = node.setdefault(k, {})
        node["_block"] = block_id

    def match_blocks(self, key_path: Sequence) -> List[int]:
        """Physical blocks of the longest registered prefix of
        ``key_path`` (contiguous from the root; stops at the first key
        without a resident block)."""
        node = self.root
        out: List[int] = []
        for k in key_path:
            node = node.get(k)
            if node is None or "_block" not in node:
                break
            out.append(node["_block"])
        return out

    def remove_block(self, key_path: Sequence) -> None:
        """Unregister the block at ``key_path``, pruning nodes that hold
        no live payload and no children afterwards."""
        path = [self.root]
        for k in key_path:
            nxt = path[-1].get(k)
            if nxt is None:
                return
            path.append(nxt)
        path[-1].pop("_block", None)
        for i in range(len(key_path), 0, -1):
            node = path[i]
            # presence checks, not truthiness: block id 0 and physical
            # worker id 0 are live payloads too
            alive = any(k not in self._META for k in node) \
                or "_block" in node or node.get("_workers")
            if alive:                    # child edges or live payloads
                break
            del path[i - 1][key_path[i - 1]]
