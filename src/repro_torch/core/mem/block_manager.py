"""PagedAttention-style block-granular KV memory manager (paper §III-B,
docs/MEMORY.md).

The port's copy of ``repro.core.mem.block_manager``, kept verbatim apart
from its imports and from ``MemoryConfig.from_model``, which sizes a pool
from the cost model and has no caller in the port yet.  The serving
engine (``repro_torch.serving.engine``) allocates its pages with it; that
it plans exactly as the reference does is checked by
tests/test_torch_engine.py, which compares the two engines' iteration
records one by one.

With ``MemoryConfig(prefix_sharing=True)`` the manager adds a
shared-prefix tier: requests declaring a common prefix
(``Request.prefix_id`` / ``prefix_len``) resolve their prefix blocks
through a content-keyed :class:`~repro_torch.core.mem.memory_pool.PrefixTrie`
and share resident physical blocks under refcounts, with copy-on-write
on append into a shared block.  Blocks are append-only, so a registered
content range is immutable; sharing is between concurrently resident
requests (the cross-time cache is the MemoryPool's job).

Invariants (property-tested on the reference in tests/test_block_manager.py
and tests/test_kv_hierarchy.py):
  * without sharing, a block belongs to at most one request; with
    sharing, a block's refcount equals the number of tables holding it,
  * free + Σ unique allocated == total,
  * a request's blocks always cover ceil(context_len / block_size).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.mem.memory_pool import PrefixTrie
from repro_torch.core.request import Request


@dataclass(frozen=True)
class MemoryConfig:
    num_blocks: int
    block_size: int = 16                # tokens per block
    #: bytes per KV token (byte-granularity reporting). 0 => attention-free
    #: arch: one constant state slot per sequence instead of paged KV.
    kv_bytes_per_token: float = 1.0
    state_bytes_per_seq: float = 0.0    # SSM/hybrid constant per-seq state
    watermark: float = 0.0              # reserve fraction for running reqs
    #: shared-prefix copy-on-write caching (docs/MEMORY.md): requests
    #: with equal (prefix_id, prefix_len) share resident prefix blocks
    prefix_sharing: bool = False


class BlockManager:
    def __init__(self, mc: MemoryConfig):
        self.mc = mc
        self.free_blocks: List[int] = list(range(mc.num_blocks))
        self.free_blocks.reverse()       # pop() yields 0,1,2,... order
        self.tables: Dict[int, List[int]] = {}   # req id -> physical blocks
        self.token_counts: Dict[int, int] = {}   # req id -> resident tokens
        self.peak_used = 0
        #: physical block -> number of tables holding it (1 = private)
        self.ref: Dict[int, int] = {}
        #: content-keyed index of resident shareable prefix blocks
        self.shared_index: Optional[PrefixTrie] = \
            PrefixTrie(mc.block_size) if mc.prefix_sharing else None
        self._shared_path: Dict[int, Tuple] = {}  # block -> trie key path
        # prefix-sharing counters (Results.memory_summary)
        self.shared_hits = 0             # prefix blocks reused via index
        self.shared_misses = 0           # prefix blocks allocated fresh
        self.shared_tokens = 0           # tokens covered by reused blocks
        self.cow_copies = 0              # copy-on-write block copies

    # -- capacity queries -------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free_blocks)

    @property
    def num_used(self) -> int:
        return self.mc.num_blocks - self.num_free

    def usage(self) -> float:
        return self.num_used / max(1, self.mc.num_blocks)

    def used_bytes(self) -> float:
        if self.mc.kv_bytes_per_token:
            return self.num_used * self.mc.block_size * \
                self.mc.kv_bytes_per_token
        return self.num_used * self.mc.state_bytes_per_seq

    def blocks_needed(self, tokens: int) -> int:
        if self.mc.kv_bytes_per_token <= 0:      # SSM: 1 slot per seq
            return 1
        return math.ceil(max(1, tokens) / self.mc.block_size)

    def can_allocate(self, tokens: int, *, respect_watermark: bool = False,
                     headroom_tokens: int = 0,
                     req: Optional[Request] = None) -> bool:
        """Whether an allocation of ``tokens`` would fit.  With ``req``
        given and prefix sharing enabled, blocks resolvable through the
        shared index are not charged against the free list (swap-aware
        admission passes the request so shared-prefix requests admit at
        their effective, not nominal, footprint)."""
        need = self.blocks_needed(tokens + headroom_tokens)
        if req is not None and self._sharing_active(req):
            need -= len(self.shared_index.match_blocks(
                self._prefix_keys(req, tokens, headroom_tokens)))
        avail = self.num_free
        if respect_watermark and self.mc.watermark > 0:
            avail -= int(self.mc.watermark * self.mc.num_blocks)
        return need <= avail

    # -- prefix sharing ---------------------------------------------------
    def _sharing_active(self, req: Request) -> bool:
        return self.shared_index is not None \
            and self.mc.kv_bytes_per_token > 0 \
            and getattr(req, "prefix_id", None) is not None \
            and req.prefix_len > 0

    def _prefix_keys(self, req: Request, tokens: int,
                     reserve: int = 0) -> List[tuple]:
        """Deterministic content keys for req's shareable prefix blocks.

        Stands in for per-block content hashes: the workload layer
        guarantees requests with equal ``prefix_id`` carry identical
        prefix tokens.  A full block is always shareable; the partial
        tail block is keyed by its valid-token count and only taken by
        requests whose tokens — including any pre-booked ``reserve``
        (static batching writes its whole output into the reservation,
        no copy-on-write possible) — end inside it.  Anyone writing
        past it recomputes the tail privately, vLLM-style, or triggers
        copy-on-write on a later append."""
        bs = self.mc.block_size
        plen = min(req.prefix_len, tokens)
        if plen <= 0:
            return []
        keys = []
        for i in range(math.ceil(plen / bs)):
            valid = min(bs, plen - i * bs)
            if valid < bs and tokens + reserve > i * bs + valid:
                break                    # req writes past the partial tail
            keys.append((req.prefix_id, i, valid))
        return keys

    def _release_block(self, b: int) -> bool:
        """Drop one table's reference; frees the block when the last
        holder releases it.  Returns True if it went back on the free
        list."""
        r = self.ref[b] - 1
        assert r >= 0, f"refcount underflow on block {b}"
        if r > 0:
            self.ref[b] = r
            return False
        del self.ref[b]
        path = self._shared_path.pop(b, None)
        if path is not None:
            self.shared_index.remove_block(path)
        self.free_blocks.append(b)
        return True

    # -- allocation -------------------------------------------------------
    def allocate(self, req: Request, tokens: int,
                 reserve: int = 0) -> List[int]:
        """Allocate blocks covering ``tokens`` (+ ``reserve`` headroom
        tokens, used by static batching to pre-book the whole output).
        With prefix sharing, resolvable prefix blocks are taken by
        reference from the shared index instead of the free list, and
        freshly written prefix blocks are registered for later reuse."""
        assert req.id not in self.tables, f"req {req.id} already allocated"
        need = self.blocks_needed(tokens + reserve)
        shared: List[int] = []
        keys: List[tuple] = []
        if self._sharing_active(req):
            keys = self._prefix_keys(req, tokens, reserve)
            shared = self.shared_index.match_blocks(keys)
        if need - len(shared) > self.num_free:
            raise MemoryError(f"OOM: need {need - len(shared)}, "
                              f"free {self.num_free}")
        for b in shared:
            self.ref[b] += 1
        fresh = [self.free_blocks.pop() for _ in range(need - len(shared))]
        for b in fresh:
            self.ref[b] = 1
        blocks = shared + fresh
        if keys:
            # register this request's freshly written prefix blocks
            for i in range(len(shared), len(keys)):
                self.shared_index.insert_block(keys[:i + 1], blocks[i])
                self._shared_path[blocks[i]] = tuple(keys[:i + 1])
            self.shared_hits += len(shared)
            self.shared_misses += len(keys) - len(shared)
            if shared:
                # tokens covered by reused blocks: full blocks, plus the
                # partial tail's valid count when it was taken
                toks = min(req.prefix_len, tokens,
                           len(shared) * self.mc.block_size)
                self.shared_tokens += toks
                req.shared_tokens += toks
                # skip prefill for the shared tokens; when the writer's
                # own prefill is still in flight this models coalesced
                # prefix computation (optimistic in-flight dedup — the
                # documented assumption in docs/MEMORY.md)
                if toks > req.cached_len:
                    req.cached_len = toks
        self.tables[req.id] = blocks
        self.token_counts[req.id] = tokens
        self.peak_used = max(self.peak_used, self.num_used)
        return blocks

    def growth_blocks(self, req: Request, n: int = 1) -> int:
        """Free blocks required to append ``n`` tokens: boundary growth
        plus one copy-on-write block when the first new token lands in
        a block shared with another request.  Schedulers budget decode
        feasibility with this (see ContinuousBatching)."""
        if self.mc.kv_bytes_per_token <= 0:
            return 0
        cur = self.token_counts[req.id]
        blocks = self.tables[req.id]
        need = max(0, self.blocks_needed(cur + n) - len(blocks))
        if cur % self.mc.block_size != 0:
            b = blocks[cur // self.mc.block_size]
            if self.ref.get(b, 1) > 1:
                need += 1                # CoW copy of the shared block
        return need

    def can_append(self, req: Request, n: int = 1) -> bool:
        if self.mc.kv_bytes_per_token <= 0:
            return True                           # constant state
        if req.id not in self.tables:
            return False
        return self.growth_blocks(req, n) <= self.num_free

    def append_tokens(self, req: Request, n: int = 1) -> None:
        """Grow req's context by n tokens, taking new blocks as needed.

        Speculative decoding appends the full draft window (K+1 tokens)
        before verify and pairs it with ``rollback_tokens`` for the
        rejected suffix, so accept/rollback is two symmetric calls and
        the coverage invariant holds between iterations.  An append
        landing in a block with refcount > 1 copies it first
        (copy-on-write), so shared prefix content is never mutated."""
        assert req.id in self.tables, f"req {req.id} not resident"
        if self.mc.kv_bytes_per_token <= 0:
            self.token_counts[req.id] += n
            return
        cur = self.token_counts[req.id]
        blocks = self.tables[req.id]
        bs = self.mc.block_size
        grow = max(0, self.blocks_needed(cur + n) - len(blocks))
        cow_idx = -1
        if cur % bs != 0:
            idx = cur // bs
            if self.ref.get(blocks[idx], 1) > 1:
                cow_idx = idx
        if grow + (1 if cow_idx >= 0 else 0) > self.num_free:
            raise MemoryError(f"OOM appending: need "
                              f"{grow + (1 if cow_idx >= 0 else 0)}")
        if cow_idx >= 0:
            old = blocks[cow_idx]
            nb = self.free_blocks.pop()
            self.ref[nb] = 1
            blocks[cow_idx] = nb
            released = self._release_block(old)
            assert not released, "CoW source had a single holder"
            self.cow_copies += 1
            req.cow_copies += 1
        for _ in range(grow):
            nb = self.free_blocks.pop()
            self.ref[nb] = 1
            blocks.append(nb)
        self.token_counts[req.id] = cur + n
        self.peak_used = max(self.peak_used, self.num_used)

    def rollback_tokens(self, req: Request, n: int = 1) -> int:
        """Shrink req's context by n tokens (rejected speculative drafts),
        releasing blocks that no longer cover any token.  Private blocks
        return to the free list in reverse allocation order — the same
        discipline ``free`` uses — so allocation patterns stay
        deterministic; shared blocks only drop this request's reference.
        Returns #blocks actually freed."""
        if n <= 0:
            return 0
        assert req.id in self.tables, f"req {req.id} not resident"
        cur = self.token_counts[req.id]
        assert n <= cur, f"rollback {n} exceeds resident {cur}"
        self.token_counts[req.id] = cur - n
        if self.mc.kv_bytes_per_token <= 0:
            return 0                      # constant state: nothing paged
        blocks = self.tables[req.id]
        keep = self.blocks_needed(cur - n) if cur - n > 0 else 0
        released = 0
        while len(blocks) > keep:
            if self._release_block(blocks.pop()):
                released += 1
        return released

    def free(self, req: Request) -> int:
        """Release req's references on all its blocks; blocks with no
        remaining holder return to the free list.  Idempotent (a second
        free is a no-op), so double frees cannot underflow refcounts.
        Returns #blocks actually freed."""
        blocks = self.tables.pop(req.id, [])
        self.token_counts.pop(req.id, None)
        released = 0
        for b in reversed(blocks):
            if self._release_block(b):
                released += 1
        return released

    def resident(self, req: Request) -> bool:
        return req.id in self.tables

    def block_table(self, req: Request) -> List[int]:
        return self.tables[req.id]

    def resident_tokens(self, req: Request) -> int:
        return self.token_counts.get(req.id, 0)

    def stats(self) -> Dict[str, float]:
        """Prefix-sharing and occupancy counters (docs/MEMORY.md)."""
        lookups = self.shared_hits + self.shared_misses
        return {"num_blocks": self.mc.num_blocks,
                "peak_used": self.peak_used,
                "shared_hits": self.shared_hits,
                "shared_misses": self.shared_misses,
                "prefix_hit_rate": self.shared_hits / lookups
                if lookups else 0.0,
                "shared_tokens": self.shared_tokens,
                "cow_copies": self.cow_copies}
