"""Prompt-prefix trie: the port's copy of ``PrefixTrie`` from
``repro.core.mem.memory_pool``.

``BlockManager`` resolves shared-prefix blocks through it.  The rest of
the reference module (``MemoryPool``, the multi-round KV pool) is not
part of the port yet; the engine takes a pool by duck typing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


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
