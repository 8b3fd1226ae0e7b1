"""Hierarchical KV memory management (paper §III-B / §IV-E,
docs/MEMORY.md).

Three tiers, device-out: ``BlockManager`` — paged device KV with
refcounted shared-prefix copy-on-write blocks; ``SwapManager`` — host
DRAM holding preempted requests' KV over a PCIe-costed channel
(``SimSpec.preemption_mode="swap"``); ``MemoryPool`` + ``PrefixTrie`` —
the cross-request/session cache serving multi-round conversations and
prefix locality.

The port's copy of ``repro.core.mem``, its imports rewritten.
"""
from repro_torch.core.mem.block_manager import (BlockManager,  # noqa: F401
                                                MemoryConfig)
from repro_torch.core.mem.memory_pool import (EVICTION_KINDS,  # noqa: F401
                                              MemoryPool, PoolConfig,
                                              PrefixTrie)
from repro_torch.core.mem.swap import (PREEMPTION_MODES,  # noqa: F401
                                       SwapConfig, SwapManager)
