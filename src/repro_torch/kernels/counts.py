"""Launch counts of the kernel wrappers, in one registry.

Each wrapper calls ``count(name)`` where it launches its kernel, and
nowhere else: a call that runs the plain version on CPU tensors counts
nothing.  A count may carry a breakdown key (the flash wrapper's query
length), kept under ``(name, key)`` beside the wrapper's total.  The
counts are one plain dict, so a CUDA graph can take the launches made
while it was captured and add them again at every replay
(``serving.graphs``).
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional

_counts: Dict[Hashable, int] = {}


def count(name: str, key: Optional[Hashable] = None) -> None:
    """One launch of kernel ``name`` (and of ``(name, key)``)."""
    _counts[name] = _counts.get(name, 0) + 1
    if key is not None:
        _counts[name, key] = _counts.get((name, key), 0) + 1


def get(name: Hashable) -> int:
    """Launches of ``name`` (or ``(name, key)``) since the last reset."""
    return _counts.get(name, 0)


def snapshot() -> Dict[Hashable, int]:
    """Every nonzero count, by name and by ``(name, key)``."""
    return {k: n for k, n in _counts.items() if n}


def reset() -> None:
    """Set every count to zero."""
    _counts.clear()


def add(delta: Dict[Hashable, int], sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (keys as ``snapshot``)."""
    for k, n in delta.items():
        _counts[k] = _counts.get(k, 0) + sign * n
