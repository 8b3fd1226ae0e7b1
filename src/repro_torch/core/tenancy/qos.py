"""Tenant-aware queue disciplines for the worker's waiting queue.

Citations: start-time fair queuing (Goyal et al. 1996) for WFQ tags;
priority aging is the classic starvation guard from OS schedulers.

The local schedulers consult a ``QueueDiscipline`` to pick which waiting
request to admit next and which running request to evict first under
memory pressure.  The default (None) keeps the seed's FIFO / newest-
victim behaviour; the tenant-aware global schedulers in
``repro.core.sched.global_sched`` hand every worker a shared discipline
so ordering is consistent cluster-wide.

The port's copy of ``repro.core.tenancy.qos``, its imports rewritten.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.request import Request


class QueueDiscipline:
    """FIFO baseline; subclasses reorder by QoS tags."""

    def select(self, waiting: Sequence[Request], now: float) -> Request:
        """The next waiting request to consider for admission."""
        return min(waiting, key=self.admit_key(now))

    def admit_key(self, now: float):
        return lambda r: (r.arrival_time, r.id)

    def victim_key(self, now: float):
        """Sort ascending by this key; evict from the END of the list
        (default: newest arrival — the seed's recompute-preemption)."""
        return lambda r: (r.arrival_time, r.id)

    def on_service_start(self, req: Request, now: float) -> None:
        """Hook fired when a request first enters a batch."""


class WFQDiscipline(QueueDiscipline):
    """Order by the virtual finish time stamped by the WFQ global
    scheduler; evict the least-entitled (largest tag) request first."""

    def __init__(self, sched) -> None:
        self.sched = sched           # WeightedFairQueuing record book

    def admit_key(self, now: float):
        return lambda r: (r.vft, r.arrival_time, r.id)

    def victim_key(self, now: float):
        # ascending => smallest tag first; pop() evicts the largest vft
        return lambda r: (-r.priority, r.vft, r.id)

    def on_service_start(self, req: Request, now: float) -> None:
        self.sched.on_service_start(req)


class PriorityAgingDiscipline(QueueDiscipline):
    """Strict priority with linear aging: effective priority grows with
    queue wait so low tiers cannot starve.  ``aging_rate`` is priority
    points gained per second of waiting."""

    def __init__(self, aging_rate: float = 0.0) -> None:
        self.aging_rate = aging_rate

    def admit_key(self, now: float):
        def key(r: Request):
            eff = r.priority + self.aging_rate * max(
                0.0, now - r.arrival_time)
            return (-eff, r.arrival_time, r.id)
        return key

    def victim_key(self, now: float):
        # highest tier first => pop() evicts the lowest tier, newest
        return lambda r: (-r.priority, r.arrival_time, r.id)
