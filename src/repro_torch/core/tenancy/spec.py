"""Tenant tiers and per-tenant QoS contracts.

Citations: token-bucket gateway limiting follows Limitador/Kuadrant;
tiered SLO contracts follow production LLM API pricing tiers.

A ``TenantTier`` is the QoS contract an operator sells: scheduling
weight/priority, a token-bucket rate limit (tokens/s + burst, the
Limitador/Kuadrant role in production gateways), per-tenant latency SLOs
and an in-flight cap.  A ``TenantSpec`` binds one tenant to a tier and a
traffic mix (its own ``WorkloadSpec``); the simulator merges all tenant
streams into one deterministic arrival sequence.

The port's copy of ``repro.core.tenancy.spec``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.workload import WorkloadSpec

#: admission policies when a tenant exceeds its rate limit / inflight cap
REJECT = "reject"      # 429 immediately: request never enters the system
QUEUE = "queue"        # hold at the gateway until the bucket refills
SHED = "shed"          # queue, but reject if projected wait > shed_timeout
ADMISSION_POLICIES = (REJECT, QUEUE, SHED)


@dataclass(frozen=True)
class TenantTier:
    """QoS contract parameters for one tier of service."""

    name: str = "standard"
    #: weighted-fair-queuing share (relative; used by global_policy="wfq")
    weight: float = 1.0
    #: strict priority, larger = more important (global_policy="priority")
    priority: int = 0
    #: token-bucket rate limit in tokens/s over prompt+output tokens;
    #: 0 disables rate limiting for the tier
    rate_tokens_per_s: float = 0.0
    #: bucket capacity in tokens (max burst admitted at line rate)
    burst_tokens: float = 0.0
    #: what the gateway does with over-limit traffic
    admission_policy: str = QUEUE
    #: max projected gateway wait before a SHED tier drops a request
    shed_timeout: float = 10.0
    #: concurrent requests allowed past the gateway; 0 = unlimited
    max_inflight: int = 0
    #: per-tenant SLOs (seconds); 0 disables the bound
    ttft_slo: float = 0.0
    tpot_slo: float = 0.0

    def __post_init__(self):
        if self.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy {self.admission_policy!r} not in "
                f"{ADMISSION_POLICIES}")
        if self.rate_tokens_per_s > 0 and self.burst_tokens <= 0:
            # a zero-capacity bucket would deadlock QUEUE tenants; default
            # the burst to one second of line rate
            object.__setattr__(self, "burst_tokens",
                               float(self.rate_tokens_per_s))


#: common API-gateway shapes, usable directly or via ``TIERS[name]``
FREE = TenantTier(name="free", weight=1.0, priority=0,
                  rate_tokens_per_s=2_000.0, burst_tokens=8_000.0,
                  admission_policy=SHED, shed_timeout=5.0,
                  max_inflight=8, ttft_slo=10.0, tpot_slo=1.0)
PRO = TenantTier(name="pro", weight=4.0, priority=5,
                 rate_tokens_per_s=20_000.0, burst_tokens=60_000.0,
                 admission_policy=QUEUE,
                 max_inflight=64, ttft_slo=3.0, tpot_slo=0.3)
ENTERPRISE = TenantTier(name="enterprise", weight=16.0, priority=10,
                        admission_policy=QUEUE,
                        ttft_slo=1.0, tpot_slo=0.2)
TIERS = {t.name: t for t in (FREE, PRO, ENTERPRISE)}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: an id, its QoS tier, and its traffic."""

    tenant_id: str
    tier: TenantTier = field(default_factory=TenantTier)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)

    def request_cost(self, req) -> float:
        """Tokens a request charges against the bucket (prompt+output,
        token-based limiting as in production LLM gateways)."""
        return float(req.prompt_len + req.output_len)
