"""Multi-tenant QoS: tenant specs, admission control, fair scheduling.

Citations: beyond-paper subsystem; see spec.py, admission.py and qos.py
for the per-technique references (Limitador, SFQ, priority aging).

The subsystem threads tenant identity through the whole stack:

    TenantSpec (tier + workload)                 [spec.py]
      -> merged arrival stream                   [core.workload]
      -> AdmissionController (token bucket)      [admission.py]
      -> tenant-aware GlobalScheduler            [core.sched.global_sched]
      -> QueueDiscipline on each worker          [qos.py]
      -> per-tenant Results breakdowns           [core.metrics]

The port's copy of ``repro.core.tenancy``, its imports rewritten.
"""
from repro_torch.core.tenancy.admission import (AdmissionController,  # noqa: F401
                                                TokenBucket)
from repro_torch.core.tenancy.qos import (PriorityAgingDiscipline,  # noqa: F401
                                          QueueDiscipline, WFQDiscipline)
from repro_torch.core.tenancy.spec import (ADMISSION_POLICIES, ENTERPRISE,  # noqa: F401
                                           FREE, PRO, QUEUE, REJECT, SHED,
                                           TIERS, TenantSpec, TenantTier)
