"""The port's copy of ``repro.core.sched``, its imports rewritten."""
from repro_torch.core.sched.local import (  # noqa: F401
    IterationPlan, LocalScheduler, StaticBatching, ContinuousBatching,
    make_local_scheduler)
from repro_torch.core.sched.global_sched import (  # noqa: F401
    GlobalScheduler, RoundRobin, LeastLoaded, DisaggPD, SessionAffinity,
    make_global_scheduler)
