"""TokenSim core: the paper's contribution — a modular, extensible
discrete-event simulator for LLM inference systems.

Layers (bottom-up): engine (DES kernel) -> request/workload -> costmodel
(hardware + operator graph + backends) -> mem (block manager, memory
pool) -> comm -> sched (global/local) -> worker -> simulator facade.

The port's copy of ``repro.core``, its imports rewritten.
"""
from repro_torch.core.engine import Environment  # noqa: F401
from repro_torch.core.mem import (BlockManager, MemoryConfig,  # noqa: F401
                                  MemoryPool, PoolConfig, SwapConfig,
                                  SwapManager)
from repro_torch.core.request import Request, State  # noqa: F401
from repro_torch.core.workload import (WorkloadSpec, generate,  # noqa: F401
                                       make_source, make_tenant_source)
from repro_torch.core.metrics import (Results, StreamingStats,  # noqa: F401
                                      jain_index)
from repro_torch.core.faults import (ChaosSpec, FaultEvent,  # noqa: F401
                                     FaultProcess, FaultSpec, FAULT_KINDS,
                                     load_fault_trace)
from repro_torch.core.simulator import (SimSpec, WorkerSpec,  # noqa: F401
                                        Simulation, simulate)
from repro_torch.core.specdecode import (AcceptanceModel,  # noqa: F401
                                         SpecDecodeSpec)
from repro_torch.core.tenancy import TenantSpec, TenantTier  # noqa: F401
