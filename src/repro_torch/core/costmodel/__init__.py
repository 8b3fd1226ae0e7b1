"""The port's copy of ``repro.core.costmodel``, its imports rewritten."""
from repro_torch.core.costmodel.hardware import (  # noqa: F401
    CLUSTERS, ClusterSpec, HARDWARE, HardwareSpec, ParallelSpec)
from repro_torch.core.costmodel.operators import BatchMix, OperatorGraph  # noqa: F401
from repro_torch.core.costmodel.backends import (  # noqa: F401
    CostBackend, PipelineBackend, RooflineBackend, TabularBackend,
    XLACalibratedBackend, make_backend)
