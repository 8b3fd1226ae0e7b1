"""The port's copy of ``repro.distributed``, its imports rewritten."""
from repro_torch.distributed.padding import PadPlan, make_pad_plan  # noqa: F401
