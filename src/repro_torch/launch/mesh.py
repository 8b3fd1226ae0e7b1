"""Production mesh construction: the port of ``repro.launch.mesh`` on
``torch.distributed.device_mesh``.

Neither function starts a process group: the caller starts one whose
world is the mesh's size (``torch.distributed.init_process_group`` with
its backend, address, world size and rank), and the mesh spans it.  The
production meshes need 256 or 512 ranks, which one machine has only as
a fake group (``torch.testing._internal.distributed.fake_pg``); that is
enough to place every leaf and read its local shape.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(device, shape, axes) -> DeviceMesh:
    return init_device_mesh("cuda" if device is None else device, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` across pods; ``device=None`` means ``"cuda"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1, pod: int = 1,
                   device=None) -> DeviceMesh:
    """A small mesh over the current process group (its world must be
    ``pod * data * model``); ``device=None`` means ``"cuda"``."""
    if pod > 1:
        return _mesh(device, (pod, data, model), ("pod", "data", "model"))
    return _mesh(device, (data, model), ("data", "model"))
