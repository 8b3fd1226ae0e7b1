"""Step-atomic checkpoints: the port of ``repro.training.checkpoint``.

It writes the reference's layout, so a checkpoint of either package
restores in the other:

* **Atomic**: a step is written under ``step_N.tmp`` and renamed to
  ``step_N`` only after every tensor file and the manifest (with
  per-tensor checksums) are written and the manifest fsync'd; a
  directory still named ``.tmp`` is never read.
* **Layout**: one ``.npy`` file per tensor, named by its path in the
  tree (keys joined by ``/``, the file name with ``/`` replaced by
  ``__``); ``manifest.json`` holds each tensor's ``file``, ``shape``,
  logical ``dtype`` and ``sha`` (the first 16 hex digits of the sha256
  of the stored bytes), the step and the ``extra`` dict.  bf16 is stored
  as its ``uint16`` view.
* **Async**: ``save(..., blocking=False)`` copies every tensor to host
  memory first, then writes on a background thread, so the step path
  can go on updating the tensors.

``load`` restores into the structure and dtypes of a template tree, on
``device`` (None: each template leaf's own device), or, with
``shardings`` (a tree of ``(mesh, placements)`` or None leaves, as
``distributed.shard_plan.named`` gives), places each leaf on its mesh:
a checkpoint saved under one mesh restores onto another, or onto none.

Sharded trees: a save writes each DTensor's ``full_tensor()``, so a
manifest does not depend on the mesh.  Every rank of the default process
group calls ``save`` (the gather is collective); rank 0 writes, and the
ranks meet at a barrier once the step is on disk (after the write, or in
``wait`` for an async save), so a load on any rank finds it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.common import tree_map


def _paths(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {"/".join(path): leaf for path, leaf in _paths(tree)}


def _unflatten_like(template, values: Dict[str, Any], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in template.items()}
    key = "/".join(prefix)
    if key not in values:
        raise KeyError(f"checkpoint missing tensor {key!r}")
    return values[key]


def _checksum(arr: np.ndarray) -> str:
    data = np.ascontiguousarray(arr).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bf16 as its uint16 view) and its
    logical dtype, named as numpy names it (``float32``, ``bfloat16``)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _ranks() -> int:
    """The default process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    if _ranks() > 1:
        dist.barrier()


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = True,
             extra: Optional[dict] = None) -> str:
        self.wait()                         # one async save in flight max
        host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}

        def write():
            if dist.is_initialized() and dist.get_rank() != 0:
                return
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "tensors": {},
                        "extra": extra or {}}
            for key, (arr, logical_dtype) in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["tensors"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": logical_dtype, "sha": _checksum(arr)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            _barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return os.path.join(self.dir, f"step_{step}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def load(self, step: int, template, *, device=None, shardings=None,
             verify: bool = True):
        """Restore into the structure and dtypes of ``template``, on
        ``device`` (None: each template leaf's device); ``shardings`` (a
        tree of ``template``'s keys whose leaves are ``(mesh,
        placements)`` or None) places each leaf on its mesh instead,
        re-sharding elastically."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        for key, meta in manifest["tensors"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            if verify and _checksum(arr) != meta["sha"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            values[key] = _from_host(arr, meta["dtype"])
        tree = _unflatten_like(template, values)

        def restore(x, t, placed=None):
            if placed is not None:
                return distribute_tensor(x.to(t.dtype), *placed)
            return x.to(device=t.device if device is None else device,
                        dtype=t.dtype)

        if shardings is None:
            tree = tree_map(restore, tree, template)
        else:
            tree = tree_map(restore, tree, template, shardings)
        return tree, manifest.get("extra", {})

    def restore_latest(self, template, *, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None, {}
        tree, extra = self.load(step, template, device=device,
                                shardings=shardings)
        return step, tree, extra
