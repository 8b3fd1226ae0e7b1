"""The reference's dry run, for tests/test_torch_dryrun.py.

Run as ``python dryrun_reference.py OUT.json CELLS.json``: imports
``repro.launch.dryrun`` (which sets ``XLA_FLAGS`` for 512 host devices
before jax loads) and writes, as JSON, its surface (``all_cells``, the
skip records of the cells no config takes, ``SETTINGS_PRESETS``,
``probe_depths``, ``with_depth`` at both probe depths, ``input_specs``
of every runnable cell) and the records of ``run_cell`` for each
(arch, shape, multi_pod, settings) of CELLS.json, at the first probe
depth.

Two changes to the reference's run, made here and nowhere in
``src/repro``:

* ``make_production_mesh`` is swapped for the same mesh with ``Auto``
  axes.  Under jax 0.9 ``jax.make_mesh`` gives ``Explicit`` axes, which
  ``with_sharding_constraint`` (the reference's ``shard``) refuses, so
  the reference's own dry run fails at its first cell.
* the records are taken with ``scan_layers=False``: under
  ``scan_layers=True`` XLA's cost analysis counts a scanned layer body
  once, whatever the depth, where the port's Python loop counts every
  layer.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.launch.dryrun as dr  # noqa: E402
from repro.configs import (ASSIGNED, get_config, get_shape,  # noqa: E402
                           shape_applicable)
from repro.models import model_zoo as zoo  # noqa: E402


def auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def specs(tree):
    if isinstance(tree, dict):
        return {k: specs(v) for k, v in tree.items()}
    return [list(tree.shape), str(tree.dtype)]


def main():
    out_path, cells_path = sys.argv[1], sys.argv[2]
    with open(cells_path) as f:
        cells = json.load(f)
    dr.make_production_mesh = auto_mesh
    out = {"cells": [list(c) for c in dr.all_cells()],
           "presets": {k: dataclasses.asdict(v)
                       for k, v in dr.SETTINGS_PRESETS.items()},
           "dtype_bytes": dr.DTYPE_BYTES,
           "collective_kinds": list(dr.COLLECTIVES),
           "probe_depths": {}, "with_depth": {}, "skips": {},
           "input_specs": {}, "records": {}}
    for arch in ASSIGNED:
        cfg = get_config(arch)
        depths = dr.probe_depths(cfg)
        out["probe_depths"][arch] = list(depths)
        out["with_depth"][arch] = {
            str(n): dataclasses.asdict(dr.with_depth(cfg, n))
            for n in depths}
    for arch, shape in dr.all_cells():
        key = f"{arch}/{shape}"
        if not shape_applicable(get_config(arch), get_shape(shape))[0]:
            out["skips"][key] = dr.run_cell(
                arch, shape, multi_pod=False,
                settings=dr.SETTINGS_PRESETS["baseline"])
            continue
        model = zoo.build(get_config(arch), tp=16)
        out["input_specs"][key] = specs(dr.input_specs(model, shape))
    for arch, shape, multi_pod, preset in cells:
        settings = dataclasses.replace(dr.SETTINGS_PRESETS[preset],
                                       scan_layers=False)
        depth = dr.probe_depths(get_config(arch))[0]
        rec = dr.run_cell(arch, shape, multi_pod=multi_pod,
                          settings=settings, depth_override=depth)
        out["records"][f"{arch}/{shape}/{multi_pod}/{preset}"] = rec
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
