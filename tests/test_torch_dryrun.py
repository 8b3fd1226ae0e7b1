"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* The surface: ``all_cells`` and the skip records, ``input_specs`` of
  every runnable cell, ``probe_depths``, ``with_depth`` and the presets,
  against the reference's own functions, which ``dryrun_reference.py``
  runs in a subprocess (importing ``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` for 512 host devices before jax loads, which this
  process must not do).
* The records, cell by cell, against the reference's records of the same
  cells from that subprocess.  Two changes to the reference's run are
  made there and nowhere in ``src/repro``: its production mesh is built
  with ``Auto`` axes (jax 0.9's ``jax.make_mesh`` gives ``Explicit``
  ones, which the reference's ``with_sharding_constraint`` refuses, so
  its dry run fails at HEAD), and it runs with ``scan_layers=False``
  (with a scanned layer body XLA counts one layer whatever the depth;
  the port's Python loop counts every layer).  Held exactly: the
  argument bytes, and the output bytes up to XLA's output tuple (8 bytes
  a leaf, a table the port has no counterpart of).  Held to invariants:
  the per-device FLOPs lie between the step's global FLOPs over the
  devices and the global FLOPs, and equal the global FLOPs on one rank.
  Reported, and pinned within 1% so that a change shows: the ratios of
  FLOPs, bytes accessed, transcendentals, temp bytes and collective
  bytes by kind to the reference's (``PERF.md``).
* The counters on one-op cases on a fake (16, 16) group, each against a
  number worked out by hand, and three planted faults that fail them.
* Every assigned config's decode_32k and prefill_32k at depth 2 on the
  256-rank mesh, which needs the logits mask to work on the
  unembedding's partial sum.
"""
import dataclasses
import json
import os
import subprocess
import sys
from functools import lru_cache

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED as R_ASSIGNED

from repro_torch.configs import ASSIGNED, get_config, get_shape
from repro_torch.distributed import shard_plan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import tree_map
from repro_torch.training import trainer as trainer_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

PRESET = "baseline"
#: (arch, shape, multi_pod) held to the reference's records, each at its
#: first probe depth under PRESET
PARITY = [
    ("qwen3-14b", "train_4k", False),
    ("qwen3-14b", "prefill_32k", False),
    ("qwen3-14b", "decode_32k", False),
    ("granite-moe-1b-a400m", "decode_32k", False),
    ("mamba2-130m", "long_500k", False),
    ("zamba2-2.7b", "decode_32k", False),
    ("whisper-base", "prefill_32k", False),
    ("qwen3-14b", "decode_32k", True),
]
#: the port's number over the reference's, per cell and quantity, as
#: PERF.md reports them; ("port", n) where the reference reads 0
RATIOS = {
    "qwen3-14b-train_4k-16x16": {
        "flops": 1.225,
        "bytes accessed": 0.8082,
        "transcendentals": 3.777,
        "temp": 0.2915,
        "all-reduce": 0.2633,
        "all-gather": 0.04552,
        "reduce-scatter": ('port', 5728894976),
        "all-to-all": 0.5375,
        "collective-permute": 0,
    },
    "qwen3-14b-prefill_32k-16x16": {
        "flops": 1.523,
        "bytes accessed": 4.177,
        "transcendentals": 68.78,
        "temp": 0.7774,
        "all-reduce": 0.4,
        "all-gather": 0.03708,
        "reduce-scatter": ('port', 1342177280),
        "all-to-all": 0.5,
        "collective-permute": 0,
    },
    "qwen3-14b-decode_32k-16x16": {
        "flops": 0.7142,
        "bytes accessed": 1.345,
        "transcendentals": 0.9954,
        "temp": 0.7867,
        "all-reduce": 1.36,
        "all-gather": 0.002925,
        "reduce-scatter": ('port', 7946240),
        "all-to-all": 8.5,
        "collective-permute": 0,
    },
    "granite-moe-1b-a400m-decode_32k-16x16": {
        "flops": 0.3534,
        "bytes accessed": 0.4024,
        "transcendentals": 0.9981,
        "temp": 0.2269,
        "all-reduce": 0.3966,
        "all-gather": 0.005297,
        "reduce-scatter": ('port', 4268032),
        "all-to-all": 10.5,
        "collective-permute": 0,
    },
    "mamba2-130m-long_500k-16x16": {
        "flops": 0.3853,
        "bytes accessed": 1.562,
        "transcendentals": 7.789,
        "temp": 2.191,
        "all-reduce": 3.768,
        "all-gather": 0.5444,
        "reduce-scatter": ('port', 192),
        "all-to-all": ('port', 0),
        "collective-permute": 0,
    },
    "zamba2-2.7b-decode_32k-16x16": {
        "flops": 0.6275,
        "bytes accessed": 0.8353,
        "transcendentals": 7.958,
        "temp": 0.6242,
        "all-reduce": 21.77,
        "all-gather": 1.063,
        "reduce-scatter": ('port', 9796608),
        "all-to-all": 11,
        "collective-permute": 0,
    },
    "whisper-base-prefill_32k-16x16": {
        "flops": 2.84,
        "bytes accessed": 3.036,
        "transcendentals": 19.85,
        "temp": 0.2277,
        "all-reduce": 0.5,
        "all-gather": 0.01638,
        "reduce-scatter": ('port', 134217728),
        "all-to-all": ('port', 67108864),
        "collective-permute": 0,
    },
    "qwen3-14b-decode_32k-2x16x16": {
        "flops": 0.6946,
        "bytes accessed": 1.152,
        "transcendentals": 0.9954,
        "temp": 0.6461,
        "all-reduce": 1.36,
        "all-gather": 0.005798,
        "reduce-scatter": ('port', 4055040),
        "all-to-all": 8,
        "collective-permute": 0,
    },
}
RATIO_RTOL = 0.01
#: XLA's output tuple: one 8-byte entry a leaf
TUPLE_ENTRY_BYTES = 8


def _cell_id(cell):
    arch, shape, multi_pod = cell
    return f"{arch}-{shape}-{'2x16x16' if multi_pod else '16x16'}"


# ---------------------------------------------------------------------------
# The reference's run, started with the module and read when a test needs it
# ---------------------------------------------------------------------------
_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_reference")
    cells = work / "cells.json"
    cells.write_text(json.dumps([list(c) + [PRESET] for c in PARITY]))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    log = open(work / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "dryrun_reference.py"),
         str(work / "out.json"), str(cells)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    _REF.update(proc=proc, work=work, log=log)
    try:
        yield
    finally:
        proc.kill()
        proc.wait()
        log.close()
        _REF.clear()


@pytest.fixture(scope="module")
def reference(_reference_process):
    proc, work = _REF["proc"], _REF["work"]
    proc.wait(timeout=600)
    _REF["log"].flush()
    assert proc.returncode == 0, (work / "log.txt").read_text()[-4000:]
    with open(work / "out.json") as f:
        return json.load(f)


def _ref_record(reference, cell):
    arch, shape, multi_pod = cell
    return reference["records"][f"{arch}/{shape}/{multi_pod}/{PRESET}"]


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------
def _depth(arch):
    return dryrun.probe_depths(get_config(arch))[0]


@lru_cache(maxsize=None)
def _port_record(arch, shape, multi_pod):
    return dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                           settings=dryrun.SETTINGS_PRESETS[PRESET],
                           depth_override=_depth(arch))


def _model(arch):
    cfg = dryrun.with_depth(get_config(arch), _depth(arch))
    return zoo.build(cfg, tp=16, settings=dryrun.SETTINGS_PRESETS[PRESET])


def _rules(shape, multi_pod):
    return shard_plan.default_rules(multi_pod=multi_pod,
                                    seq_parallel=shape == "long_500k")


def _grad_mode(shape):
    return torch.enable_grad() if get_shape(shape).kind == "train" \
        else torch.no_grad()


@lru_cache(maxsize=None)
def _global_flops(arch, shape):
    """``FlopCounterMode``'s count of the cell's step on unplaced meta
    tensors, no sharding plan installed."""
    step, args, _ = dryrun.cell_step(_model(arch), shape,
                                     _rules(shape, False))
    with _grad_mode(shape), FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


def _one_rank_flops(arch, shape, multi_pod):
    """The port's per-device FLOPs of the cell's step on a one-rank mesh
    of the cell's axes."""
    model, rules = _model(arch), _rules(shape, multi_pod)
    with dryrun.fake_world(1):
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        mesh = init_device_mesh("cpu", (1,) * len(axes),
                                mesh_dim_names=axes)
        step, args, specs = dryrun.cell_step(model, shape, rules)
        args = dryrun.place(args, mesh, specs)
        with _grad_mode(shape):
            _, _, cost, _, _, _ = dryrun.measure(step, args, mesh=mesh,
                                                 rules=rules)
    return cost["flops"]


def _flop_violations(local, global_, n_devices):
    """The FLOP invariants a per-device count must keep."""
    out = []
    if not local >= global_ / n_devices:
        out.append(f"{local} < global {global_} / {n_devices}")
    if not local <= global_:
        out.append(f"{local} > global {global_}")
    return out


# ---------------------------------------------------------------------------
# The counters on one-op cases, a fake (16, 16) group
# ---------------------------------------------------------------------------
@pytest.fixture
def mesh16():
    with dryrun.fake_world(256):
        yield make_production_mesh(device="cpu")


def _meta_dtensor(shape, mesh, placements, dtype=torch.float32):
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements)


def _partial(local_shape, mesh, placements, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype,
                                          device="meta"),
                              mesh, placements, run_check=False)


def _matmul_flops(mesh, counter_cls=dryrun.Counter):
    """A bf16 (128·512, 4096) @ (4096, 4096), the batch over "data" and
    the weight's rows over "model"."""
    x = _meta_dtensor((128 * 512, 4096), mesh, [Shard(0), Replicate()],
                      torch.bfloat16)
    w = _meta_dtensor((4096, 4096), mesh, [Replicate(), Shard(0)],
                      torch.bfloat16)
    counter = counter_cls()
    with counter:
        x @ w
    return counter.flops


#: each device multiplies its (8·512, 256) share of x by its (256, 4096)
#: rows of w (the product a partial sum over "model")
MATMUL_LOCAL_FLOPS = 2 * (128 * 512 // 16) * (4096 // 16) * 4096


def _collectives(fn):
    counter = dryrun.Counter()
    with dryrun._alltoall_as_one(counter), counter:
        out = fn()
    return counter.collectives_record(), out


def _only(record, kind):
    return {k: v for k, v in record.items()
            if k != "total_bytes" and v["count"]} == {kind: record[kind]}


def test_counts_a_matmul_at_its_local_shapes(mesh16):
    assert _matmul_flops(mesh16) == MATMUL_LOCAL_FLOPS == 8_589_934_592


def _fsdp_all_gather(mesh):
    """A bf16 (4096, 4096) weight's rows over "data", gathered whole."""
    w = _meta_dtensor((4096, 4096), mesh, [Shard(0), Replicate()],
                      torch.bfloat16)
    return _collectives(lambda: w.redistribute(mesh, [Replicate()] * 2))


def test_counts_an_fsdp_all_gather_at_its_result(mesh16):
    record, out = _fsdp_all_gather(mesh16)
    assert out.to_local().shape == (4096, 4096)
    assert _only(record, "all-gather")
    assert record["all-gather"] == {"count": 1, "bytes": 4096 * 4096 * 2}
    assert record["total_bytes"] == 4096 * 4096 * 2


def test_counts_a_gradient_reduce_scatter_at_its_operand(mesh16):
    """An fp32 (4096, 4096) gradient, a partial sum over "data", scattered
    by rows: each device sends its whole partial sum."""
    g = _partial((4096, 4096), mesh16, [Partial(), Replicate()])
    record, out = _collectives(
        lambda: g.redistribute(mesh16, [Shard(0), Replicate()]))
    assert out.to_local().shape == (256, 4096)
    assert _only(record, "reduce-scatter")
    assert record["reduce-scatter"] == {"count": 1,
                                        "bytes": 4096 * 4096 * 4}


def test_counts_an_all_reduce_of_a_partial_sum(mesh16):
    p = _partial((512, 1024), mesh16, [Replicate(), Partial()])
    record, _ = _collectives(
        lambda: p.redistribute(mesh16, [Replicate()] * 2))
    assert _only(record, "all-reduce")
    assert record["all-reduce"] == {"count": 1, "bytes": 512 * 1024 * 4}


def test_counts_an_all_to_all_not_its_cpu_all_gather(mesh16):
    """Rows over "data" to columns over "data": an all-to-all of the
    device's (16, 64) rows into its (256, 4) columns, which a CPU group
    runs as an all-gather and a chunk."""
    t = _meta_dtensor((256, 64), mesh16, [Shard(0), Replicate()])
    record, out = _collectives(
        lambda: t.redistribute(mesh16, [Shard(1), Replicate()]))
    assert out.to_local().shape == (256, 4)
    assert _only(record, "all-to-all")
    assert record["all-to-all"] == {"count": 1, "bytes": 256 * 4 * 4}


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------
class _GlobalOpCounter(dryrun.Counter):
    """Planted fault: FLOPs counted at the DTensor op, at global shapes
    (a ``FlopCounterMode`` entered above DTensor)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self.flops += self.op_flops(func, args, kwargs or {}, None)
            return NotImplemented
        return super().__torch_dispatch__(func, types, args, kwargs)

    @staticmethod
    def op_flops(func, args, kwargs, out):
        if any(isinstance(a, DTensor) for a in args):
            return dryrun.Counter.op_flops(func, args, kwargs, out)
        return 0


def test_planted_global_op_count_fails(mesh16):
    got = _matmul_flops(mesh16, _GlobalOpCounter)
    assert got == 256 * MATMUL_LOCAL_FLOPS != MATMUL_LOCAL_FLOPS


def test_planted_all_gather_at_its_operand_fails(mesh16, monkeypatch):
    op = torch.ops._c10d_functional.all_gather_into_tensor.default
    monkeypatch.setitem(dryrun._COLLECTIVE_OPS, op, ("all-gather", True))
    record, _ = _fsdp_all_gather(mesh16)
    assert record["all-gather"]["bytes"] == 4096 * 4096 * 2 // 16
    assert record["all-gather"]["bytes"] != 4096 * 4096 * 2


def test_planted_dropped_backward_fails(monkeypatch):
    """A train cell whose step never runs the backward (the gradients
    zeros) reads fewer FLOPs a device than the whole step spread over
    every device."""
    def forward_only(model, params, batch):
        with torch.no_grad():
            loss, metrics = zoo.loss_fn(model, params, batch)
        return (loss, metrics), tree_map(torch.zeros_like, params)

    arch, shape, _ = PARITY[0]
    monkeypatch.setattr(trainer_mod, "value_and_grad", forward_only)
    planted = dryrun.run_cell(arch, shape, multi_pod=False,
                              settings=dryrun.SETTINGS_PRESETS[PRESET],
                              depth_override=_depth(arch))
    monkeypatch.undo()
    sound = _port_record(arch, shape, False)
    global_ = _global_flops(arch, shape)
    assert not _flop_violations(sound["cost"]["flops"], global_, 256)
    assert _flop_violations(planted["cost"]["flops"], global_, 256)


# ---------------------------------------------------------------------------
# Every assigned config's serving cells at depth 2 (the logits mask)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_config_traces_its_serving_cells(arch, shape):
    # depth 2; a hybrid's comes in whole groups of attn_period
    assert _depth(arch) == (get_config(arch).attn_period
                            if arch == "zamba2-2.7b" else 2)
    rec = _port_record(arch, shape, False)
    assert "error" not in rec and "skipped" not in rec, rec
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The surface against the reference's
# ---------------------------------------------------------------------------
def test_all_cells_and_skips(reference):
    assert list(ASSIGNED) == list(R_ASSIGNED)
    assert [list(c) for c in dryrun.all_cells()] == reference["cells"]
    assert len(reference["cells"]) == 40 and len(reference["skips"]) == 8
    for arch, shape in dryrun.all_cells():
        key = f"{arch}/{shape}"
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              settings=dryrun.SETTINGS_PRESETS[PRESET]) \
            if key in reference["skips"] else None
        if rec is not None:
            assert rec == reference["skips"][key]
        else:
            assert key in reference["input_specs"], key
    assert len(reference["input_specs"]) == 32


def test_presets_and_tables(reference):
    assert {k: dataclasses.asdict(v)
            for k, v in dryrun.SETTINGS_PRESETS.items()} == \
        reference["presets"]
    assert dryrun.DTYPE_BYTES == reference["dtype_bytes"]
    assert list(dryrun.COLLECTIVES) == reference["collective_kinds"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_probe_depths_and_with_depth(reference, arch):
    cfg = get_config(arch)
    depths = dryrun.probe_depths(cfg)
    assert list(depths) == reference["probe_depths"][arch]
    for n in depths:
        got = json.loads(json.dumps(dataclasses.asdict(
            dryrun.with_depth(cfg, n)), default=str))
        assert got == reference["with_depth"][arch][str(n)]


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    assert tree.is_meta
    return [list(tree.shape), str(tree.dtype).replace("torch.", "")]


def test_input_specs_match_reference(reference):
    """Keys, shapes and dtypes of every runnable cell's inputs, meta
    tensors (nothing allocated)."""
    for key, want in reference["input_specs"].items():
        arch, shape = key.split("/")
        model = zoo.build(get_config(arch), tp=16)
        assert _spec_tree(dryrun.input_specs(model, shape)) == want, key


# ---------------------------------------------------------------------------
# The records against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_record_layout(reference, cell):
    got, want = _port_record(*cell), _ref_record(reference, cell)
    assert set(got) == set(want)
    for k in ("arch", "shape", "mesh", "n_devices", "seq_parallel",
              "grad_compression"):
        assert got[k] == want[k], k
    assert got["settings"] == dataclasses.asdict(
        dryrun.SETTINGS_PRESETS[PRESET])
    assert want["settings"] == dict(got["settings"], scan_layers=False)
    assert set(got["memory"]) == set(want["memory"])
    assert set(got["cost"]) == set(want["cost"])
    assert set(got["collectives"]) == set(want["collectives"])
    assert got["compile_s"] == 0.0 and got["lower_s"] > 0
    assert got["memory"]["generated_code_size_in_bytes"] == 0
    assert got["collectives"]["total_bytes"] == sum(
        got["collectives"][k]["bytes"] for k in dryrun.COLLECTIVES)


#: cache leaves a prefill replaces without reading them: the length, and
#: an encoder-decoder model's cross-attention K/V, written whole
UNREAD_IN_PREFILL = ("len", "xk", "xv")


def _unread_argument_bytes(cell):
    """The local bytes of the arguments the reference's executable leaves
    out: ``jax.jit`` drops an input the step never reads
    (``keep_unused=False``), which a prefill's UNREAD_IN_PREFILL are."""
    arch, shape, multi_pod = cell
    if get_shape(shape).kind != "prefill":
        return 0
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        _, args, specs = dryrun.cell_step(_model(arch), shape,
                                          _rules(shape, multi_pod))
        cache = dryrun.place(args, mesh, specs)[2]
        return dryrun.local_bytes([cache[k] for k in UNREAD_IN_PREFILL
                                   if k in cache])


@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_argument_bytes_equal_reference(reference, cell):
    got = _port_record(*cell)["memory"]["argument_size_in_bytes"]
    want = _ref_record(reference, cell)["memory"]["argument_size_in_bytes"]
    assert got - _unread_argument_bytes(cell) == want


def _output_leaves(cell):
    """The step's output leaves: the last logits and the cache's arrays,
    or the master tree, AdamW's mu, nu and step, the residual and three
    metrics."""
    arch, shape, multi_pod = cell
    model = _model(arch)
    if get_shape(shape).kind == "train":
        return 3 * len(list(_leaves(zoo.param_specs(model)))) + 1 + 1 + 3
    b = get_shape(shape).global_batch
    return 1 + len(zoo.cache_specs(model, b, 8))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_output_bytes_equal_reference_but_the_tuple(reference, cell):
    """The output leaves' bytes are the reference's; XLA's count adds its
    output tuple, an 8-byte entry a leaf."""
    got = _port_record(*cell)["memory"]["output_size_in_bytes"]
    want = _ref_record(reference, cell)["memory"]["output_size_in_bytes"]
    assert want - got == TUPLE_ENTRY_BYTES * _output_leaves(cell)


@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_flops_lie_between_global_over_devices_and_global(cell):
    arch, shape, multi_pod = cell
    rec = _port_record(*cell)
    assert not _flop_violations(rec["cost"]["flops"],
                                _global_flops(arch, shape),
                                rec["n_devices"])


@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_one_rank_flops_equal_global(cell):
    arch, shape, multi_pod = cell
    assert _one_rank_flops(arch, shape, multi_pod) == \
        _global_flops(arch, shape)


def _ratios(got, want):
    out = {}
    pairs = [(k, got["cost"][k], want["cost"][k])
             for k in ("flops", "bytes accessed", "transcendentals")]
    pairs.append(("temp", got["memory"]["temp_size_in_bytes"],
                  want["memory"]["temp_size_in_bytes"]))
    pairs += [(k, got["collectives"][k]["bytes"],
               want["collectives"][k]["bytes"]) for k in dryrun.COLLECTIVES]
    for k, a, b in pairs:
        out[k] = a / b if b else ("port", a)
    return out


@pytest.mark.parametrize("cell", PARITY, ids=_cell_id)
def test_reported_ratios_are_pinned(reference, cell):
    """FLOPs, bytes accessed, transcendentals, temp bytes and collective
    bytes by kind are not forced to the reference's (the port counts
    matrix products only, runs unfused, and DTensor chooses its own
    collectives); their ratios are the ones PERF.md reports."""
    got = _ratios(_port_record(*cell), _ref_record(reference, cell))
    want = RATIOS[_cell_id(cell)]
    assert set(got) == set(want)
    for k, r in got.items():
        if isinstance(want[k], tuple):
            # the reference reads 0: the port's own number is pinned
            assert r[0] == "port" and r[1] == pytest.approx(
                want[k][1], rel=RATIO_RTOL, abs=0), (k, r)
        else:
            assert r == pytest.approx(want[k], rel=RATIO_RTOL), (k, r)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------
def test_cli_writes_its_records_and_trace(tmp_path, monkeypatch):
    """``main`` writes each record under ``--out`` by the reference's tag,
    never under results/dryrun/ (the reference's), and ``--save-hlo`` the
    op-level trace with local shapes and placements."""
    assert dryrun.DEFAULT_OUT == os.path.join("results", "dryrun_torch")
    trace = tmp_path / "trace.txt"
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "mamba2-130m", "--shape", "long_500k",
        "--out", str(tmp_path / "out"), "--save-hlo", str(trace)])
    with pytest.raises(SystemExit) as exit_:
        dryrun.main()
    assert exit_.value.code == 0
    rec = json.loads((tmp_path / "out" /
                      "mamba2-130m_long_500k_single_baseline.json")
                     .read_text())
    assert rec["seq_parallel"] is True and "error" not in rec
    assert rec["settings"]["scan_layers"] is True
    lines = trace.read_text().splitlines()
    assert any("S(" in line for line in lines if not line.startswith(" "))
    assert any(line.startswith("  aten.mm") and "flops=" in line
               for line in lines)
