"""Multi-pod dry run: trace every (arch × shape × mesh) cell: the port of
``repro.launch.dryrun``.

Proves the distribution plan is coherent without hardware: a fake process
group of 256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``,
one process, no collective moves data) spans the production mesh, the
full-size model's parameters, optimizer state, batch and cache are meta
tensors placed by the plan's specs (nothing is allocated), and the real
train, prefill or decode step runs on them under the plan's rules.  This
entry point runs on no device by design; every other entry point of the
port runs on the CUDA card unless asked for the CPU.

A dispatch mode (``Counter``) sits below DTensor: it lets DTensor
redistribute and split each op, and sees the op that rank 0 runs on its
local shards, and every collective the redistributions issue.  What it
records, per device (rank 0), against what XLA's reports mean in the
reference:

* ``cost.flops``: ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention) at the local shapes; XLA's
  ``cost_analysis()["flops"]`` also counts elementwise and reduction
  work, so the two differ by that share.
* ``cost.transcendentals``: the local elements that exp, log, tanh,
  sigmoid, erf and rsqrt touch, and the fused ops built on them (softmax,
  log-softmax, logsumexp, SiLU, GELU, softplus); XLA counts the same
  functions' elements after fusion.
* ``cost["bytes accessed"]``: each op's local tensor operands read once
  and its new outputs written once (views, empty allocations and
  collectives move nothing here); XLA counts the operands and results of
  the fused HLO ops, so an unfused eager step reads more.
* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: the
  local bytes of every input / output leaf (XLA pads an uneven dim to the
  ceiling; DTensor gives rank 0 the ceiling).
  ``alias_size_in_bytes``: the outputs that share storage with an input
  (the port's AdamW and cache writes work in place; the reference
  donates nothing, so it reads 0).  ``temp_size_in_bytes``: the peak of
  the live local bytes that the step itself allocated and does not
  return, from the storages this mode sees created and freed (XLA's:
  its temporary buffers).  ``generated_code_size_in_bytes``: 0, as the
  reference reads on the CPU.
* ``collectives``: every ``_c10d_functional`` collective on its local
  tensors by the reference's convention (an all-gather at its result, a
  reduce-scatter at its operand, an all-reduce, all-to-all or
  collective-permute at its result).  DTensor runs an all-to-all on a CPU
  group as an all-gather and a chunk; it is counted as the all-to-all.

``lower_s`` is the time of the traced step; ``compile_s`` is 0.0, since
nothing is compiled.  The port runs its layers in a Python loop, so every
count is the reference's unrolled (``scan_layers=False``) count; the
record keeps ``settings`` as given.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      --mesh single --settings baseline --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED, LM_SHAPES, get_config, get_shape,
                                 shape_applicable)
from repro_torch.configs.base import PREFILL, TRAIN
from repro_torch.distributed import shard_plan
from repro_torch.distributed.api import shard, use_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.models.common import RunSettings, tree_map
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, make_train_step

SETTINGS_PRESETS = {
    # paper-faithful baseline: full-rectangle blocked attention, dense
    # (every-expert) MoE, full remat
    "baseline": RunSettings(attn_impl="blocked", moe_impl="dense_onehot",
                            remat="full", scan_layers=True),
    # causal-triangle attention + matmul-output-saving remat
    "optimized": RunSettings(attn_impl="blocked_causal",
                             moe_impl="dense_onehot",
                             remat="dots_saveable", scan_layers=True),
    # serving variant: weights replicated over "data" (no ZeRO-3
    # all-gathers at inference)
    "optimized_serve": RunSettings(attn_impl="blocked_causal",
                                   remat="none", scan_layers=True,
                                   fsdp_params=False),
}

#: the reference's table of HLO element sizes (its collective parser reads
#: it); the port reads sizes from its tensors and keeps the table as part
#: of the same surface
DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "s32": 4,
               "u64": 8, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "c64": 8, "c128": 16}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

DEFAULT_OUT = os.path.join("results", "dryrun_torch")


# ---------------------------------------------------------------------------
# Input specs (meta tensors: never allocated)
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(model: zoo.Model, shape_name: str):
    """Returns {"batch"/"cache"/"tokens": meta tensors} per shape kind."""
    cfg = model.cfg
    shape = get_shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if shape.kind in (TRAIN, PREFILL):
        batch = {"tokens": _meta((b, s), torch.int32)}
        if shape.kind == TRAIN:
            batch["labels"] = _meta((b, s), torch.int32)
        if cfg.family in ("audio", "encdec"):
            batch["embeds"] = _meta((b, cfg.enc_seq_len, cfg.d_model),
                                    torch.float32)
        out["batch"] = batch
        if shape.kind == PREFILL:
            out["cache"] = zoo.cache_specs(model, b, s)
    else:  # decode: one new token against a cache of seq_len
        out["tokens"] = _meta((b,), torch.int32)
        out["cache"] = zoo.cache_specs(model, b, s)
    return out


# ---------------------------------------------------------------------------
# The per-device counters
# ---------------------------------------------------------------------------
_c10d = torch.ops._c10d_functional
#: collective op -> (kind, counted at its operand rather than its result)
_COLLECTIVE_OPS = {
    _c10d.all_gather_into_tensor.default: ("all-gather", False),
    _c10d.all_gather_into_tensor_coalesced.default: ("all-gather", False),
    _c10d.reduce_scatter_tensor.default: ("reduce-scatter", True),
    _c10d.reduce_scatter_tensor_coalesced.default: ("reduce-scatter", True),
    _c10d.all_reduce.default: ("all-reduce", False),
    _c10d.all_reduce_coalesced.default: ("all-reduce", False),
    _c10d.all_to_all_single.default: ("all-to-all", False),
}
#: functional-collective bookkeeping that moves nothing
_COLLECTIVE_NOOPS = ("wait_tensor", "_wrap_tensor_autograd")
#: fused or plain transcendental ops, counted by their input's elements
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "tanh",
    "tanh_", "sigmoid", "sigmoid_", "erf", "rsqrt", "rsqrt_", "silu",
    "silu_", "gelu", "softplus", "_softmax", "_log_softmax", "logsumexp"}
#: ops that allocate without writing, or only read metadata: no bytes
#: accessed (an allocation still counts toward the live bytes)
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "lift_fresh", "_local_scalar_dense",
            "is_same_size"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree):
    """The tensors in a tree of lists, tuples and dicts, in order (no
    recursive closure: its reference cycle would keep them alive until
    a collection)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _describe(t) -> str:
    dt = str(t.dtype).replace("torch.", "")
    text = f"{dt}{list(t.shape)}"
    if isinstance(t, DTensor):
        text += "{" + ",".join(str(p) for p in t.placements) + "}"
    return text


def local_bytes(tree) -> int:
    """The bytes rank 0 holds of every tensor leaf of ``tree``."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """Per-device FLOPs, transcendentals, bytes, collectives and live
    bytes of the ops rank 0 runs.  An op on DTensors is handed back to
    DTensor (``NotImplemented``), which redistributes its operands and
    runs the local op with this mode still active, so the mode counts
    the local op and the collectives; DTensor's sharding propagation
    runs each op once more at global shapes under a fake-tensor mode,
    which is not counted."""

    def __init__(self, trace: bool = False):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVES}
        self.trace = [] if trace else None
        self._seq = 0
        self._live = {}          # storage key -> (seq, bytes)
        self._events = []        # (seq, +bytes / -bytes)
        self._in_alltoall = 0

    # -- collectives ---------------------------------------------------
    def count_collective(self, kind: str, nbytes: int, what: str):
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += nbytes
        if self.trace is not None:
            self.trace.append(f"  {kind} {nbytes} B ({what})")

    def collectives_record(self):
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out

    # -- live bytes ------------------------------------------------------
    def _track(self, outs, ins):
        seen = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in seen or key in self._live:
                continue
            seen.add(key)
            nbytes = t.untyped_storage().nbytes()
            self._seq += 1
            self._live[key] = (self._seq, nbytes)
            self._events.append((self._seq, nbytes))
            weakref.finalize(t.untyped_storage(), self._free, key)

    def _free(self, key):
        seq, nbytes = self._live.pop(key, (None, 0))
        if seq is not None:
            self._events.append((seq, -nbytes))

    def temp_bytes(self, outputs) -> int:
        """The peak of live bytes the step allocated, leaving out the
        storages it returns."""
        kept = {self._live[_storage_key(t)][0]
                for t in map(_local, _tensors(outputs))
                if _storage_key(t) in self._live}
        live = peak = 0
        for seq, delta in self._events:
            if seq not in kept:
                live += delta
                peak = max(peak, live)
        return peak

    # -- dispatch ---------------------------------------------------------
    @staticmethod
    def op_flops(func, args, kwargs, out) -> int:
        """``torch.utils.flop_counter``'s FLOPs of one op at the shapes of
        its arguments (0 for an op it has no formula for)."""
        formula = flop_registry.get(func._overloadpacket)
        return 0 if formula is None else formula(*args, **kwargs,
                                                 out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.trace is not None:
                self.trace.append(f"{func} " + ", ".join(
                    _describe(t) for t in _tensors((args, kwargs))))
            return NotImplemented
        if torch._guards.detect_fake_mode() is not None:
            # DTensor's sharding propagation at global shapes
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            out = func(*args, **kwargs)
            if name not in _COLLECTIVE_NOOPS and not self._in_alltoall:
                if func not in _COLLECTIVE_OPS:
                    raise NotImplementedError(f"no count rule for {func}")
                kind, at_operand = _COLLECTIVE_OPS[func]
                nbytes = sum(map(_nbytes, _tensors(
                    args[0] if at_operand else out)))
                self.count_collective(kind, nbytes, str(func))
            self._track(_tensors(out), _tensors(args))
            return out
        if func.namespace == "_dtensor" and name == "shard_dim_alltoall":
            out = func(*args, **kwargs)
            if not self._in_alltoall:
                self.count_collective("all-to-all", _nbytes(out), str(func))
            self._track([out], _tensors(args))
            return out
        # a composite op is counted through its parts, as FlopCounterMode
        # counts it
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops = self.op_flops(func, args, kwargs, out)
        self.flops += flops
        if name in _TRANSCENDENTAL and ins:
            self.transcendentals += ins[0].numel() + (
                outs[0].numel() if name == "logsumexp" else 0)
        if not func.is_view:
            if name not in _NO_DATA:
                in_keys = {_storage_key(t) for t in ins}
                self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                    _nbytes(t) for t in outs
                    if _storage_key(t) not in in_keys)
            self._track(outs, ins)
        if self.trace is not None:
            self.trace.append(
                f"  {func} " + ", ".join(_describe(t) for t in ins)
                + " -> " + ", ".join(_describe(t) for t in outs)
                + (f" flops={flops}" if flops else ""))
        return out


@contextmanager
def _alltoall_as_one(counter: Counter):
    """Count DTensor's all-to-all where it chooses one: on a CPU group it
    runs an all-gather and a chunk, which would otherwise count as the
    all-gather.  Patches ``shard_dim_alltoall`` where DTensor's
    placements call it; without it (another torch) nothing changes."""
    from torch.distributed.tensor import placement_types
    real = getattr(placement_types, "shard_dim_alltoall", None)
    if real is None:
        yield
        return

    def counted(input, *args, **kw):
        counter._in_alltoall += 1
        try:
            out = real(input, *args, **kw)
        finally:
            counter._in_alltoall -= 1
        counter.count_collective("all-to-all", _nbytes(out),
                                 "shard_dim_alltoall")
        return out

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


def measure(step, args, *, mesh, rules, trace=False):
    """Run ``step(*args)`` under ``use_rules(mesh, rules)`` and
    ``Counter``; returns (outputs, the record's ``memory``, ``cost`` and
    ``collectives``, the traced seconds, the trace lines)."""
    arg_keys = {_storage_key(_local(t)) for t in _tensors(args)}
    arg_bytes = local_bytes(args)
    counter = Counter(trace=trace)
    # storages free as their last reference goes, never at a collection
    # that happens to fall inside the step: the temp bytes repeat
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with use_rules(mesh, rules), _alltoall_as_one(counter), counter:
            out = step(*args)
    finally:
        if collecting:
            gc.enable()
    seconds = time.perf_counter() - t0
    outs = _tensors(out)
    memory = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": local_bytes(outs),
        "temp_size_in_bytes": counter.temp_bytes(outs),
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": sum(
            _nbytes(_local(t)) for t in outs
            if _storage_key(_local(t)) in arg_keys),
    }
    cost = {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed),
            "transcendentals": float(counter.transcendentals)}
    return out, memory, cost, counter.collectives_record(), seconds, \
        counter.trace


# ---------------------------------------------------------------------------
# Depth probing (roofline counting mode)
# ---------------------------------------------------------------------------
def probe_depths(cfg):
    """Two reduced depths (a < b) per family for finite-difference layer
    accounting: per-layer cost = (f(b)-f(a))/(b-a), constant part =
    f(b) - b*layer, total = constant + L*layer."""
    if cfg.family == "hybrid":
        p = cfg.attn_period or 1
        return p, 2 * p
    if cfg.family in ("audio", "encdec"):
        return 2, 4            # scales n_enc and n_dec together
    return 2, 4


def with_depth(cfg, n: int):
    kw = {"num_layers": n}
    if cfg.family in ("audio", "encdec"):
        frac_e = cfg.n_enc_layers / cfg.num_layers
        kw = {"num_layers": n,
              "n_enc_layers": max(1, round(n * frac_e)),
              "n_dec_layers": n - max(1, round(n * frac_e))}
    return cfg.with_overrides(**kw)


# ---------------------------------------------------------------------------
# The cell's step
# ---------------------------------------------------------------------------
def cell_step(model: zoo.Model, shape_name: str, rules, *,
              grad_compression: bool = False):
    """The step of ``shape_name``'s kind with its unplaced meta inputs:
    (step, args, arg_specs), ``arg_specs`` the plan's specs of each
    argument under ``rules``.  The reference's three branches: TRAIN is
    ``make_train_step`` over the master tree, AdamW state and residual;
    PREFILL is ``zoo.prefill``, keeping the last position's logits;
    DECODE is ``zoo.decode_step``.  Under rules the logits come back
    placed as the reference's ``out_shardings`` place them."""
    kind = get_shape(shape_name).kind
    specs = input_specs(model, shape_name)
    params = zoo.param_specs(model, master=True)
    pspecs = shard_plan.param_pspecs(model)
    if kind == TRAIN:
        step = make_train_step(model, TrainConfig(
            opt=AdamWConfig(), grad_compression=grad_compression))
        f32 = lambda: tree_map(  # noqa: E731
            lambda p: _meta(p.shape, torch.float32), params)
        opt = {"mu": f32(), "nu": f32(), "step": _meta((), torch.int32)}
        ef = f32() if grad_compression else {"_": _meta((), torch.float32)}
        args = (params, opt, ef, specs["batch"])
        arg_specs = (pspecs, shard_plan.opt_pspecs(model),
                     shard_plan.ef_pspecs(model, grad_compression),
                     shard_plan.batch_pspecs(specs["batch"], rules))
        return step, args, arg_specs
    cache_specs = shard_plan.cache_pspecs(model, rules)
    if kind == PREFILL:
        def prefill_step(params, batch, cache):
            logits, cache = zoo.prefill(model, params, batch, cache)
            return shard(logits[:, -1], "batch", "vocab"), cache   # last

        return prefill_step, (params, specs["batch"], specs["cache"]), \
            (pspecs, shard_plan.batch_pspecs(specs["batch"], rules),
             cache_specs)
    return serve_step(model), (params, specs["cache"], specs["tokens"]), \
        (pspecs, cache_specs, rules.spec("batch"))


def serve_step(model: zoo.Model):
    """The DECODE branch's step: ``zoo.decode_step``, its logits placed
    as the reference's ``out_shardings`` place them."""
    def step(params, cache, tokens):
        logits, cache = zoo.decode_step(model, params, cache, tokens)
        return shard(logits, "batch", "vocab"), cache

    return step


def place(args, mesh, arg_specs):
    """Each argument tree placed on ``mesh`` by its specs."""
    def one(tree, specs):
        if isinstance(tree, torch.Tensor):
            return shard_plan.distribute({"x": tree}, mesh, {"x": specs})["x"]
        return shard_plan.distribute(tree, mesh, specs)
    return tuple(one(a, s) for a, s in zip(args, arg_specs))


@contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) unless
    one is running, which must then have ``n`` ranks; destroys only a
    group it started."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is running; this mesh needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             settings: RunSettings, grad_compression: bool = False,
             seq_parallel: bool | None = None,
             save_hlo: str | None = None,
             depth_override: int | None = None) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    if depth_override is not None:
        cfg = with_depth(cfg, depth_override)

    model = zoo.build(cfg, tp=16, settings=settings)
    if seq_parallel is None:
        seq_parallel = (shape_name == "long_500k")
    rules = shard_plan.default_rules(multi_pod=multi_pod,
                                     seq_parallel=seq_parallel)
    n_devices = 512 if multi_pod else 256
    with fake_world(n_devices):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        step, args, arg_specs = cell_step(model, shape_name, rules,
                                          grad_compression=grad_compression)
        args = place(args, mesh, arg_specs)
        grad = torch.enable_grad() if shape.kind == TRAIN \
            else torch.no_grad()
        with grad:
            _, memory, cost, coll, seconds, lines = measure(
                step, args, mesh=mesh, rules=rules,
                trace=save_hlo is not None)
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.write("\n".join(lines) + "\n")

    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_devices,
        "settings": dataclasses.asdict(settings),
        "seq_parallel": seq_parallel,
        "grad_compression": grad_compression,
        "lower_s": round(seconds, 2), "compile_s": 0.0,
        "memory": memory,
        "cost": cost,
        "collectives": coll,
    }


# ---------------------------------------------------------------------------
def all_cells():
    for arch in ASSIGNED:
        for shape in LM_SHAPES:
            yield arch, shape.name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--settings", default="baseline")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seq-parallel", type=int, default=-1,
                    help="-1 auto (long_500k only), 0 off, 1 on")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", default=None,
                    help="there is no HLO: writes the op-level trace the "
                         "counters saw to this file, one line an op with "
                         "its local shapes and placements")
    ap.add_argument("--depth-probe", action="store_true",
                    help="roofline counting mode: trace each cell at two "
                         "reduced depths for finite-difference layer "
                         "accounting")
    args = ap.parse_args()

    settings = SETTINGS_PRESETS[args.settings] \
        if args.settings in SETTINGS_PRESETS else \
        RunSettings(**json.loads(args.settings))
    os.makedirs(args.out, exist_ok=True)

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            depths = [None]
            if args.depth_probe:
                depths = list(probe_depths(get_config(arch)))
            for depth in depths:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}" \
                      f"_{args.settings if args.settings in SETTINGS_PRESETS else 'custom'}"
                if depth is not None:
                    tag += f"_d{depth}"
                try:
                    sp = None if args.seq_parallel < 0 \
                        else bool(args.seq_parallel)
                    res = run_cell(arch, shape, multi_pod=mp,
                                   settings=settings,
                                   grad_compression=args.grad_compression,
                                   seq_parallel=sp, save_hlo=args.save_hlo,
                                   depth_override=depth)
                    if depth is not None:
                        res["depth_override"] = depth
                    status = "SKIP" if "skipped" in res else "OK"
                except Exception as e:                     # noqa: BLE001
                    res = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    status = "FAIL"
                    failures += 1
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if status == "OK":
                    extra = (f" lower={res['lower_s']}s "
                             f"flops={res['cost'].get('flops', 0):.3e} "
                             f"coll={res['collectives']['total_bytes']:.3e}B")
                print(f"[{status}] {tag}{extra}", flush=True)
                if status == "SKIP":
                    break                      # skip both depths
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
