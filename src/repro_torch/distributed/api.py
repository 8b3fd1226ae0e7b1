"""Logical-axis sharding API: the port of ``repro.distributed.api`` on
``torch.distributed`` DTensor.

Models never mention mesh axes; they annotate activations with *logical*
axis names via ``shard(x, "batch", "seq", "heads", None)``.  A rule set
(installed with ``use_rules``) maps logical names to mesh axes; with no
rules installed every call returns its input, so the unsharded paths
(and the CUDA graphs) never touch the mesh machinery.

A ``PartitionSpec`` here is what JAX's is: one entry per tensor dim,
each ``None`` (replicated), a mesh-axis name, or a tuple of names (one
tensor dim sharded over several mesh dims, major to minor).
``placements(mesh, spec)`` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` where the spec names that mesh dim at tensor dim
``d``, ``Replicate()`` elsewhere.  DTensor shards a tensor dim over
several mesh dims in mesh order, so a tuple entry must list its axes in
that order, which is the order every rule set of the repo uses.

Under ``use_rules`` plain tensors that meet DTensors (positions, head
masks, constants) are read as replicated, as JAX reads an unannotated
constant (``implicit_replication``).  ``local`` runs a function that
DTensor has no sharding rule for (the port's kernels) on each rank's
local shards.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor; compares as the tuple of its
    entries.  A one-axis tuple entry is stored as the axis's name, as
    JAX's ``PartitionSpec`` stores it."""

    def __new__(cls, *axes: MeshAxes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis name -> mesh axis (or tuple, or None)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        return P(*(self.get(a) for a in logical))


def make_rules(**kw: MeshAxes) -> AxisRules:
    return AxisRules(tuple(sorted(kw.items())))


#: Default logical-axis vocabulary (see shard_plan.py for parameter rules):
#:   batch     — request/example axis            -> data (+pod)
#:   seq       — sequence axis of activations    -> None (SP: "data")
#:   kv_seq    — KV-cache sequence axis          -> None (SP for long ctx)
#:   heads     — q heads                         -> model
#:   kv_heads  — kv heads (physical, replicated) -> model
#:   ff        — MLP hidden                      -> model
#:   vocab     — vocabulary                      -> model
#:   experts   — MoE expert axis                 -> model (EP)
#:   embed     — d_model of activations          -> None
DEFAULT_LOGICAL = ("batch", "seq", "kv_seq", "heads", "kv_heads", "ff",
                   "vocab", "experts", "embed")


def placements(mesh: DeviceMesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"{spec}: mesh axis {ax!r} is not one of "
                                 f"{names}")
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {dim} must follow "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} is used "
                                 "twice")
            out[i] = Shard(dim)
    return tuple(out)


class _State(threading.local):
    def __init__(self):
        self.mesh: Optional[DeviceMesh] = None
        self.rules: Optional[AxisRules] = None


_STATE = _State()


@contextmanager
def _implicit_replication():
    """``implicit_replication`` that restores the setting it found:
    torch's own switches it off on exit, which would end an enclosing
    ``use_rules``' when a nested one (a layer's recompute) exits.  It
    reads DTensor's private switch, checked on torch 2.11 and 2.13;
    tests/test_torch_sharding.py holds the nesting."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    try:
        with implicit_replication():
            yield
    finally:
        dispatcher._allow_implicit_replication = prev


@contextmanager
def use_rules(mesh: DeviceMesh, rules: AxisRules):
    """Install ``rules`` over ``mesh`` for this thread.  Autograd runs a
    CUDA backward on a thread of its own, which sees no rules: the model
    takes them into remat's recomputes itself, and gives every tensor an
    op saves for the backward as a DTensor (``replicated``), so no
    backward op meets a plain tensor."""
    prev = (_STATE.mesh, _STATE.rules)
    _STATE.mesh, _STATE.rules = mesh, rules
    try:
        with _implicit_replication():
            yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def current_rules() -> Optional[AxisRules]:
    return _STATE.rules


def current_mesh() -> Optional[DeviceMesh]:
    return _STATE.mesh


def shard(x, *logical: Optional[str]):
    """Constrain the sharding of ``x`` by logical axis names: ``x``
    itself without rules, else ``x`` redistributed to the rules'
    placements (a plain tensor read as replicated).  The counterpart of
    ``with_sharding_constraint``: the value never changes."""
    if _STATE.mesh is None or _STATE.rules is None:
        return x
    mesh = _STATE.mesh
    want = placements(mesh, _STATE.rules.spec(*logical))
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, want)


class _PlacedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and \
                tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad


def placed_grad(x):
    """``x`` itself, whose gradient arrives placed as ``x`` is (a partial
    sum reduced first).  DTensor places a backward op's gradient by its
    own rules, and some placements cannot be taken back through the
    forward's ops: a partial sum to the masked partial sum of the
    vocab-parallel lookup, or tokens split over every mesh dim to the
    (batch, seq) view they were flattened from.  ``x`` itself without
    rules or a gradient."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _PlacedGrad.apply(x)


def replicated(x):
    """``x`` replicated on every rank: ``shard(x)`` with every dim left
    whole.  For the constants the model makes (positions' rotations,
    head masks, token ids to gather by)."""
    return shard(x, *(None,) * x.dim())


def axis_size(name: Optional[str]) -> int:
    """The number of shards the installed rules give logical axis
    ``name`` (1 without rules)."""
    mesh, rules = _STATE.mesh, _STATE.rules
    if mesh is None or rules is None:
        return 1
    axes = rules.get(name)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    size = 1
    for ax in axes:
        size *= mesh.size(mesh.mesh_dim_names.index(ax))
    return size


def shard_start(x, dim: int) -> int:
    """The global index along tensor dim ``dim`` of this rank's first
    element of ``x`` (0 for a plain tensor).  DTensor splits a dim as
    ``torch.chunk`` does, mesh dim by mesh dim in mesh order."""
    if not isinstance(x, DTensor):
        return 0
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, length = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // mesh.size(i))
            start += coord[i] * chunk
            length = max(0, min(chunk, length - coord[i] * chunk))
    return start


def local(fn, out_specs, in_specs):
    """``fn`` run on each rank's local shards where one of its positional
    arguments is a DTensor, else ``fn`` itself.

    A logical spec is a tuple of logical names, read through the
    installed rules.  ``in_specs`` holds one per positional argument
    (None for a non-tensor), ``out_specs`` one per output.  The arguments are
    redistributed to their specs, ``fn`` runs on the local tensors, and
    its outputs become DTensors of ``out_specs``.  Keyword arguments
    pass through as they are.  The caller picks specs under which each
    rank's shards make a whole problem of ``fn``'s, e.g. batch rows and
    heads for attention."""
    def call(*args, **kw):
        mesh, rules = _STATE.mesh, _STATE.rules
        if mesh is None or rules is None or not any(
                isinstance(a, DTensor) for a in args):
            return fn(*args, **kw)

        def resolve(spec):
            return None if spec is None \
                else placements(mesh, rules.spec(*spec))

        return local_map(fn, out_placements=tuple(resolve(s)
                                                  for s in out_specs),
                         in_placements=tuple(resolve(s) for s in in_specs),
                         device_mesh=mesh, redistribute_inputs=True)(
                             *args, **kw)

    return call
