"""CUDA graphs of the serving engine's steps: the port's counterpart of
the reference's ``jax.jit`` on each step.

The reference compiles each per-step function and dispatches it as one
program; the port captures each step as a CUDA graph at its first use
and replays it from then on, one graph per key (the decode step; the
prefill forward of each power-of-two bucket).  A step function reads
its inputs from static tensors that the caller refills in place before
every call, and writes persistent state (the page store, the slot
cache) in place, so a replay reads and writes the addresses that were
captured.

First use of a key runs the step eagerly on the graphs' own stream (the
real step, whose outputs that call returns): that builds the kernels,
encodes the flash kernel's first TMA maps and makes the paged kernel's
merge counters for the stream, all outside the capture.  It then
captures the step (a capture launches nothing, so the step's writes to
persistent state happen once).  Later calls replay the graph and return
its static outputs, which the next replay of the same graph overwrites:
read them before that.  The graphs of one ``StepGraphs`` share a memory
pool; each graph's outputs stay alive, so no other graph's capture
reuses their memory.

The kernel wrappers count launches (``kernels.counts``) when their
Python runs, which a replay does not do.  Each graph records the
launches made while it was captured (taking them back out of the
counts: nothing ran) and adds them at every replay, so the counts over
a serving run are the eager run's.

A capture or replay that fails raises; nothing falls back to the eager
step.  Graphs need a CUDA device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import counts
from repro_torch.kernels.paged_attention import ops as paged_ops


def _diff(after, before):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@dataclass
class StepGraph:
    graph: torch.cuda.CUDAGraph
    #: what the step function returned under capture; refilled by replay
    out: Any
    #: the wrappers' launches one replay makes (keys as
    #: ``counts.snapshot``)
    launches: Dict[Hashable, int]
    #: the paged kernel's merge counters the graph was captured with
    tickets: Optional[torch.Tensor]
    capture_seconds: float
    replays: int = 0


class StepGraphs:
    """The CUDA graphs of one engine, by key."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}; "
                             f"the CPU route runs eagerly")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[Hashable, StepGraph] = {}

    def __len__(self) -> int:
        return len(self.graphs)

    @property
    def capture_seconds(self) -> float:
        return sum(g.capture_seconds for g in self.graphs.values())

    def run(self, key: Hashable, step: Callable[[], Any]):
        """Replay the graph of ``key``; at its first use, run ``step``
        eagerly and capture it."""
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, step)
        g.graph.replay()
        g.replays += 1
        counts.add(g.launches)
        return g.out

    def _capture(self, key, step):
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = step()
        before = counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            static = step()
        launches = _diff(counts.snapshot(), before)
        counts.add(launches, -1)
        current.wait_stream(self.stream)
        tickets = paged_ops.take_ticket_counters(self.device,
                                                 self.stream.cuda_stream)
        self.graphs[key] = StepGraph(graph, static, launches, tickets,
                                     time.perf_counter() - t0)
        return out
