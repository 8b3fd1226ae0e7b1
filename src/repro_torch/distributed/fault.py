"""Fault tolerance for scale-out runs.

Training side (real runtime):
  * ``run_with_restarts`` — supervises a training loop; on a (simulated
    or real) failure it restores the latest step-atomic checkpoint and
    continues.  With ``elastic=True`` the restart may build a *smaller*
    mesh (lost pod) and reload with new shardings — the checkpoint layout
    is mesh-agnostic (see training/checkpoint.py).
  * ``StragglerDetector`` — flags iterations slower than k× the running
    median; the serving counterpart (LeastLoaded dispatch) drains slowed
    workers, and the simulator's FaultSpec injects both.

Serving side: worker failure / straggler injection and mitigation live in
``repro.core`` (Worker.fail + Simulation.redispatch) — validated in
tests/test_simulator.py.

The port's copy of ``repro.distributed.fault``, its imports rewritten.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class StragglerDetector:
    factor: float = 3.0
    window: int = 32
    _times: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """Returns True if this iteration is a straggler."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 8:
            return False
        med = statistics.median(self._times)
        return seconds > self.factor * med


class InjectedFailure(RuntimeError):
    """Raised by tests/drivers to simulate a node loss."""


def run_with_restarts(make_trainer: Callable[[], "object"],
                      num_steps: int, *, max_restarts: int = 3,
                      log=print) -> "object":
    """Supervise: build trainer (restores latest ckpt), run; on failure
    rebuild and continue from the last checkpoint.  Returns the trainer
    that finished."""
    restarts = 0
    while True:
        trainer = make_trainer()
        remaining = num_steps - trainer.step
        if remaining <= 0:
            return trainer
        try:
            trainer.run(remaining, log=log)
            return trainer
        except InjectedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if log:
                log(f"[fault] {e}; restart {restarts}/{max_restarts} "
                    f"from step checkpoint")
