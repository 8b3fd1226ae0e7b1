"""Pareto-frontier extraction over sweep result rows.

An ``objectives`` map names the metric columns that matter and their
direction (``"max"`` / ``"min"``); a row is on the frontier iff no other
row is at least as good on every objective and strictly better on one.
Rows missing an objective (or carrying NaN) never dominate anything and
are excluded from the frontier — a failed metric must not look optimal.

The port's copy of ``repro.explore.pareto``, its imports rewritten.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence


def _objective_values(row: Dict, objectives: Dict[str, str]):
    """Per-objective values oriented so that larger is always better;
    None when any objective is missing or NaN."""
    vals = []
    for name, direction in objectives.items():
        v = row.get(name)
        if not isinstance(v, (int, float)) or v != v:
            return None
        if direction == "min":
            v = -v
        elif direction != "max":
            raise ValueError(f"objective {name!r}: direction must be "
                             f"'max' or 'min', got {direction!r}")
        vals.append(v)
    return tuple(vals)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff ``a`` is >= ``b`` everywhere and > somewhere (both
    already oriented larger-is-better)."""
    return all(x >= y for x, y in zip(a, b)) \
        and any(x > y for x, y in zip(a, b))


def pareto_frontier(rows: List[Dict],
                    objectives: Dict[str, str]) -> List[Dict]:
    """Non-dominated subset of ``rows`` under ``objectives``, in input
    order.  Duplicate objective vectors all stay on the frontier."""
    scored = [(r, _objective_values(r, objectives)) for r in rows]
    frontier = []
    for r, v in scored:
        if v is None:
            continue
        if not any(other is not None and dominates(other, v)
                   for _, other in scored):
            frontier.append(r)
    return frontier


def write_rows_csv(rows: List[Dict], path: str) -> None:
    """Write rows with a union-of-keys header (first-seen key order)."""
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)
