"""The numbers by which a run's readings are held to the plain reference's,
and the decision ``correct``.

Three numbers, each with its own limit in ``checks/<cell>.json``:

* ``loss_gap``: the largest gap of a step's loss, over the reference's;
* ``grad_gap``: the leaf whose first gradient's norm (read from the
  program's first Adam moment, ``m / (1 - b1)``) lies farthest from the
  reference's, over the larger of that leaf's norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (their change is round-off alone).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from perfbench.leaves import median

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of ``change_gap``
QUIET_LEAF = 1e-3


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    floor = median([ref[n] for n in names])
    return {n: abs(got[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in names}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> float:
    """The worst leaf's gap; a leaf missing on one side reads infinite."""
    if set(got) != set(ref):
        return math.inf
    return max(leaf_gaps(got, ref, names).values())


def worst_leaves(got: Dict[str, Any], ref: Dict[str, Any], key: str,
                 count: int = 3) -> List[tuple]:
    """The ``count`` leaves of ``key`` (``grad_norms`` or
    ``change_norms``) that lie farthest apart: (leaf, gap, got, ref)."""
    names = sorted(set(got[key]) & set(ref[key]))
    g = leaf_gaps(got[key], ref[key], names)
    top = sorted(names, key=lambda n: -g[n])[:count]
    return [(n, g[n], got[key][n], ref[key][n]) for n in top]


def gap_quantiles(got: Dict[str, Any], ref: Dict[str, Any], key: str,
                  qs=(0.5, 0.9, 1.0)) -> List[float]:
    """The leaves' gaps of ``key`` at the quantiles ``qs`` (lower ends)."""
    names = sorted(set(got[key]) & set(ref[key]))
    g = sorted(leaf_gaps(got[key], ref[key], names).values())
    return [g[min(len(g) - 1, int(q * len(g)))] for q in qs]


def quiet_leaves(ref: Dict[str, Any]) -> List[str]:
    """The leaves whose reference gradient is under ``QUIET_LEAF`` of the
    median leaf's: their change is round-off alone."""
    floor = median(list(ref["grad_norms"].values()))
    return sorted(n for n, g in ref["grad_norms"].items()
                  if g < QUIET_LEAF * floor)


def gaps(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The three numbers of readings ``got`` against ``ref``."""
    if len(got["losses"]) != len(ref["losses"]):
        raise ValueError("readings of different numbers of steps")
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"]))
    names = sorted(ref["grad_norms"])
    grad = leaf_gap(got["grad_norms"], ref["grad_norms"], names)
    quiet = set(quiet_leaves(ref))
    moving = [n for n in sorted(ref["change_norms"]) if n not in quiet]
    change = leaf_gap(got["change_norms"], ref["change_norms"], moving)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """``{number: {"value", "limit"}}``; a number without a limit is an
    error, not a pass."""
    missing = [n for n in numbers if n not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {n: {"value": v, "limit": float(limits[n])}
            for n, v in numbers.items()}


def passed(judged: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(j["value"]) and j["value"] <= j["limit"]
               for j in judged.values())
