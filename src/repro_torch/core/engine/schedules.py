"""Gradient-accumulation Schedule registry.

A copy of ``repro.core.engine.schedules`` (which imports no JAX, but
importing it loads ``repro.core.engine``, which does): the same registry
and the same three schedules.

A schedule answers one question: *how are the ℓ microbatches of one
training step partitioned into collective rounds?*  Every round pays one
AllGather per unit on entry and one ReduceScatter per unit on exit; all
microbatches inside a round run between those collectives.  That single
abstraction expresses the paper's two schedules and leaves room for new
ones:

* ``layered`` (Cephalo, paper Fig. 4 bottom): one round ``[ℓ]`` — one
  gather + one scatter per unit per step, the ℓ× traffic saving.
* ``per_microbatch`` (FSDP-GA baseline, Fig. 4 top): ℓ rounds of 1 —
  every microbatch pays the full per-unit collective bill.
* ``interleaved`` (beyond-paper): rounds of 2.  Halves the baseline's
  gather traffic while capping how long gathered params and accumulated
  activations stay live; because round *k*+1's AllGathers are data-
  independent of round *k*'s ReduceScatters, an async runtime can
  overlap the tail scatter of one round with the head gather of the
  next.

Adding a schedule is one call::

    register_schedule(Schedule("quartered", lambda ell: chunked(ell, 4),
                               description="rounds of 4 microbatches"))

The MPMD runtime (:mod:`repro_torch.core.hetero_trainer`) consumes
schedules through :meth:`Schedule.chunks`, so a new entry works there at
once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Union


def chunked(ell: int, size: int) -> List[int]:
    """Partition ℓ microbatches into contiguous rounds of ``size``
    (final round may be smaller)."""
    if ell <= 0:
        return []
    size = max(1, min(size, ell))
    out = [size] * (ell // size)
    if ell % size:
        out.append(ell % size)
    return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A named partition of the microbatch loop into collective rounds."""

    name: str
    chunk_fn: Callable[[int], List[int]]
    description: str = ""

    def chunks(self, ell: int) -> List[int]:
        """Round sizes for an ℓ-microbatch step (contiguous, sum = ℓ)."""
        out = [int(c) for c in self.chunk_fn(ell)]
        if sum(out) != ell or any(c <= 0 for c in out):
            raise ValueError(
                f"schedule {self.name!r} produced invalid rounds {out} "
                f"for ell={ell}")
        return out

_REGISTRY: Dict[str, Schedule] = {}


def register_schedule(schedule: Schedule, overwrite: bool = False) -> Schedule:
    if schedule.name in _REGISTRY and not overwrite:
        raise ValueError(f"schedule {schedule.name!r} already registered")
    _REGISTRY[schedule.name] = schedule
    return schedule


def get_schedule(schedule: Union[str, Schedule]) -> Schedule:
    if isinstance(schedule, Schedule):
        return schedule
    try:
        return _REGISTRY[schedule]
    except KeyError:
        raise ValueError(
            f"unknown schedule {schedule!r}; registered: "
            f"{list_schedules()}") from None


def list_schedules() -> List[str]:
    return sorted(_REGISTRY)


register_schedule(Schedule(
    "layered", lambda ell: [ell] if ell > 0 else [],
    description="Cephalo layered GA (Fig. 4 bottom): one collective round "
                "per step — one AllGather + one ReduceScatter per unit"))

register_schedule(Schedule(
    "per_microbatch", lambda ell: chunked(ell, 1),
    description="FSDP-GA baseline (Fig. 4 top): one round per microbatch "
                "— ℓ× the per-unit collective traffic"))

register_schedule(Schedule(
    "interleaved", lambda ell: chunked(ell, 2),
    description="beyond-paper: rounds of 2 microbatches — halves baseline "
                "gather traffic; round k+1's gathers overlap round k's "
                "tail ReduceScatter"))
