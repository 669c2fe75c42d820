"""The verified cell grid: every protocol configuration the parity
matrix spans, plus the ragged layouts that stress it.

The port's copy of ``repro.core.engine.verify.cells``.

Acceptance surface of the static checker: {hub, ring} × every
registered GA schedule × {sync, overlap} × n ∈ {1, 2, 3, 5} × layouts
covering uniform, ragged (different ``ell``/``m``/chunk per rank,
matching the paper's Sec. 2 decoupled compute/state assignment),
zero-size state shards, and compute-idle ranks (``b = 0``).  Hub ×
overlap cells are rejected by the engine at construction and reported
as such — safe because unreachable, not because simulated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine.schedules import list_schedules
from repro_torch.core.engine.verify.model import BASELINE, Cell, RankShape, Variant
from repro_torch.core.engine.verify.simulate import CellReport, verify_cell

#: fleet sizes the grid proves (odd/even parity corners, n=1 no-edge
#: corner, and one size with both interior even and odd ranks).
GRID_NS = (1, 2, 3, 5)


def default_layouts(n: int) -> Dict[str, Tuple[RankShape, ...]]:
    """Named layouts for an ``n``-rank cell."""
    layouts: Dict[str, Tuple[RankShape, ...]] = {
        "uniform": tuple(RankShape(ell=2, m=1, chunk=4)
                         for _ in range(n)),
        # ragged everything: ell in {1,2,3} (=> late rounds shed short
        # ranks), m in {1,2}, chunks include a zero-size state shard
        "ragged": tuple(RankShape(ell=1 + (r % 3), m=1 + (r % 2),
                                  chunk=(3, 5, 0, 2, 4)[r % 5])
                        for r in range(n)),
    }
    if n >= 2:
        # one rank with b == 0: stores state (and forwards ring
        # traffic) but never computes — excluded from step_begin and
        # from every round's active set
        idle = [RankShape(ell=2, m=1, chunk=3) for _ in range(n)]
        idle[-1] = RankShape(ell=2, m=0, chunk=5)
        layouts["idle-rank"] = tuple(idle)
    return layouts


def grid_cells(ns: Sequence[int] = GRID_NS) -> List[Cell]:
    cells: List[Cell] = []
    for topology in ("hub", "ring"):
        for schedule in list_schedules():
            for overlap in (False, True):
                for n in ns:
                    for name, layout in default_layouts(n).items():
                        cells.append(Cell(topology, schedule, overlap,
                                          layout, layout_name=name))
    return cells


@dataclasses.dataclass
class GridReport:
    reports: List[CellReport]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.reports)

    @property
    def checked(self) -> int:
        return sum(1 for r in self.reports if r.rejected is None)

    @property
    def rejected(self) -> int:
        return sum(1 for r in self.reports if r.rejected is not None)

    def failures(self) -> List[CellReport]:
        return [r for r in self.reports if not r.ok]

    def summary(self) -> str:
        lines = [r.summary() for r in self.failures()] or ["all cells ok"]
        lines.append(
            f"grid: {self.checked} cells verified on both planes, "
            f"{self.rejected} rejected-by-construction, "
            f"{len(self.failures())} failing")
        return "\n".join(lines)


def verify_grid(cells: Optional[Sequence[Cell]] = None,
                variant: Variant = BASELINE) -> GridReport:
    """Run the static checker over the full grid (or ``cells``)."""
    return GridReport([verify_cell(c, variant)
                       for c in (cells if cells is not None
                                 else grid_cells())])
