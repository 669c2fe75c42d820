"""Comm-protocol verification: static analysis + runtime sanitizer.

The port of ``repro.core.engine.verify``.  The (topology × schedule ×
overlap × nprocs × layout) protocol surface of the paper's Sec. 2 /
App. C data plane is proven safe here *before any process spawns*:
:mod:`.model` enumerates every rank's event sequence symbolically from
the pure ring generators, :mod:`.simulate` executes the programs
abstractly and checks deadlock freedom, send/recv matching, buffering
caps, and ack-gated arena reuse, :mod:`.lint` proves every gradient
reduction of the port's data plane routes through
``combine_fixed_order``, :mod:`.mutations` keeps the checker honest
with seeded bugs, and :mod:`.sanitizer` re-checks the same model against
live ring traffic (``CEPHALO_COMM_SANITIZE=1``).  ``python -m
repro_torch.core.engine.verify`` runs the offline checks (:mod:`.cli`).
"""

from repro_torch.core.engine.verify.cells import (GridReport,
                                                  default_layouts,
                                                  grid_cells, verify_grid)
from repro_torch.core.engine.verify.lint import Finding, lint_determinism
from repro_torch.core.engine.verify.model import (BASELINE, Cell, Ev,
                                                  RankShape, Variant,
                                                  cell_programs,
                                                  exchange_steps,
                                                  rounds_for)
from repro_torch.core.engine.verify.mutations import (MutationReport,
                                                      run_mutation_harness)
from repro_torch.core.engine.verify.sanitizer import (CommSanitizer,
                                                      ProtocolViolation,
                                                      resolve_sanitize)
from repro_torch.core.engine.verify.simulate import (CellReport, Report,
                                                     Violation, verify_cell)

__all__ = [
    "BASELINE", "Cell", "CellReport", "CommSanitizer", "Ev", "Finding",
    "GridReport", "MutationReport", "ProtocolViolation", "RankShape",
    "Report", "Variant", "Violation", "cell_programs", "default_layouts",
    "exchange_steps", "grid_cells", "lint_determinism", "resolve_sanitize",
    "rounds_for", "run_mutation_harness", "verify_cell", "verify_grid",
]
