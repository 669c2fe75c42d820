"""Command-line entry of the protocol verifier.

The port's copy of ``repro.core.engine.verify.cli``.

``python -m repro_torch.core.engine.verify --grid --mutations`` proves the
four static properties (deadlock freedom, matched sends without tag
collisions, bounded handoff buffering, ack-gated arena reuse — see
:mod:`verify.simulate`) over the full parity-matrix cell grid of the
paper's Sec. 2 / App. C protocol surface, runs the determinism lint,
and checks that every seeded mutation is caught.  Exit code 0 iff
everything holds.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.core.engine.verify.cells import grid_cells, verify_grid
from repro_torch.core.engine.verify.lint import lint_determinism
from repro_torch.core.engine.verify.mutations import run_mutation_harness


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.core.engine.verify",
        description="static comm-protocol verifier (deadlock / matching "
                    "/ buffering / arena / determinism)")
    ap.add_argument("--grid", action="store_true",
                    help="verify the full cell grid")
    ap.add_argument("--mutations", action="store_true",
                    help="run the seeded-bug mutation harness")
    ap.add_argument("--lint", action="store_true",
                    help="run the determinism lint on the data plane")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every cell verdict, not just failures")
    args = ap.parse_args(argv)
    if not (args.grid or args.mutations or args.lint):
        args.grid = args.mutations = args.lint = True

    failed = False
    if args.grid:
        report = verify_grid()
        if args.verbose:
            for r in report.reports:
                print(r.summary())
        print(report.summary())
        failed |= not report.ok
    if args.lint:
        findings = lint_determinism()
        for f in findings:
            print(f)
        print(f"determinism lint: {len(findings)} finding(s)")
        failed |= bool(findings)
    if args.mutations:
        mreport = run_mutation_harness()
        print(mreport.summary())
        failed |= not mreport.ok
    if args.grid:
        print(f"(grid size: {len(grid_cells())} cells)")
    return 1 if failed else 0


if __name__ == "__main__":   # pragma: no cover - exercised via __main__
    sys.exit(main())
