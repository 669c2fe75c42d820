"""Comm-protocol verification: the protocol model and the runtime
sanitizer.

The port of ``repro.core.engine.verify``'s runtime half:
:mod:`.model` enumerates every rank's send/recv event sequence
symbolically from the pure ring generators, and :mod:`.sanitizer`
re-checks live ring traffic against it (``CEPHALO_COMM_SANITIZE=1``).
The offline checker (the reference's ``simulate``, ``cells``,
``mutations``, ``lint``, ``cli`` and ``__main__``) is not ported yet:
ROADMAP queue 1, item 9.
"""

from repro_torch.core.engine.verify.model import (BASELINE, Cell, Ev,
                                                  RankShape, Variant,
                                                  cell_programs,
                                                  exchange_steps,
                                                  rounds_for)
from repro_torch.core.engine.verify.sanitizer import (CommSanitizer,
                                                      ProtocolViolation,
                                                      resolve_sanitize)

__all__ = [
    "BASELINE", "Cell", "CommSanitizer", "Ev", "ProtocolViolation",
    "RankShape", "Variant", "cell_programs", "exchange_steps",
    "resolve_sanitize", "rounds_for",
]
