"""Mutation harness: seeded protocol bugs the verifier must catch.

The port's copy of ``repro.core.engine.verify.mutations``.

A checker nobody has seen fail proves nothing.  Each mutant here is a
realistic protocol bug — the kind a refactor of the paper's Sec. 2 /
App. C ring data plane could plausibly introduce — expressed as a
:class:`verify.model.Variant` knob (or, for the reduction-order bug, a
source snippet for the determinism lint).  The harness asserts, for every mutant, that (1) the
*baseline* protocol passes the very cell the mutant is run on, and
(2) the mutant is rejected with the expected violation class:

* ``swapped_send_order`` — every rank sends before receiving; on the
  rendezvous (pipe) plane the whole ring blocks → **deadlock**.
* ``reused_tag`` — round index collapsed out of the message tags; two
  rounds' payloads share a match key → **collision** (recv_match could
  mis-deliver a prefetched round).
* ``early_arena_reuse`` — the backward ``ring_ack`` lane removed; a
  sender overwrites its shm arena while the reader may still reference
  it → **arena**.
* ``deep_prefetch`` — AllGatherv prefetch depth 2; the gathered-params
  handoff queue exceeds its double-buffered cap → **queue_cap**.
* ``ring_order_accumulation`` — gradients accumulated in arrival
  order instead of through ``combine_fixed_order`` → **DET-1/DET-2**
  lint findings.

The *runtime* halves of these bugs (a live worker stamping a reused
tag, skipping its ack) are injected through the worker ``fault``
command (``mutate_reuse_tag`` / ``mutate_skip_ack``) and must be
caught by the comm sanitizer — exercised in
``tests/test_torch_multiproc.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine.verify.lint import lint_determinism
from repro_torch.core.engine.verify.model import Cell, RankShape, Variant
from repro_torch.core.engine.verify.simulate import verify_cell


def _uniform(n: int, ell: int = 2) -> Tuple[RankShape, ...]:
    return tuple(RankShape(ell=ell, m=1, chunk=4) for _ in range(n))


#: mutant name -> (variant, cell it is seeded into, violation class the
#: static checker must report).  Cell choices matter: the send-order
#: bug needs a ring with edges (n >= 2); the arena bug needs >= 2 ring
#: steps (n >= 3) so a second bulk send exists; the tag bug needs >= 2
#: rounds (per_microbatch, ell 2) so two rounds' tags can collide; the
#: prefetch bug needs >= 3 rounds so depth 2 exceeds the cap.
STATIC_MUTANTS: Dict[str, Tuple[Variant, Cell, str]] = {
    "swapped_send_order": (
        Variant(name="swapped_send_order", send_order="send_first"),
        Cell("ring", "layered", False, _uniform(2), "uniform"),
        "deadlock"),
    "reused_tag": (
        Variant(name="reused_tag", tag_rounds=False),
        Cell("ring", "per_microbatch", True, _uniform(3), "uniform"),
        "collision"),
    "early_arena_reuse": (
        Variant(name="early_arena_reuse", ack_gated=False),
        Cell("ring", "layered", False, _uniform(3), "uniform"),
        "arena"),
    "deep_prefetch": (
        Variant(name="deep_prefetch", prefetch_depth=2),
        Cell("ring", "per_microbatch", True, _uniform(2, ell=3),
             "uniform"),
        "queue_cap"),
}

#: the reduction-order mutant: a pipelined partial-sum ring that
#: accumulates contributions in arrival (ring) order — a different
#: float-add order per destination, bitwise parity broken.
RING_ORDER_SNIPPET = '''\
def ring_round_mutant(self, arrival):
    acc = None
    for origin, chunks in arrival.items():
        for u, a in chunks.items():
            if acc is None:
                acc = {}
            acc[u] = acc[u] + a if u in acc else a
    self.accum_grads(acc)
'''


@dataclasses.dataclass
class MutantResult:
    name: str
    detected: bool
    expected: str
    detail: str

    def __str__(self) -> str:
        mark = "caught" if self.detected else "ESCAPED"
        return f"{self.name:<24} {mark:<8} [{self.expected}] {self.detail}"


@dataclasses.dataclass
class MutationReport:
    results: List[MutantResult]

    @property
    def ok(self) -> bool:
        return all(r.detected for r in self.results)

    def summary(self) -> str:
        lines = [str(r) for r in self.results]
        escaped = sum(1 for r in self.results if not r.detected)
        lines.append(f"mutation harness: {len(self.results)} seeded "
                     f"bugs, {escaped} escaped")
        return "\n".join(lines)


def run_mutation_harness() -> MutationReport:
    results: List[MutantResult] = []
    for name, (variant, cell, expected) in STATIC_MUTANTS.items():
        base = verify_cell(cell)
        if not base.ok:
            results.append(MutantResult(
                name, False, expected,
                f"harness bug: baseline fails on {cell.label()}: "
                f"{base.violations()[0]}"))
            continue
        mutated = verify_cell(cell, variant)
        hit = next((v for v in mutated.violations()
                    if v.check == expected), None)
        if hit is not None:
            results.append(MutantResult(name, True, expected, str(hit)))
        elif mutated.violations():
            results.append(MutantResult(
                name, False, expected,
                f"caught, but as {mutated.violations()[0].check!r} "
                f"not {expected!r}: {mutated.violations()[0]}"))
        else:
            results.append(MutantResult(
                name, False, expected,
                f"static checker passed the mutant on {cell.label()}"))
    # reduction-order mutant: the determinism lint is the detector
    clean = lint_determinism()
    seeded = lint_determinism(
        paths=[], extra_sources=[("<ring_order_mutant>",
                                  RING_ORDER_SNIPPET)])
    if clean:
        results.append(MutantResult(
            "ring_order_accumulation", False, "DET-1/DET-2",
            f"harness bug: the real data plane has lint findings: "
            f"{clean[0]}"))
    elif seeded:
        results.append(MutantResult(
            "ring_order_accumulation", True, "DET-1/DET-2",
            f"{len(seeded)} finding(s), e.g. {seeded[0]}"))
    else:
        results.append(MutantResult(
            "ring_order_accumulation", False, "DET-1/DET-2",
            "determinism lint passed the ring-order mutant"))
    return MutationReport(results)
