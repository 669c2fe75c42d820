"""Symbolic protocol model of the multiproc collective data plane.

The port's copy of ``repro.core.engine.verify.model``.

Cephalo's decoupled compute/state assignment (paper Sec. 2 / App. C)
makes every collective *ragged* — per-rank shard sizes differ, including
zero-size shards — and the parity contract multiplies the protocol
surface: {hub, ring} topologies × GA schedules × overlap on/off × fleet
size × layout.  This module builds, for any such cell, the exact
per-thread send/recv event sequence each participant executes, **without
spawning a process**: the ring payloads are enumerated by driving the
pure generators of :mod:`repro_torch.core.engine.ring` in lockstep (the same
code the workers drive over real channels), the overlapped op order
comes from :func:`repro_torch.core.engine.ring.overlap_plan`, and the hub /
control-plane traffic mirrors the coordinator logic of
:mod:`repro_torch.core.engine.multiproc` round for round.

The event programs feed two consumers:

* :mod:`repro_torch.core.engine.verify.simulate` — the static checker, which
  executes the programs under an abstract channel semantics and proves
  deadlock freedom, send/recv matching, handoff-queue caps, and
  ack-gated arena reuse for the whole cell grid;
* :mod:`repro_torch.core.engine.verify.sanitizer` — the runtime comm
  sanitizer, which replays :func:`exchange_steps` as the *expected*
  trace and checks every live send/recv against it.

One model, two enforcement points — the statically verified schedule and
the runtime conformance check can never drift apart.

:class:`Variant` carries the seeded-bug knobs of the mutation harness
(:mod:`repro_torch.core.engine.verify.mutations`): swapped send order, tag
reuse across rounds, un-gated arena reuse, and a too-deep prefetch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import ring
from repro_torch.core.engine.schedules import get_schedule

# ---------------------------------------------------------------------------
# Cells: one (topology, schedule, overlap, layout) protocol configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankShape:
    """One rank's shape in a cell layout.

    ``ell``/``m`` mirror :class:`repro_torch.core.partition.RankPlan` (so
    ``b = m * ell`` and the round active-set rule match the engine);
    ``chunk`` is the rank's ragged state-shard element count — 0 models
    a zero-size shard (a rank that computes but stores nothing).
    """

    ell: int
    m: int
    chunk: int

    @property
    def b(self) -> int:
        return self.ell * self.m


Layout = Tuple[RankShape, ...]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One protocol cell of the parity matrix."""

    topology: str           # "hub" | "ring"
    schedule: str           # registered GA schedule name
    overlap: bool
    layout: Layout
    layout_name: str = ""

    @property
    def n(self) -> int:
        return len(self.layout)

    def label(self) -> str:
        ov = "overlap" if self.overlap else "sync"
        return (f"{self.topology}/{self.schedule}/{ov}/n={self.n}"
                f"/{self.layout_name or 'layout'}")

    @property
    def rejected_reason(self) -> Optional[str]:
        """Cells the engine refuses by construction (no protocol to
        verify): overlap needs the ring data plane —
        ``ProcessEngine.__init__`` raises before any process spawns."""
        if self.overlap and self.topology != "ring":
            return ("overlap_rounds=True needs topology='ring' "
                    "(ProcessEngine rejects this cell at construction)")
        return None


@dataclasses.dataclass(frozen=True)
class Round:
    """One GA-schedule collective round, engine geometry."""

    idx: int
    lo: int
    hi: int
    active: Tuple[int, ...]


def rounds_for(cell: Cell) -> List[Round]:
    """Round list exactly as ``ProcessEngine.step`` builds it: schedule
    chunks over ``max(ell_pad, 1)`` microbatch slots, a rank is active
    in a round iff ``b > 0`` and its ``[lo, hi) ∩ [0, ell)`` window is
    non-empty."""
    ell_pad = max((rs.ell for rs in cell.layout), default=0)
    rounds: List[Round] = []
    mb = 0
    for idx, size in enumerate(get_schedule(cell.schedule)
                               .chunks(max(ell_pad, 1))):
        lo, hi = mb, mb + size
        mb += size
        active = tuple(
            r for r, rs in enumerate(cell.layout)
            if rs.b > 0 and min(lo, rs.ell) < min(hi, rs.ell))
        rounds.append(Round(idx, lo, hi, active))
    return rounds


# ---------------------------------------------------------------------------
# Protocol variants: the mutation-harness knobs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Variant:
    """Protocol-implementation knobs.

    The default is the shipped protocol; every other combination is a
    *seeded bug* for the mutation harness.  ``send_order`` swaps the
    even/odd parity discipline for everyone-sends-first;
    ``tag_rounds=False`` collapses the round index (and the phase's
    microbatch window) out of the message tags; ``ack_gated=False``
    drops the backward ``ring_ack`` lane entirely; ``prefetch_depth``
    deepens the overlapped AllGatherv prefetch beyond the
    double-buffered cap.
    """

    name: str = "baseline"
    send_order: str = "parity"          # "parity" | "send_first"
    tag_rounds: bool = True
    ack_gated: bool = True
    prefetch_depth: int = 1


BASELINE = Variant()


def overlap_plan_depth(n_rounds: int, depth: int = 1) -> List[tuple]:
    """Generalize :func:`ring.overlap_plan` to prefetch depth ``depth``.

    ``depth=1`` reproduces the shipped plan exactly (asserted in the
    tests); deeper variants exist only as mutation-harness seeds — the
    static queue-occupancy check must reject them."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    if depth == 1:
        return ring.overlap_plan(n_rounds)
    ops: List[tuple] = []
    issued = 0
    for k in range(n_rounds):
        target = min(k + depth, n_rounds - 1)
        while issued <= target:
            ops.append(("allgather", issued))
            issued += 1
        ops.append(("reduce_scatter", k))
    return ops


# ---------------------------------------------------------------------------
# Phases and tags: byte-for-byte the strings multiproc puts on the wire
# ---------------------------------------------------------------------------


def ag_phase(lo: int, hi: int, variant: Variant = BASELINE) -> str:
    if not variant.tag_rounds:
        return "allgather(p)"
    return f"allgather(p)[{lo},{hi})"


def rs_phase(lo: int, hi: int, variant: Variant = BASELINE) -> str:
    if not variant.tag_rounds:
        return "reduce_scatter(G)"
    return f"reduce_scatter(G)[{lo},{hi})"


def round_tags(round_idx: int, gstep: int,
               variant: Variant = BASELINE) -> Dict[str, int]:
    if not variant.tag_rounds:
        return {"round": 0, "gstep": gstep}
    return {"round": round_idx, "gstep": gstep}


# ---------------------------------------------------------------------------
# The ring exchange: shared source of truth (static checker + sanitizer)
# ---------------------------------------------------------------------------

#: per-ring-step event roles, in the order ``_RingLinks._exchange``
#: performs them.  Even ranks send-then-receive, odd ranks
#: receive-then-send — the parity discipline that breaks any cycle of
#: blocked senders on the rendezvous (pipe) plane.
ROLES_EVEN = ("send_payload", "recv_payload", "send_ack", "recv_ack")
ROLES_ODD = ("recv_payload", "send_ack", "send_payload", "recv_ack")


def exchange_steps(rank: int, n: int, phase: str, tags: Dict[str, int],
                   variant: Variant = BASELINE
                   ) -> List[Tuple[str, int, Dict[str, int]]]:
    """Expected ``(role, step, meta)`` sequence of one ring collective
    for one rank — exactly what ``_RingLinks._exchange`` does, with the
    exact wire metas.  ``meta`` for a receive role is the meta the
    *peer* stamped (``src`` = sender's rank); for a send role it is this
    rank's own stamp.  The runtime sanitizer replays this list as the
    conformance oracle; the static checker maps it onto channels."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    prev_rank, next_rank = ring.ring_neighbors(n, rank) if n > 1 else (0, 0)
    roles = ROLES_EVEN if (rank % 2 == 0
                           or variant.send_order == "send_first") \
        else ROLES_ODD
    if not variant.ack_gated:
        roles = tuple(r for r in roles if not r.endswith("_ack"))
    out: List[Tuple[str, int, Dict[str, int]]] = []
    for s in range(n - 1):
        base = {"phase": phase, "step": s, **tags}
        metas = {
            "send_payload": {**base, "src": rank},
            "recv_payload": {**base, "src": prev_rank},
            # the ack a rank SENDS carries its own stamp; the ack it
            # RECEIVES was stamped by its successor
            "send_ack": {**base, "src": rank},
            "recv_ack": {**base, "src": next_rank},
        }
        for role in roles:
            out.append((role, s, metas[role]))
    return out


# ---------------------------------------------------------------------------
# Ring payload enumeration: drive the real generators, record the wire
# ---------------------------------------------------------------------------


def _lockstep_record(gens: Sequence) -> Tuple[List[List[Tuple[str, ...]]],
                                              List]:
    """:func:`ring.simulate` with a wiretap: returns per-rank, per-step
    sorted payload key tuples alongside the generators' results."""
    n = len(gens)
    results: List = [None] * n
    outbox: List = [None] * n
    sent: List[List[Tuple[str, ...]]] = [[] for _ in range(n)]
    live = set()
    for r, g in enumerate(gens):
        try:
            outbox[r] = next(g)
            sent[r].append(tuple(sorted(outbox[r].keys())))
            live.add(r)
        except StopIteration as e:
            results[r] = e.value
    while live:
        inbox = [outbox[(r - 1) % n] for r in range(n)]
        for r in sorted(live):
            try:
                outbox[r] = gens[r].send(inbox[r])
                sent[r].append(tuple(sorted(outbox[r].keys())))
            except StopIteration as e:
                results[r] = e.value
                live.discard(r)
    return sent, results


def _own_chunks(layout: Layout, rank: int) -> Dict[str, np.ndarray]:
    """Symbolic state chunks for one rank: a ragged unit ``u`` (size
    ``chunk``, possibly zero) marked with the origin rank so the
    completeness checks can tell contributions apart."""
    return {"u": np.full((layout[rank].chunk,), float(rank + 1),
                         dtype=np.float32)}


def enumerate_allgather(layout: Layout) -> List[List[Tuple[str, ...]]]:
    """Per-rank per-step AllGatherv payload key sets, from the real
    generators; asserts the collective's postcondition (every rank holds
    every origin's chunk, values intact) before returning."""
    n = len(layout)
    gens = [ring.allgatherv(r, n, _own_chunks(layout, r))
            for r in range(n)]
    sent, results = _lockstep_record(gens)
    for r in range(n):
        got = results[r]
        if len(got) != n:
            raise AssertionError(
                f"allgather postcondition: rank {r} holds {len(got)} "
                f"chunk lists, expected {n}")
        for o in range(n):
            arr = got[o]["u"]
            if arr.shape != (layout[o].chunk,) or \
                    not np.all(arr == float(o + 1)):
                raise AssertionError(
                    f"allgather postcondition: rank {r} holds a wrong "
                    f"chunk for origin {o}")
    return sent


def enumerate_reduce_scatter(layout: Layout, active: Sequence[int]
                             ) -> List[List[Tuple[str, ...]]]:
    """Per-rank per-step ReduceScatterv payload key sets from the real
    generators, for a round whose active set is ``active``; asserts the
    accumulate-then-combine postcondition — every destination's
    :func:`ring.combine_fixed_order` result equals the element-wise sum
    of the active origins' marked contributions (zero-size chunks
    included)."""
    n = len(layout)
    active_set = set(active)

    def dests(rank: int):
        if rank not in active_set:
            return None
        return [{"u": np.full((layout[d].chunk,), float(rank + 1),
                              dtype=np.float32)} for d in range(n)]

    gens = [ring.reduce_scatterv(r, n, dests(r)) for r in range(n)]
    sent, results = _lockstep_record(gens)
    expect = float(sum(o + 1 for o in active_set))
    for r in range(n):
        combined = ring.combine_fixed_order(results[r])
        if not active_set:
            if combined is not None:
                raise AssertionError(
                    f"reduce_scatter postcondition: rank {r} combined a "
                    "sum out of an all-inactive round")
            continue
        arr = combined["u"]
        if arr.shape != (layout[r].chunk,) or not np.all(arr == expect):
            raise AssertionError(
                f"reduce_scatter postcondition: rank {r} sum is wrong "
                f"(expected fill {expect})")
    return sent


# ---------------------------------------------------------------------------
# Event programs: every thread of every participant, in execution order
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ev:
    """One abstract protocol event.

    ``op`` ∈ send | recv | put | get | join.  ``chan`` identifies the
    directed wire (``("c2w", r)`` / ``("w2c", r)`` coordinator legs,
    ``("fwd", e)`` / ``("bwd", e)`` ring edge ``e`` payload/ack
    directions), the handoff queue (``("gq", r)`` / ``("oq", r)``), or
    the joined thread.  ``meta`` is the wire meta as a sorted item tuple
    (hashable); ``bulk`` marks array-carrying messages (the ones that
    rendezvous on the pipe plane and occupy shm arenas); ``mode`` is the
    receive discipline (``strict`` = fail-fast in-order verify,
    ``match`` = ``Channel.recv_match`` parking).
    """

    op: str
    chan: Optional[tuple] = None
    kind: str = ""
    meta: Tuple[Tuple[str, object], ...] = ()
    bulk: bool = False
    mode: str = "strict"
    payload: Tuple[str, ...] = ()


def _freeze(meta: Dict[str, object]) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(meta.items()))


#: keys of a ring meta that participate in recv_match matching (the
#: receiver's match dict is the sender's meta minus ``src``).
MATCH_EXCLUDED = ("src",)


def match_key(kind: str, meta: Tuple[Tuple[str, object], ...]) -> tuple:
    return (kind,) + tuple((k, v) for k, v in meta
                           if k not in MATCH_EXCLUDED)


def _ring_collective_events(rank: int, n: int, phase: str,
                            tags: Dict[str, int], variant: Variant,
                            payloads: Sequence[Tuple[str, ...]],
                            mode: str) -> List[Ev]:
    """Map :func:`exchange_steps` onto directed channels + payloads."""
    prev_rank, _ = ring.ring_neighbors(n, rank)
    out: List[Ev] = []
    for role, s, meta in exchange_steps(rank, n, phase, tags, variant):
        fmeta = _freeze(meta)
        if role == "send_payload":
            keys = tuple(payloads[s]) if s < len(payloads) else ()
            out.append(Ev("send", ("fwd", rank), "ring", fmeta,
                          bulk=bool(keys), payload=keys))
        elif role == "recv_payload":
            out.append(Ev("recv", ("fwd", prev_rank), "ring", fmeta,
                          mode=mode))
        elif role == "send_ack":
            out.append(Ev("send", ("bwd", prev_rank), "ring_ack", fmeta))
        elif role == "recv_ack":
            out.append(Ev("recv", ("bwd", rank), "ring_ack", fmeta,
                          mode=mode))
    return out


def _coord_pair(r: int, tag: str, meta: Dict[str, object], *,
                bulk_req: bool = False,
                payload: Tuple[str, ...] = ()) -> Tuple[Ev, Ev]:
    """Coordinator's request event on ``("c2w", r)`` plus the matching
    worker-side receive (the reply legs are built separately so
    ``request_all``'s send-all-then-recv-in-rank-order shape is kept)."""
    fmeta = _freeze(meta)
    return (Ev("send", ("c2w", r), tag, fmeta, bulk=bulk_req,
               payload=payload),
            Ev("recv", ("c2w", r), tag, fmeta))


def _reply_pair(r: int, tag: str, meta: Dict[str, object], *,
                bulk: bool = False,
                payload: Tuple[str, ...] = ()) -> Tuple[Ev, Ev]:
    fmeta = _freeze(meta)
    return (Ev("send", ("w2c", r), tag, fmeta, bulk=bulk,
               payload=payload),
            Ev("recv", ("w2c", r), tag, fmeta))


def cell_programs(cell: Cell, variant: Variant = BASELINE,
                  gstep: int = 1) -> Dict[str, List[Ev]]:
    """The full per-thread event programs of one engine step in ``cell``.

    Threads: ``coord`` (the coordinator), ``w<r>`` (each worker's
    command loop), plus ``w<r>.comm`` (the dedicated communication
    thread) under overlap.  Mirrors ``ProcessEngine.step`` +
    ``_worker_main`` exactly: ``step_begin`` to active ranks, one
    collective round per schedule chunk (hub data plane or ring
    peer-to-peer; overlapped rounds fold into a single ``ring_step``
    broadcast), and the step-end ``adam`` barrier.
    """
    if cell.rejected_reason is not None:
        raise ValueError(f"cell {cell.label()} is rejected by "
                         f"construction: {cell.rejected_reason}")
    n = cell.n
    rounds = rounds_for(cell)
    nonempty = [rd for rd in rounds if rd.active]
    active_ranks = [r for r, rs in enumerate(cell.layout) if rs.b > 0]
    progs: Dict[str, List[Ev]] = {"coord": []}
    main = {r: f"w{r}" for r in range(n)}
    for r in range(n):
        progs[main[r]] = []
    coord = progs["coord"]

    # --- step_begin: tokens to every active rank, oks in rank order ----
    for r in active_ranks:
        req, wrecv = _coord_pair(r, "step_begin", {}, bulk_req=True,
                                 payload=("tokens", "labels"))
        coord.append(req)
        progs[main[r]].append(wrecv)
    for r in active_ranks:
        rep, crecv = _reply_pair(r, "ok", {"re": "step_begin"})
        progs[main[r]].append(rep)
        coord.append(crecv)

    if cell.topology == "hub":
        _hub_rounds(cell, rounds, progs, coord, main)
    elif not cell.overlap:
        _ring_sync_rounds(cell, nonempty, progs, coord, main, variant,
                          gstep)
    else:
        _ring_overlap_step(cell, nonempty, progs, coord, main, variant,
                           gstep)

    # --- adam barrier: only when some round produced gradients ---------
    if nonempty:
        for r in range(n):
            req, wrecv = _coord_pair(r, "adam", {})
            coord.append(req)
            progs[main[r]].append(wrecv)
        for r in range(n):
            rep, crecv = _reply_pair(r, "ok", {"re": "adam"})
            progs[main[r]].append(rep)
            coord.append(crecv)
    return progs


def _hub_rounds(cell: Cell, rounds: List[Round], progs, coord,
                main) -> None:
    """Hub data plane: the coordinator gathers every rank's param
    slices (it does this even for an all-inactive round — the
    ``gather_flat`` runs before the empty-round early-out in
    ``_hub_collective_round``), broadcasts full flats to the active
    set, collects gradient flats in rank order, scatters summed slices
    to everyone."""
    n = cell.n
    for rd in rounds:
        tag = {"round": rd.idx}
        for r in range(n):
            req, wrecv = _coord_pair(r, "get_state", tag)
            coord.append(req)
            progs[main[r]].append(wrecv)
        for r in range(n):
            rep, crecv = _reply_pair(r, "state", tag, bulk=True,
                                     payload=("u|p",))
            progs[main[r]].append(rep)
            coord.append(crecv)
        if not rd.active:
            continue
        for r in rd.active:
            req, wrecv = _coord_pair(r, "round", tag, bulk_req=True,
                                     payload=("P|u",))
            coord.append(req)
            progs[main[r]].append(wrecv)
        for r in rd.active:
            rep, crecv = _reply_pair(r, "grads", tag, bulk=True,
                                     payload=("G|u",))
            progs[main[r]].append(rep)
            coord.append(crecv)
        for r in range(n):
            req, wrecv = _coord_pair(r, "grad_accum", tag, bulk_req=True,
                                     payload=("u",))
            coord.append(req)
            progs[main[r]].append(wrecv)
        for r in range(n):
            rep, crecv = _reply_pair(r, "ok", {**tag, "re": "grad_accum"})
            progs[main[r]].append(rep)
            coord.append(crecv)


def _ring_sync_rounds(cell: Cell, nonempty: List[Round], progs, coord,
                      main, variant: Variant, gstep: int) -> None:
    """Synchronous ring rounds: one control-only ``ring_round``
    broadcast per non-empty round; every worker (active or not) runs
    the round's AllGatherv + ReduceScatterv peer-to-peer on its main
    thread, strict in-order receives."""
    n = cell.n
    ag_pay = enumerate_allgather(cell.layout) if n > 1 else []
    for rd in nonempty:
        tags = round_tags(rd.idx, gstep, variant)
        rs_pay = enumerate_reduce_scatter(cell.layout, rd.active) \
            if n > 1 else []
        for r in range(n):
            req, wrecv = _coord_pair(r, "ring_round", {"round": rd.idx})
            coord.append(req)
            progs[main[r]].append(wrecv)
        for r in range(n):
            if n > 1:
                progs[main[r]].extend(_ring_collective_events(
                    r, n, ag_phase(rd.lo, rd.hi, variant), tags, variant,
                    ag_pay[r], mode="strict"))
                progs[main[r]].extend(_ring_collective_events(
                    r, n, rs_phase(rd.lo, rd.hi, variant), tags, variant,
                    rs_pay[r], mode="strict"))
            rep, crecv = _reply_pair(r, "ring_done", {"round": rd.idx})
            progs[main[r]].append(rep)
            coord.append(crecv)


def _ring_overlap_step(cell: Cell, nonempty: List[Round], progs, coord,
                       main, variant: Variant, gstep: int) -> None:
    """Overlapped rounds: ONE ``ring_step`` broadcast; each worker's
    communication thread executes the fixed global op order
    (:func:`overlap_plan_depth`), handing gathered params / outbound
    grads to the main thread through the double-buffered queues; the
    main thread joins the comm thread (step barrier) before replying."""
    n = cell.n
    if not nonempty:
        return
    ag_pay = enumerate_allgather(cell.layout) if n > 1 else []
    rs_pays = {rd.idx: (enumerate_reduce_scatter(cell.layout, rd.active)
                        if n > 1 else [])
               for rd in nonempty}
    for r in range(n):
        req, wrecv = _coord_pair(r, "ring_step", {})
        coord.append(req)
        progs[main[r]].append(wrecv)
    plan = overlap_plan_depth(len(nonempty), variant.prefetch_depth)
    for r in range(n):
        comm_t = f"w{r}.comm"
        progs[comm_t] = []
        for op, k in plan:
            rd = nonempty[k]
            tags = round_tags(rd.idx, gstep, variant)
            if op == "allgather":
                if n > 1:
                    progs[comm_t].extend(_ring_collective_events(
                        r, n, ag_phase(rd.lo, rd.hi, variant), tags,
                        variant, ag_pay[r], mode="match"))
                progs[comm_t].append(Ev("put", ("gq", r)))
            else:
                progs[comm_t].append(Ev("get", ("oq", r)))
                if n > 1:
                    progs[comm_t].extend(_ring_collective_events(
                        r, n, rs_phase(rd.lo, rd.hi, variant), tags,
                        variant, rs_pays[rd.idx][r], mode="match"))
        for rd in nonempty:
            progs[main[r]].append(Ev("get", ("gq", r)))
            progs[main[r]].append(Ev("put", ("oq", r)))
        progs[main[r]].append(Ev("join", None, kind=comm_t))
        rep, crecv = _reply_pair(r, "ring_step_done", {})
        progs[main[r]].append(rep)
        coord.append(crecv)
