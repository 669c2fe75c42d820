"""Abstract execution of protocol event programs — the static checker.

The port's copy of ``repro.core.engine.verify.simulate``.

Executes the per-thread programs of :func:`verify.model.cell_programs`
under an abstract channel semantics and decides, for one protocol cell,
the safety properties Cephalo's parity contract (paper Sec. 2 / App. C)
rests on:

(a) **deadlock freedom** — the maximal execution completes every
    thread; if not, the wait-for graph (recv → channel writer,
    rendezvous send → channel reader, queue get → producer, join →
    target) is extracted and any cycle reported.  Soundness: the
    programs are deterministic and every directed channel has a single
    writer and a single reader, so the network is a Kahn process
    network — the terminal state is schedule-independent, and ONE
    maximal execution decides deadlock for all schedules.
(b) **matched sends** — every receive's delivered message satisfies its
    match (strict receives verify in place, ``match``-mode receives
    park mismatches exactly like ``Channel.recv_match``), every parked
    message is eventually claimed, and no two messages on a
    ``recv_match`` channel share a match key (a tag collision the
    out-of-order parking could mis-deliver).
(c) **bounded buffering** — the overlap handoff queues never exceed the
    double-buffered structural cap of 2 and parking never exceeds
    ``Channel.MAX_PENDING``.  The scheduler runs producers (comm
    threads, then the coordinator) ahead of consumers, so the measured
    occupancy is the worst case any real interleaving can reach.
(d) **ack-gated arena reuse** — a writer never sends bulk payload
    ``k+1`` on a direction before evidence (carried on the paired
    reverse direction) that the reader copied payload ``k`` out of the
    shm arena.

Both data planes are checked: ``pipe`` treats bulk sends as rendezvous
(a large send can block until the peer drains it — the deadlock-relevant
semantics), ``shm`` treats them as buffered (the arena-reuse property is
what protects that plane).  Header-only messages (acks, control) are
always buffered — the OS socket buffer absorbs them.

This still describes the port's wire
(:mod:`repro_torch.core.engine.transport`), whose pipe plane differs
from the reference's: a message is its pickled header (``send_bytes``,
small) followed by each array's bytes raw on the same socket pair
(``sendall``; the peer reads them with ``recv_into`` after the header).
A ``sendall`` larger than the socket's buffer returns only once the peer
has read the rest, so a bulk send blocks until its reader drains it, as
the reference's large ``send_bytes`` does; modelling every bulk send as
a rendezvous is the worst case of that (a payload small enough for the
buffer only lets the sender run ahead, which in a Kahn network cannot
create a deadlock).  A header-only message is one ``send_bytes`` of a
few hundred bytes, and the socket's buffer (hundreds of KiB on Linux)
holds hundreds of them: buffered, as modelled.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine.transport import Channel
from repro_torch.core.engine.verify import model
from repro_torch.core.engine.verify.model import BASELINE, Cell, Ev, Variant

#: structural cap of the overlap handoff queues (double buffering: the
#: op order admits at most the current round's item plus one prefetch).
QUEUE_CAP = 2


@dataclasses.dataclass
class Violation:
    check: str          # deadlock | match | collision | queue_cap | arena | pending_cap | leak
    thread: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.thread}: {self.detail}"


@dataclasses.dataclass
class _Msg:
    kind: str
    meta: Tuple[Tuple[str, object], ...]
    bulk: bool
    sender: str
    ack: int            # sender's copied-count snapshot of the paired direction
    consumed: bool = False


def _pair_chan(chan: tuple) -> tuple:
    """The reverse direction sharing a duplex pipe with ``chan`` — the
    lane ack evidence for ``chan``'s arena travels on."""
    kind, idx = chan
    return {"c2w": "w2c", "w2c": "c2w", "fwd": "bwd", "bwd": "fwd"}[kind], idx


@dataclasses.dataclass
class Report:
    """Result of one plane's simulation."""

    plane: str
    ok: bool
    violations: List[Violation]
    max_queue: Dict[tuple, int]
    max_parked: Dict[tuple, int]
    events_run: int

    def first(self) -> Optional[Violation]:
        return self.violations[0] if self.violations else None


class _Sim:
    def __init__(self, progs: Dict[str, List[Ev]], rendezvous_bulk: bool,
                 plane: str):
        self.progs = progs
        self.rendezvous = rendezvous_bulk
        self.plane = plane
        self.pc = {t: 0 for t in progs}
        self.blocked: Dict[str, Tuple[str, tuple, Optional[_Msg]]] = {}
        self.wire: Dict[tuple, deque] = {}
        self.parked: Dict[tuple, List[_Msg]] = {}
        self.queues: Dict[tuple, deque] = {}
        self.max_queue: Dict[tuple, int] = {}
        self.max_parked: Dict[tuple, int] = {}
        self.copied: Dict[tuple, int] = {}      # bulk msgs reader copied out
        self.bulk_sent: Dict[tuple, int] = {}
        self.known_ack: Dict[tuple, int] = {}   # acked copies known to writer
        self.history: Dict[tuple, List[_Msg]] = {}
        self.violations: List[Violation] = []
        self.events_run = 0
        # endpoint maps (single writer / single reader per direction)
        self.writer: Dict[tuple, str] = {}
        self.reader: Dict[tuple, str] = {}
        self.q_producer: Dict[tuple, str] = {}
        self.q_consumer: Dict[tuple, str] = {}
        self.match_chans = set()
        for t, prog in progs.items():
            for ev in prog:
                if ev.op == "send":
                    old = self.writer.setdefault(ev.chan, t)
                    assert old == t, f"two writers on {ev.chan}"
                elif ev.op == "recv":
                    old = self.reader.setdefault(ev.chan, t)
                    assert old == t, f"two readers on {ev.chan}"
                    if ev.mode == "match":
                        self.match_chans.add(ev.chan)
                elif ev.op == "put":
                    self.q_producer.setdefault(ev.chan, t)
                elif ev.op == "get":
                    self.q_consumer.setdefault(ev.chan, t)
        # producers-first: comm threads, then coordinator, then mains —
        # maximizes queue/parking occupancy (worst case for check c)
        def prio(t: str) -> tuple:
            if t.endswith(".comm"):
                return (0, t)
            if t == "coord":
                return (1, t)
            return (2, t)
        self.order = sorted(progs, key=prio)

    # --- channel plumbing ------------------------------------------------
    def _deliver(self, chan: tuple, msg: _Msg) -> None:
        """Reader-side bookkeeping common to deliver-and-park: the
        arrays are copied out of the peer's arena the moment the message
        is taken off the wire (``_recv_wire``), so parking still frees
        the arena."""
        if msg.bulk:
            self.copied[chan] = self.copied.get(chan, 0) + 1
        pair = _pair_chan(chan)
        self.known_ack[pair] = max(self.known_ack.get(pair, 0), msg.ack)
        msg.consumed = True

    def _step_send(self, t: str, ev: Ev) -> bool:
        chan = ev.chan
        ack = self.copied.get(_pair_chan(chan), 0)
        msg = _Msg(ev.kind, ev.meta, ev.bulk, t, ack)
        if ev.bulk:
            sent = self.bulk_sent.get(chan, 0)
            known = self.known_ack.get(chan, 0)
            if sent != known:
                self.violations.append(Violation(
                    "arena", t,
                    f"bulk send #{sent + 1} on {chan} before the reader "
                    f"acknowledged copy-out of payload #{known + 1} "
                    f"(kind {ev.kind!r} meta {dict(ev.meta)}): the shm "
                    "arena would be overwritten while still referenced"))
            self.bulk_sent[chan] = sent + 1
        self.wire.setdefault(chan, deque()).append(msg)
        self.history.setdefault(chan, []).append(msg)
        if self.rendezvous and ev.bulk:
            # the append IS progress (the receiver can now take it);
            # the thread parks until the reader marks it consumed
            self.blocked[t] = ("send", chan, msg)
            return True
        self.pc[t] += 1
        return True

    def _step_recv(self, t: str, ev: Ev) -> bool:
        chan = ev.chan
        want = model.match_key(ev.kind, ev.meta)
        parked = self.parked.setdefault(chan, [])
        if ev.mode == "match":
            for i, m in enumerate(parked):
                if model.match_key(m.kind, m.meta) == want:
                    parked.pop(i)
                    self.pc[t] += 1
                    return True
        elif parked:
            # strict recv pops the pending buffer first (Channel.recv),
            # then verifies — a parked leftover is out-of-protocol here
            m = parked.pop(0)
            if model.match_key(m.kind, m.meta) != want:
                self.violations.append(Violation(
                    "match", t,
                    f"strict recv on {chan} got parked {m.kind!r} "
                    f"{dict(m.meta)}, expected {ev.kind!r} "
                    f"{dict(ev.meta)}"))
            self.pc[t] += 1
            return True
        wire = self.wire.setdefault(chan, deque())
        while wire:
            m = wire.popleft()
            self._deliver(chan, m)
            got = model.match_key(m.kind, m.meta)
            if got == want:
                self.pc[t] += 1
                return True
            if ev.mode == "strict":
                self.violations.append(Violation(
                    "match", t,
                    f"strict recv on {chan} got {m.kind!r} "
                    f"{dict(m.meta)}, expected {ev.kind!r} "
                    f"{dict(ev.meta)}"))
                self.pc[t] += 1
                return True
            parked.append(m)
            self.max_parked[chan] = max(self.max_parked.get(chan, 0),
                                        len(parked))
            if len(parked) > Channel.MAX_PENDING:
                self.violations.append(Violation(
                    "pending_cap", t,
                    f"{len(parked)} unmatched messages parked on {chan} "
                    f"while waiting for {ev.kind!r} {dict(ev.meta)} "
                    f"(MAX_PENDING={Channel.MAX_PENDING})"))
                self.pc[t] += 1
                return True
        self.blocked[t] = ("recv", chan, None)
        return False

    def _step(self, t: str) -> bool:
        """Try to advance thread ``t`` one event; True on progress."""
        if t in self.blocked:
            op, chan, msg = self.blocked[t]
            if op == "send":
                if not msg.consumed:
                    return False
                del self.blocked[t]
                self.pc[t] += 1
                return True
            del self.blocked[t]
        prog = self.progs[t]
        if self.pc[t] >= len(prog):
            return False
        ev = prog[self.pc[t]]
        if ev.op == "send":
            return self._step_send(t, ev)
        if ev.op == "recv":
            return self._step_recv(t, ev)
        if ev.op == "put":
            q = self.queues.setdefault(ev.chan, deque())
            q.append(1)
            self.max_queue[ev.chan] = max(self.max_queue.get(ev.chan, 0),
                                          len(q))
            self.pc[t] += 1
            return True
        if ev.op == "get":
            q = self.queues.setdefault(ev.chan, deque())
            if not q:
                self.blocked[t] = ("get", ev.chan, None)
                return False
            q.popleft()
            self.pc[t] += 1
            return True
        if ev.op == "join":
            target = ev.kind
            if self.pc.get(target, 0) >= len(self.progs.get(target, [])) \
                    and target not in self.blocked:
                self.pc[t] += 1
                return True
            self.blocked[t] = ("join", (target,), None)
            return False
        raise AssertionError(f"unknown op {ev.op!r}")

    def _wait_edges(self) -> List[Tuple[str, str, str]]:
        edges = []
        for t in self.order:
            if self.pc[t] >= len(self.progs[t]) and t not in self.blocked:
                continue
            info = self.blocked.get(t)
            if info is None:
                continue
            op, chan, _ = info
            if op == "recv":
                peer = self.writer.get(chan, "?")
                edges.append((t, peer, f"recv {chan}"))
            elif op == "send":
                peer = self.reader.get(chan, "?")
                edges.append((t, peer, f"rendezvous send {chan}"))
            elif op == "get":
                peer = self.q_producer.get(chan, "?")
                edges.append((t, peer, f"queue get {chan}"))
            elif op == "join":
                edges.append((t, chan[0], f"join {chan[0]}"))
        return edges

    def _find_cycle(self, edges) -> Optional[List[str]]:
        adj = {}
        for a, b, _ in edges:
            adj.setdefault(a, []).append(b)
        for start in adj:
            path, seen = [start], {start}
            node = start
            while True:
                nxts = adj.get(node, [])
                if not nxts:
                    break
                node = nxts[0]
                if node in seen:
                    return path[path.index(node):] if node in path \
                        else path + [node]
                path.append(node)
                seen.add(node)
        return None

    def run(self, max_events: int = 2_000_000) -> Report:
        # strict priority scheduling: after every event, restart from
        # the highest-priority thread.  Consumers (main threads) advance
        # only when every producer is blocked, so queue/parking
        # occupancy is measured at its worst case — any real
        # interleaving drains at least as eagerly.
        while True:
            progressed = False
            for t in self.order:
                if self._step(t):
                    progressed = True
                    self.events_run += 1
                    if self.events_run > max_events:
                        raise RuntimeError("simulation event budget "
                                           "exceeded (runaway model?)")
                    if self.violations:
                        return self._finish(aborted=True)
                    break
            if not progressed:
                break
        unfinished = [t for t in self.order
                      if self.pc[t] < len(self.progs[t])
                      or t in self.blocked]
        if unfinished:
            edges = self._wait_edges()
            cycle = self._find_cycle(edges)
            desc = "; ".join(f"{a} waits on {b} ({why})"
                             for a, b, why in edges)
            if cycle:
                desc = " -> ".join(cycle + cycle[:1]) + f" | {desc}"
            self.violations.append(Violation(
                "deadlock", unfinished[0],
                f"{len(unfinished)} thread(s) stuck: {desc}"))
            return self._finish(aborted=True)
        return self._finish(aborted=False)

    def _finish(self, aborted: bool) -> Report:
        if not aborted:
            for chan, q in self.wire.items():
                if q:
                    self.violations.append(Violation(
                        "leak", self.reader.get(chan, "?"),
                        f"{len(q)} message(s) never received on {chan}: "
                        f"{[(m.kind, dict(m.meta)) for m in list(q)[:4]]}"))
            for chan, parked in self.parked.items():
                if parked:
                    self.violations.append(Violation(
                        "leak", self.reader.get(chan, "?"),
                        f"{len(parked)} parked message(s) never claimed "
                        f"on {chan}: "
                        f"{[(m.kind, dict(m.meta)) for m in parked[:4]]}"))
            for chan, q in self.queues.items():
                if q:
                    self.violations.append(Violation(
                        "leak", self.q_consumer.get(chan, "?"),
                        f"{len(q)} item(s) left in handoff queue {chan}"))
            # tag-collision check on recv_match channels: two in-flight
            # messages with the same match key could be mis-delivered
            for chan in self.match_chans:
                seen: Dict[tuple, int] = {}
                for m in self.history.get(chan, []):
                    key = model.match_key(m.kind, m.meta)
                    seen[key] = seen.get(key, 0) + 1
                dups = {k: c for k, c in seen.items() if c > 1}
                if dups:
                    k, c = next(iter(dups.items()))
                    self.violations.append(Violation(
                        "collision", self.writer.get(chan, "?"),
                        f"{len(dups)} duplicated match key(s) on {chan}, "
                        f"e.g. {k} x{c}: recv_match parking could "
                        "mis-deliver one round's payload as another's"))
            for chan, occupancy in self.max_queue.items():
                if occupancy > QUEUE_CAP:
                    self.violations.append(Violation(
                        "queue_cap", self.q_producer.get(chan, "?"),
                        f"handoff queue {chan} reached {occupancy} live "
                        f"entries (structural cap {QUEUE_CAP}: double "
                        "buffering)"))
        return Report(plane=self.plane, ok=not self.violations,
                      violations=self.violations,
                      max_queue=dict(self.max_queue),
                      max_parked=dict(self.max_parked),
                      events_run=self.events_run)


def simulate_programs(progs: Dict[str, List[Ev]], *,
                      rendezvous_bulk: bool, plane: str) -> Report:
    return _Sim(progs, rendezvous_bulk, plane).run()


@dataclasses.dataclass
class CellReport:
    """Verdict for one protocol cell: both planes."""

    cell: Cell
    variant: Variant
    rejected: Optional[str]
    planes: List[Report]

    @property
    def ok(self) -> bool:
        return self.rejected is not None or all(p.ok for p in self.planes)

    def violations(self) -> List[Violation]:
        return [v for p in self.planes for v in p.violations]

    def summary(self) -> str:
        if self.rejected is not None:
            return f"{self.cell.label():<55} n/a ({self.rejected})"
        status = "ok" if self.ok else \
            f"FAIL {self.violations()[0]}"
        occ = max([o for p in self.planes
                   for o in p.max_queue.values()] or [0])
        return (f"{self.cell.label():<55} {status}  "
                f"(events {self.planes[0].events_run}, max queue {occ})")


def verify_cell(cell: Cell, variant: Variant = BASELINE) -> CellReport:
    """Check one cell on both data planes; a rejected-by-construction
    cell (hub + overlap) short-circuits — the engine refuses to build
    it, so there is no protocol to verify."""
    if cell.rejected_reason is not None:
        return CellReport(cell, variant, cell.rejected_reason, [])
    progs = model.cell_programs(cell, variant)
    return CellReport(cell, variant, None, [
        simulate_programs(progs, rendezvous_bulk=True, plane="pipe"),
        simulate_programs(progs, rendezvous_bulk=False, plane="shm"),
    ])
