"""Runtime comm sanitizer: live conformance against the verified model.

The port's copy of ``repro.core.engine.verify.sanitizer``.

``CEPHALO_COMM_SANITIZE=1`` (or ``build_train_step(...,
sanitize=True)``) arms one :class:`CommSanitizer` per ring worker.  At
each collective's start the sanitizer derives the rank's *expected*
send/recv sequence from :func:`verify.model.exchange_steps` — the same
function the static checker (:mod:`verify.simulate`) proves safe for
the paper's Sec. 2 / App. C data plane — and then checks every live
``_RingLinks`` event against it as it happens:

* each send/recv role and its full wire meta must equal the next
  expected event (a swapped send order, a reused tag, or a skipped ack
  raises :class:`ProtocolViolation` **at the offending rank**, with
  rank/phase/tag/round context, before the bug can wedge a peer);
* collectives must arrive in the statically fixed op order
  (:func:`ring.overlap_plan` under overlap, AG-then-RS per round in
  sync mode);
* at step end the expected queue must be drained and no message may be
  left parked in a channel's pending buffer (a leaked prefetch);
* a watchdog thread observes every blocking receive and, past a stall
  threshold, warns with the wait-for edge (who this rank is blocked
  on, and which event it expected next) — the bounded ``ring_timeout``
  still delivers the hard error, the watchdog names the cycle early.

When sanitizing is off the hot path carries exactly one
``is None`` branch per hook — nil overhead, asserted by the throughput
benchmark's artifact gate.
"""

from __future__ import annotations

import os
import threading
import warnings
from collections import deque
from contextlib import contextmanager
from time import monotonic as _monotonic
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine.verify import model


class ProtocolViolation(RuntimeError):
    """A live comm event diverged from the verified protocol model."""


def resolve_sanitize(value: Optional[bool] = None) -> bool:
    """Sanitizer selection: explicit arg > ``$CEPHALO_COMM_SANITIZE`` >
    off.  Same env grammar as the other engine knobs."""
    if value is not None:
        return bool(value)
    raw = os.environ.get("CEPHALO_COMM_SANITIZE", "")
    if raw.lower() in ("", "0", "false", "no", "off"):
        return False
    if raw.lower() in ("1", "true", "yes", "on"):
        return True
    raise ValueError(
        f"CEPHALO_COMM_SANITIZE={raw!r} not understood; use 1/true/yes/on "
        "or 0/false/no/off")


def _op_of(phase: str) -> str:
    return "allgather" if phase.startswith("allgather") \
        else "reduce_scatter"


class CommSanitizer:
    """Per-worker live protocol conformance checker.

    Exactly one thread drives a worker's ring links at a time (the main
    thread for synchronous rounds, the dedicated comm thread under
    overlap), so ``begin_*``/``observe`` need no locking; only the
    watchdog reads concurrently, through ``_wait_lock``.
    """

    #: how many recent events to keep for violation context
    TRACE_DEPTH = 64

    def __init__(self, rank: int, n: int, *, stall_after: float = 30.0):
        self.rank, self.n = rank, n
        self.stall_after = stall_after
        self._expected: deque = deque()
        self._plan: Optional[deque] = None
        self._phase: str = "<idle>"
        self._tags: Dict[str, int] = {}
        self._trace: deque = deque(maxlen=self.TRACE_DEPTH)
        self._wait_lock = threading.Lock()
        self._waiting: Optional[Tuple[str, float]] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --- context for error messages --------------------------------------
    def _ctx(self) -> str:
        nxt = self._expected[0] if self._expected else None
        return (f"rank {self.rank} phase {self._phase!r} tags "
                f"{self._tags} (next expected: "
                f"{(nxt[0], nxt[2]) if nxt else 'collective end'}; "
                f"recent: {list(self._trace)[-6:]})")

    def _raise(self, why: str) -> None:
        raise ProtocolViolation(f"comm sanitizer: {why} [{self._ctx()}]")

    # --- step / collective lifecycle --------------------------------------
    def begin_step(self, ops: Sequence[Tuple[str, int]]) -> None:
        """Arm the fixed collective order of one engine step (or of one
        synchronous round): ``[("allgather", round_idx), ...]``."""
        if self._plan:
            self._raise(
                f"begin_step with {len(self._plan)} collective(s) of the "
                f"previous step still unexecuted: {list(self._plan)}")
        self._plan = deque(ops)
        if self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True,
                name=f"cephalo-rank{self.rank}-comm-sanitizer")
            self._watchdog.start()

    def begin_collective(self, phase: str, tags: Dict[str, int]) -> None:
        if self._expected:
            self._raise(
                f"collective {phase!r} began with "
                f"{len(self._expected)} event(s) of the previous "
                "collective outstanding")
        if self._plan is not None:
            if not self._plan:
                self._raise(
                    f"collective {phase!r} round {tags.get('round')} "
                    "began after the step's planned op order was "
                    "exhausted")
            want_op, want_round = self._plan.popleft()
            if _op_of(phase) != want_op or \
                    tags.get("round") != want_round:
                self._raise(
                    f"collective order diverged: got {_op_of(phase)} "
                    f"round {tags.get('round')}, the verified plan "
                    f"expects {want_op} round {want_round}")
        self._phase, self._tags = phase, dict(tags)
        self._expected = deque(
            model.exchange_steps(self.rank, self.n, phase, tags))

    def observe(self, role: str, meta: Dict[str, int]) -> None:
        """Check one live link event (called from ``_RingLinks``)."""
        self._trace.append((role, dict(meta)))
        if not self._expected:
            self._raise(f"unexpected {role} {meta} after the "
                        "collective's verified event sequence ended")
        want_role, _, want_meta = self._expected.popleft()
        if role != want_role or dict(meta) != want_meta:
            self._raise(
                f"event diverged from the verified schedule: got "
                f"{role} {dict(meta)}, expected {want_role} {want_meta}")

    def end_collective(self) -> None:
        if self._expected:
            self._raise(
                f"collective ended with {len(self._expected)} verified "
                f"event(s) never performed, next: {self._expected[0]}")
        self._phase, self._tags = "<idle>", {}

    def end_step(self, channels: Sequence) -> None:
        """Step-end drain check: the plan must be exhausted and no ring
        channel may hold parked messages (a leaked prefetch)."""
        if self._plan:
            self._raise(
                f"step ended with {len(self._plan)} planned "
                f"collective(s) never run: {list(self._plan)}")
        self._plan = None
        for ch in channels:
            pending = getattr(ch, "_pending", None)
            if pending:
                self._raise(
                    f"step ended with {len(pending)} message(s) parked "
                    "on a ring channel (leaked prefetch): "
                    f"{[(t, m) for t, m, _ in pending[:4]]}")

    # --- watchdog ---------------------------------------------------------
    @contextmanager
    def waiting(self, what: str):
        """Mark a blocking receive for the stall watchdog."""
        with self._wait_lock:
            self._waiting = (what, _monotonic())
        try:
            yield
        finally:
            with self._wait_lock:
                self._waiting = None

    def _watch(self) -> None:
        warned_at: Optional[float] = None
        while not self._stop.wait(0.25):
            with self._wait_lock:
                info = self._waiting
            if info is None:
                warned_at = None
                continue
            what, t0 = info
            elapsed = _monotonic() - t0
            if elapsed >= self.stall_after and warned_at != t0:
                warned_at = t0
                nxt = self._expected[0] if self._expected else None
                warnings.warn(
                    f"comm sanitizer watchdog: rank {self.rank} stalled "
                    f"{elapsed:.0f}s on {what} in phase {self._phase!r} "
                    f"tags {self._tags} (wait-for edge; next expected "
                    f"event: {(nxt[0], nxt[2]) if nxt else 'none'})",
                    RuntimeWarning)

    def close(self) -> None:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None


@contextmanager
def _null():
    yield


def waiting_guard(sanitizer: Optional[CommSanitizer], what: str):
    """``with waiting_guard(san, ...)`` — no-op when sanitizing is off."""
    if sanitizer is None:
        return _null()
    return sanitizer.waiting(what)
