"""Host-side collective transport for the multi-process MPMD substrate.

The port's copy of ``repro.core.engine.transport`` (numpy and the
standard library only).  One change: the pipe plane moves each array's
bytes with one ``sendall`` and ``recv_into`` a buffer of the receiver's
own, where the reference frames them with ``send_bytes`` /
``recv_bytes``, whose receive copies every array twice through a
Python-level read loop: ~0.5 GB/s on the CPU, too slow for the
gigabytes of a full-width round.  So a channel's connection must be a
socket (``multiprocessing.Pipe(duplex=True)``, a socket pair on Linux);
:class:`Channel` raises on anything else.  The messages, their bytes
and their accounting are the reference's.

The paper's runtime (Sec. 2 / App. C) moves two kinds of bulk payload per
collective round: gathered full-parameter buffers (AllGatherv) and full
gradient buffers (ReduceScatterv).  This module is the wire under
:mod:`repro_torch.core.engine.multiproc`: a tagged message channel between the
coordinator and one worker process, carrying a small pickled header over
a ``multiprocessing`` duplex pipe (an ``AF_UNIX`` socket pair on Linux)
and array payloads over one of two data planes:

* ``shm`` (default) — a per-direction :class:`ShmArena`
  (``multiprocessing.shared_memory``) the sender memcpys arrays into;
  the header carries only offsets.  Safe without locks because the
  substrate's protocol is strict request→reply per channel: the sender
  never reuses an arena before the receiver has copied out and replied.
  Arenas grow by replacement (a new segment is announced in the header)
  and fall back to the pipe when shared memory is unavailable.
* ``pipe`` — array bytes sent unframed on the socket pair
  (``sendall`` / ``recv_into``), no shared memory involved.

Select with ``CEPHALO_MP_TRANSPORT=shm|pipe`` or the engine's
``transport=`` knob.  Both planes carry identical bytes — the parity
tests run the same step on either.

Coordinator↔worker channels are strict request→reply; the worker↔worker
ring channels additionally support tag-matched out-of-order receive
(:meth:`Channel.recv_match`) so the overlapped round pipeline's
prefetch traffic (round *k+1* gathers in flight under round *k*'s
compute, ``CEPHALO_MP_OVERLAP=1``) can never be mistaken for the
current round's payload.
"""

from __future__ import annotations

import os
import pickle
import secrets
import socket
import warnings
from time import monotonic as _monotonic
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: transport selection order: explicit arg > env > default
DEFAULT_TRANSPORT = "shm"
TRANSPORTS = ("shm", "pipe")

#: collective topology of the multiproc substrate: ``hub`` routes every
#: AllGatherv/ReduceScatterv payload through the coordinator;
#: ``ring`` moves them over peer-to-peer worker↔worker channels
#: (:mod:`repro_torch.core.engine.ring`) and shrinks the coordinator to a
#: control plane.  Selection order: explicit arg > env > default.
DEFAULT_TOPOLOGY = "hub"
TOPOLOGIES = ("hub", "ring")


def resolve_transport(name: Optional[str] = None) -> str:
    name = name or os.environ.get("CEPHALO_MP_TRANSPORT", DEFAULT_TRANSPORT)
    if name not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {name!r}; choose from {TRANSPORTS}")
    return name


def resolve_topology(name: Optional[str] = None) -> str:
    name = name or os.environ.get("CEPHALO_MP_TOPOLOGY", DEFAULT_TOPOLOGY)
    if name not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {name!r}; choose from {TOPOLOGIES}")
    return name


def resolve_overlap(value: Optional[bool] = None) -> bool:
    """Round-overlap selection: explicit arg > ``$CEPHALO_MP_OVERLAP`` >
    off.  The env var accepts 1/true/yes/on (any case) for on and
    0/false/no/off for off."""
    if value is not None:
        return bool(value)
    raw = os.environ.get("CEPHALO_MP_OVERLAP", "")
    if raw.lower() in ("", "0", "false", "no", "off"):
        return False
    if raw.lower() in ("1", "true", "yes", "on"):
        return True
    raise ValueError(
        f"CEPHALO_MP_OVERLAP={raw!r} not understood; use 1/true/yes/on "
        "or 0/false/no/off")


def _try_import_shm():
    try:
        from multiprocessing import shared_memory
        return shared_memory
    except Exception:   # noqa: BLE001 - no shm plane; pragma: no cover
        return None


class ShmArena:
    """One-direction bulk buffer between two processes in lockstep.

    The *owner* creates (and grows, by replacement) the segment; the
    *peer* attaches lazily by the name announced in each message header.
    ``write`` returns ``None`` when shared memory cannot hold the
    payload (creation failed) — the caller then inlines the arrays over
    the pipe.
    """

    def __init__(self, owner: bool, size: int = 1 << 22):
        self._shm_mod = _try_import_shm()
        self.owner = owner
        self.size = int(size)
        self.seg = None
        self.name: Optional[str] = None
        self.disabled = self._shm_mod is None

    def _ensure(self, nbytes: int) -> bool:
        if self.disabled:
            return False
        if self.seg is not None and self.size >= nbytes:
            return True
        want = max(self.size, 1 << 16)
        while want < nbytes:
            want *= 2
        try:
            seg = self._shm_mod.SharedMemory(
                name=f"cephalo_{os.getpid()}_{secrets.token_hex(4)}",
                create=True, size=want)
        except OSError as e:
            # /dev/shm full or unwritable: degrade to the pipe plane for
            # the rest of this channel's life — loudly, not silently
            warnings.warn(
                f"shared-memory arena creation failed ({e!r}); falling "
                f"back to the pipe data plane for this channel",
                RuntimeWarning, stacklevel=2)
            self.disabled = True
            return False
        self.close()
        self.seg, self.size, self.name = seg, want, seg.name
        return True

    def write(self, arrays: Dict[str, np.ndarray]
              ) -> Optional[Tuple[str, List[Tuple[str, Any, Any, int]]]]:
        """Copy arrays into the arena; return (segment_name, manifest)
        where manifest rows are (key, shape, dtype_str, offset)."""
        total = sum(int(a.nbytes) for a in arrays.values())
        if not self._ensure(total):
            return None
        manifest, off = [], 0
        buf = self.seg.buf
        for k, a in arrays.items():
            a = np.ascontiguousarray(a)
            n = int(a.nbytes)
            buf[off: off + n] = a.reshape(-1).view(np.uint8).data
            manifest.append((k, a.shape, str(a.dtype), off))
            off += n
        return self.seg.name, manifest

    def read(self, name: str, manifest) -> Dict[str, np.ndarray]:
        """Attach (or re-attach) to ``name`` and copy the arrays out."""
        if self.seg is None or self.name != name:
            # NOTE: attaching registers the segment with the resource
            # tracker shared across the spawn tree — a harmless dup of
            # the owner's registration; the owner's unlink clears it.
            self.close()
            self.seg = self._shm_mod.SharedMemory(name=name)
            self.name = name
        out: Dict[str, np.ndarray] = {}
        buf = self.seg.buf
        for k, shape, dtype, off in manifest:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out[k] = np.frombuffer(
                bytes(buf[off: off + n]), dtype=dtype).reshape(shape)
        return out

    def close(self) -> None:
        """Detach (and, for the owner, unlink) the segment.  Idempotent;
        an already-gone segment (peer unlinked first, interpreter
        shutdown races) is expected and stays quiet, anything else is
        reported."""
        if self.seg is None:
            return
        seg, self.seg, self.name = self.seg, None, None
        try:
            seg.close()
            if self.owner:
                seg.unlink()
        except FileNotFoundError:
            pass    # peer (or a previous close) already unlinked it
        except (OSError, BufferError) as e:
            warnings.warn(
                f"shared-memory arena teardown failed ({e!r}); the "
                f"segment may leak until process exit",
                RuntimeWarning, stacklevel=2)


class Channel:
    """Tagged request/reply messaging over one duplex pipe connection.

    Each message is ``(tag, meta, arrays)``: a pickled ``(tag, meta,
    manifest)`` header frame followed (pipe mode) by each array's bytes,
    unframed, on the socket, or (shm mode) by nothing — the header's manifest points into
    the sender's arena.  Coordinator↔worker channels stay strictly
    alternating request→reply; the worker↔worker ring channels of the
    overlapped round pipeline instead use :meth:`recv_match` — a
    tag-matched out-of-order receive that parks messages for a *later*
    round in a pending buffer, so prefetch traffic can never be
    mistaken for the current round's payload.
    """

    def __init__(self, conn, transport: str = DEFAULT_TRANSPORT):
        self.conn = conn
        #: the connection's socket, which carries the pipe plane's
        #: array bytes unframed.
        fd = os.dup(conn.fileno())
        try:
            self._sock: Any = socket.socket(fileno=fd)
        except OSError as e:
            os.close(fd)
            raise ValueError(
                "a Channel needs a socket connection "
                "(multiprocessing.Pipe(duplex=True)); the pipe plane "
                f"moves array bytes on the socket ({e})") from e
        self.transport = resolve_transport(transport)
        use_shm = self.transport == "shm"
        # each endpoint owns (creates, grows, unlinks) its own send
        # arena and attaches read-only to the peer's by announced name.
        self._send_arena = ShmArena(owner=True) if use_shm else None
        self._recv_arena = ShmArena(owner=False) if use_shm else None
        #: messages received but not yet claimed by a recv/recv_match
        #: (arrays are copied out of the peer's arena on arrival, so
        #: parking a message never blocks the sender's arena reuse).
        self._pending: List[Tuple[str, dict, Dict[str, np.ndarray]]] = []
        #: data-plane accounting: array payload bytes by message tag,
        #: each direction (headers/metas excluded — those are the
        #: control plane).  The throughput benchmark reads these to
        #: show hub-vs-ring bytes through the coordinator.
        self.array_bytes_out: Dict[str, int] = {}
        self.array_bytes_in: Dict[str, int] = {}
        #: array payload bytes received but never claimed: parked
        #: messages discarded at close plus stale messages dropped by
        #: :meth:`recv_match` — nonzero means a peer sent traffic this
        #: endpoint paid for on the wire and then threw away.
        self.array_bytes_dropped: Dict[str, int] = {}

    #: largest single socket read (Linux caps one read below 2 GiB)
    RAW_CHUNK = 1 << 30

    def _recv_raw(self, shape, dtype) -> np.ndarray:
        """One array's bytes off the socket, into a new array."""
        out = np.empty(shape, dtype=dtype)
        view = memoryview(out.reshape(-1).view(np.uint8))
        got = 0
        while got < len(view):
            n = self._sock.recv_into(view[got: got + self.RAW_CHUNK],
                                     min(len(view) - got, self.RAW_CHUNK),
                                     socket.MSG_WAITALL)
            if n == 0:
                raise EOFError("peer closed the channel mid-payload")
            got += n
        return out

    # --- send ---------------------------------------------------------------
    def send(self, tag: str, meta: Optional[dict] = None,
             arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        arrays = arrays or {}
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        self.array_bytes_out[tag] = \
            self.array_bytes_out.get(tag, 0) + nbytes
        placed = self._send_arena.write(arrays) \
            if (self._send_arena is not None and arrays) else None
        if placed is not None:
            seg_name, manifest = placed
            header = (tag, meta or {}, ("shm", seg_name, manifest))
            self.conn.send_bytes(pickle.dumps(header, protocol=4))
            return
        manifest = [(k, a.shape, str(a.dtype)) for k, a in arrays.items()]
        header = (tag, meta or {}, ("pipe", None, manifest))
        self.conn.send_bytes(pickle.dumps(header, protocol=4))
        for _, a in arrays.items():
            self._sock.sendall(
                np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)

    # --- recv ---------------------------------------------------------------
    def recv(self, timeout: Optional[float] = None,
             alive=None) -> Tuple[str, dict, Dict[str, np.ndarray]]:
        """Blocking receive; with ``timeout``, polls in 50ms slices and
        calls ``alive()`` between slices so a dead peer raises instead of
        hanging forever.  Messages parked by :meth:`recv_match` are
        delivered first, in arrival order."""
        if self._pending:
            return self._pending.pop(0)
        return self._recv_wire(timeout, alive)

    #: recv_match parks at most this many unmatched messages before
    #: declaring a protocol error.  The overlap pipeline's prefetch
    #: depth bounds legitimate parking to a handful of in-flight
    #: messages per channel; unbounded growth means the peer is sending
    #: traffic this endpoint will never claim.
    MAX_PENDING = 64

    def recv_match(self, tag: str, match: dict,
                   timeout: Optional[float] = None,
                   alive=None, stale=None
                   ) -> Tuple[str, dict, Dict[str, np.ndarray]]:
        """Tag-matched out-of-order receive.

        Returns the first message (pending buffer first, then the wire)
        whose tag equals ``tag`` and whose meta contains every ``match``
        item; non-matching messages are parked in arrival order for a
        later ``recv``/``recv_match``.  This is what lets the overlapped
        ring pipeline prefetch round *k+1* traffic while round *k* is
        still draining: a receiver waiting for round *k* simply parks any
        early round-*k+1* payload instead of mistaking it for its own.
        ``timeout`` bounds the *total* wait across parked mismatches.

        Two fail-fast guards keep a protocol error from stalling until
        the timeout: ``stale`` — an optional ``meta -> bool`` predicate
        naming messages that can *never* be claimed (e.g. a ring message
        from an already-completed engine step), which are dropped with a
        warning instead of parked — and :data:`MAX_PENDING`, beyond
        which parking raises immediately.
        """
        for i, (t, m, a) in enumerate(self._pending):
            if t == tag and all(m.get(k) == v for k, v in match.items()):
                return self._pending.pop(i)
        waited = 0.0
        while True:
            left = None if timeout is None else max(timeout - waited, 0.0)
            t0 = _monotonic()
            try:
                got = self._recv_wire(left, alive)
            except TimeoutError as e:
                raise self._match_timeout(tag, match, timeout) from e
            waited += _monotonic() - t0
            t, m, _ = got
            if t == tag and all(m.get(k) == v for k, v in match.items()):
                return got
            if stale is not None and stale(m):
                self._count_dropped(got)
                warnings.warn(
                    f"dropping stale {t!r} message (meta {m}) that can "
                    f"no longer be claimed while waiting for {tag!r} "
                    f"{match}", RuntimeWarning)
                continue
            self._pending.append(got)
            if len(self._pending) > self.MAX_PENDING:
                raise RuntimeError(
                    f"protocol error: {len(self._pending)} unmatched "
                    f"messages parked while waiting for {tag!r} {match} "
                    f"(first parked: "
                    f"{[(p[0], p[1]) for p in self._pending[:4]]})")
            if timeout is not None and waited >= timeout:
                raise self._match_timeout(tag, match, timeout)

    def _match_timeout(self, tag: str, match: dict,
                       timeout: float) -> TimeoutError:
        return TimeoutError(
            f"no {tag!r} message matching {match} within {timeout:.1f}s "
            f"({len(self._pending)} unmatched parked: "
            f"{[(p[0], p[1]) for p in self._pending[:4]]})")

    def _recv_wire(self, timeout: Optional[float] = None,
                   alive=None) -> Tuple[str, dict, Dict[str, np.ndarray]]:
        if timeout is not None:
            waited = 0.0
            while not self.conn.poll(0.05):
                waited += 0.05
                if alive is not None and not alive():
                    raise EOFError("peer process died")
                if waited >= timeout:
                    raise TimeoutError(
                        f"no message within {timeout:.0f}s")
        tag, meta, (plane, seg_name, manifest) = pickle.loads(
            self.conn.recv_bytes())
        if plane == "shm":
            if self._recv_arena is None:
                self._recv_arena = ShmArena(owner=False)
            arrays = self._recv_arena.read(seg_name, manifest)
        else:
            arrays = {k: self._recv_raw(shape, dtype)
                      for k, shape, dtype in manifest}
        self.array_bytes_in[tag] = self.array_bytes_in.get(tag, 0) + \
            sum(int(a.nbytes) for a in arrays.values())
        return tag, meta, arrays

    def _count_dropped(self, msg: Tuple[str, dict, Dict[str, np.ndarray]]
                       ) -> None:
        tag, _, arrays = msg
        self.array_bytes_dropped[tag] = \
            self.array_bytes_dropped.get(tag, 0) + \
            sum(int(a.nbytes) for a in arrays.values())

    def close(self) -> None:
        """Release arenas and the pipe connection.  Idempotent; a
        connection that is already gone (peer died, double close) is
        expected and stays quiet, anything else is reported.

        Parked messages (received, never claimed) are not silently
        forgotten: closing over them warns with the unclaimed tags/metas
        and counts their payload bytes in ``array_bytes_dropped`` — on a
        healthy channel the protocol drains every message it paid for,
        so anything still parked here points at a protocol bug (e.g. a
        prefetch the overlap pipeline never consumed)."""
        for arena in (self._send_arena, self._recv_arena):
            if arena is not None:
                arena.close()
        if self._pending:
            for msg in self._pending:
                self._count_dropped(msg)
            warnings.warn(
                f"channel closed with {len(self._pending)} parked "
                "message(s) never claimed (unclaimed: "
                f"{[(t, m) for t, m, _ in self._pending[:4]]}; "
                f"{sum(self.array_bytes_dropped.values())} total bytes "
                "dropped)", RuntimeWarning, stacklevel=2)
        self._pending = []
        self._sock.close()
        try:
            self.conn.close()
        except OSError as e:
            warnings.warn(
                f"channel connection close failed ({e!r})",
                RuntimeWarning, stacklevel=2)
