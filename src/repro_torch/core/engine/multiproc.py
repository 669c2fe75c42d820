"""Multi-process MPMD substrate: one OS process per rank.

The port of ``repro.core.engine.multiproc``.  The loopback runtime
(:mod:`repro_torch.core.hetero_trainer`) reproduces the
paper's MPMD execution model — per-rank programs with unpadded
``(ell_i, m_i)`` shapes, one state shard per rank (Sec. 2), collective
rounds from the GA schedule (Fig. 4) — but simulates the fleet inside a
single process.  This module runs the *same* step across real process
boundaries:

* **ProcessEngine** — a :class:`~repro_torch.core.engine.api.TrainEngine`
  whose per-rank programs run in ``plan.n`` spawned worker processes.
  Each worker owns its rank's ragged state shard as tensors on its device
  (physical memory ∝ r_i, the paper's memory-balancing claim, now per
  *process*), runs the model's forward and backward under
  ``torch.autograd`` there (on the card, through the flash and SSD
  kernels, forward and backward), and applies Adam locally (ZeRO-3).
* **MultiProcessSubstrate** — the ``LoopbackSubstrate`` surface with a
  real data plane, in one of two topologies
  (``CEPHALO_MP_TOPOLOGY=hub|ring`` or the ``topology=`` knob):

  - ``hub`` — AllGatherv collects every worker's ragged shard slices at
    the coordinator and reassembles full flat unit buffers;
    ReduceScatterv sums the workers' full gradient buffers (fixed rank
    order, so the float accumulation is bit-identical to loopback's)
    and returns each rank its slice.  O(N·total_bytes) per round at the
    coordinator.
  - ``ring`` — workers exchange the same payloads peer-to-peer over
    worker↔worker ring channels (:mod:`repro_torch.core.engine.ring`): N−1
    steps per collective, each rank forwarding its neighbor's chunk,
    reductions applied accumulate-then-combine in fixed rank order so
    the results stay bitwise-identical to hub and loopback.  The
    coordinator shrinks to a control plane (round orchestration,
    telemetry, lifecycle) — its per-round data-plane bytes drop to ~0.
    With ``overlap_rounds=True`` (``CEPHALO_MP_OVERLAP=1``, launcher
    ``--overlap``) each worker moves its ring data plane to a dedicated
    communication thread: round *k+1*'s parameter AllGatherv prefetches
    under round *k*'s compute and round *k*'s gradient ReduceScatterv
    drains under round *k+1*'s, double-buffered, with a barrier only at
    step end for Adam — overlap changes *when* payloads move, never the
    reduction order, so bitwise parity holds
    (``tests/test_torch_parity_matrix.py`` gates the overlap cells too),
    and
    :meth:`ProcessEngine.hidden_comm_fraction` reports how much wire
    time the pipeline actually hid.

  Either way bytes move over :mod:`repro_torch.core.engine.transport`
  (shared-memory arenas or the socket pair): payloads on the wire are
  host numpy arrays, as in the reference; a worker copies what it
  receives onto its device (on the CPU, into tensors of its own, so that
  the sender may reuse its arena as soon as it has the reply).
* **WallClockOracle** — the real-measurement latency source of the
  elastic runtime (:mod:`repro_torch.core.engine.elastic`):
  passive queries are answered from each worker's measured fwd/bwd step
  timings, active probe queries run a timed single-layer pass (the
  paper's Sec. 3.1 profile, live; CUDA events on the card) *inside* the
  worker.  Straggler
  injection (:meth:`WallClockOracle.degrade`) makes the worker process
  actually slower — it sleeps proportionally to its compute — so the
  telemetry → refit → replan → migrate loop runs end-to-end on real
  wall-clock, not on a cost-model multiplier.

Schedules are walked entirely on the coordinator (workers only see
"microbatches [lo, hi) now"), so every registered GA schedule runs
unchanged across process boundaries; the cross-substrate parity test
asserts params + Adam moments match loopback after N steps.

Workers run on the engine's device, ``cuda`` unless the caller asks for
the CPU; on the card every worker shares the one device with the others
(and the coordinator), and each reports the kernel launches of its
compute in every reply (:func:`kernel_launches`), so the coordinator can
show that the kernels ran inside the rank processes.  Workers start by
``spawn`` (CUDA cannot be forked); on the card the coordinator builds the
kernels before it spawns, so that workers only load them.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fsdp, profiler
from repro_torch.core.engine import ring
from repro_torch.core.engine.api import TrainEngine
from repro_torch.core.engine.ranks import (REPLY_TIMEOUT, RankPool,
                                           apply_settings,
                                           report_start_failure)
from repro_torch.core.engine.schedules import Schedule
from repro_torch.core.engine.substrate import LoopbackSubstrate
from repro_torch.core.engine.transport import (Channel, resolve_overlap,
                                               resolve_topology,
                                               resolve_transport)
from repro_torch.core.engine.units import UnitPlanner, normalized_ratios
from repro_torch.core.engine.verify.sanitizer import (CommSanitizer,
                                                      resolve_sanitize,
                                                      waiting_guard)
from repro_torch.core.partition import Plan
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig, adam_update

#: default bounded wait for one ring-step receive between workers.  A
#: ring peer that produces nothing within this window is declared hung
#: (a dead peer is detected much sooner via EOF on its channel) — the
#: bounded wait is what turns a mid-collective worker death into a
#: clear RuntimeError naming the rank and phase instead of a hang.
#: Matches REPLY_TIMEOUT: a healthy neighbor may legitimately spend a
#: whole round's compute (a full-width model on a shared card) between
#: the round's allgather and its reduce-scatter, so the ring wait needs
#: the same generous budget.
RING_TIMEOUT = REPLY_TIMEOUT

#: coordinator message tags whose array payloads are collective data
#: plane traffic (vs control / lifecycle).  Request tags and their
#: array-carrying reply tags both appear; the throughput benchmark sums
#: these to show hub-vs-ring bytes through the coordinator.
COLLECTIVE_TAGS = ("get_state", "state", "round", "grads", "grad_accum",
                   "ring_round", "ring_step")

#: per-step ring communication telemetry keys: total seconds the wire
#: was busy per collective phase, and the *exposed* share — seconds the
#: compute (main) thread actually stalled on that phase.  Synchronous
#: rounds expose everything; the overlapped pipeline hides whatever fits
#: under compute.  hidden = total − exposed.
COMM_KEYS = ("allgather_s", "reduce_scatter_s",
             "exposed_allgather_s", "exposed_reduce_scatter_s")


def _empty_comm() -> Dict[str, float]:
    return {k: 0.0 for k in COMM_KEYS}


def kernel_launches() -> Dict[str, int]:
    """This process's kernel launch counts: each kernel's, and each
    kernel's by variant as ``"<kernel>/<variant>"`` (the flash backward's
    variants count both of its kernels)."""
    out = {"flash_attention": flash_ops.LAUNCHES,
           **flash_ops.BWD_LAUNCHES, "ssd_scan": ssd_ops.LAUNCHES,
           "ssd_scan_bwd": ssd_ops.BWD_LAUNCHES}
    for name, counts in (("flash_attention", flash_ops.VARIANT_LAUNCHES),
                         ("flash_bwd", flash_ops.BWD_VARIANT_LAUNCHES),
                         ("ssd_scan", ssd_ops.VARIANT_LAUNCHES),
                         ("ssd_scan_bwd", ssd_ops.BWD_VARIANT_LAUNCHES)):
        out.update({f"{name}/{v}": n for v, n in counts.items()})
    return out


def _add_counts(into: Dict[str, int], counts: Optional[dict]) -> None:
    for k, n in (counts or {}).items():
        into[k] = into.get(k, 0) + int(n)


def _from_host(a: np.ndarray) -> torch.Tensor:
    """A received payload array as a CPU tensor sharing its memory.  The
    transport's arrays are read-only copies nobody else holds; only
    torch's warning about that is silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array for the wire (a view on the CPU:
    sending copies it out at once)."""
    return t.detach().cpu().numpy()


def send_plane(ch: Channel) -> str:
    """The data plane ``ch`` sends arrays on: ``"shm"``, or ``"pipe"``
    (asked for, or the fallback after a failed arena)."""
    arena = ch._send_arena
    return "shm" if arena is not None and not arena.disabled else "pipe"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: overlap-pipeline handoff sentinels (queue items between the worker's
#: compute thread and its communication thread).
_ABORT = object()        # main → comm: step aborted, stop consuming
_COMM_FAILED = object()  # comm → main: comm thread died, see failure[0]


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything one worker needs to build its rank's program.

    Must stay picklable under the ``spawn`` start method: plain data
    only (the GA schedule deliberately stays coordinator-side — its
    ``chunk_fn`` lambda would not pickle, and workers never need it).
    """

    rank: int
    cfg: ArchConfig
    ratios: Tuple[float, ...]
    m: int
    ell: int
    seq: int
    adam: AdamConfig
    transport: str
    n_ranks: int
    #: the worker's device: ``cuda`` (it raises without one) or ``cpu``
    device: str = "cuda"
    #: the coordinator's intra-op thread count (0 leaves torch's
    #: default): spawned workers do not inherit ``torch.set_num_threads``
    threads: int = 0
    #: the coordinator's TF32 switches (matmul, cuDNN), so that fp32
    #: numerics match the loopback engine's in the coordinator's process
    allow_tf32: Tuple[bool, bool] = (False, True)
    topology: str = "hub"
    ring_timeout: float = RING_TIMEOUT
    #: arm the runtime comm sanitizer (verify.sanitizer.CommSanitizer):
    #: every ring link event is checked live against the statically
    #: verified protocol model.
    sanitize: bool = False


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

class _RingLinks:
    """One worker's two ring channels + the one-step exchange protocol.

    Each ring edge ``r → (r+1) mod n`` is a dedicated duplex pipe:
    payloads flow forward (``ring`` messages, arrays on the configured
    data plane), acknowledgements flow backward (``ring_ack``, header
    only).  The ack is what makes the shared-memory arena safe to reuse
    — a sender never writes its next payload before the receiver has
    copied the previous one out.

    Deadlock avoidance on the pipe plane (where a large ``send`` can
    block until the peer drains it): even ranks send-then-receive, odd
    ranks receive-then-send.  Any cycle of blocked senders would have to
    span the whole ring, and rank 1 (receive-first) breaks it; for the
    all-even corner (n == 1) there are no edges at all.

    Every message is tagged with its collective phase, ring step, round
    index, and the engine's step counter, and receives verify those
    tags.  In synchronous mode any mismatch is an immediate
    out-of-protocol error (nothing may legally arrive early); during an
    overlapped ``ring_step`` (``out_of_order`` set) receives go through
    :meth:`Channel.recv_match` instead, so a payload from a later round
    — the prefetch of round *k+1*'s AllGatherv under round *k*'s
    compute — parks in the channel buffer instead of being misdelivered,
    while provably-stale traffic and runaway parking still fail fast.
    Exactly one thread drives the links at a time (the worker main
    thread for synchronous rounds, the dedicated communication thread
    under overlap), so the channels need no locking.

    Receives are *bounded* (``spec.ring_timeout``): a peer that goes
    silent mid-collective surfaces as a RuntimeError naming the peer
    rank and the collective phase instead of hanging the fleet.
    """

    def __init__(self, rank: int, n: int, prev_ch: Channel,
                 next_ch: Channel, timeout: float):
        self.rank, self.n = rank, n
        self.prev_rank, self.next_rank = ring.ring_neighbors(n, rank)
        self.prev_ch, self.next_ch = prev_ch, next_ch
        self.timeout = timeout
        #: fault injection: seconds slept before every forward send,
        #: making this worker's outbound ring edge deliberately slow
        #: (the overlap stress tests drive it via the ``fault`` command).
        self.delay = 0.0
        #: set by the overlapped pipeline for the duration of a
        #: ``ring_step``: early traffic from a *later* collective is
        #: then legitimate and parks via ``recv_match``.  In synchronous
        #: mode no out-of-order traffic can legally exist, so any
        #: mismatch raises an out-of-protocol error immediately instead
        #: of parking until the timeout.
        self.out_of_order = False
        #: live protocol conformance checker (CEPHALO_COMM_SANITIZE=1) —
        #: ``None`` keeps the hot path at one ``is None`` branch per hook.
        self.sanitizer: Optional[CommSanitizer] = None
        #: seeded-bug injection for the sanitizer tests (the ``fault``
        #: command): "reuse_tag" stamps every outbound payload with
        #: round 0, "skip_ack" elides the arena-ack ops.
        self.mutate: Optional[str] = None

    def run(self, gen, phase: str, tags: Optional[dict] = None):
        """Drive one ring collective generator over the real channels.

        ``tags`` (round index, engine step counter) are stamped on every
        message of this collective and matched on receive.
        """
        tags = tags or {}
        if self.sanitizer is not None:
            self.sanitizer.begin_collective(phase, tags)
        result = ring.drive(
            gen,
            lambda step, payload: self._exchange(phase, step, payload,
                                                 tags))
        if self.sanitizer is not None:
            self.sanitizer.end_collective()
        return result

    def _exchange(self, phase: str, step: int,
                  payload: Dict[str, np.ndarray],
                  tags: dict) -> Dict[str, np.ndarray]:
        meta = {"phase": phase, "step": step, "src": self.rank, **tags}
        match = {"phase": phase, "step": step, **tags}
        send_meta = meta if self.mutate != "reuse_tag" else \
            {**meta, "round": 0}
        try:
            if self.rank % 2 == 0:
                self._send(send_meta, payload)
                received = self._recv(phase, step, match)
                self._send_ack(meta)
                self._recv_ack(phase, step, match)
            else:
                received = self._recv(phase, step, match)
                self._send_ack(meta)
                self._send(send_meta, payload)
                self._recv_ack(phase, step, match)
        except (EOFError, OSError) as e:
            raise RuntimeError(
                f"ring {phase} step {step}: rank {self.rank} lost peer "
                f"(prev rank {self.prev_rank} / next rank "
                f"{self.next_rank}): {e!r}") from e
        return received

    def _send(self, meta: dict, payload: Dict[str, np.ndarray]) -> None:
        if self.sanitizer is not None:
            # checked BEFORE the bytes move: a protocol bug raises at
            # the offending rank instead of wedging its peer
            self.sanitizer.observe("send_payload", meta)
        if self.delay > 0.0:
            time.sleep(self.delay)
        self.next_ch.send("ring", meta, payload)

    def _send_ack(self, meta: dict) -> None:
        if self.mutate == "skip_ack":
            return
        if self.sanitizer is not None:
            self.sanitizer.observe("send_ack", meta)
        self.prev_ch.send("ring_ack", meta)

    def _recv(self, phase: str, step: int,
              match: dict) -> Dict[str, np.ndarray]:
        _, g_meta, arrays = self._bounded_recv(self.prev_ch, "ring", match,
                                               phase, step, self.prev_rank)
        if self.sanitizer is not None:
            self.sanitizer.observe("recv_payload", g_meta)
        return arrays

    def _recv_ack(self, phase: str, step: int, match: dict) -> None:
        if self.mutate == "skip_ack":
            return
        _, g_meta, _ = self._bounded_recv(self.next_ch, "ring_ack", match,
                                          phase, step, self.next_rank)
        if self.sanitizer is not None:
            self.sanitizer.observe("recv_ack", g_meta)

    def _bounded_recv(self, ch: Channel, tag: str, match: dict,
                      phase: str, step: int, peer: int):
        try:
            with waiting_guard(self.sanitizer,
                               f"{tag!r} from rank {peer} "
                               f"({phase} step {step})"):
                return self._recv_checked(ch, tag, match, phase, step,
                                          peer)
        except TimeoutError as e:
            raise RuntimeError(
                f"ring {phase} step {step}: rank {self.rank} timed out "
                f"after {self.timeout:.0f}s waiting for {tag!r} from "
                f"rank {peer} ({e})") from e

    def _recv_checked(self, ch: Channel, tag: str, match: dict,
                      phase: str, step: int, peer: int):
        if not self.out_of_order:
            # synchronous rounds: nothing may legally arrive early,
            # so verify in place and fail fast on any mismatch
            got = ch.recv(timeout=self.timeout)
            g_tag, g_meta, _ = got
            if g_tag != tag or any(g_meta.get(k) != v
                                   for k, v in match.items()):
                raise RuntimeError(
                    f"ring {phase} step {step}: rank {self.rank} got "
                    f"out-of-protocol message {g_tag!r} (meta "
                    f"{g_meta}) from rank {peer}, expected {tag!r} "
                    f"{match}")
            return got
        # overlapped pipeline: prefetch traffic parks via the
        # tag-matched receive.  The step-end barrier fully drains
        # each engine step's ring traffic, so a message tagged with
        # an older gstep can never be claimed — drop-with-warning
        # instead of parking it until the timeout.
        gstep = match.get("gstep")
        stale = None if gstep is None else \
            (lambda m: m.get("gstep", gstep) < gstep)
        return ch.recv_match(tag, match, timeout=self.timeout,
                             stale=stale)

    def close(self) -> None:
        self.prev_ch.close()
        self.next_ch.close()


class _Worker:
    """Per-process rank runtime: state shard on the device + timers."""

    def __init__(self, spec: WorkerSpec,
                 ring_links: Optional[_RingLinks] = None):
        self.spec = spec
        self.ring_links = ring_links
        self.device = M.resolve_device(spec.device)
        # torch.utils.checkpoint imports torch._dynamo at its first call,
        # and that import leaves the frames that called it in a reference
        # cycle (torch.fx's ``wrap`` keeps its own frame): a first round
        # would hold its params and batch until the cyclic GC ran.  Done
        # here, the cycle holds only start-up frames.
        import torch._dynamo  # noqa: F401
        self.sub = LoopbackSubstrate(UnitPlanner(spec.cfg,
                                                 list(spec.ratios)),
                                     self.device)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.grad_acc: Optional[Dict[str, torch.Tensor]] = None
        self.tokens: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.w_val = 0.0
        self.slowdown = 1.0
        self.die_next_round = False
        self._probe_cache: Dict[Tuple[str, int], Callable] = {}
        self._probe_params = None

    def _release(self) -> None:
        """Return this process's unused device memory to the card: every
        rank's process runs on the coordinator's device, so the ranks
        share one card, and a block one keeps cached is one another
        cannot have."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _host_slices(self, flats: Dict[str, torch.Tensor]
                     ) -> List[Dict[str, np.ndarray]]:
        """{unit: flat on the device} → per-rank {unit: ragged slice}
        on the host: the layout's slices (``slice_flats``) copied off
        the device one by one, with no device copy of the whole."""
        out: List[Dict[str, np.ndarray]] = [{} for _ in range(self.sub.n)]
        for g in self.sub.planner.groups:
            off = 0
            flat = flats[g.name]
            for r, size in enumerate(g.layout.shard_sizes):
                out[r][g.name] = _to_host(flat[..., off: off + size])
                off += size
        return out

    def _tensor(self, a) -> torch.Tensor:
        """A received array as a tensor of this worker's own on its
        device: a host-to-device copy on the card, a copy on the CPU (a
        tensor is taken as it is: the worker made it)."""
        if isinstance(a, torch.Tensor):
            return a
        t = _from_host(a)
        return t.to(self.device) if self.device.type != "cpu" \
            else t.clone()

    # --- state ----------------------------------------------------------
    def scatter_state(self, arrays: Dict[str, np.ndarray]) -> None:
        for key, arr in arrays.items():
            unit, part = key.rsplit("|", 1)
            self.state.setdefault(unit, {})[part] = self._tensor(arr)

    def get_state(self, parts: Sequence[str]) -> Dict[str, np.ndarray]:
        return {f"{u}|{p}": _to_host(self.state[u][p])
                for u in self.state for p in parts}

    def state_nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for u in self.state.values() for t in u.values())

    # --- programs -------------------------------------------------------
    def begin_step(self, meta: dict, arrays: Dict[str, np.ndarray]) -> None:
        self.tokens, self.labels = (
            torch.from_numpy(np.asarray(arrays[k], dtype=np.int64)).to(
                self.device) for k in ("tokens", "labels"))
        self.w_val = float(meta["w_val"])
        self.grad_acc = None

    def round(self, lo: int, hi: int,
              flats: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
        """Hub round: fwd+bwd over [lo, hi) on coordinator-fed params,
        gradient flats returned to the coordinator for the rank-order
        sum."""
        meta, gflats = self._compute_round(lo, hi, flats)
        out = {f"G|{u}": _to_host(f) for u, f in gflats.items()}
        del gflats
        self._release()
        return meta, out

    def _compute_round(self, lo: int, hi: int,
                       flats: Dict[str, np.ndarray]
                       ) -> Tuple[dict, Dict[str, np.ndarray]]:
        """Fwd+bwd over microbatch indices [lo, hi) ∩ [0, ell).

        ``flats`` are host arrays or the worker's own device tensors.
        Returns (meta, grad flats on the device): meta carries the loss
        contribution, the measured fwd+bwd wall-clock seconds (inflated
        — and the process actually slept — under an injected slowdown)
        and the kernel launches of this compute (``launches``, the change
        of :func:`kernel_launches`).  The fwd/bwd *split* telemetry comes
        from the cheap single-layer probes at step end, not from timing
        the hot path twice.  The loss and its gradients come from the
        loopback engine's own function
        (:func:`~repro_torch.core.hetero_trainer.rank_loss_and_grads`) on
        the same rows, so the two engines agree bit for bit.
        """
        # the runtime imports this package: import it here, not above
        from repro_torch.core.hetero_trainer import (rank_loss_and_grads,
                                                     trainable)
        ell, m = self.spec.ell, self.spec.m
        lo, hi = min(lo, ell), min(hi, ell)
        if hi <= lo or m == 0 or self.tokens is None:
            return {"loss": 0.0, "n_mb": 0, "t_wall": 0.0}, {}
        # each host flat is dropped as soon as it is on the device
        params, leaves = trainable(self.sub.unflatten_flats(
            {u: self._tensor(flats.pop(u)) for u in list(flats)}))
        rows = slice(lo * m, hi * m)
        batch = {"tokens": self.tokens[rows], "labels": self.labels[rows],
                 "weights": torch.full(((hi - lo) * m, self.spec.seq),
                                       self.w_val, dtype=torch.float32,
                                       device=self.device)}
        before = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        loss_val, grads = rank_loss_and_grads(self.spec.cfg, params, leaves,
                                              batch)
        _sync(self.device)
        t_wall = time.perf_counter() - t0
        launches = {k: n - before[k] for k, n in kernel_launches().items()}
        if self.slowdown > 1.0:
            # an ACTUAL slow process: burn real wall-clock time
            time.sleep((self.slowdown - 1.0) * t_wall)
        _, treedef = fsdp.tree_flatten(params)
        gflats = self.sub.flatten_tree(fsdp.tree_unflatten(treedef, grads))
        del grads, params, leaves
        meta = {"loss": loss_val, "n_mb": hi - lo,
                "t_wall": t_wall * self.slowdown, "launches": launches}
        return meta, gflats

    # --- ring data-plane phases (shared by sync rounds and overlap) -----
    def _own_param_chunks(self) -> Dict[str, np.ndarray]:
        return {g.name: _to_host(self.state[g.name]["p"])
                for g in self.sub.planner.groups}

    def _ring_allgather(self, own: Dict[str, np.ndarray], lo: int, hi: int,
                        tags: dict, comm: Dict[str, float]):
        """Ring AllGatherv of every rank's own param chunks; returns the
        per-origin chunk list."""
        rank, n = self.spec.rank, self.spec.n_ranks
        phase = f"allgather(p)[{lo},{hi})"
        t0 = time.perf_counter()
        gen = ring.allgatherv(rank, n, own)
        if self.ring_links is None:
            if n != 1:
                raise RuntimeError(
                    f"rank {rank}: ring round without ring links (n={n})")
            got = ring.drive(gen, None)
        else:
            got = self.ring_links.run(gen, phase, tags)
        comm["allgather_s"] += time.perf_counter() - t0
        return got

    def _ring_reduce_scatter(self, dest_chunks, lo: int, hi: int,
                             tags: dict, comm: Dict[str, float]):
        """Ring ReduceScatterv (accumulate half); returns the collected
        per-origin raw chunks addressed to this rank."""
        rank, n = self.spec.rank, self.spec.n_ranks
        phase = f"reduce_scatter(G)[{lo},{hi})"
        t0 = time.perf_counter()
        gen = ring.reduce_scatterv(rank, n, dest_chunks)
        if self.ring_links is None:
            collected = ring.drive(gen, None)
        else:
            collected = self.ring_links.run(gen, phase, tags)
        comm["reduce_scatter_s"] += time.perf_counter() - t0
        return collected

    def _round_compute(self, rd: dict) -> Tuple[dict, Optional[list]]:
        """Compute one round on previously gathered params (``rd["got"]``
        is the per-origin chunk list): returns (telemetry meta, the
        per-destination gradient chunks for the ReduceScatterv — ``None``
        when this rank is inactive or produced no gradients)."""
        out_meta = {"loss": 0.0, "n_mb": 0, "t_wall": 0.0}
        dest_chunks = None
        if self.spec.rank in set(rd["active"]):
            # chunks to the device first: concat and slice run there
            flats = self.sub.concat_slices(
                [{u: self._tensor(a) for u, a in chunks.items()}
                 for chunks in rd["got"]], key=None)
            out_meta, gflats = self._compute_round(
                int(rd["lo"]), int(rd["hi"]), flats)
            if gflats:
                dest_chunks = self._host_slices(gflats)
            del gflats
            self._release()
        return out_meta, dest_chunks

    def ring_round(self, meta: dict) -> dict:
        """One synchronous collective round on the peer-to-peer ring.

        The coordinator sent only control (``lo``/``hi`` plus the active
        rank set); params come from a ring AllGatherv of every worker's
        own state chunks, gradients leave through a ring ReduceScatterv
        whose per-destination contributions are combined in fixed rank
        order (:func:`repro_torch.core.engine.ring.combine_fixed_order`), so
        the round sum is bitwise-identical to the hub coordinator's.
        Ranks outside the active set still forward ring traffic and
        still collect their gradient slice (they own state and run Adam
        too).
        """
        lo, hi = int(meta["lo"]), int(meta["hi"])
        tags = {"round": int(meta.get("round", 0)),
                "gstep": int(meta.get("gstep", 0))}
        comm = _empty_comm()
        san = self.ring_links.sanitizer if self.ring_links is not None \
            else None
        if san is not None:
            # a synchronous round's fixed op order: AG then RS
            san.begin_step([("allgather", tags["round"]),
                            ("reduce_scatter", tags["round"])])
        own = self._own_param_chunks()
        got = self._ring_allgather(own, lo, hi, tags, comm)
        out_meta, dest_chunks = self._round_compute(
            {"lo": lo, "hi": hi, "active": meta["active"], "got": got})
        collected = self._ring_reduce_scatter(dest_chunks, lo, hi, tags,
                                              comm)
        round_sum = ring.combine_fixed_order(collected)
        if round_sum is not None:
            self.accum_grads(round_sum)
        if san is not None:
            san.end_step((self.ring_links.prev_ch,
                          self.ring_links.next_ch))
        # synchronous ring: the main thread drives the wire, so every
        # communication second is exposed to the step's critical path
        comm["exposed_allgather_s"] = comm["allgather_s"]
        comm["exposed_reduce_scatter_s"] = comm["reduce_scatter_s"]
        out_meta["comm"] = comm
        return out_meta

    def ring_step(self, meta: dict) -> dict:
        """One whole step of overlapped collective rounds.

        The ring data plane moves to a dedicated communication thread
        that executes the fixed global op order of
        :func:`repro_torch.core.engine.ring.overlap_plan`: round *k+1*'s
        parameter AllGatherv prefetches while round *k*'s microbatches
        compute on this (the main) thread, and round *k*'s gradient
        ReduceScatterv drains under round *k+1*'s compute.  Handoffs go
        through two queues — the double-buffered gathered-param and
        outbound-grad slots; the op order structurally caps each at two
        live entries (AG *k+2* cannot start before the grads of round
        *k* were consumed), so prefetch depth never exceeds one round.

        Numerics are untouched: params are frozen for the whole step
        (Adam runs only after this method returns — the step barrier),
        per-round sums still combine in fixed rank order, and rounds
        still accumulate in round order on this rank's slice, so the
        result stays bitwise-identical to the synchronous ring, the hub,
        and loopback.  A comm-thread failure (peer death mid-prefetch,
        timeout) is re-raised here, naming the rank and collective
        phase, and forwarded to the coordinator like any worker error.
        """
        rounds = list(meta["rounds"])
        gstep = int(meta.get("gstep", 0))
        comm = _empty_comm()
        if not rounds:
            return {"rounds": [], "comm": comm}
        own = self._own_param_chunks()
        gathered_q: queue.Queue = queue.Queue()
        outbound_q: queue.Queue = queue.Queue()
        failure: List[BaseException] = []

        def comm_main() -> None:
            try:
                for op, k in ring.overlap_plan(len(rounds)):
                    rd = rounds[k]
                    tags = {"round": int(rd["round"]), "gstep": gstep}
                    lo, hi = int(rd["lo"]), int(rd["hi"])
                    if op == "allgather":
                        got = self._ring_allgather(own, lo, hi, tags, comm)
                        gathered_q.put(got)
                    else:
                        item = outbound_q.get()
                        if item is _ABORT:
                            return
                        collected = self._ring_reduce_scatter(
                            item, lo, hi, tags, comm)
                        round_sum = ring.combine_fixed_order(collected)
                        if round_sum is not None:
                            # RS ops run in round order, so cross-round
                            # accumulation keeps the synchronous order
                            self.accum_grads(round_sum)
            except BaseException as e:   # noqa: BLE001 - re-raised on main
                failure.append(e)
                gathered_q.put(_COMM_FAILED)

        comm_thread = threading.Thread(
            target=comm_main, daemon=True,
            name=f"cephalo-rank{self.spec.rank}-ring-comm")
        san = self.ring_links.sanitizer if self.ring_links is not None \
            else None
        if san is not None:
            # arm the step's verified global op order before the comm
            # thread starts consuming it (overlap_plan is the single
            # source of truth for both)
            san.begin_step([(op, int(rounds[k]["round"]))
                            for op, k in ring.overlap_plan(len(rounds))])
        if self.ring_links is not None:
            # prefetch traffic is legitimate for the duration of this
            # step: let early later-round messages park instead of
            # tripping the synchronous out-of-protocol check
            self.ring_links.out_of_order = True
        comm_thread.start()
        out_metas = []
        try:
            for rd in rounds:
                t0 = time.perf_counter()
                item = gathered_q.get()
                comm["exposed_allgather_s"] += time.perf_counter() - t0
                if item is _COMM_FAILED:
                    raise failure[0]
                out_meta, dest_chunks = self._round_compute(
                    {**rd, "got": item})
                out_metas.append(out_meta)
                outbound_q.put(dest_chunks)
            t0 = time.perf_counter()
            comm_thread.join()   # step barrier: tail RS drains before Adam
            comm["exposed_reduce_scatter_s"] += time.perf_counter() - t0
            if failure:
                raise failure[0]
            if san is not None:
                # the comm thread is done: the plan must be exhausted
                # and no prefetch may be left parked past the barrier
                san.end_step((self.ring_links.prev_ch,
                              self.ring_links.next_ch))
        except BaseException:
            outbound_q.put(_ABORT)   # unblock a comm thread awaiting grads
            comm_thread.join(timeout=self.spec.ring_timeout + 30.0)
            raise
        finally:
            if self.ring_links is not None:
                self.ring_links.out_of_order = False
        return {"rounds": out_metas, "comm": comm}

    def accum_grads(self, arrays: Dict[str, np.ndarray]) -> None:
        """Accumulate a round's gradient slice into this rank's shard
        space on the device, in round order (the loopback engine's
        in-place add)."""
        sl = {k: self._tensor(v) for k, v in arrays.items()}
        if self.grad_acc is None:
            self.grad_acc = sl
        else:
            for u, t in sl.items():
                self.grad_acc[u].add_(t)

    def adam_step(self, step_no: int) -> None:
        """The loopback engine's Adam, in place on this rank's shard."""
        if self.grad_acc is None:
            raise RuntimeError("adam before any gradient round")
        for g in self.sub.planner.groups:
            st = self.state[g.name]
            adam_update(self.spec.adam, st["p"], self.grad_acc[g.name],
                        st["m"], st["v"], step_no)
        self.grad_acc = None
        self._release()

    # --- wall-clock probes ----------------------------------------------
    def probe(self, m: int, phase: str, repeats: int = 2) -> float:
        """Timed single-layer pass at microbatch ``m`` — the Sec. 3.1
        profile measurement, run live inside this rank's process."""
        if phase not in ("fwd", "bwd"):
            raise ValueError(f"unknown phase {phase!r}")
        fn = self._probe_fn(phase, m)
        best = profiler._best_seconds(fn, self.device, max(repeats, 1))
        if self.slowdown > 1.0:
            time.sleep((self.slowdown - 1.0) * best * max(repeats, 1))
        return best * self.slowdown

    def _probe_fn(self, phase: str, m: int):
        """One element of the first stage (the profiler's seeded params
        and input), forward or forward + backward, as a call."""
        key = (phase, m)
        if key in self._probe_cache:
            return self._probe_cache[key]
        cfg = self.spec.cfg
        if self._probe_params is None:
            spec0, bp, shared = profiler._layer(cfg, self.device)
            leaves: List[torch.Tensor] = []
            bp = M.tree_map(bp, lambda _, t: t.requires_grad_(True))
            M.tree_map(bp, lambda _, t: leaves.append(t))
            self._probe_params = (spec0, bp, shared, leaves)
        spec0, bp, shared, leaves = self._probe_params
        x, pos = profiler._input(cfg, m, self.spec.seq, self.device)
        fn = profiler.layer_call(cfg, spec0, bp, shared, x, pos,
                                 None if phase == "fwd" else leaves)
        self._probe_cache[key] = fn
        return fn


def _worker_main(spec: WorkerSpec, conn, ring_prev=None,
                 ring_next=None) -> None:
    """Entry point of one spawned rank process.

    The worker first takes the coordinator's thread count and TF32
    switches, then its device; a worker that cannot have its device (CUDA
    asked for, none there) replies to the start-up with its traceback,
    which the coordinator raises.  The reference's optional
    ``jax.distributed`` start-up has no counterpart here: the
    ``torch.distributed`` process groups belong to the SPMD runtime
    (:mod:`repro_torch.core.engine.world`); the fleet's data plane is its
    own channels.
    """
    apply_settings(spec.threads, spec.allow_tf32)
    channel = Channel(conn, transport=spec.transport)
    try:
        M.resolve_device(spec.device)
    except Exception:   # noqa: BLE001 - forwarded to coordinator
        report_start_failure(channel)
        return
    channel.send("ready", {"pid": os.getpid(), "rank": spec.rank})
    links = None
    if ring_prev is not None and ring_next is not None:
        links = _RingLinks(spec.rank, spec.n_ranks,
                           Channel(ring_prev, transport=spec.transport),
                           Channel(ring_next, transport=spec.transport),
                           timeout=spec.ring_timeout)
        if spec.sanitize:
            links.sanitizer = CommSanitizer(spec.rank, spec.n_ranks)
    worker = _Worker(spec, ring_links=links)
    while True:
        try:
            tag, meta, arrays = channel.recv()
        except (EOFError, OSError):     # coordinator went away
            break
        try:
            if tag == "exit":
                channel.send("ok")
                break
            elif tag == "scatter_state":
                worker.scatter_state(arrays)
                channel.send("ok")
            elif tag == "get_state":
                channel.send("state", {},
                             worker.get_state(meta["parts"]))
            elif tag == "step_begin":
                worker.begin_step(meta, arrays)
                channel.send("ok")
            elif tag == "round":
                if worker.die_next_round:   # injected mid-collective death
                    os._exit(17)
                flats = {k.split("|", 1)[1]: v for k, v in arrays.items()}
                arrays = None   # each flat is dropped once on the device
                out_meta, out_arrays = worker.round(meta["lo"], meta["hi"],
                                                    flats)
                channel.send("grads", out_meta, out_arrays)
                out_arrays = None
            elif tag == "ring_round":
                if worker.die_next_round:   # injected mid-collective death
                    os._exit(17)
                channel.send("ring_done", worker.ring_round(meta))
            elif tag == "ring_step":
                if worker.die_next_round:   # injected mid-prefetch death
                    os._exit(17)
                channel.send("ring_step_done", worker.ring_step(meta))
            elif tag == "fault":
                # fault injection for the stress tests: "die_next_round"
                # exits the instant the next collective round (or
                # overlapped step) arrives, so peers and coordinator
                # observe a mid-collective death; "slow_ring" delays
                # every forward send on this worker's outbound ring edge.
                mode = meta.get("mode")
                if mode == "die_next_round":
                    worker.die_next_round = True
                elif mode == "slow_ring":
                    if worker.ring_links is None:
                        raise ValueError(
                            f"rank {spec.rank}: slow_ring fault needs "
                            "ring links (topology='ring', n > 1)")
                    worker.ring_links.delay = float(meta.get("delay", 0.0))
                elif mode in ("mutate_reuse_tag", "mutate_skip_ack"):
                    # seeded protocol bugs for the sanitizer tests:
                    # reuse_tag stamps outbound payloads with round 0,
                    # skip_ack elides the arena-ack ops on this rank
                    if worker.ring_links is None:
                        raise ValueError(
                            f"rank {spec.rank}: {mode} fault needs "
                            "ring links (topology='ring', n > 1)")
                    worker.ring_links.mutate = mode[len("mutate_"):]
                else:
                    raise ValueError(f"unknown fault mode {mode!r}")
                channel.send("ok")
            elif tag == "grad_accum":
                worker.accum_grads(arrays)
                channel.send("ok")
            elif tag == "adam":
                worker.adam_step(meta["step"])
                channel.send("ok")
            elif tag == "probe":
                channel.send("t", {"seconds": worker.probe(
                    meta["m"], meta["phase"], meta.get("repeats", 2))})
            elif tag == "slowdown":
                worker.slowdown = max(float(meta["factor"]), 1.0)
                channel.send("ok")
            elif tag == "mem":
                planes = {"to_coordinator": send_plane(channel)}
                if links is not None:
                    planes["ring_next"] = send_plane(links.next_ch)
                    planes["ring_prev_acks"] = send_plane(links.prev_ch)
                channel.send("ok", {"nbytes": worker.state_nbytes(),
                                    "planes": planes})
            else:
                channel.send("error",
                             {"traceback": f"unknown command {tag!r}"})
        except Exception:   # noqa: BLE001 - forwarded to coordinator
            channel.send("error", {"traceback": traceback.format_exc()})
        # a full-width payload is gigabytes of host memory: hold none of
        # it while the next message arrives
        arrays = None
    if links is not None:
        if links.sanitizer is not None:
            links.sanitizer.close()
        links.close()
    channel.close()


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------

class MultiProcessSubstrate(RankPool, LoopbackSubstrate):
    """``LoopbackSubstrate`` surface with a process-per-rank data plane.

    Inherits the flat layout primitives (the single layout path), so
    coordinator-side resharding (``shard_state`` for init / import, on
    ``device``: ``cuda`` unless the caller asks for the CPU) is
    byte-identical to loopback; the collectives move real bytes between
    the coordinator and the rank processes (a :class:`RankPool`), and
    what the coordinator gathers it holds as CPU tensors.
    """

    name = "multiproc"

    def __init__(self, planner: UnitPlanner, specs: Sequence[WorkerSpec],
                 device: torch.device | str = "cuda",
                 start_method: str = "spawn",
                 reply_timeout: float = REPLY_TIMEOUT,
                 topology: str = "hub"):
        LoopbackSubstrate.__init__(self, planner, M.resolve_device(device))
        self.reply_timeout = reply_timeout
        self.topology = resolve_topology(topology)
        ctx = mp.get_context(start_method)
        n = len(specs)
        # peer-to-peer data plane: one dedicated duplex pipe per ring
        # edge r → (r+1) mod n; rank r gets edge r's head end as its
        # "next" channel and edge (r-1) mod n's tail end as its "prev".
        ring_edges = []
        if self.topology == "ring" and n > 1:
            ring_edges = [ctx.Pipe(duplex=True) for _ in range(n)]
        try:
            self.start_ranks(
                ctx, _worker_main, specs, [s.transport for s in specs],
                extras=[(ring_edges[(s.rank - 1) % n][1],
                         ring_edges[s.rank][0]) for s in specs]
                if ring_edges else None)
            for head, tail in ring_edges:
                # the workers own the ring ends now; drop our copies
                head.close()
                tail.close()
            self.await_ready()
        except Exception:
            self.close()
            raise

    # --- data-plane accounting -----------------------------------------
    def coordinator_bytes(self, tags: Optional[Sequence[str]] = None
                          ) -> int:
        """Array-payload bytes moved over coordinator↔worker channels
        (both directions), optionally restricted to ``tags`` (e.g.
        :data:`COLLECTIVE_TAGS`).  Ring-topology rounds keep this at
        zero — the collectives move peer-to-peer."""
        want = set(tags) if tags is not None else None
        total = 0
        for ch in self.channels:
            for counts in (ch.array_bytes_out, ch.array_bytes_in):
                for tag, nbytes in counts.items():
                    if want is None or tag in want:
                        total += nbytes
        return total

    # --- collectives ----------------------------------------------------
    def gather_flat(self, key: str) -> Dict[str, torch.Tensor]:
        """AllGatherv: every worker's ragged ``key`` slices → full flat
        unit buffers on the coordinator (CPU tensors)."""
        self.stats["all_gather"] += 1
        replies = self.request_all("get_state",
                                   metas=[{"parts": [key]}] * self.n,
                                   phase=f"allgatherv({key})")
        slices = [{g.name: _from_host(arrs[f"{g.name}|{key}"])
                   for g in self.planner.groups}
                  for _, arrs in replies]
        del replies
        return self.concat_slices(slices, key=None)

    def allgather_params(self, shards: Optional[List[Dict[str, Any]]] = None,
                         key: str = "p") -> Dict[str, Any]:
        """Full params pytree: from the live workers (``shards=None``,
        one real AllGatherv) or from host-resident shards (the inherited
        loopback path, used by resharding helpers)."""
        if shards is not None:
            return super().allgather_params(shards, key)
        return self.unflatten_flats(self.gather_flat(key))

    def scatter_grad_flats(self, sums: Dict[str, np.ndarray]) -> None:
        """ReduceScatterv, scatter half: slice the rank-order-summed
        full gradient buffers and hand every rank its slice."""
        self.stats["reduce_scatter"] += 1
        slices = self.slice_flats({u: torch.from_numpy(a)
                                   for u, a in sums.items()})
        self.request_all("grad_accum",
                         arrays=[{u: t.numpy() for u, t in slices[r].items()}
                                 for r in range(self.n)],
                         phase="reduce_scatterv(G)")


class ProcessEngine(TrainEngine):
    """Multiproc substrate: the MPMD step across real rank processes.

    Every worker runs on ``device`` (``cuda`` unless the caller asks for
    the CPU; it raises when CUDA is asked for and absent), as does the
    coordinator's own layout work (drawing the initial params, sharding
    them).  On the card the coordinator builds the kernels and returns
    its cached device memory before it spawns the fleet."""

    def __init__(self, cfg: ArchConfig, plan: Plan, schedule: Schedule,
                 adam: AdamConfig, seq_len: int, *,
                 device: torch.device | str = "cuda",
                 transport: Optional[str] = None,
                 topology: Optional[str] = None,
                 overlap_rounds: Optional[bool] = None,
                 start_method: str = "spawn",
                 reply_timeout: float = REPLY_TIMEOUT,
                 ring_timeout: float = RING_TIMEOUT,
                 sanitize: Optional[bool] = None):
        if not plan.feasible:
            raise ValueError(plan.infeasible_reason)
        self.cfg, self.plan, self.schedule = cfg, plan, schedule
        self.adam, self.seq = adam, seq_len
        self.n = plan.n
        self.device = M.resolve_device(device)
        transport = resolve_transport(transport)
        self.topology = resolve_topology(topology)
        self.overlap = resolve_overlap(overlap_rounds)
        self.sanitize = resolve_sanitize(sanitize)
        if self.overlap and self.topology != "ring":
            if overlap_rounds:
                raise ValueError(
                    "overlap_rounds=True needs topology='ring': the hub "
                    "topology's coordinator request→reply data plane has "
                    "no prefetch lane (pass topology='ring' or set "
                    "CEPHALO_MP_TOPOLOGY=ring)")
            # env-resolved overlap on a hub fleet: the env default stays
            # inert (mirrors how CEPHALO_MP_TOPOLOGY behaves off-substrate)
            warnings.warn(
                "CEPHALO_MP_OVERLAP is set but the topology is "
                f"{self.topology!r}; round overlap needs the ring data "
                "plane — running synchronous rounds", RuntimeWarning)
            self.overlap = False
        ratios = normalized_ratios(plan.state_ratios())
        self.planner = UnitPlanner(cfg, ratios)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        specs = [WorkerSpec(rank=r.rank, cfg=cfg,
                            ratios=tuple(float(x) for x in ratios),
                            m=r.m, ell=r.ell, seq=seq_len, adam=adam,
                            transport=transport, n_ranks=plan.n,
                            device=str(self.device),
                            threads=torch.get_num_threads(),
                            allow_tf32=tf32, topology=self.topology,
                            ring_timeout=ring_timeout,
                            sanitize=self.sanitize)
                 for r in plan.ranks]
        if self.device.type == "cuda":
            build.build_all()
            torch.cuda.empty_cache()
        self.substrate = MultiProcessSubstrate(
            self.planner, specs, device=self.device,
            start_method=start_method, reply_timeout=reply_timeout,
            topology=self.topology)
        #: rank -> (m, fwd_layer_s, bwd_layer_s): one timed single-layer
        #: pass per active rank at each step's end (sequential, so the
        #: measurements don't contend) — the WallClockOracle's
        #: passive-telemetry source, in the same units as the replan's
        #: probe sweep and the planner's latency models.
        self.last_step_samples: Dict[int, Tuple[int, float, float]] = {}
        #: rank -> whole-step fwd+bwd compute wall seconds measured
        #: around the worker boundary (full model, all rounds).
        self.last_step_walls: Dict[int, float] = {}
        #: coordinator-side wall seconds of the last whole step.
        self.last_step_wall_s = 0.0
        #: rank -> per-phase ring comm seconds of the last step
        #: (:data:`COMM_KEYS`: total AllGatherv / ReduceScatterv wire
        #: time plus the *exposed* share the compute thread stalled on).
        #: Empty on hub steps — the hub's data plane is coordinator-side.
        self.last_step_comm: Dict[int, Dict[str, float]] = {}
        #: kernel launches of the last step's compute, summed over the
        #: rank processes' replies (:func:`kernel_launches` keys).
        self.last_step_launches: Dict[str, int] = {}
        #: engine step counter used to tag ring messages (uniqueness
        #: within this fleet's life is all that matters — replans respawn
        #: the fleet and may reset it).
        self._gstep = 0

    # --- TrainEngine surface -------------------------------------------
    def init_state(self, generator: torch.Generator) -> Dict[str, int]:
        """Shard fp32 params drawn from ``generator`` (which lives on the
        engine's device) out to the workers: the loopback engine's draw
        and layout, so the same seed gives both engines the same state
        bit for bit."""
        params = M.init_params(self.cfg, generator, self.device,
                               all_fp32=True)
        shards = self.substrate.shard_state(params)
        del params
        self._scatter_shards(shards)
        return {"step": 0}

    def _scatter_shards(self, shards: List[Dict[str, Any]]) -> None:
        """One rank and one part (p, m, v) at a time, each host copy
        dropped once sent, so the coordinator holds at most one part of
        one rank's shard on the host (and no arena grows past it)."""
        for r in range(self.n):
            for part in ("p", "m", "v"):
                arrays = {f"{g.name}|{part}": _to_host(shards[r][g.name][part])
                          for g in self.planner.groups}
                self.substrate.request(r, "scatter_state", {}, arrays,
                                       phase=f"scatter_state({part})")
                del arrays
            shards[r] = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def step(self, state: Dict[str, int], big: np.ndarray
             ) -> Tuple[Dict[str, int], float]:
        """One training iteration, schedule-driven, across the fleet.

        Round structure and reduction order are identical to the
        loopback step (rank-major float accumulation) on **both**
        topologies, so every substrate agrees numerically; the
        microbatch work itself runs concurrently in the rank processes.
        On the ``ring`` topology the coordinator's part of each round is
        control-plane only — one ``ring_round`` broadcast and per-rank
        meta replies; params and gradients move worker↔worker.  With
        ``overlap_rounds`` the whole step's round list goes out in a
        single ``ring_step`` broadcast and each worker pipelines the
        rounds on its communication thread — the reply (and the Adam
        barrier behind it) arrives only after the tail ReduceScatterv
        drained.
        """
        t_step0 = time.perf_counter()
        big = np.asarray(big)
        plan = self.plan
        if big.shape[0] < plan.global_batch:
            raise ValueError(
                f"sample block has {big.shape[0]} rows; the plan's "
                f"global_batch needs {plan.global_batch}")
        w_val = 1.0 / (plan.global_batch * self.seq) \
            if plan.global_batch else 0.0
        cursor = 0
        active, payloads = [], []
        for r in plan.ranks:
            if r.b == 0:
                continue
            rows = big[cursor: cursor + r.b]
            cursor += r.b
            active.append(r.rank)
            payloads.append({"tokens": rows[:, :-1], "labels": rows[:, 1:]})
        if cursor != plan.global_batch:
            raise ValueError(
                f"plan rank batches consumed {cursor} rows, expected "
                f"global_batch {plan.global_batch}")
        self.substrate.request_all(
            "step_begin", metas=[{"w_val": w_val}] * len(active),
            arrays=payloads, ranks=active, phase="step_begin")

        total_loss = 0.0
        walls = {r: 0.0 for r in active}
        n_mb = {r: 0 for r in active}
        rounds = []
        mb_off = 0
        for size in self.schedule.chunks(max(plan.ell_pad, 1)):
            lo, hi = mb_off, mb_off + size
            mb_off += size
            rnd = [r.rank for r in plan.ranks
                   if r.b > 0 and min(lo, r.ell) < min(hi, r.ell)]
            rounds.append((lo, hi, rnd))
        self._gstep += 1
        self.last_step_comm = {}
        self.last_step_launches = {}
        if self.topology == "ring" and self.overlap:
            step_metas = self._ring_overlap_step(rounds)
        else:
            step_metas = []
            for idx, (lo, hi, rnd) in enumerate(rounds):
                if self.topology == "ring":
                    round_metas = self._ring_collective_round(
                        lo, hi, rnd, round_idx=idx)
                else:
                    round_metas = self._hub_collective_round(lo, hi, rnd)
                if round_metas is not None:
                    step_metas.append(round_metas)
        any_grads = bool(step_metas)
        for round_metas in step_metas:
            for rank, meta in round_metas:
                if meta["n_mb"] == 0:
                    continue
                total_loss += meta["loss"]
                walls[rank] += meta["t_wall"]
                n_mb[rank] += meta["n_mb"]
                _add_counts(self.last_step_launches, meta.get("launches"))
        if not any_grads:
            # zero-gradient step (every active rank has ell_i == 0):
            # no optimizer update, state unchanged — same contract as
            # the loopback trainer.
            return dict(state), total_loss
        step_no = state["step"] + 1
        self.substrate.request_all("adam", metas=[{"step": step_no}] * self.n)
        self.last_step_walls = {r: walls[r]
                                for r in active if n_mb[r] > 0}
        # one timed single-layer pass per active rank, *sequentially* so
        # the samples don't contend with each other on shared silicon —
        # unit-consistent with the probe sweep and the planner's models.
        self.last_step_samples = {
            r: (plan.ranks[r].m,
                self.probe(r, plan.ranks[r].m, "fwd", repeats=1),
                self.probe(r, plan.ranks[r].m, "bwd", repeats=1))
            for r in active if n_mb[r] > 0}
        self.last_step_wall_s = time.perf_counter() - t_step0
        return {"step": step_no}, total_loss

    # --- per-round collective dispatch ---------------------------------
    def _hub_collective_round(self, lo: int, hi: int,
                              rnd: List[int]
                              ) -> Optional[List[Tuple[int, dict]]]:
        """Hub topology: the coordinator IS the data plane — gather all
        param slices, broadcast full flats, sum the returned gradient
        flats in fixed rank order, scatter the slices back."""
        flats = self.substrate.gather_flat("p")             # AllGatherv
        if not rnd:
            return None
        payloads = [{f"P|{u}": f.numpy() for u, f in flats.items()}] * \
            len(rnd)
        del flats       # request_all releases the payloads once sent
        replies = self.substrate.request_all(
            "round", metas=[{"lo": lo, "hi": hi}] * len(rnd),
            arrays=payloads, ranks=rnd, phase=f"round[{lo},{hi})")
        out = []
        contribs: List[Optional[Dict[str, np.ndarray]]] = []
        for rank, (meta, arrs) in zip(rnd, replies):
            out.append((rank, meta))
            contribs.append(
                None if meta["n_mb"] == 0 else
                {k.split("|", 1)[1]: v for k, v in arrs.items()})
        # one authoritative reduction: the replies are already in rank
        # order, so combine_fixed_order gives the union-over-unit-keys
        # rank-order sum — bitwise the same contract the ring applies at
        # each destination
        sums = ring.combine_fixed_order(contribs)
        del contribs, replies
        if sums is None:
            return None
        self.substrate.scatter_grad_flats(sums)             # ReduceScatterv
        return out

    def _ring_collective_round(self, lo: int, hi: int, rnd: List[int],
                               round_idx: int = 0
                               ) -> Optional[List[Tuple[int, dict]]]:
        """Ring topology, synchronous rounds: control-plane only — every
        worker (active or not: inactive ranks still forward ring traffic
        and still own a gradient slice) runs the round's ring AllGatherv
        + ring ReduceScatterv peer-to-peer and replies with telemetry
        meta.  The collective event counters mirror the hub/loopback
        structure so round-structure assertions stay
        substrate-independent."""
        self.substrate.stats["all_gather"] += 1
        if not rnd:
            return None
        meta = {"lo": lo, "hi": hi, "active": list(rnd),
                "round": round_idx, "gstep": self._gstep}
        replies = self.substrate.request_all(
            "ring_round", metas=[meta] * self.n,
            phase=f"ring round[{lo},{hi})")
        self.substrate.stats["reduce_scatter"] += 1
        for rank, (r_meta, _) in enumerate(replies):
            self._merge_comm(rank, r_meta.get("comm"))
        return [(rank, r_meta) for rank, (r_meta, _) in enumerate(replies)]

    def _ring_overlap_step(self, rounds: List[Tuple[int, int, List[int]]]
                           ) -> List[List[Tuple[int, dict]]]:
        """Ring topology, overlapped rounds: ONE control-plane broadcast
        carries the whole step's round list; each worker pipelines the
        rounds on its communication thread (prefetching gathers under
        compute, draining scatters under the next round's compute) and
        replies with per-round telemetry after its tail ReduceScatterv —
        the only barrier before Adam.  Collective event counters follow
        the same per-round structure as the synchronous paths, so the
        parity matrix's stats assertions hold across overlap too."""
        payload_rounds = []
        for idx, (lo, hi, rnd) in enumerate(rounds):
            self.substrate.stats["all_gather"] += 1
            if not rnd:
                continue
            self.substrate.stats["reduce_scatter"] += 1
            payload_rounds.append({"round": idx, "lo": lo, "hi": hi,
                                   "active": list(rnd)})
        if not payload_rounds:
            return []
        meta = {"rounds": payload_rounds, "gstep": self._gstep}
        replies = self.substrate.request_all(
            "ring_step", metas=[meta] * self.n,
            phase=f"ring step({len(payload_rounds)} rounds)")
        for rank, (r_meta, _) in enumerate(replies):
            self._merge_comm(rank, r_meta.get("comm"))
        return [[(rank, r_meta["rounds"][i])
                 for rank, (r_meta, _) in enumerate(replies)]
                for i in range(len(payload_rounds))]

    # --- comm telemetry -------------------------------------------------
    def _merge_comm(self, rank: int, comm: Optional[dict]) -> None:
        if not comm:
            return
        agg = self.last_step_comm.setdefault(rank, _empty_comm())
        for key, val in comm.items():
            agg[key] = agg.get(key, 0.0) + float(val)

    def hidden_comm_fraction(self, comm: Optional[Dict[int, Dict[str,
                             float]]] = None) -> Dict[int, float]:
        """Per-rank fraction of ring communication hidden under compute:
        ``1 − exposed/total``.  Synchronous rounds report ~0.0
        (everything the wire did, the compute thread waited for);
        overlapped rounds report whatever the prefetch actually hid.
        Reads the last step's telemetry by default; pass ``comm`` (same
        shape as :attr:`last_step_comm`, e.g. summed over many steps) to
        evaluate an aggregate.  Empty for hub steps (no worker-side
        wire)."""
        comm = self.last_step_comm if comm is None else comm
        out: Dict[int, float] = {}
        for rank, c in comm.items():
            total = c.get("allgather_s", 0.0) + \
                c.get("reduce_scatter_s", 0.0)
            exposed = c.get("exposed_allgather_s", 0.0) + \
                c.get("exposed_reduce_scatter_s", 0.0)
            out[rank] = max(0.0, 1.0 - exposed / total) if total > 0 \
                else 0.0
        return out

    def gather_params(self, state) -> Dict[str, Any]:
        return self.substrate.allgather_params(None, "p")

    def export_state(self, state) -> Dict[str, Any]:
        return {"step": int(state["step"]),
                "p": self.substrate.allgather_params(None, "p"),
                "m": self.substrate.allgather_params(None, "m"),
                "v": self.substrate.allgather_params(None, "v")}

    def import_state(self, exported: Dict[str, Any]) -> Dict[str, int]:
        """Lay an exported state (leaves on any device) out on this
        fleet's plan."""
        shards = self.substrate.shard_state(
            exported["p"], exported.get("m"), exported.get("v"))
        self._scatter_shards(shards)
        return {"step": int(exported.get("step", 0))}

    def close(self) -> None:
        self.substrate.close()

    # --- wall-clock surface --------------------------------------------
    def probe(self, rank: int, m: int, phase: str,
              repeats: int = 2) -> float:
        """Live single-layer latency measurement on one rank process."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        meta, _ = self.substrate.request(
            rank, "probe", {"m": int(m), "phase": phase,
                            "repeats": int(repeats)})
        return float(meta["seconds"])

    def inject_slowdown(self, rank: int, factor: float) -> None:
        """Make a rank process actually slower (straggler injection)."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        self.substrate.request(rank, "slowdown", {"factor": float(factor)})

    def inject_death(self, rank: int) -> None:
        """Fault injection: the rank process exits the moment the next
        collective round reaches it — mid-collective from every other
        participant's point of view.  The step must then raise a
        RuntimeError naming the dead rank and the phase (bounded waits,
        no hang); the fleet is unusable afterwards except for close()."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        self.substrate.request(rank, "fault", {"mode": "die_next_round"})

    def inject_ring_delay(self, rank: int, delay_s: float) -> None:
        """Fault injection: make ``rank``'s outbound ring edge slow —
        every forward send sleeps ``delay_s`` first.  Rounds must still
        complete, in order, bitwise-identical (the overlap stress
        tests); pass 0.0 to restore the edge."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        if delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.substrate.request(rank, "fault",
                               {"mode": "slow_ring", "delay": delay_s})

    def inject_protocol_mutation(self, rank: int, mode: str) -> None:
        """Fault injection: seed a live protocol bug at ``rank`` for the
        comm-sanitizer tests.  ``"reuse_tag"`` stamps every outbound
        ring payload with round 0 (the tag-collision bug the static
        checker proves absent); ``"skip_ack"`` elides the rank's
        arena-ack ops (the early-reuse bug).  With the sanitizer armed
        (``sanitize=True`` / ``CEPHALO_COMM_SANITIZE=1``) either raises
        a ProtocolViolation at the offending rank before a peer can
        wedge; without it the bug surfaces only as a peer-side
        out-of-protocol error or a bounded timeout."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        if mode not in ("reuse_tag", "skip_ack"):
            raise ValueError(
                f"unknown protocol mutation {mode!r}; expected "
                "'reuse_tag' or 'skip_ack'")
        self.substrate.request(rank, "fault", {"mode": f"mutate_{mode}"})

    # --- MPMD extras (launcher surface) --------------------------------
    def transport_planes(self) -> Dict[int, Dict[str, str]]:
        """Rank → the data plane each of its channels sends on, as used
        (a failed arena shows as ``"pipe"``): the coordinator's channel
        to the worker, the worker's back, and on the ring its two
        peer channels."""
        replies = self.substrate.request_all("mem", metas=[{}] * self.n)
        return {r: {"to_worker": send_plane(self.substrate.channels[r]),
                    **meta["planes"]}
                for r, (meta, _) in enumerate(replies)}

    def memory_report(self, state) -> str:
        replies = self.substrate.request_all("mem", metas=[{}] * self.n)
        lines = []
        for r, (meta, _) in enumerate(replies):
            lines.append(
                f"rank{r} {self.plan.ranks[r].device:<8} state "
                f"{meta['nbytes'] / (1 << 20):8.1f} MiB  "
                f"(ratio {self.plan.ranks[r].state_ratio:.3f}, "
                f"pid {self.substrate.procs[r].pid})")
        return "\n".join(lines)

    def simulated_iteration_seconds(self) -> Dict[str, float]:
        return {
            "layer_s": self.plan.predicted_layer_s,
            "iteration_s": self.plan.predicted_iter_s,
            "throughput_samples_s": self.plan.predicted_throughput,
        }


# ---------------------------------------------------------------------------
# Wall-clock telemetry
# ---------------------------------------------------------------------------

class WallClockOracle:
    """Real-measurement latency source for the elastic control loop.

    Drop-in for the reference's ``elastic.CostModelOracle`` —
    same ``(rank, m, phase) -> seconds`` query surface, same
    ``degrade``/``restore`` straggler hooks — but every number is a
    wall-clock measurement from a rank *process*:

    * passive queries (the per-step telemetry ingest at the plan's
      ``m_i``) are served from the engine's last-step measured fwd/bwd
      per-layer timings — free, the step ran anyway;
    * probe queries (the replan's Sec. 3.1 ``m``-grid sweep) run a timed
      single-layer pass inside the worker;
    * ``degrade(rank, f)`` makes the worker sleep ``(f-1)×`` its compute
      time — an actually-slow process, re-applied across replans (the
      slow *machine* stays slow even after the fleet is respawned).

    :class:`~repro_torch.core.engine.elastic.ElasticEngine` binds the
    oracle to its inner engine (:meth:`bind`), and again after every
    replan's respawn; outside the elastic loop :meth:`bind` binds by
    hand.
    """

    def __init__(self, probe_repeats: int = 2):
        self.engine: Optional[ProcessEngine] = None
        self.factors: Dict[int, float] = {}
        self.probe_repeats = probe_repeats

    def bind(self, engine: ProcessEngine) -> None:
        if not hasattr(engine, "probe") or \
                not hasattr(engine, "inject_slowdown"):
            raise TypeError(
                "WallClockOracle needs the multiproc substrate "
                f"(engine {type(engine).__name__} has no live probe "
                "surface); use CostModelOracle for simulated substrates")
        self.engine = engine
        for rank, factor in self.factors.items():
            if rank < engine.n:
                engine.inject_slowdown(rank, factor)

    def degrade(self, rank: int, factor: float) -> None:
        self.factors[rank] = float(factor)
        if self.engine is not None and rank < self.engine.n:
            self.engine.inject_slowdown(rank, factor)

    def restore(self, rank: int) -> None:
        self.factors.pop(rank, None)
        if self.engine is not None and rank < self.engine.n:
            self.engine.inject_slowdown(rank, 1.0)

    def __call__(self, rank: int, m: int, phase: str) -> float:
        if phase not in ("fwd", "bwd"):
            raise ValueError(
                f"unknown phase {phase!r}; expected 'fwd' or 'bwd'")
        if self.engine is None:
            raise RuntimeError(
                "WallClockOracle is unbound: pass it to "
                "build_train_step(..., substrate='multiproc', "
                "elastic=True, oracle=...), which binds it, or call "
                "oracle.bind(engine) on a multiproc engine")
        cached = self.engine.last_step_samples.get(rank)
        if cached is not None and cached[0] == m:
            return cached[1] if phase == "fwd" else cached[2]
        return self.engine.probe(rank, m, phase,
                                 repeats=self.probe_repeats)
