"""The SPMD runtime's world: rank processes, their process groups and the
collectives between them.

The JAX package runs its SPMD step as one ``shard_map`` program over a
device mesh; the port runs one process per mesh position, each holding
its rank's shard, joined by ``torch.distributed``.  This module starts
such a world and carries calls into it:

* **The backend follows from the placement**, never from an error.  Ranks
  on the CPU use gloo.  Ranks on the card go on ``cuda:r % device_count``;
  where each has a card of its own they use NCCL, and where ranks share a
  card (more ranks than cards) they use gloo over explicit pinned host
  copies of the card's buffers — d2h, the collective, h2d — for every
  collective (:class:`Comm`).  NCCL refuses two ranks on one device
  (``tools/probe_nccl.py`` asks it).  Compute, Adam and the state stay
  on the card.  A start-up that fails raises.
* **The mesh's groups** (:meth:`RankContext.axis_group`) follow the
  device order of ``jax.make_mesh``: rank ``r`` sits at the row-major
  position ``r`` of :class:`Mesh`, and a group over some axes orders its
  ranks row-major over those axes, as ``lax.all_gather`` over those axis
  names orders its shards — so ratio ``i`` lands on the same rank as in
  the reference and shard boundaries compare element for element.
* **Each world takes a fresh rendezvous**: a ``TCPStore`` on a free port
  of the loopback address, held by the controller.  Every start-up and
  every reply has a timeout, and a rank that dies raises in the
  controller at once, so a dead rank fails its caller instead of hanging
  it.

:class:`World` is the controller's handle: ``world.call(fn, ...)`` runs
the module-level function ``fn(ctx, *args)`` on every rank (``ctx`` the
rank's :class:`RankContext`) and returns the results in rank order.  Its
processes, their control channels (the multiproc fleet's
:class:`~repro_torch.core.engine.transport.Channel`, pipe plane) and
their lifecycle are the fleet's
(:class:`~repro_torch.core.engine.ranks.RankPool`); collective bytes
never pass through the controller.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine.ranks import (RankPool, apply_settings,
                                           report_start_failure)
from repro_torch.core.engine.transport import Channel

#: seconds a collective (and the process group's start-up) may wait for
#: a peer before it raises
COLLECTIVE_TIMEOUT = 600.0
LOOPBACK = "127.0.0.1"
#: what the ``forkserver``'s server imports before it forks a rank: the
#: first world pays for the imports, a later one starts in about a second
FORKSERVER_PRELOAD = ("torch", "torch._dynamo", "repro_torch.core.layered_ga")


# ---------------------------------------------------------------------------
# Mesh and placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh without devices: its shape and axis names (the
    reference's ``jax.make_mesh(shape, names)``).  Rank ``r`` is the
    row-major position ``r``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in axes]))

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The partition of the ranks into groups over ``axes``: each
        group holds the ranks that agree on every other axis, ordered
        row-major over ``axes`` in the order given.  Groups come in the
        row-major order of the other axes."""
        axes = tuple(axes)
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in idx]
        out = []
        for other in np.ndindex(*[self.shape[i] for i in rest]):
            ranks = []
            for mine in np.ndindex(*[self.shape[i] for i in idx]):
                coord = [0] * len(self.shape)
                for i, c in zip(rest, other):
                    coord[i] = c
                for i, c in zip(idx, mine):
                    coord[i] = c
                ranks.append(int(np.ravel_multi_index(coord, self.shape)))
            out.append(ranks)
        return out


def device_count(device: torch.device | str) -> int:
    """Devices of ``device``'s type a world can spread over: the cards on
    ``cuda``, one on the CPU (as JAX counts one CPU device)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each rank runs and how its collectives move.  ``staged``:
    ranks share a card, so collectives run on gloo over pinned host
    copies."""

    devices: Tuple[str, ...]
    backend: str
    staged: bool


def placement(device: torch.device | str, n: int) -> Placement:
    """The fixed rule: CPU ranks → gloo; a card per rank → NCCL; ranks
    sharing a card (``n`` above the card count) → gloo, staged through
    pinned host memory."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return Placement(("cpu",) * n, "gloo", False)
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' to run on the CPU")
    devices = tuple(f"cuda:{r % cards}" for r in range(n))
    shared = n > cards
    return Placement(devices, "gloo" if shared else "nccl", shared)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# torch renamed the tensor collectives; either name does the same
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class Comm:
    """One rank's collectives.  With ``staged`` (ranks sharing a card)
    every collective copies its device buffers to pinned host memory,
    runs on gloo there and copies the result back; ``host_bytes`` counts
    the bytes of those copies, both ways."""

    def __init__(self, staged: bool = False):
        self.staged = staged
        self.host_bytes = 0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.host_bytes += t.numel() * t.element_size()
        return h

    def _back(self, out: torch.Tensor, h: torch.Tensor) -> None:
        out.copy_(h)
        self.host_bytes += h.numel() * h.element_size()

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   group) -> None:
        """``out`` (N, ...) ← every rank's ``inp`` (...) in group order
        (both contiguous; the backends take them flat)."""
        out, inp = out.view(-1), inp.view(-1)
        if not self.staged:
            _ALL_GATHER(out, inp, group=group)
            return
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _ALL_GATHER(h_out, self._host(inp), group=group)
        self._back(out, h_out)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       group) -> None:
        """``out`` (P,) ← the sum over the group of row ``i`` of every
        rank's ``inp`` (N, P), ``i`` this rank's index in the group (both
        contiguous; the backends take them flat)."""
        out, inp = out.view(-1), inp.view(-1)
        if not self.staged:
            _REDUCE_SCATTER(out, inp, group=group)
            return
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _REDUCE_SCATTER(h_out, self._host(inp), group=group)
        self._back(out, h_out)

    def all_reduce(self, t: torch.Tensor, group, op: str = "sum") -> None:
        """``t`` ← its sum (or max) over the group, in place."""
        if not self.staged:
            dist.all_reduce(t, op=_OPS[op], group=group)
            return
        h = self._host(t)
        dist.all_reduce(h, op=_OPS[op], group=group)
        self._back(t, h)


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Payload:
    """A call's argument or result with numpy arrays that travel raw on
    the channel's data plane (``arrays``) beside a small pickled
    ``meta``."""

    meta: Any = None
    arrays: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


class RankContext:
    """What a rank function sees: its rank, the mesh, its device, its
    :class:`Comm` and a dict ``objects`` that lives as long as the rank
    (a program, its state)."""

    def __init__(self, rank: int, mesh: Mesh, device: torch.device,
                 comm: Comm):
        self.rank = rank
        self.mesh = mesh
        self.device = device
        self.comm = comm
        self.objects: Dict[str, Any] = {}
        self._groups: Dict[Tuple[str, ...], Tuple[Any, int]] = {}

    @property
    def world_size(self) -> int:
        return self.mesh.size

    def axis_group(self, axes: Sequence[str]) -> Tuple[Any, int]:
        """(process group over ``axes`` holding this rank, this rank's
        index in it).  Every rank creates every group of the partition,
        in one order, the first time any of them asks (``new_group`` is
        collective); later calls return the cached group."""
        axes = tuple(axes)
        if axes not in self._groups:
            mine = None
            for ranks in self.mesh.groups(axes):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = (g, ranks.index(self.rank))
            self._groups[axes] = mine
        return self._groups[axes]


@dataclasses.dataclass(frozen=True)
class _RankSpec:
    rank: int
    mesh: Mesh
    device: str
    backend: str
    staged: bool
    store_port: int
    threads: int
    allow_tf32: Tuple[bool, bool]


def _unpack(meta: dict, arrays: Dict[str, np.ndarray]) -> Any:
    if meta.get("payload"):
        return Payload(meta.get("meta"), arrays)
    return meta.get("value")


def _pack(value: Any) -> Tuple[dict, Dict[str, np.ndarray]]:
    if isinstance(value, Payload):
        return {"payload": True, "meta": value.meta}, value.arrays
    return {"value": value}, {}


def _start_rank(spec: _RankSpec) -> RankContext:
    """The rank's threads, TF32 switches, device and process group."""
    apply_settings(spec.threads, spec.allow_tf32)
    # every rank of a world runs on this host: the backends' own sockets
    # go on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # torch.utils.checkpoint imports torch._dynamo at its first call,
    # leaving the calling frames in a reference cycle that would hold a
    # first step's tensors until the cyclic collector ran
    import torch._dynamo as _dynamo  # noqa: F401
    device = torch.device(spec.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for but is not available")
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)
    store = dist.TCPStore(LOOPBACK, spec.store_port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(spec.backend, store=store, rank=spec.rank,
                            world_size=spec.mesh.size, timeout=timeout)
    return RankContext(spec.rank, spec.mesh, device, Comm(spec.staged))


def _rank_main(spec: _RankSpec, conn) -> None:
    """Entry point of one spawned rank: start, say ``ready`` (or send
    the start-up's traceback), then run calls until ``exit``."""
    channel = Channel(conn, transport="pipe")
    try:
        ctx = _start_rank(spec)
    except Exception:   # noqa: BLE001 - forwarded to the controller
        report_start_failure(channel)
        return
    channel.send("ready")
    try:
        while True:
            try:
                tag, meta, arrays = channel.recv()
            except (EOFError, OSError):     # the controller went away
                break
            if tag == "exit":
                channel.send("ok")
                break
            try:
                arg = _unpack(meta, arrays)
                arrays = None
                args = tuple(meta["args"]) + (
                    (arg,) if meta["per_rank"] else ())
                out_meta, out_arrays = _pack(meta["fn"](ctx, *args))
                channel.send("result", out_meta, out_arrays)
            except Exception:   # noqa: BLE001 - forwarded to the controller
                channel.send("error", {"traceback": traceback.format_exc()})
    finally:
        ctx.objects.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        channel.close()


# ---------------------------------------------------------------------------
# Controller side
# ---------------------------------------------------------------------------

class World(RankPool):
    """The controller's handle on one SPMD world: ``mesh.size`` rank
    processes on ``device`` (``cuda`` unless the caller asks for the CPU;
    it raises, before any process starts, when CUDA is asked for and
    absent), placed and wired by :func:`placement`.

    Ranks fork from the ``forkserver``, whose server imports
    :data:`FORKSERVER_PRELOAD` once (and initialises no device), so that
    a world after the first starts in about a second.  They take the controller's
    intra-op thread count and TF32 switches.  A rank's exception comes
    back as a ``RuntimeError`` with its traceback; a rank that dies or
    stays silent past ``reply_timeout`` raises too.  ``close()`` (or
    ``with``) stops every rank; it is idempotent."""

    rank_name = "spmd rank {}"
    #: leaving the process group may wait on its peers
    exit_timeout = 30.0

    def __init__(self, mesh: Mesh, device: torch.device | str = "cuda"):
        self.mesh = mesh
        self.placement = placement(device, mesh.size)
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)
        # a fresh rendezvous for every world: port 0 takes a free port
        self._store = dist.TCPStore(LOOPBACK, 0, is_master=True,
                                    wait_for_workers=False, timeout=timeout)
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        specs = [_RankSpec(rank=r, mesh=mesh,
                           device=self.placement.devices[r],
                           backend=self.placement.backend,
                           staged=self.placement.staged,
                           store_port=self._store.port,
                           threads=torch.get_num_threads(), allow_tf32=tf32)
                 for r in range(mesh.size)]
        try:
            self.start_ranks(ctx, _rank_main, specs, ["pipe"] * mesh.size,
                             name="cephalo-spmd{}")
            self.await_ready()
        except BaseException:
            self.close()
            raise

    @property
    def size(self) -> int:
        return self.mesh.size

    def call(self, fn: Callable, args: Sequence[Any] = (),
             per_rank: Optional[Sequence[Any]] = None) -> List[Any]:
        """``fn(ctx, *args[, per_rank[r]])`` on every rank at once; the
        results in rank order.  ``fn`` must be a module-level function
        (it is pickled by name); a :class:`Payload` argument or result
        moves its arrays raw.  A list ``per_rank`` is emptied once sent
        (a full-width payload is gigabytes of host memory)."""
        metas, arrays = [], []
        for r in range(self.size):
            meta, arrs = _pack(per_rank[r] if per_rank is not None
                               else None)
            meta.update(fn=fn, args=tuple(args),
                        per_rank=per_rank is not None)
            metas.append(meta)
            arrays.append(arrs)
        if isinstance(per_rank, list):
            per_rank.clear()    # the sends below hold the payloads
        return [_unpack(meta, arrs) for meta, arrs in self.request_all(
            "call", metas, arrays, phase=getattr(fn, "__name__", repr(fn)))]

    def close(self) -> None:
        """Stop every rank (:meth:`RankPool.close`) and let go of the
        rendezvous.  Idempotent."""
        super().close()
        self._store = None

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
