"""Rank processes and their control channels: the scaffolding that the
process fleet (:mod:`repro_torch.core.engine.multiproc`, the paper's
MPMD runtime with one process per rank, Sec. 2 / App. C) and the SPMD
world (:mod:`repro_torch.core.engine.world`) share.

:class:`RankPool` is the controller's side: it starts one process per
rank from a ``multiprocessing`` context (``spawn`` or ``forkserver``),
each at the far end of a duplex :class:`~repro_torch.core.engine.
transport.Channel`; waits for every rank's ``ready``; carries requests
and collects the replies in rank order; maps a rank's forwarded
traceback, its death and its silence past :attr:`RankPool.reply_timeout`
to a ``RuntimeError`` that names the rank and the phase; and stops the
ranks (``exit``, a join, then SIGTERM with a warning).  On the rank's
side, :func:`apply_settings` takes the controller's thread count and
TF32 switches, and :func:`report_start_failure` forwards a failed
start-up's traceback and answers the controller's ``exit``.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine.transport import Channel

#: seconds a rank may take to answer: its first reply includes torch's
#: import, the device's start-up and, on the card, the kernels' load; a
#: full-width step on a shared card is tens of seconds
REPLY_TIMEOUT = 600.0


def apply_settings(threads: int, allow_tf32: Tuple[bool, bool]) -> None:
    """A rank's intra-op thread count (0 keeps torch's default: spawned
    processes do not inherit ``torch.set_num_threads``) and TF32
    switches (matmul, cuDNN), as the controller's."""
    if threads:
        torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32[0]
    torch.backends.cudnn.allow_tf32 = allow_tf32[1]


def report_start_failure(channel: Channel) -> None:
    """A rank whose start-up raised: send the traceback (the controller
    raises it), answer the controller's ``exit`` and close."""
    channel.send("error", {"traceback": traceback.format_exc()})
    try:
        if channel.recv()[0] == "exit":
            channel.send("ok")
    except (EOFError, OSError):
        pass
    channel.close()


class RankPool:
    """The controller's side of a set of rank processes, one
    :class:`Channel` each (``procs[r]``, ``channels[r]``)."""

    #: how errors name rank ``r``
    rank_name = "rank {} worker"
    reply_timeout = REPLY_TIMEOUT
    #: seconds a rank may take to acknowledge ``exit``
    exit_timeout = 5.0

    # empty until start_ranks (and again after close)
    procs: Sequence[mp.process.BaseProcess] = ()
    channels: Sequence[Channel] = ()

    def start_ranks(self, ctx, target: Callable, specs: Sequence,
                    transports: Sequence[str],
                    extras: Optional[Sequence[Tuple]] = None,
                    name: str = "cephalo-rank{}") -> None:
        """Start ``target(specs[r], conn, *extras[r])`` in a daemon
        process per rank, ``conn`` the rank's end of its channel."""
        self.procs, self.channels = [], []
        for r, spec in enumerate(specs):
            parent, child = ctx.Pipe(duplex=True)
            args = (spec, child) + (tuple(extras[r]) if extras else ())
            proc = ctx.Process(target=target, args=args, daemon=True,
                               name=name.format(r))
            proc.start()
            child.close()
            self.procs.append(proc)
            self.channels.append(Channel(parent, transport=transports[r]))

    def await_ready(self) -> None:
        """Every rank's ``ready``, in rank order."""
        for rank in range(len(self.channels)):
            tag, meta, _ = self._recv(rank, phase="startup")
            if tag != "ready":
                raise RuntimeError(f"{self.rank_name.format(rank)} failed "
                                   f"to start: {tag} {meta}")

    # --- messaging ------------------------------------------------------
    def _recv(self, rank: int, phase: str = ""
              ) -> Tuple[str, dict, Dict[str, np.ndarray]]:
        proc = self.procs[rank]
        who = self.rank_name.format(rank)
        where = f" during {phase}" if phase else ""
        try:
            tag, meta, arrays = self.channels[rank].recv(
                timeout=self.reply_timeout, alive=proc.is_alive)
        except EOFError as e:
            raise RuntimeError(
                f"{who} died{where} (exitcode {proc.exitcode})") from e
        except TimeoutError as e:
            raise RuntimeError(
                f"{who} gave no reply{where} within "
                f"{self.reply_timeout:.0f}s") from e
        if tag == "error":
            raise RuntimeError(f"{who} error{where}:\n"
                               f"{meta.get('traceback')}")
        return tag, meta, arrays

    def _send(self, rank: int, tag: str, meta: Optional[dict],
              arrays: Optional[Dict[str, np.ndarray]],
              phase: str = "") -> None:
        where = f" during {phase}" if phase else ""
        try:
            self.channels[rank].send(tag, meta, arrays)
        except (OSError, EOFError) as e:
            raise RuntimeError(
                f"{self.rank_name.format(rank)} unreachable{where} "
                f"(exitcode {self.procs[rank].exitcode}): {e!r}") from e

    def request(self, rank: int, tag: str, meta: Optional[dict] = None,
                arrays: Optional[Dict[str, np.ndarray]] = None,
                phase: str = "") -> Tuple[dict, Dict[str, np.ndarray]]:
        """One strict request→reply exchange with one rank."""
        self._send(rank, tag, meta, arrays, phase=phase or tag)
        _, r_meta, r_arrays = self._recv(rank, phase=phase or tag)
        return r_meta, r_arrays

    def request_all(self, tag: str, metas: Optional[List[dict]] = None,
                    arrays: Optional[List[Optional[dict]]] = None,
                    ranks: Optional[Sequence[int]] = None,
                    phase: str = ""
                    ) -> List[Tuple[dict, Dict[str, np.ndarray]]]:
        """Fan a request out to ``ranks`` (default: all) and collect the
        replies **in rank order** — the fixed order every reduction uses,
        which is what makes the multiproc step numerics match loopback's
        rank-major accumulation exactly."""
        ranks = list(ranks) if ranks is not None \
            else list(range(len(self.channels)))
        for i, rank in enumerate(ranks):
            self._send(rank, tag, metas[i] if metas else None,
                       arrays[i] if arrays else None,
                       phase=phase or tag)
        if arrays:
            # sent: the list lets go of its payloads while the replies
            # arrive (full-width flats are gigabytes of host memory)
            arrays.clear()
        out = []
        for rank in ranks:
            _, meta, arrs = self._recv(rank, phase=phase or tag)
            out.append((meta, arrs))
        return out

    # --- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Stop every rank.  Idempotent; a rank that died (or goes
        silent) during teardown is *reported* via ``warnings.warn`` —
        never silently swallowed — and then reaped with terminate."""
        for rank, ch in enumerate(self.channels):
            proc = self.procs[rank]
            try:
                if proc.is_alive():
                    ch.send("exit")
                    ch.recv(timeout=self.exit_timeout, alive=proc.is_alive)
            except (EOFError, OSError, TimeoutError) as e:
                warnings.warn(
                    f"{self.rank_name.format(rank)} did not acknowledge "
                    f"exit (exitcode {proc.exitcode}): {e!r}; "
                    "terminating it", RuntimeWarning)
        for rank, proc in enumerate(self.procs):
            proc.join(timeout=self.exit_timeout)
            if proc.is_alive():
                warnings.warn(
                    f"{self.rank_name.format(rank)} (pid {proc.pid}) "
                    "survived exit; sending SIGTERM", RuntimeWarning)
                proc.terminate()
                proc.join(timeout=5.0)
        for ch in self.channels:
            ch.close()
        self.channels = []
        self.procs = []

    def __del__(self):   # best-effort backstop; close() is the real API
        try:
            self.close()
        except Exception:   # noqa: BLE001 - interpreter-shutdown races
            # (modules half-torn-down, warnings machinery gone) make any
            # reporting here unreliable; close() itself warns when
            # invoked normally, so the backstop stays silent by design.
            pass
