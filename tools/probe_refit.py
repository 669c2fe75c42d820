"""How two processes that share one card read the same layer, timed two ways.

    python tools/probe_refit.py [--sets 2]

Starts two worker processes on the card, each holding the element the
process fleet of ``chip_smoke.py``'s phase ``train_elastic_multiproc``
probes (one gpt-1.3b layer at full width: the profiler's seeded params
and input, ``profiler._layer`` / ``layer_call``, its params requiring
grad as the fleet worker's), and probes them as
``multiproc.WallClockOracle`` does: ``SHARED_PROBE_TURNS`` turns over the
two, each probe the best of ``SHARED_PROBE_REPEATS`` forward passes
after ``SHARED_PROBE_WARMUP_S`` seconds of warm-up
(``profiler._best_seconds``), a slowed worker sleeping after its probe as
the fleet's straggler does, each worker's best kept.  It does so
``--sets`` times under each of:

* timing: CUDA events around each pass (``queued=False``, the host's
  launches included) or the device's work alone (``queued=True``, as the
  fleet's probes are timed);
* worker 0 unslowed, or three times slower;
* turn order 0, 1, 1, 0, ... or 1, 0, 0, 1, ...;
* a thread of the controller calling ``torch.cuda.mem_get_info`` every
  20 ms (as ``chip_smoke.py``'s memory poll does) or not;
* microbatch 1 or 8 (sequence 512).

Prints the card's name and power limit, then one JSON line a set: each
worker's best in ms (the sleep of a slowed one is not timed) and their
ratio (worker 1 over worker 0).  Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.engine import multiproc as MP  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCH, SEQ, MS = "gpt-1.3b", 512, (1, 8)


def _worker(conn) -> None:
    """Answers ``(m, queued, slowdown)`` with the best forward pass of the
    layer at microbatch ``m`` in seconds, then sleeps as a straggler
    ``slowdown`` times slower would; ``None`` ends it."""
    device = torch.device("cuda")
    cfg = get_arch(ARCH)
    spec, bp, shared = profiler._layer(cfg, device)
    bp = M.tree_map(bp, lambda _, t: t.requires_grad_(True))
    calls = {}
    while (msg := conn.recv()) is not None:
        m, queued, slow = msg
        if m not in calls:
            x, pos = profiler._input(cfg, m, SEQ, device)
            calls[m] = profiler.layer_call(cfg, spec, bp, shared, x, pos)
        best = profiler._best_seconds(calls[m], device,
                                      MP.SHARED_PROBE_REPEATS,
                                      MP.SHARED_PROBE_WARMUP_S, queued)
        if slow > 1.0:
            time.sleep((slow - 1.0) * best * MP.SHARED_PROBE_REPEATS)
        conn.send(best)


def _turns(conns, m: int, order, queued: bool, slow: float) -> dict:
    """Each worker's best over the oracle's turns at microbatch ``m``."""
    best: dict = {}
    seq = [r for k in range(MP.SHARED_PROBE_TURNS)
           for r in (order if k % 2 == 0 else order[::-1])]
    for r in seq:
        conns[r].send((m, queued, slow if r == 0 else 1.0))
        t = conns[r].recv()
        best[r] = min(best.get(r, t), t)
    return best


@contextlib.contextmanager
def _poll():
    stop = threading.Event()

    def run():
        while not stop.is_set():
            torch.cuda.mem_get_info()
            stop.wait(0.02)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_refit: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "arch": ARCH, "seq": SEQ,
                      "turns": MP.SHARED_PROBE_TURNS,
                      "repeats": MP.SHARED_PROBE_REPEATS,
                      "warmup_s": MP.SHARED_PROBE_WARMUP_S}), flush=True)
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(2)]
    procs = [ctx.Process(target=_worker, args=(child,), daemon=True)
             for _, child in pipes]
    for p in procs:
        p.start()
    conns = [parent for parent, _ in pipes]
    try:
        for queued, slow, order, poll, m in itertools.product(
                (False, True), (1.0, 3.0), ((0, 1), (1, 0)), (False, True),
                MS):
            for i in range(args.sets):
                with _poll() if poll else contextlib.nullcontext():
                    best = _turns(conns, m, order, queued, slow)
                ms = [best[0] * 1e3, best[1] * 1e3]
                print(json.dumps({
                    "queued": queued, "worker0_slowdown": slow,
                    "order": order, "mem_poll": poll, "m": m, "set": i,
                    "best_ms": ms, "worker1_over_worker0": ms[1] / ms[0]}),
                    flush=True)
    finally:
        for conn in conns:
            conn.send(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
