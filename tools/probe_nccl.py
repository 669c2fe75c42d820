"""Ask NCCL whether two ranks may share one card.

    python tools/probe_nccl.py

Starts two NCCL ranks on ``cuda:0`` (one all-reduce each) and prints
each rank's outcome: ``(rank, "ok", result)``, ``(rank, "error",
message)``, ``(rank, "hung")`` or ``(rank, "exit N")``.  The SPMD
runtime's placement rule (``repro_torch.core.engine.world.placement``)
gives ranks that share a card gloo over pinned host copies because NCCL
refuses them (PERF.md quotes the outcome).  Needs torch with CUDA only.
"""

import datetime
import multiprocessing as mp
import queue

import torch
import torch.distributed as dist

LOOPBACK = "127.0.0.1"


def _probe_rank(rank: int, port: int, out) -> None:
    try:
        torch.cuda.set_device(0)
        timeout = datetime.timedelta(seconds=60)
        store = dist.TCPStore(LOOPBACK, port, is_master=False,
                              timeout=timeout)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=2, timeout=timeout)
        t = torch.ones(4, device="cuda:0") * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.put((rank, "ok", t.tolist()))
        dist.destroy_process_group()
    except Exception as e:   # noqa: BLE001 - the probe reports it
        out.put((rank, "error", f"{type(e).__name__}: {e}"))


def probe_nccl_shared(timeout: float = 120.0) -> list:
    """Each rank's outcome; a rank that neither answers nor exits within
    ``timeout`` seconds is ``hung`` and terminated."""
    ctx = mp.get_context("spawn")
    store = dist.TCPStore(LOOPBACK, 0, is_master=True,
                          wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=_probe_rank, args=(r, store.port, out),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    while len(got) < 2 and datetime.datetime.now() < deadline:
        try:
            item = out.get(timeout=1.0)
            got[item[0]] = item
        except queue.Empty:
            if not any(p.is_alive() for p in procs) and out.empty():
                break
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
    return [got.get(r, (r, "hung" if procs[r].exitcode is None
                        else f"exit {procs[r].exitcode}"))
            for r in range(2)]


if __name__ == "__main__":
    for outcome in probe_nccl_shared():
        print(outcome, flush=True)
