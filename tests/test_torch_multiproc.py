"""The port's process fleet, its wire and its ring collectives, on the
CPU, against the JAX package's copies.

* **transport** — every channel case of ``tests/test_multiproc.py`` on
  the port's copy of ``transport.py``: round trips on both planes, arena
  growth and the pipe fallback, bounded waits, data-plane byte counts,
  tag-matched out-of-order receives, and the knobs' resolution.
* **ring** — the port's copy of ``ring.py`` gives the reference's arrays
  for seeded ragged inputs: ``simulate`` of both collectives over
  several fleet sizes (a zero-size rank among them), ``combine_fixed_order``
  and ``overlap_plan``.
* **fleet** — a worker killed mid-collective raises a RuntimeError
  naming its rank and phase, on hub, ring and the overlapped ring; a
  worker asked for CUDA where there is none raises, and the coordinator
  surfaces its traceback; messaging a gone worker names it; the hub
  sums the union of unit sets; ``hidden_comm_fraction``'s arithmetic;
  the ``WallClockOracle``'s surface.
* **sanitizer** — the runtime comm sanitizer's unit cases of
  ``tests/test_comm_sanitizer.py`` on the port's copies, and live ring
  fleets: a seeded protocol mutation (a reused round tag, a skipped ack)
  is caught at the offending rank, after a clean sanitized step whose
  loss equals an unsanitized fleet's.

(Bitwise step parity of the fleet with the loopback engine, over
topologies and schedules, is ``tests/test_torch_parity_matrix.py``.)
"""

import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.engine import ring as jax_ring
from repro_torch.configs.base import get_arch
from repro_torch.core.engine import (WallClockOracle, build_train_step,
                                     ring)
from repro_torch.core.engine.multiproc import (MultiProcessSubstrate,
                                               ProcessEngine, WorkerSpec,
                                               send_plane)
from repro_torch.core.engine.transport import Channel, ShmArena
from repro_torch.core.engine.units import UnitPlanner
from repro_torch.core.engine.verify import (CommSanitizer,
                                            ProtocolViolation,
                                            exchange_steps,
                                            resolve_sanitize)
from repro_torch.core.engine.verify.sanitizer import waiting_guard
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

REPO = Path(__file__).resolve().parents[1]


def _plan(ranks_spec, batch):
    ranks = [RankPlan(i, d, m=m, ell=ell, state_ratio=r)
             for i, (d, m, ell, r) in enumerate(ranks_spec)]
    return Plan(model="toy", cluster="toy", global_batch=batch, ranks=ranks)


# --- transport ---------------------------------------------------------------

@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_channel_roundtrip(transport):
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport=transport), Channel(b, transport=transport)
    try:
        payload = {
            "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
            "i32": np.asarray([[1, -2], [3, 4]], dtype=np.int32),
            "stacked": np.ones((2, 7), dtype=np.float32),
            "empty": np.zeros((0,), dtype=np.float32),
        }
        tx.send("data", {"step": 3}, payload)
        tag, meta, arrays = rx.recv()
        assert tag == "data" and meta == {"step": 3}
        assert sorted(arrays) == sorted(payload)
        for k in payload:
            np.testing.assert_array_equal(arrays[k], payload[k])
            assert arrays[k].dtype == payload[k].dtype
        # reply direction over the same channel pair
        rx.send("ok", {"echo": True})
        tag, meta, arrays = tx.recv()
        assert tag == "ok" and meta["echo"] and arrays == {}
    finally:
        tx.close()
        rx.close()


def test_shm_arena_grows_and_pipe_fallback():
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport="shm"), Channel(b, transport="shm")
    try:
        small = {"x": np.arange(8, dtype=np.float32)}
        tx.send("m", None, small)
        _, _, got = rx.recv()
        np.testing.assert_array_equal(got["x"], small["x"])
        first_size = tx._send_arena.size
        big = {"y": np.arange(first_size // 4 + 1024, dtype=np.float32)}
        tx.send("m", None, big)          # forces arena replacement
        _, _, got = rx.recv()
        np.testing.assert_array_equal(got["y"], big["y"])
        assert tx._send_arena.size > first_size
        # a disabled arena degrades to the pipe plane transparently
        tx._send_arena.disabled = True
        tx.send("m", None, small)
        _, _, got = rx.recv()
        np.testing.assert_array_equal(got["x"], small["x"])
    finally:
        tx.close()
        rx.close()


def test_shm_failure_warns_and_falls_back_to_pipe():
    """Shared-memory breakage degrades loudly, not silently: a failed
    arena creation warns and reroutes the payload over the pipe plane;
    tearing down an already-unlinked segment stays quiet (expected
    during shutdown races)."""

    class _BrokenShm:
        def SharedMemory(self, *a, **kw):
            raise OSError("no /dev/shm today")

    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport="shm"), Channel(b, transport="shm")
    try:
        tx._send_arena._shm_mod = _BrokenShm()
        payload = {"x": np.arange(8, dtype=np.float32)}
        with pytest.warns(RuntimeWarning, match="falling back"):
            tx.send("m", None, payload)
        _, _, got = rx.recv()
        np.testing.assert_array_equal(got["x"], payload["x"])
        assert tx._send_arena.disabled
    finally:
        tx.close()
        rx.close()
    # an arena whose segment the peer already unlinked closes quietly
    arena = ShmArena(owner=True)
    if not arena.disabled and arena._ensure(1 << 12):
        arena.seg.unlink()
        arena.close()       # FileNotFoundError path: no warning, no raise
        assert arena.seg is None
        arena.close()       # idempotent


def test_channel_recv_bounded_wait():
    """Receives are bounded: a silent peer raises TimeoutError within
    the window, a dead peer raises EOFError via the alive() probe —
    nobody hangs (the fault-injection contract's transport half)."""
    a, b = mp.Pipe(duplex=True)
    rx = Channel(b, transport="pipe")
    try:
        with pytest.raises(TimeoutError, match="no message"):
            rx.recv(timeout=0.2)
        with pytest.raises(EOFError, match="died"):
            rx.recv(timeout=30.0, alive=lambda: False)
    finally:
        rx.close()
        a.close()


@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_channel_accounts_data_plane_bytes(transport):
    """Per-tag array-byte counters feed the hub-vs-ring benchmark; meta
    and headers are control plane and must not count."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport=transport), Channel(b, transport=transport)
    try:
        payload = {"x": np.zeros((8, 4), np.float32)}
        tx.send("round", {"lo": 0}, payload)
        tx.send("control", {"big_meta": list(range(100))})
        rx.recv()
        rx.recv()
        assert tx.array_bytes_out == {"round": 8 * 4 * 4, "control": 0}
        assert rx.array_bytes_in == {"round": 8 * 4 * 4, "control": 0}
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_channel_recv_match_out_of_order(transport):
    """Tag-matched receive delivers the requested (tag, meta) message
    even when other traffic arrives first, parking mismatches for later
    receives in arrival order — the guarantee that keeps the overlap
    pipeline's prefetch traffic out of the current round's hands."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport=transport), Channel(b, transport=transport)
    try:
        early = {"x": np.arange(4, dtype=np.float32)}
        want = {"y": np.arange(6, dtype=np.float32)}
        tx.send("ring", {"round": 1, "step": 0}, early)   # prefetch traffic
        tx.send("ring_ack", {"round": 0, "step": 0})
        tx.send("ring", {"round": 0, "step": 0}, want)    # current round
        tag, meta, arrays = rx.recv_match("ring", {"round": 0, "step": 0},
                                          timeout=5.0)
        assert (tag, meta["round"]) == ("ring", 0)
        np.testing.assert_array_equal(arrays["y"], want["y"])
        # parked messages drain in arrival order via plain recv ...
        tag, meta, arrays = rx.recv()
        assert (tag, meta["round"]) == ("ring", 1)
        np.testing.assert_array_equal(arrays["x"], early["x"])
        # ... or by a later match
        tag, meta, _ = rx.recv_match("ring_ack", {"round": 0}, timeout=5.0)
        assert tag == "ring_ack"
        # a match that never arrives times out and reports the parked mess
        stranded = {"z": np.ones((2, 3), np.float32)}
        tx.send("ring", {"round": 9, "step": 9}, stranded)
        with pytest.raises(TimeoutError, match="parked"):
            rx.recv_match("ring", {"round": 2, "step": 2}, timeout=0.2)
        # closing over a parked message is loud, not silent: the warning
        # names the unclaimed tag/meta and the payload bytes count as
        # dropped (the peer paid wire time for traffic nobody claimed)
        with pytest.warns(RuntimeWarning, match="never claimed"):
            rx.close()
        assert rx.array_bytes_dropped == {"ring": stranded["z"].nbytes}
    finally:
        tx.close()
        rx.close()   # idempotent: pending already drained/discarded


def test_channel_recv_match_fail_fast_guards():
    """Protocol errors surface immediately, not after the ring timeout:
    provably-unclaimable messages (the ``stale`` predicate — e.g. a ring
    message from a completed engine step) are dropped with a warning,
    and a runaway parked buffer raises instead of growing forever."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport="pipe"), Channel(b, transport="pipe")
    try:
        old = {"w": np.ones((4,), np.float32)}
        tx.send("ring", {"gstep": 1, "round": 0}, old)   # stale (old step)
        tx.send("ring", {"gstep": 2, "round": 0},
                {"x": np.ones(3, np.float32)})
        with pytest.warns(RuntimeWarning, match="stale"):
            tag, meta, arrays = rx.recv_match(
                "ring", {"gstep": 2, "round": 0}, timeout=5.0,
                stale=lambda m: m.get("gstep", 2) < 2)
        assert meta["gstep"] == 2 and "x" in arrays
        assert rx._pending == []            # the stale one was dropped
        # ... and its payload bytes are accounted as dropped
        assert rx.array_bytes_dropped == {"ring": old["w"].nbytes}
        # parked-buffer cap: a flood of never-matching traffic raises
        for i in range(Channel.MAX_PENDING + 1):
            tx.send("ring", {"gstep": 99, "round": i}, {})
        with pytest.raises(RuntimeError, match="protocol error"):
            rx.recv_match("ring", {"gstep": 3, "round": 0}, timeout=30.0)
        with pytest.warns(RuntimeWarning, match="never claimed"):
            rx.close()
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_channel_recv_match_duplicate_tags_in_flight(transport):
    """Two in-flight messages with the *same* (tag, meta) match key
    deliver in arrival order, once each — never the same message twice,
    never zero times.  (The static verifier proves the ring protocol
    never produces duplicate keys; this pins the channel's behavior if
    one ever appeared.)  Payload *integrity* under back-to-back sends is
    plane-dependent: the pipe plane frames each payload, while the shm
    plane reuses the arena — without the ring protocol's ack gating the
    second write may overwrite the first before the reader copies it
    out, which is exactly the arena property the verifier checks."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport=transport), Channel(b, transport=transport)
    try:
        first = {"x": np.asarray([1.0, 2.0], np.float32)}
        second = {"x": np.asarray([3.0, 4.0], np.float32)}
        tx.send("ring", {"round": 0, "step": 0}, first)
        tx.send("ring", {"round": 0, "step": 0}, second)   # duplicate key
        _, m1, got1 = rx.recv_match("ring", {"round": 0, "step": 0},
                                    timeout=5.0)
        _, m2, got2 = rx.recv_match("ring", {"round": 0, "step": 0},
                                    timeout=5.0)
        assert m1 == m2 == {"round": 0, "step": 0}
        np.testing.assert_array_equal(got2["x"], second["x"])
        if transport == "pipe":
            np.testing.assert_array_equal(got1["x"], first["x"])
        else:
            # the unacked second send overwrote the arena: the first
            # payload is gone — the hazard ack gating exists to prevent
            np.testing.assert_array_equal(got1["x"], second["x"])
        assert rx._pending == []
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("transport", ["pipe", "shm"])
def test_channel_recv_match_interleaved_park_claim(transport):
    """The overlap tag scheme interleaved: an AG round k+1 prefetch
    payload arrives early, is parked by a claim for a *different* match
    key, and is then claimed by the later matched receive — with its
    meta and payload surviving parking byte-exactly (phase, step, round,
    gstep).  The wire order respects the ring's ack discipline (at most
    one unacked bulk payload per direction), so parking's dequeue-time
    copy-out keeps the shm arena safe to reuse."""
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport=transport), Channel(b, transport=transport)
    try:
        ag = "allgather(p)[2,4)"
        rs = "reduce_scatter(G)[0,2)"
        # AG k+1 prefetch payload and its trailing ack arrive early
        tx.send("ring", {"phase": ag, "step": 0, "round": 1, "gstep": 3,
                         "src": 1}, {"p": np.ones(5, np.float32)})
        tx.send("ring_ack", {"phase": ag, "step": 0, "round": 1,
                             "gstep": 3, "src": 1})
        # claiming the ack parks the AG payload (copied out of the
        # arena at dequeue — the sender may now legally reuse it)
        _, meta, _ = rx.recv_match(
            "ring_ack", {"phase": ag, "step": 0, "round": 1, "gstep": 3},
            timeout=5.0)
        assert meta["round"] == 1
        assert [t for t, _, _ in rx._pending] == ["ring"]
        # RS round k traffic flows and claims while AG k+1 stays parked
        tx.send("ring", {"phase": rs, "step": 0, "round": 0, "gstep": 3,
                         "src": 1}, {"g": np.full(4, 2.0, np.float32)})
        _, meta, arrays = rx.recv_match(
            "ring", {"phase": rs, "step": 0, "round": 0, "gstep": 3},
            timeout=5.0)
        assert meta["round"] == 0
        np.testing.assert_array_equal(arrays["g"],
                                      np.full(4, 2.0, np.float32))
        assert [t for t, _, _ in rx._pending] == ["ring"]   # still parked
        # the later AG-round claim drains it, meta + payload intact
        _, meta, arrays = rx.recv_match(
            "ring", {"phase": ag, "step": 0, "round": 1, "gstep": 3},
            timeout=5.0)
        assert meta == {"phase": ag, "step": 0, "round": 1, "gstep": 3,
                        "src": 1}
        np.testing.assert_array_equal(arrays["p"], np.ones(5, np.float32))
        assert rx._pending == []
        assert rx.array_bytes_dropped == {}
    finally:
        tx.close()
        rx.close()


def test_pipe_plane_moves_raw_bytes_and_refuses_a_non_socket():
    """The port's one change to the wire: the pipe plane moves array
    bytes unframed on the socket pair (``sendall`` / ``recv_into`` a
    buffer of the receiver's own, so the array is writable), with the
    reference's arrays, byte counts and order.  A connection that is no
    socket (an ``os.pipe``) is refused when the channel is made."""
    # small enough for the kernel's buffers: one thread sends, then reads
    big = np.arange(3 * 1024, dtype=np.float32).reshape(3, -1)
    payload = {"big": big, "i": np.asarray([7, -1], np.int64),
               "empty": np.zeros((0, 4), np.float32)}
    a, b = mp.Pipe(duplex=True)
    tx, rx = Channel(a, transport="pipe"), Channel(b, transport="pipe")
    try:
        tx.send("round", {"k": 1}, payload)
        tx.send("ok")
        tag, meta, got = rx.recv()
        assert (tag, meta) == ("round", {"k": 1})
        for k, v in payload.items():
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == v.dtype
        assert got["big"].flags.writeable
        assert rx.recv()[0] == "ok"
        assert tx.array_bytes_out == rx.array_bytes_in == {
            "round": sum(v.nbytes for v in payload.values()), "ok": 0}
        assert send_plane(tx) == "pipe"
    finally:
        tx.close()
        rx.close()
    r, w = mp.Pipe(duplex=False)
    try:
        for conn in (r, w):
            with pytest.raises(ValueError, match="socket connection"):
                Channel(conn, transport="pipe")
    finally:
        r.close()
        w.close()


def test_resolve_topology():
    from repro_torch.core.engine.transport import resolve_topology
    assert resolve_topology() in ("hub", "ring")
    assert resolve_topology("ring") == "ring"
    with pytest.raises(ValueError, match="topology"):
        resolve_topology("star")


def test_resolve_overlap(monkeypatch):
    from repro_torch.core.engine.transport import resolve_overlap
    monkeypatch.delenv("CEPHALO_MP_OVERLAP", raising=False)
    assert resolve_overlap() is False
    assert resolve_overlap(True) is True
    assert resolve_overlap(False) is False
    for raw, expect in [("1", True), ("true", True), ("ON", True),
                        ("0", False), ("off", False), ("", False)]:
        monkeypatch.setenv("CEPHALO_MP_OVERLAP", raw)
        assert resolve_overlap() is expect, raw
    monkeypatch.setenv("CEPHALO_MP_OVERLAP", "sideways")
    with pytest.raises(ValueError, match="CEPHALO_MP_OVERLAP"):
        resolve_overlap()


def test_overlap_requires_ring_topology():
    """overlap_rounds=True on the hub topology is a configuration error,
    raised before any worker spawns."""
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan([("A", 1, 1, 0.6), ("B", 1, 1, 0.4)], batch=2)
    with pytest.raises(ValueError, match="ring"):
        build_train_step(cfg, plan, substrate="multiproc", device="cpu",
                         topology="hub", overlap_rounds=True,
                         adam=AdamConfig(lr=1e-3), seq_len=16)


# --- ring: the port's copy against the reference's ---------------------------

def _ragged_chunks(rng, n, sizes):
    """Per-rank {unit: array}: a flat unit and a stacked one, each rank's
    slice its own length (zero allowed)."""
    return [{"u0": rng.standard_normal(s).astype(np.float32),
             "s1": rng.standard_normal((3, s + 1)).astype(np.float32)}
            for s in sizes[:n]]


@pytest.mark.parametrize("sizes", [[5], [4, 0], [3, 7, 1], [2, 0, 6, 9]],
                         ids=lambda s: f"n{len(s)}")
def test_ring_collectives_match_reference(sizes):
    rng = np.random.default_rng(len(sizes))
    n = len(sizes)
    own = _ragged_chunks(rng, n, sizes)
    got = ring.simulate([ring.allgatherv(r, n, own[r]) for r in range(n)])
    want = jax_ring.simulate([jax_ring.allgatherv(r, n, own[r])
                              for r in range(n)])
    for g, w in zip(got, want):
        assert len(g) == len(w) == n
        for gc, wc in zip(g, w):
            assert gc.keys() == wc.keys()
            for u in gc:
                np.testing.assert_array_equal(gc[u], wc[u])
    # reduce-scatter: each origin's per-destination chunks (None where an
    # origin contributes nothing), collected then combined in rank order
    dest = [None if r == 1 else _ragged_chunks(rng, n, sizes)
            for r in range(n)]
    got = ring.simulate([ring.reduce_scatterv(r, n, dest[r])
                         for r in range(n)])
    want = jax_ring.simulate([jax_ring.reduce_scatterv(r, n, dest[r])
                              for r in range(n)])
    for g, w in zip(got, want):
        a, b = ring.combine_fixed_order(g), jax_ring.combine_fixed_order(w)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for u in a:
                np.testing.assert_array_equal(a[u], b[u])
                assert a[u].dtype == np.float32
    for k in range(6):
        assert ring.overlap_plan(k) == jax_ring.overlap_plan(k)
        for r in range(n):
            assert ring.ring_neighbors(n, r) == \
                jax_ring.ring_neighbors(n, r)


def test_combine_fixed_order_matches_reference():
    """Unions of unit sets, ``None`` contributors, rank order: the same
    float32 sums, bit for bit."""
    rng = np.random.default_rng(7)
    parts = [{"a": rng.standard_normal(9).astype(np.float32)}, None,
             {"a": rng.standard_normal(9).astype(np.float32),
              "b": rng.standard_normal((2, 4)).astype(np.float32)},
             {"b": rng.standard_normal((2, 4)).astype(np.float32)}]
    got, want = ring.combine_fixed_order(parts), \
        jax_ring.combine_fixed_order(parts)
    assert got.keys() == want.keys() == {"a", "b"}
    for u in got:
        np.testing.assert_array_equal(got[u], want[u])
    assert ring.combine_fixed_order([None, None]) is None


# --- the fleet ---------------------------------------------------------------

@pytest.mark.parametrize("topology,overlap", [("hub", False),
                                              ("ring", False),
                                              ("ring", True)])
def test_worker_death_mid_collective_names_rank_and_phase(topology,
                                                          overlap):
    """A worker dying mid-collective surfaces a RuntimeError naming the
    dead rank and the collective phase instead of hanging the fleet, on
    both topologies, and mid-prefetch on the overlapped pipeline."""
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan([("A", 1, 1, 0.6), ("B", 1, 1, 0.4)], batch=2)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, 16, seed=4))
    with build_train_step(cfg, plan, substrate="multiproc", device="cpu",
                          topology=topology, overlap_rounds=overlap,
                          ring_timeout=30.0, adam=AdamConfig(lr=1e-3),
                          seq_len=16) as eng:
        eng.init_state(torch.Generator().manual_seed(0))
        eng.inject_death(1)      # dies the instant round 0 reaches it
        with pytest.raises(RuntimeError, match="rank 1") as excinfo:
            eng.step({"step": 0}, stream.sample(0, 2))
        msg = str(excinfo.value)
        if topology == "ring":
            # a surviving participant reported which ring phase broke
            assert "ring" in msg, msg
        else:
            # the coordinator reported which hub round phase broke
            assert "round[" in msg, msg


def test_worker_without_cuda_raises_with_its_traceback():
    """A worker asked for CUDA on a machine without it does not fall back
    to the CPU: its start-up reply is its traceback, which the
    coordinator (here on the CPU) raises (the fleet is then closed)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_arch("tiny-llama").reduced()
    spec = WorkerSpec(rank=0, cfg=cfg, ratios=(1.0,), m=1, ell=1, seq=16,
                      adam=AdamConfig(), transport="pipe", n_ranks=1,
                      device="cuda")
    with pytest.raises(RuntimeError, match="rank 0 worker error during "
                                           "startup") as excinfo:
        MultiProcessSubstrate(UnitPlanner(cfg, [1.0]), [spec], device="cpu")
    assert "CUDA was asked for but is not available" in str(excinfo.value)


def test_worker_round_leaves_no_tensor_in_a_reference_cycle():
    """A worker's rounds and Adam steps hold no tensor past their end
    with the cyclic collector off, the first round too.  The first
    activation checkpoint of a process imports ``torch._dynamo``, and
    that import keeps its callers' frames in a cycle (a round's params
    and batch); the worker imports it when it starts.  Run in a fresh
    interpreter, so the import has not happened yet."""
    code = textwrap.dedent(f"""
        import gc, sys, weakref
        sys.path[:0] = [{str(REPO / "src")!r}]
        import numpy as np, torch
        torch.set_num_threads(1)
        assert "torch._dynamo" not in sys.modules
        from repro_torch.configs.base import get_arch
        from repro_torch.core.engine.multiproc import WorkerSpec, _Worker
        from repro_torch.models import model as M
        from repro_torch.optim.adam import AdamConfig
        cfg = get_arch("tiny-llama").reduced()
        w = _Worker(WorkerSpec(rank=0, cfg=cfg, ratios=(1.0,), m=2, ell=2,
                               seq=16, adam=AdamConfig(), transport="pipe",
                               n_ranks=1, device="cpu"))
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu", all_fp32=True)
        w.scatter_state({{f"{{u}}|{{k}}": t.numpy()
                         for u, parts in w.sub.shard_state(params)[0].items()
                         if u != "step" for k, t in parts.items()}})
        del params
        flats = {{u: w.state[u]["p"].numpy() for u in w.state}}
        tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
        gc.collect()
        gc.disable()
        for step in range(2):
            w.begin_step({{"w_val": 0.25}}, {{"tokens": tok, "labels": tok}})
            meta, w.grad_acc = w._compute_round(0, 2, dict(flats))
            w.adam_step(step + 1)
            del meta
            refs = [weakref.ref(o) for o in gc.get_objects()
                    if isinstance(o, torch.Tensor)]
            gc.collect()
            print("freed by the collector", sum(r() is None for r in refs))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split("\n")[:2] == ["freed by the collector 0"] * 2


def test_dead_worker_on_send_is_named_not_raw_broken_pipe():
    """Messaging a gone worker raises the substrate's RuntimeError (rank
    + phase), never a bare BrokenPipeError."""

    class _Proc:
        exitcode = -9

        @staticmethod
        def is_alive():
            return False

    sub = MultiProcessSubstrate.__new__(MultiProcessSubstrate)
    a, b = mp.Pipe(duplex=True)
    b.close()
    sub.procs = [_Proc()]
    sub.channels = [Channel(a, transport="pipe")]
    try:
        with pytest.raises(RuntimeError, match="rank 0.*unreachable.*"
                                               "reduce_scatterv"):
            sub._send(0, "grad_accum",
                      None, {"g": np.zeros(1 << 20, np.float32)},
                      phase="reduce_scatterv(G)")
    finally:
        sub.channels[0].close()
        sub.channels, sub.procs = [], []


def test_hidden_comm_fraction_math():
    """1 − exposed/total per rank, clamped at 0, 0.0 when the wire was
    idle; accepts an explicit aggregate as well as the last step."""
    eng = ProcessEngine.__new__(ProcessEngine)
    eng.last_step_comm = {
        0: {"allgather_s": 0.6, "reduce_scatter_s": 0.4,
            "exposed_allgather_s": 0.1, "exposed_reduce_scatter_s": 0.1},
        1: {"allgather_s": 0.5, "reduce_scatter_s": 0.5,
            "exposed_allgather_s": 0.9, "exposed_reduce_scatter_s": 0.9},
        2: {"allgather_s": 0.0, "reduce_scatter_s": 0.0,
            "exposed_allgather_s": 0.0, "exposed_reduce_scatter_s": 0.0},
    }
    fracs = eng.hidden_comm_fraction()
    assert abs(fracs[0] - 0.8) < 1e-9
    assert fracs[1] == 0.0          # exposed > total clamps, not negative
    assert fracs[2] == 0.0          # idle wire
    agg = {5: {"allgather_s": 1.0, "reduce_scatter_s": 1.0,
               "exposed_allgather_s": 0.5,
               "exposed_reduce_scatter_s": 0.5}}
    assert eng.hidden_comm_fraction(agg) == {5: 0.5}


def test_hub_round_sums_union_of_unit_sets():
    """The hub coordinator's gradient sum unions heterogeneous per-rank
    unit sets in rank order, as ``ring.combine_fixed_order`` does, and
    adds each reply's kernel launches to the step's; no fleet."""
    captured = {}

    class _Sub:
        stats = {"all_gather": 0, "reduce_scatter": 0}

        def gather_flat(self, key):
            return {}

        def request_all(self, tag, metas=None, arrays=None, ranks=None,
                        phase=""):
            return [
                ({"loss": 1.0, "n_mb": 1, "t_wall": 0.0},
                 {"G|a": np.asarray([1.0, 2.0], np.float32)}),
                ({"loss": 2.0, "n_mb": 1, "t_wall": 0.0},
                 {"G|a": np.asarray([1.0, 1.0], np.float32),
                  "G|b": np.asarray([5.0], np.float32)}),
            ]

        def scatter_grad_flats(self, sums):
            captured.update(sums)

    eng = ProcessEngine.__new__(ProcessEngine)
    eng.substrate = _Sub()
    out = eng._hub_collective_round(0, 1, [0, 1])
    assert [rank for rank, _ in out] == [0, 1]
    np.testing.assert_array_equal(captured["a"], [2.0, 3.0])
    np.testing.assert_array_equal(captured["b"], [5.0])   # not dropped


def test_wallclock_oracle_validation_no_fleet():
    oracle = WallClockOracle()
    with pytest.raises(ValueError, match="phase"):
        oracle(0, 1, "sideways")
    with pytest.raises(RuntimeError, match="unbound"):
        oracle(0, 1, "fwd")

    class NotMultiproc:
        pass

    with pytest.raises(TypeError, match="multiproc"):
        oracle.bind(NotMultiproc())
    oracle.degrade(1, 2.5)
    assert oracle.factors == {1: 2.5}
    oracle.restore(1)
    assert oracle.factors == {}


# --- the runtime comm sanitizer: unit conformance ----------------------------

AG = "allgather(p)[0,1)"
RS = "reduce_scatter(G)[0,1)"
TAGS = {"round": 0, "gstep": 1}


@pytest.fixture
def san():
    s = CommSanitizer(0, 3, stall_after=3600.0)
    yield s
    s.close()


def _replay(s, phase, tags=TAGS):
    s.begin_collective(phase, tags)
    for role, _, meta in exchange_steps(s.rank, s.n, phase, tags):
        s.observe(role, meta)
    s.end_collective()


class _Chan:
    def __init__(self, pending=()):
        self._pending = list(pending)


def test_clean_step_conforms(san):
    san.begin_step([("allgather", 0), ("reduce_scatter", 0)])
    _replay(san, AG)
    _replay(san, RS)
    san.end_step([_Chan(), _Chan()])


def test_single_rank_collective_is_trivially_clean():
    s = CommSanitizer(0, 1)
    try:
        s.begin_step([("allgather", 0)])
        _replay(s, AG)
        s.end_step([])
    finally:
        s.close()


def _expect_violation(fn, *needles):
    with pytest.raises(ProtocolViolation) as ei:
        fn()
    msg = str(ei.value)
    assert "comm sanitizer" in msg and "rank 0" in msg, msg
    for needle in needles:
        assert needle in msg, (needle, msg)


def _role_meta(step):
    role, _, meta = step
    return role, meta


def test_swapped_role_diverges(san):
    san.begin_collective(AG, TAGS)
    steps = exchange_steps(0, 3, AG, TAGS)
    wrong_role = "recv_payload" if steps[0][0] == "send_payload" \
        else "send_payload"
    _expect_violation(lambda: san.observe(wrong_role, steps[0][2]),
                      "diverged from the verified schedule")


def test_reused_tag_meta_diverges(san):
    tags = {"round": 2, "gstep": 5}
    san.begin_collective("allgather(p)[2,3)", tags)
    role, _, meta = exchange_steps(0, 3, "allgather(p)[2,3)", tags)[0]
    _expect_violation(lambda: san.observe(role, {**meta, "round": 0}),
                      "diverged", "'round': 0")


def test_collective_out_of_plan_order(san):
    san.begin_step([("allgather", 0), ("reduce_scatter", 0)])
    _expect_violation(lambda: san.begin_collective(RS, TAGS),
                      "collective order diverged")


def test_collective_past_plan_end(san):
    san.begin_step([("allgather", 0)])
    _replay(san, AG)
    _expect_violation(
        lambda: san.begin_collective(RS, TAGS),
        "after the step's planned op order was exhausted")


def test_skipped_events_caught_at_collective_end(san):
    san.begin_collective(AG, TAGS)
    steps = exchange_steps(0, 3, AG, TAGS)
    san.observe(*_role_meta(steps[0]))       # perform only the first
    _expect_violation(san.end_collective, "never performed")


def test_extra_event_past_sequence_end(san):
    _replay(san, AG)
    _expect_violation(
        lambda: san.observe("send_payload",
                            {"phase": AG, "step": 0, "src": 0, **TAGS}),
        "unexpected")


def test_step_end_with_unrun_collectives(san):
    san.begin_step([("allgather", 0), ("reduce_scatter", 0)])
    _replay(san, AG)
    _expect_violation(lambda: san.end_step([]), "never run")


def test_step_end_with_parked_message(san):
    san.begin_step([("allgather", 0)])
    _replay(san, AG)
    leaked = _Chan(pending=[("ring", {"round": 9}, object())])
    _expect_violation(lambda: san.end_step([_Chan(), leaked]),
                      "leaked prefetch")


def test_begin_step_with_previous_plan_unexecuted(san):
    san.begin_step([("allgather", 0)])
    _expect_violation(lambda: san.begin_step([("allgather", 0)]),
                      "previous step still unexecuted")


def test_watchdog_names_the_wait_for_edge():
    s = CommSanitizer(1, 2, stall_after=0.3)
    try:
        s.begin_step([("allgather", 0)])     # starts the watchdog
        s.begin_collective(AG, TAGS)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            with s.waiting("'ring' from rank 0"):
                time.sleep(1.2)
        stalls = [w for w in got if "watchdog" in str(w.message)]
        assert stalls, [str(w.message) for w in got]
        msg = str(stalls[0].message)
        assert "rank 1" in msg and "'ring' from rank 0" in msg
    finally:
        s.close()


def test_waiting_guard_null_when_off():
    with waiting_guard(None, "anything"):
        pass


def test_resolve_sanitize(monkeypatch):
    monkeypatch.delenv("CEPHALO_COMM_SANITIZE", raising=False)
    assert resolve_sanitize() is False
    assert resolve_sanitize(True) is True
    for raw, want in (("1", True), ("true", True), ("YES", True),
                      ("on", True), ("0", False), ("false", False),
                      ("off", False), ("", False)):
        monkeypatch.setenv("CEPHALO_COMM_SANITIZE", raw)
        assert resolve_sanitize() is want, raw
        assert resolve_sanitize(False) is False     # arg wins
    monkeypatch.setenv("CEPHALO_COMM_SANITIZE", "maybe")
    with pytest.raises(ValueError):
        resolve_sanitize()


# --- the runtime comm sanitizer: live ring fleets ----------------------------

def _ring_fleet(cfg, seq, **knobs):
    plan = _plan([("A", 2, 2, 0.6), ("B", 1, 1, 0.4)], batch=5)
    return build_train_step(cfg, plan, substrate="multiproc", device="cpu",
                            topology="ring", schedule="per_microbatch",
                            ring_timeout=10.0, adam=AdamConfig(lr=1e-3),
                            seq_len=seq, **knobs)


@pytest.mark.parametrize("mode", ["reuse_tag", "skip_ack"])
def test_live_protocol_mutation_caught_at_offending_rank(mode):
    """m = 2/1 under per_microbatch: several rounds a step, so a round
    stamped as round 0 diverges.  The sanitized clean step first gives
    an unsanitized fleet's loss, bit for bit (the sanitizer only
    observes)."""
    cfg = get_arch("tiny-llama").reduced()
    seq = 16
    stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=4))
    with _ring_fleet(cfg, seq, sanitize=True) as eng:
        s = eng.init_state(torch.Generator().manual_seed(0))
        s, clean = eng.step(s, stream.sample(0, 5))
        eng.inject_protocol_mutation(0, mode)
        with pytest.raises(RuntimeError) as ei:
            eng.step(s, stream.sample(1, 5))
        msg = str(ei.value)
        assert "comm sanitizer" in msg and "rank 0" in msg, msg
    if mode == "reuse_tag":
        with _ring_fleet(cfg, seq, sanitize=False) as eng:
            s = eng.init_state(torch.Generator().manual_seed(0))
            _, plain = eng.step(s, stream.sample(0, 5))
        assert clean == plain and np.isfinite(clean)
