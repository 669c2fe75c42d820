"""Ragged ring collectives — the algorithm, separated from the wire.

The port's copy of ``repro.core.engine.ring`` (numpy only).

The hub topology funnels every AllGatherv / ReduceScatterv
payload through the coordinator, so per-round traffic at the hub grows
as O(N · total_bytes) — the centralized bottleneck bandwidth-optimal
ring algorithms exist to avoid.  This module is the *pure* half of the
ring data plane: chunk scheduling and reduction ordering with no
processes, pipes, or shared memory in sight.  The worker runtime
(:mod:`repro_torch.core.engine.multiproc`) drives these generators over real
channels; the tests drive all N of them in lockstep with
:func:`simulate` — one copy of the algorithm, exercised both ways
(``tests/test_torch_multiproc.py`` holds this copy, the port's, against
the JAX package's).

Cephalo's decoupled compute/state assignment (paper Sec. 2 / App. C)
makes both collectives *ragged*: per-rank shard sizes differ (including
zero-size shards), so the classic fixed-chunk ring is generalized to
per-rank ragged chunks keyed by unit name.

Step rule (both collectives, ``s = 0 .. n-2``): at step ``s`` rank
``r`` sends the payload that originated at rank ``(r - s) mod n`` to
its successor ``(r + 1) mod n`` and receives the payload originating at
``(r - 1 - s) mod n`` from its predecessor — each payload walks the
ring once, one hop per step.

* **AllGatherv** — the payload is the origin's ragged state chunk,
  forwarded verbatim; after ``n - 1`` steps every rank holds every
  chunk and concatenates them in rank order (bitwise-identical to the
  hub's coordinator-side concat).
* **ReduceScatterv** — the payload is the origin's per-*destination*
  gradient chunks; each visited rank extracts the chunk addressed to
  itself and forwards the rest (payloads shrink hop by hop).  Reduction
  is **accumulate-then-combine**: destinations collect every origin's
  raw chunk, then sum them in fixed rank order ``0..n-1``
  (:func:`combine_fixed_order`).  A pipelined partial-sum ring would
  accumulate in ring order — a *different* float order per destination,
  breaking the bitwise parity contract the hub and loopback substrates
  share; accumulate-then-combine trades a small memory overhead for
  exact cross-topology reproducibility.
"""

from __future__ import annotations

from typing import Dict, Generator, List, Optional, Sequence

import numpy as np

#: wire-key separator between destination rank and unit name in
#: reduce-scatter payloads ("<dest>|<unit>").
DEST_SEP = "|"

Chunks = Dict[str, np.ndarray]


def ring_neighbors(n: int, rank: int) -> tuple:
    """(predecessor, successor) of ``rank`` on the n-ring."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} out of range for ring of {n}")
    return ((rank - 1) % n, (rank + 1) % n)


def origin_sent(n: int, rank: int, step: int) -> int:
    """Origin rank of the payload ``rank`` forwards at ``step``."""
    return (rank - step) % n


def origin_received(n: int, rank: int, step: int) -> int:
    """Origin rank of the payload ``rank`` receives at ``step``."""
    return (rank - 1 - step) % n


# ---------------------------------------------------------------------------
# Generators: yield the payload to send, receive the peer's via .send()
# ---------------------------------------------------------------------------

def allgatherv(rank: int, n: int, own: Chunks
               ) -> Generator[Chunks, Chunks, List[Optional[Chunks]]]:
    """Ragged ring AllGatherv from ``rank``'s perspective.

    Yields the payload to hand to the successor at each of the ``n-1``
    steps; the caller sends back the payload received from the
    predecessor.  Returns the per-origin chunk list (``got[r]`` is rank
    ``r``'s contribution) — concatenating in list order reproduces the
    hub's rank-order concat bitwise.
    """
    got: List[Optional[Chunks]] = [None] * n
    got[rank] = dict(own)
    payload = got[rank]
    for s in range(n - 1):
        received = yield payload
        got[origin_received(n, rank, s)] = dict(received)
        payload = received
    return got


def reduce_scatterv(rank: int, n: int,
                    dest_chunks: Optional[Sequence[Chunks]]
                    ) -> Generator[Chunks, Chunks, List[Optional[Chunks]]]:
    """Ragged ring ReduceScatterv (accumulate half) from ``rank``.

    ``dest_chunks[d]`` is this rank's gradient contribution addressed to
    rank ``d`` (``None`` when this rank computed no gradients this
    round — it still forwards for everyone else).  Payload wire keys are
    ``"<dest>|<unit>"``; each hop pops the chunks addressed to itself
    and forwards the remainder, so payloads shrink as they travel.
    Returns ``collected`` with ``collected[o]`` = origin ``o``'s raw
    chunk for *this* rank (``None`` if ``o`` contributed nothing);
    :func:`combine_fixed_order` turns it into the round sum.
    """
    collected: List[Optional[Chunks]] = [None] * n
    if dest_chunks is not None:
        if len(dest_chunks) != n:
            raise ValueError(
                f"dest_chunks has {len(dest_chunks)} entries for n={n}")
        collected[rank] = dict(dest_chunks[rank])
        payload = {f"{d}{DEST_SEP}{u}": a
                   for d in range(n) if d != rank
                   for u, a in dest_chunks[d].items()}
    else:
        payload = {}
    for s in range(n - 1):
        received = yield payload
        origin = origin_received(n, rank, s)
        mine: Chunks = {}
        remainder: Chunks = {}
        for key, arr in received.items():
            dest, unit = key.split(DEST_SEP, 1)
            if int(dest) == rank:
                mine[unit] = arr
            else:
                remainder[key] = arr
        collected[origin] = mine or None
        payload = remainder
    return collected


def combine_fixed_order(collected: Sequence[Optional[Chunks]]
                        ) -> Optional[Chunks]:
    """Sum collected contributions in fixed rank order ``0..n-1``.

    This is the "combine" half of accumulate-then-combine: fp32
    accumulation in exactly the order the hub coordinator (and
    loopback's rank-major tree sum) uses, so the result is bitwise
    identical across topologies.  Contributors may carry different unit
    sets (a rank whose program touched only some units); each unit is
    summed over the ranks that carry it, still in rank order.  Returns
    ``None`` when no rank contributed (a round where every rank
    exhausted its ℓ_i).
    """
    out: Optional[Chunks] = None
    for chunks in collected:
        if chunks is None:
            continue
        if out is None:
            out = {}
        for u, a in chunks.items():
            a32 = np.asarray(a, dtype=np.float32)
            out[u] = out[u] + a32 if u in out \
                else np.array(a32, dtype=np.float32)
    return out


# ---------------------------------------------------------------------------
# Overlapped round pipeline: the fixed global data-plane order
# ---------------------------------------------------------------------------

def overlap_plan(n_rounds: int) -> List[tuple]:
    """Data-plane op order for the overlapped round pipeline.

    Returns ``[("allgather", k) | ("reduce_scatter", k), ...]`` — the
    exact sequence every worker's communication thread executes when
    round-level overlap is on::

        AG0, AG1, RS0, AG2, RS1, ..., AG_{R-1}, RS_{R-2}, RS_{R-1}

    Round ``k+1``'s parameter AllGatherv is *prefetched* while round
    ``k``'s microbatches compute (params are frozen for the whole step —
    Adam runs only at the step barrier — so the prefetch reads the same
    bytes a synchronous gather would), and round ``k``'s gradient
    ReduceScatterv drains under round ``k+1``'s compute.  Because every
    rank follows this one order, the per-channel message sequence is
    identical on all workers and the pipeline cannot deadlock; because
    the *reduction* order (accumulate-then-combine per round, rounds
    accumulated in round order) is untouched, results stay bitwise
    identical to the synchronous ring, the hub, and loopback.

    Invariants (property-tested on the reference's copy in
    ``tests/test_layout_properties.py``):
    every round appears exactly once per phase, ``("allgather", k)``
    precedes ``("reduce_scatter", k)``, reduce-scatters run in round
    order, and the allgather prefetch depth never exceeds one round.
    """
    if n_rounds < 0:
        raise ValueError(f"n_rounds must be >= 0, got {n_rounds}")
    ops: List[tuple] = []
    for k in range(n_rounds):
        if k == 0:
            ops.append(("allgather", 0))
        if k + 1 < n_rounds:
            ops.append(("allgather", k + 1))
        ops.append(("reduce_scatter", k))
    return ops


# ---------------------------------------------------------------------------
# Running the generators
# ---------------------------------------------------------------------------

def drive(gen, exchange):
    """Run one ring generator against a real transport.

    ``exchange(step, payload) -> received`` performs the simultaneous
    send-to-successor / receive-from-predecessor of one ring step (the
    worker implements it over its neighbor channels).  Returns the
    generator's result.
    """
    try:
        payload = next(gen)
    except StopIteration as e:      # n == 1: no steps at all
        return e.value
    step = 0
    while True:
        try:
            payload = gen.send(exchange(step, payload))
        except StopIteration as e:
            return e.value
        step += 1


def simulate(gens: Sequence) -> List:
    """Lockstep in-process scheduler for N ring generators (tests).

    Advances all ranks one synchronized step at a time, wiring rank
    ``r``'s sent payload to rank ``(r+1) mod n``'s receive — the same
    data motion the multiproc workers perform over real channels, with
    zero transport in the way.  Returns each generator's result.
    """
    n = len(gens)
    results: List = [None] * n
    outbox: List = [None] * n
    live = set()
    for r, g in enumerate(gens):
        try:
            outbox[r] = next(g)
            live.add(r)
        except StopIteration as e:
            results[r] = e.value
    while live:
        inbox = [outbox[(r - 1) % n] for r in range(n)]
        for r in sorted(live):
            try:
                outbox[r] = gens[r].send(inbox[r])
            except StopIteration as e:
                results[r] = e.value
                live.discard(r)
    return results
