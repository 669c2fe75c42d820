"""Cephalo's optimizer (paper Sec. 2.4, Alg. 1).

A copy of ``repro.core.planner`` (numpy only): the port keeps its own,
so that it imports nothing of the JAX package.  Its plans are
``repro_torch.core.partition.Plan`` objects.

Dynamic program over ``D[i][j][k]`` — the minimum achievable per-layer
latency when the first ``i`` ranks process a total batch of ``j`` with total
microbatch footprint ``k = Σ m_i`` — followed by backtracking and the greedy
training-state partition.

The inner recurrence is vectorized with numpy: for each candidate
``(m, ell)`` pair on rank ``i`` the transition is a shifted element-wise
``min(max(D_prev, T), ·)`` over the whole ``(j, k)`` plane.

Two entry points:

* :func:`solve` — exact DP, used for paper-scale problems (N ≤ 16, B ≤ 512);
* :func:`solve_scaled` — same DP on a quantized batch grid for large
  clusters (the paper's O(N·B³logB) is equally impractical at B=1024
  without coarsening; they report 327 s with engineering we reproduce via
  quantization).

Baselines used by the ablation benchmarks (Fig. 7):
:func:`plan_even` (vanilla FSDP), :func:`plan_compute_only` (Cephalo-CB),
:func:`plan_memory_only` (Cephalo-MB).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import ClusterCostModel
from repro_torch.core.partition import Plan, RankPlan


# ---------------------------------------------------------------------------
# Per-rank candidate enumeration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Cand:
    m: int
    ell: int
    t_layer: float   # max(Tf, AG') + max(Tb, AG'+RS')  (Alg. 1)
    t_fwd: float
    t_bwd: float


def _layer_time(cm: ClusterCostModel, rank: int, m: int, ell: int,
                uneven: bool) -> Tuple[float, float, float]:
    dc = cm.per_rank[rank]
    tf = dc.t_fwd(m, ell)
    tb = dc.t_bwd(m, ell)
    ag = cm.ag_latency(uneven)
    rs = cm.rs_latency(uneven)
    return max(tf, ag) + max(tb, ag + rs), tf, tb


def _candidates(cm: ClusterCostModel, rank: int, batch: int,
                m_values: Sequence[int],
                b_quantum: int = 1) -> List[_Cand]:
    """All memory-feasible (m, ell) pairs for one rank.

    ``b_quantum`` restricts total per-rank batches to multiples of the
    quantum (the scaled solver's coarsening).
    """
    dc = cm.per_rank[rank]
    cap = dc.mem_cap()
    even_state = cm.even_state_bytes_per_rank()
    out: List[_Cand] = []
    for m in m_values:
        if m <= 0 or m > batch:
            continue
        if dc.memory(m) > cap:
            continue   # constraint (II)
        # Uneven collectives are needed if this rank cannot hold an even
        # state share on top of its compute memory (Alg. 1).
        uneven = dc.memory(m) + even_state > cap
        for ell in range(1, batch // m + 1):
            if (m * ell) % b_quantum != 0:
                continue
            t, tf, tb = _layer_time(cm, rank, m, ell, uneven)
            out.append(_Cand(m, ell, t, tf, tb))
    return out


# ---------------------------------------------------------------------------
# The DP
# ---------------------------------------------------------------------------

_INF = np.float64(np.inf)


def _run_dp(cm: ClusterCostModel, batch: int,
            m_values: Sequence[int], k_cap: int,
            b_quantum: int = 1,
            ) -> Tuple[np.ndarray, List[List[_Cand]], List[np.ndarray]]:
    """Returns final D plane, per-rank candidates, and per-rank choice
    tables for backtracking.

    Choice table ``C_i[j, k]`` stores the index (into the rank's candidate
    list, or -1 for "rank idles") chosen at rank ``i`` for state ``(j, k)``.
    """
    n = cm.cluster.n
    J = batch + 1
    K = k_cap + 1
    D = np.full((J, K), _INF)
    D[0, 0] = 0.0
    cands_per_rank: List[List[_Cand]] = []
    choices: List[np.ndarray] = []
    for i in range(n):
        cands = _candidates(cm, i, batch, m_values, b_quantum)
        cands_per_rank.append(cands)
        D_new = D.copy()                       # option: rank i idles (b_i = 0)
        choice = np.full((J, K), -1, dtype=np.int32)
        for ci, c in enumerate(cands):
            db, dk = c.m * c.ell, c.m
            if db >= J or dk >= K:
                continue
            # transition: D_new[j, k] <- max(D[j-db, k-dk], T_c)
            src = D[: J - db, : K - dk]
            cand = np.maximum(src, c.t_layer)
            dst = D_new[db:, dk:]
            better = cand < dst
            dst[better] = cand[better]
            choice[db:, dk:][better] = ci
        D = D_new
        choices.append(choice)
    return D, cands_per_rank, choices


def _backtrack(j: int, k: int, cands_per_rank: List[List[_Cand]],
               choices: List[np.ndarray]) -> Optional[List[Optional[_Cand]]]:
    n = len(choices)
    picks: List[Optional[_Cand]] = [None] * n
    for i in range(n - 1, -1, -1):
        ci = int(choices[i][j, k])
        if ci >= 0:
            c = cands_per_rank[i][ci]
            picks[i] = c
            j -= c.m * c.ell
            k -= c.m
    if j != 0 or k != 0:
        return None
    return picks


# ---------------------------------------------------------------------------
# Greedy training-state partition (paper Sec. 2.4, "Training State Partition")
# ---------------------------------------------------------------------------

def partition_state(cm: ClusterCostModel,
                    compute_mem: Sequence[float],
                    quanta: int = 1024) -> Optional[np.ndarray]:
    """Greedy: hand the next state quantum to the rank with the lowest
    *memory utilization fraction*; returns per-rank state bytes, or None if
    some quantum fits nowhere (infeasible)."""
    n = cm.cluster.n
    state_total = float(cm.model.state_bytes())
    q = state_total / quanta
    caps = np.asarray([dc.mem_cap() for dc in cm.per_rank])
    used = np.asarray(compute_mem, dtype=np.float64).copy()
    assigned = np.zeros(n)
    for _ in range(quanta):
        util = np.where(caps > 0, (used + q) / caps, np.inf)
        order = np.argsort(util)
        placed = False
        for i in order:
            if used[i] + q <= caps[i]:
                used[i] += q
                assigned[i] += q
                placed = True
                break
        if not placed:
            return None
    return assigned


# ---------------------------------------------------------------------------
# Plan assembly
# ---------------------------------------------------------------------------

def _assemble(cm: ClusterCostModel, batch: int,
              picks: List[Optional[_Cand]],
              t_layer: float) -> Optional[Plan]:
    n = cm.cluster.n
    compute_mem = [cm.per_rank[i].memory(picks[i].m if picks[i] else 0)
                   for i in range(n)]
    state = partition_state(cm, compute_mem)
    if state is None:
        return None
    state_total = float(cm.model.state_bytes())
    ranks = []
    for i in range(n):
        c = picks[i]
        ranks.append(RankPlan(
            rank=i,
            device=cm.cluster.devices[i].name,
            m=c.m if c else 0,
            ell=c.ell if c else 0,
            state_ratio=float(state[i] / state_total),
            state_bytes=int(state[i]),
            compute_mem_bytes=int(compute_mem[i]),
            mem_cap_bytes=int(cm.per_rank[i].mem_cap()),
            t_fwd_s=c.t_fwd if c else 0.0,
            t_bwd_s=c.t_bwd if c else 0.0,
        ))
    head_s = max((cm.per_rank[i].head_time(picks[i].m, picks[i].ell)
                  for i in range(n) if picks[i]), default=0.0)
    iter_s = t_layer * cm.model.n_layers + head_s
    plan = Plan(
        model=cm.model.name,
        cluster=cm.cluster.name,
        global_batch=batch,
        ranks=ranks,
        predicted_layer_s=t_layer,
        predicted_iter_s=iter_s,
        predicted_throughput=batch / iter_s if iter_s > 0 else 0.0,
    )
    plan.check()
    return plan


def _infeasible(cm: ClusterCostModel, batch: int, reason: str) -> Plan:
    return Plan(model=cm.model.name, cluster=cm.cluster.name,
                global_batch=batch, ranks=[], feasible=False,
                infeasible_reason=reason)


# ---------------------------------------------------------------------------
# Public solvers
# ---------------------------------------------------------------------------

def solve(cm: ClusterCostModel, batch: int,
          m_values: Optional[Sequence[int]] = None,
          k_cap: Optional[int] = None) -> Plan:
    """Exact DP (Alg. 1).  Suitable for N ≤ ~16, B ≤ ~512."""
    if m_values is None:
        m_values = list(range(1, min(batch, 64) + 1))
    if k_cap is None:
        k_cap = min(batch, cm.cluster.n * max(m_values))
    D, cands, choices = _run_dp(cm, batch, m_values, k_cap)
    # min over k of D[B][k], trying k's best-first so the first feasible
    # state partition wins (constraint III enforced by partition_state).
    col = D[batch, :]
    for k in np.argsort(col):
        if not np.isfinite(col[k]):
            break
        picks = _backtrack(batch, int(k), cands, choices)
        if picks is None:
            continue
        plan = _assemble(cm, batch, picks, float(col[k]))
        if plan is not None:
            return plan
    return _infeasible(cm, batch, "no feasible (batch, state) assignment")


_LOG_MS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64]


def solve_scaled(cm: ClusterCostModel, batch: int,
                 grid: int = 128) -> Plan:
    """Quantized DP for large (N, B): batch allocations restricted to
    multiples of ``B/grid`` and log-spaced microbatch sizes."""
    q = max(1, batch // grid)
    if q == 1:
        return solve(cm, batch, m_values=_LOG_MS,
                     k_cap=min(batch, cm.cluster.n * 64))
    m_values = [m for m in _LOG_MS if m <= batch]
    k_cap = min(batch, cm.cluster.n * max(m_values))
    # Quantize the k axis too: account each m as ceil(m/qk) units.
    D, cands, choices = _run_dp(cm, batch, m_values, k_cap, b_quantum=q)
    col = D[batch, :]
    for k in np.argsort(col):
        if not np.isfinite(col[k]):
            break
        picks = _backtrack(batch, int(k), cands, choices)
        if picks is None:
            continue
        plan = _assemble(cm, batch, picks, float(col[k]))
        if plan is not None:
            return plan
    return _infeasible(cm, batch, "no feasible (batch, state) assignment")


def auto_solve(cm: ClusterCostModel, batch: int) -> Plan:
    """Pick the exact solver when tractable, the quantized one otherwise."""
    work = cm.cluster.n * (batch ** 2)
    if work <= 16 * 512 ** 2:
        return solve(cm, batch)
    return solve_scaled(cm, batch)


def evaluate_plan(cm: ClusterCostModel, plan: Plan) -> dict:
    """Predicted timings of a FIXED plan under a (possibly different)
    cost model — the elastic runtime's "what is the old plan worth on
    the cluster as observed now" query.  ``plan.ranks`` must correspond
    1:1 to ``cm.per_rank``.

    Returns ``{"layer_s", "iter_s", "throughput"}`` computed with the
    same Alg. 1 per-layer time as the solver (max(Tf, AG') +
    max(Tb, AG'+RS')), including the solver's per-rank uneven-collective
    criterion (a rank pays the overhead iff it cannot hold an even state
    share on top of its compute memory), so a re-solved plan's
    ``predicted_*`` fields and this function agree by construction.
    """
    if len(plan.ranks) != cm.cluster.n:
        raise ValueError(
            f"plan has {len(plan.ranks)} ranks, cost model "
            f"{cm.cluster.n} — evaluate_plan needs a 1:1 correspondence")
    even_state = cm.even_state_bytes_per_rank()
    worst = 0.0
    head_s = 0.0
    for i, r in enumerate(plan.ranks):
        if r.b == 0:
            continue
        dc = cm.per_rank[i]
        uneven = dc.memory(r.m) + even_state > dc.mem_cap()
        t, _, _ = _layer_time(cm, i, r.m, r.ell, uneven)
        worst = max(worst, t)
        head_s = max(head_s, dc.head_time(r.m, r.ell))
    iter_s = worst * cm.model.n_layers + head_s
    return {"layer_s": worst, "iter_s": iter_s,
            "throughput": plan.global_batch / iter_s if iter_s else 0.0}


# ---------------------------------------------------------------------------
# Ablation baselines (Fig. 7) and classic FSDP
# ---------------------------------------------------------------------------

def _fixed_assignment(cm: ClusterCostModel, batch: int,
                      bs: Sequence[int], ms: Sequence[int],
                      even_state: bool) -> Plan:
    """Build a plan from externally chosen per-rank batches/microbatches."""
    n = cm.cluster.n
    picks: List[Optional[_Cand]] = []
    worst = 0.0
    for i in range(n):
        b, m = int(bs[i]), int(ms[i])
        if b == 0 or m == 0:
            picks.append(None)
            continue
        ell = max(1, b // m)
        m = b // ell
        uneven = not even_state
        t, tf, tb = _layer_time(cm, i, m, ell, uneven)
        picks.append(_Cand(m, ell, t, tf, tb))
        worst = max(worst, t)
    # memory feasibility (constraint II)
    for i in range(n):
        c = picks[i]
        if c and cm.per_rank[i].memory(c.m) > cm.per_rank[i].mem_cap():
            return _infeasible(
                cm, batch, f"rank {i} OOM: compute memory for m={c.m} "
                f"exceeds cap")
    compute_mem = [cm.per_rank[i].memory(picks[i].m if picks[i] else 0)
                   for i in range(n)]
    if even_state:
        # Vanilla FSDP: every rank must hold an even share.
        share = cm.even_state_bytes_per_rank()
        for i in range(n):
            if compute_mem[i] + share > cm.per_rank[i].mem_cap():
                return _infeasible(
                    cm, batch,
                    f"rank {i} OOM: even state share does not fit")
        state_total = float(cm.model.state_bytes())
        ranks = []
        for i in range(n):
            c = picks[i]
            ranks.append(RankPlan(
                rank=i, device=cm.cluster.devices[i].name,
                m=c.m if c else 0, ell=c.ell if c else 0,
                state_ratio=1.0 / n, state_bytes=int(share),
                compute_mem_bytes=int(compute_mem[i]),
                mem_cap_bytes=int(cm.per_rank[i].mem_cap()),
                t_fwd_s=c.t_fwd if c else 0.0, t_bwd_s=c.t_bwd if c else 0.0))
        head_s = max((cm.per_rank[i].head_time(picks[i].m, picks[i].ell)
                      for i in range(n) if picks[i]), default=0.0)
        iter_s = worst * cm.model.n_layers + head_s
        plan = Plan(model=cm.model.name, cluster=cm.cluster.name,
                    global_batch=batch, ranks=ranks,
                    predicted_layer_s=worst, predicted_iter_s=iter_s,
                    predicted_throughput=batch / iter_s if iter_s else 0.0)
        plan.check()
        return plan
    plan = _assemble(cm, batch, picks, worst)
    if plan is None:
        return _infeasible(cm, batch, "greedy state partition infeasible")
    return plan


def _split_proportional(batch: int, weights: Sequence[float]) -> List[int]:
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    bs = np.floor(w * batch).astype(int)
    rem = batch - int(bs.sum())
    order = np.argsort(-(w * batch - bs))
    for i in range(rem):
        bs[order[i % len(bs)]] += 1
    return [int(x) for x in bs]


def plan_even(cm: ClusterCostModel, batch: int,
              microbatch: Optional[int] = None) -> Plan:
    """Vanilla FSDP: even batch, even state, no gradient accumulation
    unless ``microbatch`` is given."""
    n = cm.cluster.n
    b = batch // n
    if b * n != batch:
        b = max(1, b)
    bs = [b] * n
    bs[0] += batch - b * n
    ms = [microbatch or b] * n
    return _fixed_assignment(cm, batch, bs, ms, even_state=True)


def plan_compute_only(cm: ClusterCostModel, batch: int) -> Plan:
    """Cephalo-CB: batch ∝ device speed, even state, no grad accumulation."""
    speeds = [d.peak_flops for d in cm.cluster.devices]
    bs = _split_proportional(batch, speeds)
    return _fixed_assignment(cm, batch, bs, bs, even_state=True)


def plan_memory_only(cm: ClusterCostModel, batch: int) -> Plan:
    """Cephalo-MB: even batch, microbatch size 1, uneven (greedy) state."""
    n = cm.cluster.n
    bs = _split_proportional(batch, [1.0] * n)
    ms = [1] * n
    return _fixed_assignment(cm, batch, bs, ms, even_state=False)


def plan_whale(cm: ClusterCostModel, batch: int) -> Plan:
    """Whale-style: batch ∝ speed, but *replicated* training state (pure
    data parallelism — every rank stores the full state)."""
    speeds = [d.peak_flops for d in cm.cluster.devices]
    bs = _split_proportional(batch, speeds)
    n = cm.cluster.n
    state_total = float(cm.model.state_bytes())
    ranks = []
    worst = 0.0
    for i in range(n):
        b = bs[i]
        m = b
        t, tf, tb = _layer_time(cm, i, m, 1, uneven=False)
        comp = cm.per_rank[i].memory(m)
        cap = cm.per_rank[i].mem_cap()
        if comp + state_total > cap:
            return _infeasible(
                cm, batch,
                f"rank {i} OOM: replicated state ({state_total/(1<<30):.1f} "
                f"GiB) + compute does not fit")
        worst = max(worst, t)
        ranks.append(RankPlan(
            rank=i, device=cm.cluster.devices[i].name, m=m, ell=1,
            state_ratio=1.0 / n, state_bytes=int(state_total),
            compute_mem_bytes=int(comp), mem_cap_bytes=int(cap),
            t_fwd_s=tf, t_bwd_s=tb))
    head_s = max((cm.per_rank[i].head_time(bs[i], 1)
                  for i in range(n) if bs[i]), default=0.0)
    iter_s = worst * cm.model.n_layers + head_s
    return Plan(model=cm.model.name, cluster=cm.cluster.name,
                global_batch=batch, ranks=ranks, predicted_layer_s=worst,
                predicted_iter_s=iter_s,
                predicted_throughput=batch / iter_s if iter_s else 0.0,
                feasible=True)
