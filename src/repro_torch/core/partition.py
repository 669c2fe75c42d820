"""Plan datatypes and the Eq. 1 gradient-equivalence math.

A copy of ``repro.core.partition`` (which imports no JAX): the port keeps
its own, so that it imports nothing of the JAX package.

A :class:`Plan` is the planner's output: for every rank, the microbatch size
``m_i``, microbatch count ``ell_i`` (so ``b_i = m_i * ell_i``), and the
training-state ratio ``r_i``.  It also carries the padding geometry needed to
express Cephalo's *uneven* batches as SPMD-legal *uniform* shapes:

* every rank materializes an ``(ell_pad, m_pad, seq)`` microbatch grid;
* rank *i* fills the first ``ell_i`` microbatches' first ``m_i`` rows with
  real samples and zero-pads the rest;
* per-example weights make the summed gradient equal ``(1/B) Σ_ij ∇_ij``
  exactly (paper Eq. 1) — padding rows get weight 0.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RankPlan:
    """Per-rank slice of a plan."""

    rank: int
    device: str
    m: int                    # microbatch size (0 = rank idles)
    ell: int                  # number of microbatches
    state_ratio: float        # r_i, fraction of the training state stored here
    state_bytes: int = 0
    compute_mem_bytes: int = 0
    mem_cap_bytes: int = 0
    t_fwd_s: float = 0.0
    t_bwd_s: float = 0.0

    @property
    def b(self) -> int:
        return self.m * self.ell

    @property
    def mem_used_bytes(self) -> int:
        return self.state_bytes + self.compute_mem_bytes

    @property
    def mem_utilization(self) -> float:
        return self.mem_used_bytes / max(self.mem_cap_bytes, 1)


@dataclasses.dataclass
class Plan:
    """Full training configuration for one (model, cluster, B) triple."""

    model: str
    cluster: str
    global_batch: int
    ranks: List[RankPlan]
    predicted_layer_s: float = 0.0      # Tf + Tb for the bottleneck rank
    predicted_iter_s: float = 0.0       # whole-model iteration latency
    predicted_throughput: float = 0.0   # samples / second
    feasible: bool = True
    infeasible_reason: str = ""

    # --- geometry -----------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.ranks)

    @property
    def m_pad(self) -> int:
        return max((r.m for r in self.ranks), default=0)

    @property
    def ell_pad(self) -> int:
        return max((r.ell for r in self.ranks), default=0)

    @property
    def padded_batch(self) -> int:
        """Total examples materialized after padding (≥ global_batch)."""
        return self.n * self.m_pad * self.ell_pad

    @property
    def padding_waste(self) -> float:
        pb = self.padded_batch
        return 0.0 if pb == 0 else 1.0 - self.global_batch / pb

    def check(self) -> None:
        """Invariants: Σ b_i = B, Σ r_i = 1, no rank over its cap."""
        total_b = sum(r.b for r in self.ranks)
        if self.feasible and total_b != self.global_batch:
            raise ValueError(
                f"plan batch mismatch: Σb_i={total_b} != B={self.global_batch}")
        total_r = sum(r.state_ratio for r in self.ranks)
        if self.feasible and abs(total_r - 1.0) > 1e-6:
            raise ValueError(f"plan state ratios sum to {total_r}, want 1.0")
        for r in self.ranks:
            if self.feasible and r.mem_cap_bytes and \
                    r.mem_used_bytes > r.mem_cap_bytes:
                raise ValueError(
                    f"rank {r.rank} ({r.device}) over memory cap: "
                    f"{r.mem_used_bytes} > {r.mem_cap_bytes}")

    # --- Eq. 1 weights --------------------------------------------------------
    def example_weights(self) -> np.ndarray:
        """``(n, ell_pad, m_pad)`` float32 weights.

        With per-example loss ``L_ij`` the training objective is
        ``Σ_ij w_ij · L_ij`` followed by a *sum* (not mean) all-reduce across
        ranks.  Setting ``w_ij = 1/B`` on real rows and 0 on padding rows
        gives exactly Eq. 1's ``∇ = (1/B) Σ_ij ∇_ij``.
        """
        w = np.zeros((self.n, self.ell_pad, self.m_pad), dtype=np.float32)
        for i, r in enumerate(self.ranks):
            if r.m > 0:
                w[i, : r.ell, : r.m] = 1.0 / self.global_batch
        return w

    def sample_counts(self) -> np.ndarray:
        return np.asarray([r.b for r in self.ranks], dtype=np.int32)

    def state_ratios(self) -> np.ndarray:
        return np.asarray([r.state_ratio for r in self.ranks], dtype=np.float64)

    # --- (de)serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "model": self.model,
            "cluster": self.cluster,
            "global_batch": self.global_batch,
            "predicted_layer_s": self.predicted_layer_s,
            "predicted_iter_s": self.predicted_iter_s,
            "predicted_throughput": self.predicted_throughput,
            "feasible": self.feasible,
            "infeasible_reason": self.infeasible_reason,
            "ranks": [dataclasses.asdict(r) for r in self.ranks],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        d = json.loads(text)
        ranks = [RankPlan(**r) for r in d.pop("ranks")]
        return cls(ranks=ranks, **d)

    def summary(self) -> str:
        lines = [
            f"Plan[{self.model} @ {self.cluster}] B={self.global_batch} "
            f"feasible={self.feasible} "
            f"T_layer={self.predicted_layer_s*1e3:.2f}ms "
            f"throughput={self.predicted_throughput:.2f} samples/s "
            f"pad_waste={self.padding_waste:.1%}",
        ]
        for r in self.ranks:
            lines.append(
                f"  rank{r.rank:>3} {r.device:<8} b={r.b:<4} m={r.m:<3} "
                f"l={r.ell:<3} r_i={r.state_ratio:.3f} "
                f"mem={r.mem_used_bytes/(1<<30):.1f}/"
                f"{r.mem_cap_bytes/(1<<30):.1f} GiB "
                f"({r.mem_utilization:.0%})")
        return "\n".join(lines)


def even_shard_sizes(total: int, ratios: Sequence[float],
                     quantum: int = 128) -> List[int]:
    """Split ``total`` elements into per-rank shard sizes ∝ ``ratios``,
    rounded to ``quantum`` elements (for aligned collectives); remainders go
    to the largest-ratio rank.  Sizes sum exactly to ``total``."""
    n = len(ratios)
    raw = np.asarray(ratios, dtype=np.float64)
    if raw.sum() <= 0:
        raw = np.ones(n)
    raw = raw / raw.sum()
    sizes = [int(round(x * total / quantum)) * quantum for x in raw]
    diff = total - sum(sizes)
    order = np.argsort(-raw)
    i = 0
    # Fix rounding drift in |quantum| steps, never letting a size go negative.
    while diff != 0:
        step = int(math.copysign(min(abs(diff), quantum), diff))
        j = int(order[i % n])
        if sizes[j] + step >= 0:
            sizes[j] += step
            diff -= step
        i += 1
    return sizes
