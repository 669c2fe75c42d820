"""Data pipeline: deterministic synthetic token streams with Cephalo's
uneven per-rank batch geometry.

A copy of ``repro.data.pipeline`` (numpy only) but for its ``iterate``
generator, which no caller in the port needs: seeded by numpy, so the
same seed gives the same token blocks and stub frontend embeddings as the
JAX package.

The pipeline produces, per iteration, the padded SPMD batch layout
``(n_ranks, ell_pad, m_pad, seq)`` plus per-token weights implementing the
Eq. 1 normalization (1/B on real tokens, 0 on padding — see
:meth:`repro_torch.core.partition.Plan.example_weights`), and next-token
labels.

Synthetic text is a mixture of short Markov "phrases" so the loss curve is
non-trivial (a learnable bigram structure), deterministic in (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.partition import Plan


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    seed: int = 0
    frontend_dim: int = 0      # >0 → also emit stub frontend embeddings


class SyntheticStream:
    """Deterministic bigram-structured token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse bigram transition table: each token has 8 likely successors
        self._succ = rng.integers(0, v, size=(v, 8), dtype=np.int32)

    def sample(self, step: int, n: int) -> np.ndarray:
        """(n, seq+1) tokens, deterministic in (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        out = np.empty((n, cfg.seq_len + 1), dtype=np.int32)
        tok = rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
        out[:, 0] = tok
        for t in range(1, cfg.seq_len + 1):
            choice = rng.integers(0, 8, size=n)
            noise = rng.random(n) < 0.1
            nxt = self._succ[tok, choice]
            rand_tok = rng.integers(0, cfg.vocab_size, size=n,
                                    dtype=np.int32)
            tok = np.where(noise, rand_tok, nxt).astype(np.int32)
            out[:, t] = tok
        return out


def make_homogeneous_batch(stream: SyntheticStream, step: int, batch: int,
                           ) -> Dict[str, np.ndarray]:
    """Plain (B, S) batch for the single-host examples/tests."""
    seq = stream.cfg.seq_len
    toks = stream.sample(step, batch)
    w = np.full((batch, seq), 1.0 / (batch * seq), np.float32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "weights": w}
    if stream.cfg.frontend_dim:
        rng = np.random.default_rng((stream.cfg.seed, step, 7))
        out["frontend_embed"] = rng.standard_normal(
            (batch, seq, stream.cfg.frontend_dim)).astype(np.float32)
    return out


def plan_grid_from_block(plan: Plan, big: np.ndarray
                         ) -> Dict[str, np.ndarray]:
    """Lay a (B, seq+1) token block out on the plan's padded SPMD grid.

    Returns tokens/labels (n, ell_pad, m_pad, seq) and weights
    (n, ell_pad, m_pad, seq) with Eq. 1 scaling: real tokens get
    ``1/(B·seq)``; padding gets 0.  Rank *i*'s real rows are the first
    ``ell_i`` microbatches × first ``m_i`` rows.  The same block fed to
    the MPMD runtime (``HeteroTrainer.rank_batches``) yields identical
    gradients — the engine parity property (tests/test_engine.py).
    """
    seq = big.shape[1] - 1
    n, lp, mp = plan.n, max(plan.ell_pad, 1), max(plan.m_pad, 1)
    tokens = np.zeros((n, lp, mp, seq), np.int32)
    labels = np.zeros((n, lp, mp, seq), np.int32)
    weights = np.zeros((n, lp, mp, seq), np.float32)
    cursor = 0
    w_val = 1.0 / (plan.global_batch * seq)
    for i, r in enumerate(plan.ranks):
        for l in range(r.ell):
            rows = big[cursor: cursor + r.m]
            cursor += r.m
            tokens[i, l, : r.m] = rows[:, :-1]
            labels[i, l, : r.m] = rows[:, 1:]
            weights[i, l, : r.m] = w_val
    assert cursor == plan.global_batch
    return {"tokens": tokens, "labels": labels, "weights": weights}


def make_plan_batch(stream: SyntheticStream, step: int, plan: Plan,
                    ) -> Dict[str, np.ndarray]:
    """Padded SPMD batch per the plan geometry (see
    :func:`plan_grid_from_block` for the layout contract)."""
    return plan_grid_from_block(plan, stream.sample(step,
                                                    plan.global_batch))


def iterate(stream: SyntheticStream, plan: Optional[Plan] = None,
            batch: Optional[int] = None, start_step: int = 0,
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches from ``start_step`` on: the plan's padded grid
    (:func:`make_plan_batch`) where a ``plan`` is given, else a
    homogeneous batch of ``batch`` rows."""
    step = start_step
    while True:
        if plan is not None:
            yield make_plan_batch(stream, step, plan)
        else:
            yield make_homogeneous_batch(stream, step, batch)
        step += 1
