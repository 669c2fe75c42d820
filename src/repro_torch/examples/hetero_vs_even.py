"""Why decoupling matters: Cephalo vs even-split FSDP on a skewed cluster.

    PYTHONPATH=src python -m repro_torch.examples.hetero_vs_even --device cpu

The port of ``examples/hetero_vs_even.py``: the paper's central claim on
a small scale.  On a cluster where memory capacity does NOT track compute
speed (L4 vs P40 — same memory, 2.6x compute gap), even splitting either
OOMs or idles the fast GPUs; Cephalo's plan gives fast GPUs more batch
and memory-rich GPUs more state.  Then it *trains* both plans on the
MPMD runtime (every rank of a plan on the one device: the card unless
``--device cpu`` is asked for) and shows the losses are the same (Eq. 1)
while the predicted wall-clock differs.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.device_specs import L4, P40, Cluster
from repro_torch.core.hetero_trainer import HeteroTrainer
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.planner import plan_even, solve
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim.adam import AdamConfig

SEQ, BATCH, STEPS = 64, 24, 5


def plans():
    """(config, Cephalo's plan, the even FSDP plan) on the L4/P40
    cluster."""
    cfg = get_arch("tiny-llama").reduced()
    # the paper's Fig. 2 mismatch in miniature: L4 fast / P40 roomy
    cluster = Cluster([L4, L4, P40, P40], link_gbps=50, name="l4-p40")
    cm = analytic_cluster_model(cluster, build_model_stats(cfg, SEQ))
    return cfg, solve(cm, BATCH), plan_even(cm, BATCH)


def train(cfg, plan, device: str, params: Optional[dict] = None
          ) -> List[float]:
    """The losses of STEPS steps of ``plan`` on the MPMD runtime, from
    fp32 ``params`` (a whole tree on ``device``) or, without them, from
    params drawn from a seeded generator."""
    stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=0))
    tr = HeteroTrainer(cfg, plan, AdamConfig(lr=2e-3), seq_len=SEQ,
                       device=device)
    if params is None:
        shards = tr.init_shards(torch.Generator(device).manual_seed(0))
    else:
        shards = tr.substrate.shard_state(params)
        for s in shards:
            s["step"] = 0
    losses = []
    for step in range(STEPS):
        shards, loss = tr.step(shards, stream.sample(step, BATCH))
        losses.append(loss)
    return losses


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cfg, cephalo, even = plans()
    print("=== Cephalo plan ===")
    print(cephalo.summary())
    print("\n=== even FSDP plan ===")
    print(even.summary() if even.feasible else
          f"infeasible: {even.infeasible_reason}")
    if even.feasible:
        speedup = cephalo.predicted_throughput / even.predicted_throughput
        print(f"\npredicted speedup from decoupling: {speedup:.2f}x")

    # train both for a few steps — losses must match (Eq. 1)
    losses: Dict[str, List[float]] = {}
    for name, plan in (("cephalo", cephalo),) + (
            (("even", even),) if even.feasible else ()):
        losses[name] = train(cfg, plan, args.device)
        print(f"{name}: losses {['%.4f' % v for v in losses[name]]}")
    if "even" in losses:
        assert np.allclose(losses["cephalo"], losses["even"], atol=1e-3), \
            "gradient equivalence violated!"
        print("\nloss trajectories identical — the plans differ only in "
              "WHERE compute/memory live, not in the math (Eq. 1).")
    return losses


if __name__ == "__main__":
    main()
