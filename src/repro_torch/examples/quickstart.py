"""Quickstart: plan and train a small model on a heterogeneous cluster.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port of ``examples/quickstart.py``.  Walks the full Cephalo pipeline
(on the card unless ``--device cpu`` is asked for):
 1. pick an architecture (the reduced variant of stablelm-1.6b),
 2. build the cost model for the paper's Cluster A,
 3. run the DP optimizer → per-GPU batch/microbatch/state-ratio plan,
 4. train a few steps on the MPMD heterogeneous runtime (every rank of
    the plan on the one device),
 5. inspect the plan, memory split, and simulated wall-clock.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.device_specs import cluster_a
from repro_torch.core.engine import build_train_step
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.planner import solve
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim.adam import AdamConfig

SEQ, BATCH, STEPS = 64, 32, 10


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # 1. architecture: the real stablelm-1.6b config, shrunk
    cfg = get_arch("stablelm-1.6b").reduced()
    print(f"arch: {cfg.name} ({cfg.n_layers}L d={cfg.d_model})")

    # 2. cost model for the paper's Cluster A (2xL4, A6000, 3xP40, 2xP100)
    cluster = cluster_a()
    print(f"cluster: {cluster.describe()}")
    cm = analytic_cluster_model(cluster, build_model_stats(cfg, SEQ))

    # 3. the Cephalo optimizer (Alg. 1 DP + greedy state partition)
    plan = solve(cm, BATCH)
    print("\n--- plan ---")
    print(plan.summary())

    # 4. heterogeneous MPMD training through the unified engine API
    engine = build_train_step(cfg, plan, schedule="layered",
                              substrate="loopback",
                              adam=AdamConfig(lr=2e-3), seq_len=SEQ,
                              device=args.device)
    state = engine.init_state(torch.Generator(args.device).manual_seed(0))
    print("\n--- per-rank state memory (∝ r_i) ---")
    print(engine.memory_report(state))

    stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=0))
    print("\n--- training ---")
    losses = []
    for step in range(STEPS):
        state, loss = engine.step(state, stream.sample(step, BATCH))
        losses.append(loss)
        print(f"step {step:>3}  loss {loss:.4f}")

    sim = engine.simulated_iteration_seconds()
    print(f"\nsimulated iteration on Cluster A: "
          f"{sim['iteration_s'] * 1e3:.1f} ms  "
          f"→ {sim['throughput_samples_s']:.1f} samples/s")
    return losses


if __name__ == "__main__":
    main()
