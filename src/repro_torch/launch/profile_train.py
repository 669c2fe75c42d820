"""Where the training step's time goes: ``torch.profiler`` over one step
of the loopback MPMD engine (``build_train_step(..., substrate=
"loopback")``), at the plan ``chip_smoke.py`` phase ``train`` runs, or at
the plan the port's planner solves for a cluster and a global batch (the
plan ``python -m repro_torch.launch.train`` trains).

    python -m repro_torch.launch.profile_train --arch gpt-1.3b --seq 512
    python -m repro_torch.launch.profile_train --arch gpt-1.3b --seq 512 \
        --cluster cluster-a --batch 128
    python -m repro_torch.launch.profile_train --arch mamba2-370m \
        --seq 2048 --cluster cluster-a --batch 32

Needs a CUDA device.  After one warm-up step, the step runs twice: once
bare, for the host wall time, and once under the profiler, for the device
time of each kernel (the same window as ``profile_serve``).  Prints one
JSON line: wall ms, device ms, the device's idle share, device ms by kind
(flash attention forward and backward, the SSD scan forward and backward,
matrix products, copies and casts, the other elementwise work: norms,
activations, the conv, the loss, Adam) and the kernels that took most of
it.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.engine import build_train_step
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.core.planner import auto_solve
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import profile_serve
from repro_torch.launch.train import CLUSTERS

#: two ranks on the one card: (device, m, ell, state ratio)
RANKS = [("rank0", 4, 2, 0.6), ("rank1", 2, 1, 0.4)]

_COPY_MARKS = ("copy", "memcpy", "memset", "catarray")


def _kind(name: str) -> str:
    """``profile_serve``'s kinds, with its ``other`` split into copies
    (device copies, casts, the loopback's concatenations) and the rest of
    the elementwise work."""
    kind = profile_serve._kind(name)
    if kind != "other":
        return kind
    low = name.lower()
    return "copy" if any(m in low for m in _COPY_MARKS) else "elementwise"


def _plan(cfg, seq: int, cluster: Optional[str], batch: int) -> Plan:
    if cluster is None:
        ranks = [RankPlan(i, dev, m=m, ell=ell, state_ratio=r)
                 for i, (dev, m, ell, r) in enumerate(RANKS)]
        return Plan(model=cfg.name, cluster="loopback-1-gpu",
                    global_batch=sum(r.b for r in ranks), ranks=ranks)
    cm = analytic_cluster_model(CLUSTERS[cluster](),
                                build_model_stats(cfg, seq))
    plan = auto_solve(cm, batch)
    if not plan.feasible:
        raise SystemExit(f"infeasible: {plan.infeasible_reason}")
    return plan


def run(arch: str, seq: int, schedule: str, seed: int,
        cluster: Optional[str] = None, batch: int = 128, top: int = 16):
    cfg = get_arch(arch)
    plan = _plan(cfg, seq, cluster, batch)
    engine = build_train_step(cfg, plan, substrate="loopback",
                              schedule=schedule, seq_len=seq)
    state = {"s": engine.init_state(
        torch.Generator(device="cuda").manual_seed(seed))}
    stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=seed))
    step = {"i": 0}

    def one_step():
        blk = stream.sample(step["i"], plan.global_batch)
        state["s"], _ = engine.step(state["s"], blk)
        step["i"] += 1

    one_step()                                  # warm-up
    out = profile_serve._window("train_step", one_step, top, kind=_kind)
    out.update(arch=arch, seq=seq, schedule=schedule,
               cluster=plan.cluster, global_batch=plan.global_batch,
               ranks=[(r.device, r.m, r.ell, r.state_ratio)
                      for r in plan.ranks])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-1.3b")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cluster", default=None, choices=list(CLUSTERS),
                    help="profile the plan the planner solves for this "
                         "cluster (default: the two-rank plan above)")
    ap.add_argument("--batch", type=int, default=128,
                    help="global batch of the planned step (--cluster)")
    args = ap.parse_args()
    print(json.dumps(run(args.arch, args.seq, args.schedule, args.seed,
                         args.cluster, args.batch)), flush=True)


if __name__ == "__main__":
    main()
