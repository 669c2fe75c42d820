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
    python -m repro_torch.launch.profile_train --arch gpt-1.3b --seq 512 \
        --runtime spmd --batch 16 --ell 4

Needs a CUDA device.  After one warm-up step, the step runs twice: once
bare, for the host wall time, and once under the profiler, for the device
time of each kernel (the same window as ``profile_serve``).  Prints one
JSON line: wall ms, device ms, the device's idle share, device ms by kind
(flash attention forward and backward, the SSD scan forward and backward,
matrix products, copies and casts, the other elementwise work: norms,
activations, the conv, the loss, Adam) and the kernels that took most of
it.  With ``--runtime spmd`` the step is the SPMD engine's at the
launcher's geometry (``launch.train.spmd_world``: one rank per card), and
the window runs inside rank 0's process (kind ``collective`` for the NCCL
kernels).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core import layered_ga
from repro_torch.core.engine import build_train_step
from repro_torch.core.engine.world import Payload
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.core.planner import auto_solve
from repro_torch.data.pipeline import (DataConfig, SyntheticStream,
                                       plan_grid_from_block)
from repro_torch.launch import profile_serve
from repro_torch.launch import train as launch_train
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
    if "nccl" in low:
        return "collective"
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


def rank_profile(ctx, top: int, batch: Payload) -> dict:
    """Inside an SPMD rank: the profiler's window over this rank's step
    (``layered_ga.rank_step``) on ``batch``, taken twice (bare, then
    profiled)."""
    return profile_serve._window(
        "spmd_step", lambda: layered_ga.rank_step(ctx, batch), top,
        kind=_kind)


def run_spmd(arch: str, seq: int, schedule: str, seed: int, batch: int,
             ell: int, top: int = 16):
    """One SPMD step profiled in rank 0, after a warm-up step, at the
    launcher's ``--runtime spmd`` geometry."""
    args = launch_train.parser().parse_args([
        "--arch", arch, "--seq", str(seq), "--batch", str(batch),
        "--ell", str(ell), "--runtime", "spmd"])
    mesh, plan = launch_train.spmd_world(args)
    cfg = get_arch(arch)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=seed))
    with build_train_step(cfg, plan, substrate="shard_map",
                          schedule=schedule, mesh=mesh,
                          seq_len=seq) as engine:
        state = engine.init_state(
            torch.Generator(device="cuda").manual_seed(seed))
        engine.step(state, stream.sample(0, plan.global_batch))
        grid = plan_grid_from_block(plan, stream.sample(
            1, plan.global_batch))
        out = engine.world.call(rank_profile, (top,), per_rank=[
            Payload(None, {k: v[r] for k, v in grid.items()})
            for r in range(plan.n)])[0]
    out.update(arch=arch, seq=seq, schedule=schedule, runtime="spmd",
               mesh=mesh.shape, global_batch=plan.global_batch,
               ell=plan.ranks[0].ell, m=plan.ranks[0].m)
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
                    help="global batch of the planned step (--cluster, "
                         "--runtime spmd)")
    ap.add_argument("--runtime", choices=("mpmd", "spmd"), default="mpmd")
    ap.add_argument("--ell", type=int, default=1,
                    help="microbatches a rank (--runtime spmd)")
    args = ap.parse_args()
    if args.runtime == "spmd":
        out = run_spmd(args.arch, args.seq, args.schedule, args.seed,
                       args.batch, args.ell)
    else:
        out = run(args.arch, args.seq, args.schedule, args.seed,
                  args.cluster, args.batch)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
