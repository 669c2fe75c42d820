"""Where the training step's time goes: ``torch.profiler`` over one step
of the loopback MPMD engine (``build_train_step(..., substrate=
"loopback")``), at the plan ``chip_smoke.py`` phase ``train`` runs.

    python -m repro_torch.launch.profile_train --arch gpt-1.3b --seq 512

Needs a CUDA device.  After one warm-up step, the step runs twice: once
bare, for the host wall time, and once under the profiler, for the device
time of each kernel (the same window as ``profile_serve``).  Prints one
JSON line: wall ms, device ms, the device's idle share, device ms by kind
(flash attention forward and backward, matrix products, the rest: norms,
activations, casts, the loss, Adam and the loopback copies) and the
kernels that took most of it.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.engine import build_train_step
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.profile_serve import _window

#: two ranks on the one card: (device, m, ell, state ratio)
RANKS = [("rank0", 4, 2, 0.6), ("rank1", 2, 1, 0.4)]


def run(arch: str, seq: int, schedule: str, seed: int, top: int = 16):
    cfg = get_arch(arch)
    ranks = [RankPlan(i, dev, m=m, ell=ell, state_ratio=r)
             for i, (dev, m, ell, r) in enumerate(RANKS)]
    plan = Plan(model=arch, cluster="loopback-1-gpu",
                global_batch=sum(r.b for r in ranks), ranks=ranks)
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
    out = _window("train_step", one_step, top)
    out.update(arch=arch, seq=seq, schedule=schedule,
               global_batch=plan.global_batch, ranks=RANKS)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-1.3b")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(run(args.arch, args.seq, args.schedule, args.seed)),
          flush=True)


if __name__ == "__main__":
    main()
