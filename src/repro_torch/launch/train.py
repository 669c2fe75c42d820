"""Training launcher: plan a heterogeneous cluster, then train on the plan.

The port of ``repro.launch.train`` for ``--runtime mpmd``: builds the
analytic cost model of ``--cluster`` for the model, runs the Cephalo
planner (``auto_solve``), prints the plan, then trains with truly uneven
per-rank batches and state shards through ``build_train_step``: every
rank of the plan runs on the one device, ``cuda`` unless ``--device
cpu`` is asked for.  ``--ga-mode`` selects any registered
gradient-accumulation schedule.

``--substrate multiproc`` runs the ranks as a fleet of worker processes
(``--nprocs`` sizes it; ``--topology hub|ring``, default
``$CEPHALO_MP_TOPOLOGY`` or hub; ``--overlap`` pipelines the ring's
rounds and needs ``--topology ring``).  As in the reference, its planner
starts from wall-clock latency models measured on the device
(``profiler.wallclock_cluster_model``), and the memory report names each
rank's worker pid.

``--elastic`` wraps the engine in the elastic replanning runtime
(:mod:`repro_torch.core.engine.elastic`): step-time telemetry refits
the cost model, the planner re-solves when the observed imbalance
crosses the threshold, and the training state (params and Adam moments)
migrates live to the new plan.  Its telemetry comes from the cost model
(``CostModelOracle``) on the loopback substrate and from the worker
processes' wall clocks (``WallClockOracle``) on a fleet.  ``--straggler
RANK:FACTOR@STEP`` injects a slowdown mid-run (``2:3.0@2`` makes rank 2
three times slower from step 2; on a fleet its worker actually sleeps).
After the run the launcher prints each replan event and, if it changed,
the final plan; ``--checkpoint`` saves the final plan.

Not ported yet, and refused with the ROADMAP item that ports it:
``--runtime spmd`` (queue 1, item 10).

Example (CPU, small model)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-llama \
        --reduced --steps 3 --batch 12 --seq 32 --cluster mini --device cpu

gpt-1.3b at full width on the plan for the paper's Cluster A (one card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \
        --seq 512 --batch 128 --runtime mpmd --cluster cluster-a --steps 3

gpt-1.3b at full width across two worker processes on the card, ring
topology::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \
        --seq 512 --batch 16 --substrate multiproc --nprocs 2 \
        --topology ring --steps 3

mamba2-370m at full width and depth on its Cluster A plan (8 ranks, m 7,
7, 10, 2, 2, 2, 1, 1; the SSD scan's gradient from its CUDA backward
kernel)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --seq 2048 --batch 32 --runtime mpmd --cluster cluster-a --steps 3

and reduced, on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --reduced --seq 64 --batch 32 --cluster cluster-a --steps 3 \
        --device cpu

gpt-1.3b at full width on Cluster A's plan, rank 2 three times slower
from step 2: the replan after the third step sheds its batch::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \
        --seq 512 --batch 128 --runtime mpmd --cluster cluster-a \
        --steps 6 --elastic --straggler 2:3.0@2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core import device_specs as D
from repro_torch.core.cost_model import (ClusterCostModel,
                                         analytic_cluster_model)
from repro_torch.core.engine import build_train_step, list_schedules
from repro_torch.core.engine.transport import resolve_topology
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.partition import Plan
from repro_torch.core.planner import auto_solve
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig

CLUSTERS = {
    "cluster-a": D.cluster_a,
    "cluster-b": D.cluster_b,
    "mini": lambda: D.Cluster([D.L4, D.A6000, D.P40, D.P100],
                              link_gbps=50, name="mini"),
}

_ITEM_10 = "not ported yet: ROADMAP queue 1, item 10 (SPMD runtime)"


def _train_loop(engine, args, plan, state=None, on_step=None) -> object:
    stream = SyntheticStream(DataConfig(engine.cfg.vocab_size, args.seq,
                                        seed=args.seed))
    if state is None:
        state = engine.init_state(
            torch.Generator(args.device).manual_seed(args.seed))
    # perf_counter: a monotonic clock, so a clock adjustment mid-run
    # cannot corrupt the step wall times
    t0 = time.perf_counter()
    for step in range(args.steps):
        if on_step is not None:
            on_step(step)
        big = stream.sample(step, plan.global_batch)
        state, loss = engine.step(state, big)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:>5} loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f}s wall)")
    return state


def _parse_straggler(spec: str) -> Tuple[int, float, int]:
    """'RANK:FACTOR@STEP' → (rank, factor, step); exits on another
    form."""
    try:
        head, step = spec.split("@")
        rank, factor = head.split(":")
        return int(rank), float(factor), int(step)
    except ValueError:
        raise SystemExit(f"--straggler {spec!r}: expected "
                         "RANK:FACTOR@STEP, e.g. 1:3.0@5") from None


def solve_plan(args, cfg: Optional[ArchConfig] = None
               ) -> Tuple[ArchConfig, Plan, ClusterCostModel]:
    """The model, its plan and the cost model the plan was solved from:
    the cost model of ``--cluster`` (cycled out to ``--nprocs`` ranks
    when given), solved by ``auto_solve`` for ``--batch``.  The cost
    model is analytic, or for ``--substrate multiproc`` measured: the
    fleet's ranks share the one kind of device, so its single-layer
    latency, measured there, is the observed truth.  ``cfg`` replaces
    ``--arch`` (and ``--reduced``) where given.  Prints the plan; an
    infeasible plan exits."""
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    cluster = CLUSTERS[args.cluster]()
    if args.nprocs:
        devices = [cluster.devices[i % len(cluster.devices)]
                   for i in range(args.nprocs)]
        cluster = dataclasses.replace(
            cluster, devices=devices,
            name=f"{cluster.name}x{args.nprocs}")
    if args.substrate == "multiproc":
        from repro_torch.core.profiler import wallclock_cluster_model
        print(f"profiling wall-clock latency models on {args.device} ...")
        cm = wallclock_cluster_model(cluster, cfg, args.seq,
                                     device=args.device)
    else:
        cm = analytic_cluster_model(cluster,
                                    build_model_stats(cfg, args.seq))
    plan = auto_solve(cm, args.batch)
    print(plan.summary())
    if not plan.feasible:
        raise SystemExit(f"infeasible: {plan.infeasible_reason}")
    return cfg, plan, cm


def _substrate_knobs(args) -> dict:
    """The multiproc fleet's knobs from the flags (none for loopback):
    ``--topology`` over ``$CEPHALO_MP_TOPOLOGY`` over hub; ``--overlap``
    only on the ring."""
    if args.substrate != "multiproc":
        return {}
    knobs = {"topology": resolve_topology(args.topology)}
    if args.overlap:
        if knobs["topology"] != "ring":
            raise SystemExit("--overlap needs --topology ring (the hub "
                             "data plane has no prefetch lane)")
        knobs["overlap_rounds"] = True
    return knobs


def elastic_knobs(args, cm: ClusterCostModel
                  ) -> Tuple[dict, Optional[Callable[[int], None]]]:
    """``build_train_step``'s elastic knobs for ``--elastic`` (none
    without it), and the ``on_step`` hook of ``--straggler``, which
    degrades the oracle's rank at its step.  The oracle is the fleet's
    wall clock for ``--substrate multiproc``, else the cost model."""
    if not args.elastic:
        return {}, None
    from repro_torch.core.engine.elastic import (CostModelOracle,
                                                 ElasticConfig)
    from repro_torch.core.engine.multiproc import WallClockOracle
    oracle = WallClockOracle() if args.substrate == "multiproc" \
        else CostModelOracle(cm)
    knobs = dict(elastic=ElasticConfig(), cost_model=cm, oracle=oracle)
    if not args.straggler:
        return knobs, None
    rank, factor, at_step = _parse_straggler(args.straggler)
    if not 0 <= rank < cm.cluster.n:
        raise SystemExit(f"--straggler rank {rank} out of range for "
                         f"{cm.cluster.name} (n={cm.cluster.n})")

    def on_step(step: int) -> None:
        if step == at_step:
            print(f"-- injecting straggler: rank {rank} x{factor} --")
            oracle.degrade(rank, factor)
    return knobs, on_step


def build_engine(args, cfg: ArchConfig, plan: Plan, **elastic):
    """The MPMD engine for ``plan`` on ``--device``: loopback, or the
    process fleet for ``--substrate multiproc``; with the knobs of
    :func:`elastic_knobs`, the elastic engine around it."""
    return build_train_step(cfg, plan, schedule=args.ga_mode,
                            substrate=args.substrate,
                            adam=AdamConfig(lr=args.lr), seq_len=args.seq,
                            device=args.device, **_substrate_knobs(args),
                            **elastic)


def run_mpmd(args) -> None:
    cfg, plan, cm = solve_plan(args)
    knobs, on_step = elastic_knobs(args, cm)
    engine = build_engine(args, cfg, plan, **knobs)
    with engine:
        state = engine.init_state(
            torch.Generator(args.device).manual_seed(args.seed))
        print(engine.memory_report(state))
        sim = engine.simulated_iteration_seconds()
        print(f"predicted iteration: {sim['iteration_s']*1e3:.1f} ms "
              f"({sim['throughput_samples_s']:.2f} samples/s)")
        state = _train_loop(engine, args, plan, state=state,
                            on_step=on_step)
        final_plan = plan
        if args.elastic:
            for ev in engine.events:
                print(f"replan@{ev.step} adopted={ev.adopted}: {ev.reason}")
            if engine.plan is not plan:
                print("final plan after replanning:")
                print(engine.plan.summary())
            final_plan = engine.plan
        if args.checkpoint:
            from repro_torch.checkpoint import checkpointing as C
            if args.substrate == "multiproc":
                # worker-held shards → the substrate-independent
                # exported trees, as the reference saves them
                exported = engine.export_state(state)
                C.save(args.checkpoint, args.steps,
                       [{k: exported[k] for k in ("p", "m", "v")}],
                       {"step": exported["step"]},
                       meta={"plan": final_plan.to_json(),
                             "format": "exported"})
            else:
                C.save(args.checkpoint, args.steps, state, {},
                       meta={"plan": final_plan.to_json()})
            print(f"saved checkpoint to {args.checkpoint}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--runtime", choices=("spmd", "mpmd"), default="mpmd")
    ap.add_argument("--cluster", default="mini", choices=list(CLUSTERS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ell", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ga-mode", default="layered",
                    choices=list_schedules())
    ap.add_argument("--substrate", default="loopback",
                    choices=("loopback", "multiproc"),
                    help="mpmd collective substrate: in-process loopback, "
                         "or one worker process per rank")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="size the rank fleet explicitly (cycles the "
                         "--cluster device specs); 0 = cluster size")
    ap.add_argument("--topology", default=None, choices=("hub", "ring"),
                    help="multiproc collective topology (default "
                         "$CEPHALO_MP_TOPOLOGY, else hub)")
    ap.add_argument("--overlap", action="store_true",
                    help="multiproc: overlap the ring's collective rounds "
                         "with compute (needs --topology ring)")
    ap.add_argument("--elastic", action="store_true",
                    help="enable the replanning runtime (mpmd only)")
    ap.add_argument("--straggler", default="",
                    help="inject a slowdown: RANK:FACTOR@STEP "
                         "(requires --elastic)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    if args.runtime != "mpmd" and (args.elastic or args.straggler):
        raise SystemExit("--elastic/--straggler require --runtime mpmd "
                         "(the replanning loop drives the planner, which "
                         "the homogeneous SPMD launcher bypasses)")
    if args.runtime == "spmd":
        raise SystemExit(f"--runtime spmd is {_ITEM_10}")
    if args.straggler and not args.elastic:
        raise SystemExit("--straggler needs --elastic")
    if args.straggler:
        _parse_straggler(args.straggler)
    _substrate_knobs(args)      # a flag error exits before any work
    M.resolve_device(args.device)
    run_mpmd(args)


if __name__ == "__main__":
    main()
