"""Training launcher: both runtimes go through the execution engine.

The port of ``repro.launch.train``.  ``--runtime mpmd`` (the default)
builds the analytic cost model of ``--cluster`` for the model, runs the
Cephalo planner (``auto_solve``), prints the plan, then trains with truly
uneven per-rank batches and state shards through ``build_train_step``:
every rank of the plan runs on the one device, ``cuda`` unless ``--device
cpu`` is asked for.  ``--ga-mode`` selects any registered
gradient-accumulation schedule, on either runtime.

``--runtime spmd`` is the Cephalo SPMD step (:func:`run_spmd`): the world
has one rank per card (``torch.cuda.device_count()``), or one rank with
``--device cpu``, on the mesh ``(n//2, 2)`` or ``(n, 1)`` with an even
plan of ``--ell`` microbatches a rank, through ``build_train_step(...,
substrate="shard_map")``; ``--checkpoint`` saves the exported state.

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
the final plan; ``--checkpoint`` saves the final plan.  As in the
reference, ``--elastic``, ``--straggler``, ``--substrate`` and
``--nprocs`` are refused with ``--runtime spmd``.

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

gpt-1.3b at full width and depth through the SPMD runtime, one rank on
the one card (NCCL), 4 microbatches of 4::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \
        --seq 512 --batch 16 --ell 4 --runtime spmd --steps 4

and reduced, on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-llama \
        --reduced --steps 3 --batch 12 --seq 32 --runtime spmd --ell 2 \
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
from repro_torch.core.engine import (build_train_step, homogeneous_plan,
                                     list_schedules)
from repro_torch.core.engine import world as W
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


def _train_loop(engine, args, plan, state=None, on_step=None,
                after_step=None) -> object:
    """``--steps`` steps of ``engine`` on ``SyntheticStream`` blocks, from
    ``state`` or a fresh one; ``on_step(step)`` runs before each step,
    ``after_step(step, loss)`` after it."""
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
        if after_step is not None:
            after_step(step, loss)
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
            if args.substrate == "multiproc":
                # worker-held shards → the substrate-independent
                # exported trees, as the reference saves them
                _save_exported(args, engine, state, final_plan)
            else:
                from repro_torch.checkpoint import checkpointing as C
                C.save(args.checkpoint, args.steps, state, {},
                       meta={"plan": final_plan.to_json()})
                print(f"saved checkpoint to {args.checkpoint}")


def _save_exported(args, engine, state, plan: Plan) -> None:
    """``--checkpoint``: the engine's exported trees (its shards live in
    other processes), as the reference saves a fleet's."""
    from repro_torch.checkpoint import checkpointing as C
    exported = engine.export_state(state)
    C.save(args.checkpoint, args.steps,
           [{k: exported[k] for k in ("p", "m", "v")}],
           {"step": exported["step"]},
           meta={"plan": plan.to_json(), "format": "exported"})
    print(f"saved checkpoint to {args.checkpoint}")


def spmd_world(args) -> Tuple[W.Mesh, Plan]:
    """The SPMD launcher's geometry, as the reference sizes it from the
    device count: one rank per card on ``cuda``, one with ``--device
    cpu``; the mesh ``(n//2, 2)`` or ``(n, 1)`` (``(1, 1)`` for one); an
    even plan of ``--ell`` microbatches of ``--batch // n // --ell``
    rows a rank."""
    n = W.device_count(args.device)
    if n < 1:
        M.resolve_device(args.device)       # raises: no CUDA
    shape = {1: (1, 1)}.get(n) or ((n // 2, 2) if n % 2 == 0 else (n, 1))
    per_dev = max(args.batch // n, 1)
    plan = homogeneous_plan(n, ell=args.ell,
                            m=max(per_dev // args.ell, 1), device="host")
    return W.Mesh(shape, ("data", "model")), plan


def run_spmd(args) -> list:
    """Train ``--steps`` steps through the SPMD runtime; returns each
    step's record: the loss, the controller's step ms, and every rank's
    record (:attr:`SpmdEngine.last_step`)."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh, plan = spmd_world(args)
    print(f"spmd: mesh {mesh.shape} {mesh.axis_names}, "
          f"{plan.n} rank(s) on {args.device}, ell {plan.ranks[0].ell}, "
          f"m {plan.ranks[0].m}, global batch {plan.global_batch}")
    records = []
    engine = build_train_step(cfg, plan, schedule=args.ga_mode,
                              substrate="shard_map", mesh=mesh,
                              adam=AdamConfig(lr=args.lr),
                              seq_len=args.seq, device=args.device)
    with engine:
        state = _train_loop(engine, args, plan, after_step=lambda _, loss: (
            records.append({"loss": loss, "step_ms": engine.step_ms,
                            "ranks": engine.last_step})))
        if args.checkpoint:
            _save_exported(args, engine, state, plan)
    return records


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
    if args.runtime != "mpmd" and (args.substrate != "loopback"
                                   or args.nprocs):
        raise SystemExit("--substrate/--nprocs apply to --runtime mpmd")
    if args.straggler and not args.elastic:
        raise SystemExit("--straggler needs --elastic")
    if args.straggler:
        _parse_straggler(args.straggler)
    _substrate_knobs(args)      # a flag error exits before any work
    M.resolve_device(args.device)
    if args.runtime == "spmd":
        run_spmd(args)
    else:
        run_mpmd(args)


if __name__ == "__main__":
    main()
