"""``build_train_step`` — the entry point of the Cephalo training runtime.

The port of ``repro.core.engine.api``::

    engine = build_train_step(cfg, plan, schedule="layered",
                              substrate="loopback")
    state = engine.init_state(torch.Generator("cuda").manual_seed(0))
    state, loss = engine.step(state, big)      # big: (B, seq+1) tokens
    params = engine.gather_params(state)

``substrate="loopback"`` (or ``"auto"``) is the MPMD runtime: per-rank
unpadded ``(ell_i, m_i)`` work and software loopback collectives on one
device, ``cuda`` unless ``device="cpu"`` is asked for.
``substrate="multiproc"`` runs the same step across a fleet of worker
processes, one per rank, each on that device
(:class:`~repro_torch.core.engine.multiproc.ProcessEngine`).  With
``elastic=`` either one is wrapped in the replanning
:class:`~repro_torch.core.engine.elastic.ElasticEngine`.  The SPMD
``shard_map`` runtime is not ported yet (ROADMAP queue 1, item 10) and
raises.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine.schedules import Schedule, get_schedule
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.optim.adam import AdamConfig

SUBSTRATES = ("shard_map", "loopback", "multiproc")


def homogeneous_plan(n: int, ell: int, m: int,
                     device: str = "dev") -> Plan:
    """Even plan for n identical ranks (the SPMD launcher's geometry)."""
    ranks = [RankPlan(i, device, m=m, ell=ell, state_ratio=1.0 / n)
             for i in range(n)]
    return Plan(model="homogeneous", cluster=f"{n}x{device}",
                global_batch=n * ell * m, ranks=ranks)


class TrainEngine(abc.ABC):
    """Uniform train-step surface over a (cfg, plan, schedule, substrate)."""

    cfg: ArchConfig
    plan: Plan
    schedule: Schedule

    @abc.abstractmethod
    def init_state(self, generator: torch.Generator) -> Any:
        """Materialize sharded training state from a seeded generator."""

    @abc.abstractmethod
    def step(self, state: Any, big: np.ndarray) -> Tuple[Any, float]:
        """One optimizer step over a (B, seq+1) token block."""

    @abc.abstractmethod
    def gather_params(self, state: Any) -> Dict[str, Any]:
        """Reassemble the full model param tree."""

    @abc.abstractmethod
    def export_state(self, state: Any) -> Dict[str, Any]:
        """Substrate-independent full training state:
        ``{"step": int, "p"/"m"/"v": model-shaped trees}``."""

    @abc.abstractmethod
    def import_state(self, exported: Dict[str, Any]) -> Any:
        """Lay an :meth:`export_state` payload out on THIS engine's plan:
        params and Adam moments land on the shard layouts, the step
        counter carries over.  Leaves may be tensors on any device."""

    def close(self) -> None:
        """Release engine-held resources; nothing for the loopback
        substrate.  Idempotent."""

    def __enter__(self) -> "TrainEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MpmdEngine(TrainEngine):
    """Loopback substrate: per-rank unpadded work in one process."""

    def __init__(self, cfg: ArchConfig, plan: Plan, schedule: Schedule,
                 adam: AdamConfig, seq_len: int,
                 device: torch.device | str):
        # the runtime imports this package: import it here, not above
        from repro_torch.core.hetero_trainer import HeteroTrainer
        self.cfg, self.plan, self.schedule = cfg, plan, schedule
        self.seq = seq_len
        self.trainer = HeteroTrainer(cfg, plan, adam=adam, seq_len=seq_len,
                                     schedule=schedule, device=device)

    def init_state(self, generator: torch.Generator):
        return self.trainer.init_shards(generator)

    def step(self, state, big: np.ndarray):
        return self.trainer.step(state, np.asarray(big))

    def gather_params(self, state) -> Dict[str, Any]:
        return self.trainer.software_allgather(state)

    def export_state(self, state) -> Dict[str, Any]:
        sub = self.trainer.substrate
        return {"step": int(state[0]["step"]) if state else 0,
                "p": sub.allgather_params(state, "p"),
                "m": sub.allgather_params(state, "m"),
                "v": sub.allgather_params(state, "v")}

    def import_state(self, exported: Dict[str, Any]):
        shards = self.trainer.substrate.shard_state(
            exported["p"], exported.get("m"), exported.get("v"))
        for s in shards:
            s["step"] = int(exported.get("step", 0))
        return shards

    # MPMD extras surfaced for the launcher
    def memory_report(self, state) -> str:
        return self.trainer.memory_report(state)

    def simulated_iteration_seconds(self) -> Dict[str, float]:
        return self.trainer.simulated_iteration_seconds()


def build_train_step(cfg: ArchConfig, plan: Plan, *,
                     schedule: Union[str, Schedule] = "layered",
                     substrate: str = "auto",
                     adam: AdamConfig = AdamConfig(),
                     seq_len: int = 512,
                     device: torch.device | str = "cuda",
                     elastic=None,
                     cost_model=None,
                     oracle=None,
                     **knobs) -> TrainEngine:
    """Build a train engine for ``(cfg, plan)``.

    ``schedule`` — any name in :func:`list_schedules` (or a
    :class:`Schedule`).  ``substrate`` — ``"loopback"`` or ``"auto"``
    (which means loopback), or ``"multiproc"``, which takes the
    reference's knobs ``transport=``, ``topology=`` (``"hub"``/
    ``"ring"``), ``overlap_rounds=`` (ring only: round *k+1*'s
    AllGatherv prefetches under round *k*'s compute — same bits, less
    exposed wire time; default ``$CEPHALO_MP_OVERLAP``),
    ``ring_timeout=``, ``reply_timeout=``, ``start_method=`` and
    ``sanitize=`` (the runtime comm sanitizer on every ring worker;
    default ``$CEPHALO_COMM_SANITIZE``).  ``"shard_map"`` raises
    NotImplementedError until its slice lands.  With ``elastic=`` the
    knobs and ``device`` are captured and re-applied on every replan
    rebuild, so a ring fleet replans into a ring fleet on the same
    device.

    ``elastic`` — an :class:`~repro_torch.core.engine.elastic.ElasticConfig`
    (or ``True`` for defaults) returns an
    :class:`~repro_torch.core.engine.elastic.ElasticEngine` that replans
    and live-migrates state when runtime telemetry drifts from the plan;
    it needs ``cost_model`` (the ``ClusterCostModel`` the plan came
    from).  ``oracle`` optionally overrides the latency-measurement
    source (``elastic.CostModelOracle`` by default; a fleet's is
    ``multiproc.WallClockOracle``).
    """
    if elastic is not None and elastic is not False:
        from repro_torch.core.engine.elastic import (ElasticConfig,
                                                     ElasticEngine)
        if cost_model is None:
            raise ValueError("elastic replanning needs cost_model= (the "
                             "ClusterCostModel the plan was solved from)")
        ecfg = ElasticConfig() if elastic is True else elastic
        return ElasticEngine(cfg, cost_model, plan=plan,
                             schedule=schedule, substrate=substrate,
                             adam=adam, seq_len=seq_len, device=device,
                             elastic=ecfg, oracle=oracle, **knobs)
    if cost_model is not None or oracle is not None:
        raise ValueError("cost_model=/oracle= only apply with elastic=")
    sched = get_schedule(schedule)
    if substrate == "auto":
        substrate = "loopback"
    if substrate == "shard_map":
        raise NotImplementedError(
            "substrate 'shard_map' (the SPMD runtime) is not ported yet: "
            "ROADMAP queue 1, item 10")
    if substrate == "multiproc":
        from repro_torch.core.engine.multiproc import ProcessEngine
        return ProcessEngine(cfg, plan, sched, adam, seq_len, device=device,
                             **knobs)
    if substrate != "loopback":
        raise ValueError(f"unknown substrate {substrate!r}; "
                         f"choose from {SUBSTRATES}")
    if knobs:
        raise ValueError(
            f"loopback substrate takes no extra knobs, got {knobs}")
    return MpmdEngine(cfg, plan, sched, adam, seq_len, device)
