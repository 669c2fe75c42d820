"""``build_train_step`` — the entry point of the Cephalo training runtime.

The port of ``repro.core.engine.api``::

    engine = build_train_step(cfg, plan, schedule="layered",
                              substrate="loopback")
    state = engine.init_state(torch.Generator("cuda").manual_seed(0))
    state, loss = engine.step(state, big)      # big: (B, seq+1) tokens
    params = engine.gather_params(state)

All substrates consume the same plan, the same data block, the same
UnitPlanner layouts and any registered Schedule; the gradient math is
identical (Eq. 1).  Every engine runs on ``device``, ``cuda`` unless
``device="cpu"`` is asked for.

* ``substrate="shard_map"`` — the SPMD runtime
  (:class:`SpmdEngine`): one rank process per mesh position, each a
  :class:`~repro_torch.core.layered_ga.CephaloProgram` on the plan's
  padded ``(ell_pad, m_pad)`` grid with Eq. 1 zero-weight padding,
  joined by ``torch.distributed`` (:mod:`.world`).
* ``substrate="loopback"`` — the MPMD runtime: per-rank unpadded
  ``(ell_i, m_i)`` work and software loopback collectives on one
  device.
* ``substrate="multiproc"`` — the same MPMD step across a fleet of
  worker processes, one per rank
  (:class:`~repro_torch.core.engine.multiproc.ProcessEngine`).

``"auto"`` picks shard_map exactly when the reference does: when a
``mesh`` is given or the devices number at least ``plan.n > 1``.  With
``elastic=`` any of them is wrapped in the replanning
:class:`~repro_torch.core.engine.elastic.ElasticEngine`.  Engines that
own processes (shard_map, multiproc) must be closed (or used as context
managers).
"""

from __future__ import annotations

import abc
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import world as W
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
        """Release engine-held resources (rank processes); nothing for
        the loopback substrate.  Idempotent."""

    def __enter__(self) -> "TrainEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SpmdEngine(TrainEngine):
    """shard_map substrate: the plan's padded grid on ``mesh.size`` rank
    processes (``mesh`` defaults to ``(plan.n,)`` over ``"data"``).

    The single-controller surface of the reference: the controller holds
    no training state, only a ``{"step": n}`` handle; each rank holds its
    shards on its device and receives only its own slice of each step's
    grid.  ``init_state`` sends the generator's state, so every rank draws
    the loopback engine's params bit for bit and keeps its shard;
    ``export_state`` takes each part's padded shards from the state
    group's ranks and reassembles them on the controller's host, as the
    reference's host-side ``gather_part`` does; ``import_state`` cuts each
    rank's padded shards there and sends them.  Knobs go to
    :class:`~repro_torch.core.layered_ga.CephaloProgram`
    (``gather_dtype``, ``grad_dtype``, ``remat``, ``unroll``,
    ``ce_chunk``, ``has_frontend_batch``, ``state_axes``).

    After each step ``last_step`` holds every rank's record (loss,
    seconds, collectives, host bytes, kernel launches, peak device
    memory) and ``step_ms`` the controller's wall time of the step.
    """

    def __init__(self, cfg: ArchConfig, plan: Plan, schedule: Schedule,
                 adam: AdamConfig, seq_len: int, mesh: Optional[W.Mesh] = None,
                 *, device: torch.device | str = "cuda", **knobs):
        from repro_torch.core import layered_ga
        from repro_torch.core.engine.units import (UnitPlanner,
                                                   normalized_ratios)
        from repro_torch.models import model as M
        if not plan.feasible:
            raise ValueError(plan.infeasible_reason)
        self.cfg, self.plan, self.schedule = cfg, plan, schedule
        self.seq = seq_len
        self.device = M.resolve_device(device)     # before any spawn
        self.mesh = mesh if mesh is not None else W.Mesh((plan.n,),
                                                         ("data",))
        if self.mesh.size != plan.n:
            raise ValueError(f"mesh {self.mesh.shape} has {self.mesh.size} "
                             f"ranks; the plan has {plan.n}")
        self.ratios = [float(r) for r in normalized_ratios(
            plan.state_ratios())]
        state_axes = knobs.get("state_axes") or self.mesh.axis_names
        if self.mesh.axis_size(state_axes) != len(self.ratios):
            raise ValueError(f"{len(self.ratios)} plan ratios for a state "
                             f"group of {self.mesh.axis_size(state_axes)}")
        self.planner = UnitPlanner(cfg, self.ratios)
        self._state_index = [
            ranks.index(r) for r in range(self.mesh.size)
            for ranks in self.mesh.groups(state_axes) if r in ranks]
        #: the ranks whose shards make up the state (a replica's are the
        #: same), in shard order
        self._export_ranks = self.mesh.groups(state_axes)[0]
        ell, m = max(plan.ell_pad, 1), max(plan.m_pad, 1)
        sched = Schedule(schedule.name,
                         layered_ga.FixedRounds(tuple(schedule.chunks(ell))),
                         schedule.description)
        self.last_step: List[dict] = []
        self.step_ms = 0.0
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()
            torch.cuda.empty_cache()
        self.world = W.World(self.mesh, self.device)
        try:
            self.world.call(layered_ga.rank_build, (cfg, dict(
                ratios=self.ratios, ell=ell, m=m, seq=seq_len,
                schedule=sched, adam=adam, **knobs)))
        except BaseException:
            self.world.close()
            raise

    def init_state(self, generator: torch.Generator) -> Dict[str, int]:
        """Every rank draws the params from ``generator``'s state (the
        generator lives on the engine's device type) and keeps its
        shard."""
        from repro_torch.core import layered_ga
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}; the ranks "
                             f"run on {self.device.type}")
        gen_state = bytes(generator.get_state().numpy())
        self.world.call(layered_ga.rank_init, (gen_state,))
        return {"step": 0}

    def step(self, state: Dict[str, int], big: np.ndarray
             ) -> Tuple[Dict[str, int], float]:
        from repro_torch.core import layered_ga
        from repro_torch.data.pipeline import plan_grid_from_block
        grid = plan_grid_from_block(self.plan, np.asarray(big))
        batches = [W.Payload(None, {k: v[r] for k, v in grid.items()})
                   for r in range(self.mesh.size)]
        t0 = time.perf_counter()
        self.last_step = self.world.call(layered_ga.rank_step,
                                         per_rank=batches)
        self.step_ms = (time.perf_counter() - t0) * 1e3
        losses = {rec["loss"] for rec in self.last_step}
        if len(losses) != 1:
            raise RuntimeError(f"ranks summed different losses: {losses}")
        return {"step": state["step"] + 1}, self.last_step[0]["loss"]

    def _flats(self, part: str) -> Tuple[int, Dict[str, torch.Tensor]]:
        """{unit: full flat} of one part, from the state group's padded
        shards, reassembled on the host."""
        from repro_torch.core import fsdp, layered_ga
        out = self.world.call(layered_ga.rank_export, (part,))
        shards = [out[r] for r in self._export_ranks]
        del out
        flats = {g.name: fsdp.unshard(g.layout, torch.from_numpy(np.stack(
            [s.arrays.pop(g.name) for s in shards], axis=-2)))
                 for g in self.planner.groups}
        return shards[0].meta["step"], flats

    def _tree(self, flats: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        from repro_torch.core.engine.substrate import LoopbackSubstrate
        return LoopbackSubstrate(self.planner, "cpu").unflatten_flats(flats)

    def gather_params(self, state) -> Dict[str, Any]:
        return self._tree(self._flats("p")[1])

    def export_state(self, state) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for part in ("p", "m", "v"):
            out["step"], flats = self._flats(part)
            out[part] = self._tree(flats)
        return out

    def import_state(self, exported: Dict[str, Any]) -> Dict[str, int]:
        from repro_torch.core import fsdp, layered_ga
        from repro_torch.core.engine.substrate import LoopbackSubstrate
        from repro_torch.models import model as M
        sub = LoopbackSubstrate(self.planner, "cpu")
        step = int(exported.get("step", 0))
        for k, part in enumerate(("p", "m", "v")):
            tree = exported.get(part)
            if tree is None:
                tree = M.tree_map(exported["p"],
                                  lambda _, t: torch.zeros_like(t))
            flats = sub.flatten_tree(M.tree_map(tree,
                                                lambda _, t: t.cpu()))
            shards = [W.Payload({"step": step, "fresh": k == 0}, {
                f"{g.name}|{part}": fsdp.padded_shard(
                    g.layout, flats[g.name], self._state_index[r]).numpy()
                for g in self.planner.groups})
                for r in range(self.mesh.size)]
            del flats
            self.world.call(layered_ga.rank_import, per_rank=shards)
        return {"step": step}

    def close(self) -> None:
        self.world.close()


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
                     mesh: Optional[W.Mesh] = None,
                     elastic=None,
                     cost_model=None,
                     oracle=None,
                     **knobs) -> TrainEngine:
    """Build a train engine for ``(cfg, plan)``.

    ``schedule`` — any name in :func:`list_schedules` (or a
    :class:`Schedule`).  ``substrate`` — ``"shard_map"``, ``"loopback"``,
    ``"auto"`` (shard_map iff ``mesh`` is given or the devices of
    ``device``'s type number at least ``plan.n > 1``, else loopback), or
    ``"multiproc"``.  ``"shard_map"`` takes a :class:`~.world.Mesh`
    (``mesh=``) and the knobs of :class:`SpmdEngine`; ``"multiproc"``
    takes the
    reference's knobs ``transport=``, ``topology=`` (``"hub"``/
    ``"ring"``), ``overlap_rounds=`` (ring only: round *k+1*'s
    AllGatherv prefetches under round *k*'s compute — same bits, less
    exposed wire time; default ``$CEPHALO_MP_OVERLAP``),
    ``ring_timeout=``, ``reply_timeout=``, ``start_method=`` and
    ``sanitize=`` (the runtime comm sanitizer on every ring worker;
    default ``$CEPHALO_COMM_SANITIZE``).  With ``elastic=`` the
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
                             mesh=mesh, elastic=ecfg, oracle=oracle,
                             **knobs)
    if cost_model is not None or oracle is not None:
        raise ValueError("cost_model=/oracle= only apply with elastic=")
    sched = get_schedule(schedule)
    if substrate == "auto":
        substrate = "shard_map" if (mesh is not None or
                                    W.device_count(device) >= plan.n > 1) \
            else "loopback"
    if substrate == "shard_map":
        return SpmdEngine(cfg, plan, sched, adam, seq_len, mesh=mesh,
                          device=device, **knobs)
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
