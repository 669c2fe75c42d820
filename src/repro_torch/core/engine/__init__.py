"""The execution engine of the port's Cephalo training runtime.

The port of ``repro.core.engine`` (its loopback runtime, its process
fleet and its SPMD runtime):

* :mod:`.units` — **UnitPlanner**: the param→unit grouping and flat
  layouts;
* :mod:`.schedules` — **Schedule**: the gradient-accumulation schedule
  registry (``layered``, ``per_microbatch``, ``interleaved``);
* :mod:`.substrate` — **LoopbackSubstrate**: the in-process ragged
  AllGatherv / ReduceScatterv; **ShardMapSubstrate**: the SPMD ranks'
  differentiable AllGather / ReduceScatter;
* :mod:`.world` — **World**: the SPMD runtime's rank processes, their
  ``torch.distributed`` groups and collectives;
* :mod:`.transport`, :mod:`.ring` — the fleet's wire and its ring
  collectives;
* :mod:`.multiproc` — **ProcessEngine**: the MPMD step across real
  rank processes, hub or ring, and the **WallClockOracle**;
* :mod:`.api` — ``build_train_step(cfg, plan, schedule=...,
  substrate="shard_map" | "loopback" | "multiproc")``, which returns a
  ``TrainEngine`` (**SpmdEngine**, **MpmdEngine**, **ProcessEngine**);
* :mod:`.elastic` — **ElasticEngine**: the closed-loop replanning
  runtime on top of them — step-time telemetry refits the Sec. 2.3
  latency models, ``auto_solve`` re-runs the Sec. 2.4 DP, and live
  state migration reshards params and Adam moments between plans
  (``build_train_step(..., elastic=True, cost_model=cm)``);
* :mod:`.verify` — the offline protocol checker (``python -m
  repro_torch.core.engine.verify``) and the fleet's runtime comm
  sanitizer.
"""

from repro_torch.core.engine.api import (MpmdEngine, SpmdEngine,
                                         TrainEngine, build_train_step,
                                         homogeneous_plan)
from repro_torch.core.engine.elastic import (CostModelOracle,
                                             ElasticConfig, ElasticEngine,
                                             TelemetryBuffer, migrate_state)
from repro_torch.core.engine.multiproc import (MultiProcessSubstrate,
                                               ProcessEngine,
                                               WallClockOracle)
from repro_torch.core.engine.schedules import (Schedule, chunked,
                                               get_schedule, list_schedules,
                                               register_schedule)
from repro_torch.core.engine.substrate import (CollectiveSubstrate,
                                               LoopbackSubstrate,
                                               ShardMapSubstrate)
from repro_torch.core.engine.units import (UnitGroup, UnitPlanner,
                                           element_tree, merge_params,
                                           split_params)
from repro_torch.core.engine.world import Mesh, World

__all__ = [
    "CollectiveSubstrate", "CostModelOracle", "ElasticConfig",
    "ElasticEngine", "LoopbackSubstrate", "Mesh", "MpmdEngine",
    "MultiProcessSubstrate", "ProcessEngine", "Schedule",
    "ShardMapSubstrate", "SpmdEngine", "TelemetryBuffer", "TrainEngine",
    "UnitGroup", "UnitPlanner", "WallClockOracle", "World",
    "build_train_step", "chunked", "element_tree",
    "get_schedule", "homogeneous_plan", "list_schedules", "merge_params",
    "migrate_state", "register_schedule", "split_params",
]
