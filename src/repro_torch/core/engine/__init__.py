"""The execution engine of the port's Cephalo training runtime.

The port of ``repro.core.engine`` (its loopback runtime and its process
fleet):

* :mod:`.units` — **UnitPlanner**: the param→unit grouping and flat
  layouts;
* :mod:`.schedules` — **Schedule**: the gradient-accumulation schedule
  registry (``layered``, ``per_microbatch``, ``interleaved``);
* :mod:`.substrate` — **LoopbackSubstrate**: the in-process ragged
  AllGatherv / ReduceScatterv;
* :mod:`.transport`, :mod:`.ring` — the fleet's wire and its ring
  collectives;
* :mod:`.multiproc` — **ProcessEngine**: the MPMD step across real
  rank processes, hub or ring, and the **WallClockOracle**;
* :mod:`.api` — ``build_train_step(cfg, plan, schedule=...,
  substrate="loopback" | "multiproc")``, which returns a
  ``TrainEngine``;
* :mod:`.elastic` — **ElasticEngine**: the closed-loop replanning
  runtime on top of them — step-time telemetry refits the Sec. 2.3
  latency models, ``auto_solve`` re-runs the Sec. 2.4 DP, and live
  state migration reshards params and Adam moments between plans
  (``build_train_step(..., elastic=True, cost_model=cm)``);
* :mod:`.verify` — the offline protocol checker (``python -m
  repro_torch.core.engine.verify``) and the fleet's runtime comm
  sanitizer.
"""

from repro_torch.core.engine.api import (MpmdEngine, TrainEngine,
                                         build_train_step, homogeneous_plan)
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
                                               LoopbackSubstrate)
from repro_torch.core.engine.units import (UnitGroup, UnitPlanner,
                                           element_tree, merge_params,
                                           split_params)

__all__ = [
    "CollectiveSubstrate", "CostModelOracle", "ElasticConfig",
    "ElasticEngine", "LoopbackSubstrate", "MpmdEngine",
    "MultiProcessSubstrate", "ProcessEngine", "Schedule",
    "TelemetryBuffer", "TrainEngine", "UnitGroup", "UnitPlanner",
    "WallClockOracle", "build_train_step", "chunked", "element_tree",
    "get_schedule", "homogeneous_plan", "list_schedules", "merge_params",
    "migrate_state", "register_schedule", "split_params",
]
