"""Elastic replanning runtime: telemetry → refit → replan → migrate.

The port of ``repro.core.engine.elastic``.  Cephalo's plan (paper Sec.
2.4) is computed once, offline, from profiled latency models (Sec. 3.1).
Any runtime drift — thermal throttling, a contended GPU, a rank joining
or leaving — silently turns the "optimal" plan into a stale one: the
step time is ``max_i t_i``, so one straggler degrades the whole cluster.
This module closes the loop over the engine's seams:

1. **Telemetry** — :class:`TelemetryBuffer` collects per-rank, per-phase
   ``(m, seconds)`` single-layer samples each step (passively at the
   plan's ``m_i``; a replan triggers an active probe sweep over the
   profiler's standard ``m`` grid).  The measurement source is a
   pluggable oracle: :class:`CostModelOracle` answers from a cost model
   (simulated runs, the loopback substrate), and
   :class:`~repro_torch.core.engine.multiproc.WallClockOracle` times the
   rank processes of a fleet (on the card, by CUDA events inside each
   worker).
2. **Refit** — :func:`repro_torch.core.profiler.refit_cluster_model`
   rebuilds the per-device latency models through the same
   ``fit_piecewise`` path the offline profiler uses (Sec. 2.3).
3. **Replan + migrate** — ``planner.auto_solve`` on the refitted model;
   if the new plan beats the old one under that model by ``min_gain``,
   :func:`migrate_state` moves the training state (params, Adam moments,
   step counter) from the old plan's uneven shards to the new one:
   ``export_state`` gathers each part into model-shaped trees,
   ``import_state`` lays them out on the new plan.  Pure data movement,
   so the migrated state equals a from-scratch resharding bit for bit.

The control loop's arithmetic is the reference's line for line (the
trigger, the probe merge, the comparison of the old plan under the refit
model, the hysteresis).  The port's differences: ``init_state`` takes a
``torch.Generator``; the engine runs on ``device`` (``cuda`` unless the
caller asks for the CPU), one of the knobs every rebuild carries; and
each :class:`ReplanEvent` records the seconds of its stages.

Entry points: ``build_train_step(..., elastic=ElasticConfig(...),
cost_model=cm)`` or :class:`ElasticEngine` directly; the launcher flags
are ``repro_torch.launch.train --elastic --straggler RANK:FACTOR@STEP``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import ClusterCostModel
from repro_torch.core.engine.api import TrainEngine, build_train_step
from repro_torch.core.partition import Plan
from repro_torch.core.planner import auto_solve, evaluate_plan
from repro_torch.core.profiler import PROFILE_MS, refit_cluster_model
from repro_torch.optim.adam import AdamConfig

#: Active-probe microbatch grid — literally the offline profiler's
#: small-m sweep (one constant, ``profiler.PROFILE_MS``), so the runtime
#: refit and the offline profile always fit on the same grid.
PROBE_MS = PROFILE_MS


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Control-loop knobs for :class:`ElasticEngine`."""

    #: replan when the observed bottleneck compute time exceeds the
    #: plan's prediction by this fraction.
    imbalance_threshold: float = 0.15
    #: hysteresis: never replan twice within this many steps.
    min_steps_between_replans: int = 3
    #: steps of telemetry required before the first replan may fire.
    warmup_steps: int = 2
    #: rolling telemetry window (steps) per rank.
    telemetry_window: int = 16
    #: only adopt a new plan if it improves predicted iteration time
    #: over the *observed* old plan by at least this fraction (guards
    #: against migration churn for marginal gains).
    min_gain: float = 0.02
    #: active-probe m sweep used for the refit.
    probe_ms: Tuple[int, ...] = PROBE_MS


class CostModelOracle:
    """Latency-measurement source for simulated runs.

    Answers single-layer ``(rank, m, phase)`` queries from a ground-truth
    cost model; :meth:`degrade` multiplies a rank's latency by a factor —
    the straggler-injection hook (thermal throttling, contention,
    invisible to the planner until refit).  On a process fleet the
    :class:`~repro_torch.core.engine.multiproc.WallClockOracle` takes its
    place; the control loop is identical.
    """

    def __init__(self, cm: ClusterCostModel):
        self.cm = cm
        self.factors: Dict[int, float] = {}

    def degrade(self, rank: int, factor: float) -> None:
        self.factors[rank] = float(factor)

    def restore(self, rank: int) -> None:
        self.factors.pop(rank, None)

    def __call__(self, rank: int, m: int, phase: str) -> float:
        if phase not in ("fwd", "bwd"):
            raise ValueError(
                f"unknown phase {phase!r}; expected 'fwd' or 'bwd'")
        dc = self.cm.per_rank[rank]
        model = dc.t_fwd if phase == "fwd" else dc.t_bwd
        return model.one(m) * self.factors.get(rank, 1.0)


class TelemetryBuffer:
    """Rolling per-rank step/phase timing telemetry.

    Two views of the same measurements: ``(m, seconds)`` sample lists per
    phase (what :func:`~repro_torch.core.profiler.refit_cluster_model`
    consumes) and per-step observed layer seconds per rank (what the
    replan trigger compares against the plan's prediction).
    """

    def __init__(self, n: int, window: int = 16):
        self.n = n
        self.window = window
        self.fwd: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        self.bwd: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        self.layer_seconds: List[np.ndarray] = []   # per step, shape (n,)

    def record_step(self, plan: Plan,
                    samples: Sequence[Tuple[int, int, float, float]]
                    ) -> None:
        """Ingest one step: ``samples`` = (rank, m, t_fwd, t_bwd)."""
        obs = np.zeros(self.n)
        by_rank = {}
        for rank, m, tf, tb in samples:
            self.fwd[rank].append((m, tf))
            self.bwd[rank].append((m, tb))
            self.fwd[rank] = self.fwd[rank][-self.window:]
            self.bwd[rank] = self.bwd[rank][-self.window:]
            by_rank[rank] = (m, tf, tb)
        for r in plan.ranks:
            if r.rank in by_rank:
                _, tf, tb = by_rank[r.rank]
                obs[r.rank] = r.ell * (tf + tb)
        self.layer_seconds.append(obs)
        self.layer_seconds = self.layer_seconds[-self.window:]

    def steps_observed(self) -> int:
        return len(self.layer_seconds)

    def observed_bottleneck(self, last: int = 4) -> float:
        """max_i of the mean per-rank layer seconds over the last steps."""
        if not self.layer_seconds:
            return 0.0
        window = np.stack(self.layer_seconds[-last:])
        return float(window.mean(axis=0).max())


def migrate_state(src: TrainEngine, state: Any, dst: TrainEngine) -> Any:
    """Live state migration between two engines' plans.

    ``src.export_state`` gathers each flat part (params, Adam m/v) into
    substrate-independent model-shaped trees; ``dst.import_state`` lays
    them out on the new plan's uneven shards.  Pure data movement — no
    arithmetic — so the migrated state matches a from-scratch resharding
    of the new plan exactly, optimizer moments and step counter
    included.  Works across plans of different rank counts and across
    substrates (loopback ↔ process fleet), since the interchange format
    is the full tree.
    """
    return dst.import_state(src.export_state(state))


@dataclasses.dataclass
class ReplanEvent:
    """One control-loop decision, for logs / benchmarks / tests.

    ``seconds`` — the host wall seconds of the replan's stages, as far
    as it got: ``probe``, ``refit``, ``solve`` (``auto_solve``), and
    when adopted ``build`` (the new engine; a fleet's respawn),
    ``migrate`` and ``close`` (the old engine), each ended by a device
    synchronise on the card."""

    step: int
    reason: str
    adopted: bool
    observed_layer_s: float
    old_predicted_layer_s: float
    new_predicted_layer_s: float = 0.0
    old_plan: Optional[Plan] = None
    new_plan: Optional[Plan] = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


class ElasticEngine(TrainEngine):
    """A :class:`TrainEngine` that replans itself.

    Wraps an inner engine built by :func:`build_train_step` and runs the
    telemetry → refit → replan → migrate loop around its ``step``.  The
    wrapped engine is swapped between steps; callers hold only the
    (opaque) state, which is migrated in place.
    """

    def __init__(self, cfg: ArchConfig, cost_model: ClusterCostModel,
                 plan: Optional[Plan] = None,
                 batch: Optional[int] = None, *,
                 schedule="layered", substrate: str = "loopback",
                 adam: AdamConfig = AdamConfig(), seq_len: int = 512,
                 device: torch.device | str = "cuda",
                 elastic: ElasticConfig = ElasticConfig(),
                 oracle: Optional[Callable[[int, int, str], float]] = None,
                 **knobs):
        if plan is None:
            if batch is None:
                raise ValueError("need plan= or batch=")
            plan = auto_solve(cost_model, batch)
        assert plan.feasible, plan.infeasible_reason
        self.cfg = cfg
        self.cm = cost_model
        self.batch = plan.global_batch
        self.plan = plan
        self.elastic = elastic
        self.oracle = oracle if oracle is not None \
            else CostModelOracle(cost_model)
        self._mk = dict(schedule=schedule, substrate=substrate, adam=adam,
                        seq_len=seq_len, device=device, **knobs)
        self.engine = build_train_step(cfg, plan, **self._mk)
        self.schedule = self.engine.schedule
        # measurement oracles that talk to live workers (WallClockOracle)
        # attach to the concrete inner engine, here and after every rebuild
        if hasattr(self.oracle, "bind"):
            self.oracle.bind(self.engine)
        self.telemetry = TelemetryBuffer(plan.n, elastic.telemetry_window)
        self.step_count = 0
        self.steps_since_replan = 0
        self.events: List[ReplanEvent] = []

    # --- TrainEngine surface (delegates) -----------------------------------
    def init_state(self, generator: torch.Generator) -> Any:
        return self.engine.init_state(generator)

    def gather_params(self, state: Any) -> Dict[str, Any]:
        return self.engine.gather_params(state)

    def export_state(self, state: Any) -> Dict[str, Any]:
        return self.engine.export_state(state)

    def import_state(self, exported: Dict[str, Any]) -> Any:
        return self.engine.import_state(exported)

    def memory_report(self, state: Any) -> str:
        return self.engine.memory_report(state)

    def simulated_iteration_seconds(self) -> Dict[str, float]:
        return self.engine.simulated_iteration_seconds()

    def close(self) -> None:
        self.engine.close()

    # --- the control loop ---------------------------------------------------
    def step(self, state: Any, big: np.ndarray) -> Tuple[Any, float]:
        """Inner train step + telemetry ingest + (maybe) replan.

        Replanning migrates ``state`` to the new plan before returning,
        so the caller's training loop never observes a layout change.
        """
        state, loss = self.engine.step(state, big)
        self.step_count += 1
        self.steps_since_replan += 1
        self._ingest()
        reason = self._replan_reason()
        if reason:
            state = self._replan(state, reason)
        return state, loss

    def _ingest(self) -> None:
        """Passive telemetry: measure each active rank at its current
        ``m_i`` (free on a real fleet — the step ran anyway)."""
        samples = [(r.rank, r.m,
                    self.oracle(r.rank, r.m, "fwd"),
                    self.oracle(r.rank, r.m, "bwd"))
                   for r in self.plan.ranks if r.b > 0]
        self.telemetry.record_step(self.plan, samples)

    def _predicted_bottleneck(self) -> float:
        """The plan's own per-layer compute prediction (comm excluded on
        both sides of the comparison)."""
        return max((r.t_fwd_s + r.t_bwd_s for r in self.plan.ranks
                    if r.b > 0), default=0.0)

    def _replan_reason(self) -> str:
        e = self.elastic
        if self.telemetry.steps_observed() < e.warmup_steps:
            return ""
        if self.steps_since_replan < e.min_steps_between_replans:
            return ""
        obs = self.telemetry.observed_bottleneck()
        pred = self._predicted_bottleneck()
        if pred > 0 and obs > (1.0 + e.imbalance_threshold) * pred:
            return (f"imbalance: observed bottleneck {obs * 1e3:.2f}ms > "
                    f"{1 + e.imbalance_threshold:.2f}x predicted "
                    f"{pred * 1e3:.2f}ms")
        return ""

    def _probe(self) -> Tuple[List[List[Tuple[int, float]]],
                              List[List[Tuple[int, float]]]]:
        """Active probe: sweep the profiler's m grid on every rank (the
        paper's Sec. 3.1 profile, re-run live), merged with the passive
        window so the fit sees the actually-trained m too."""
        fwd: List[List[Tuple[int, float]]] = []
        bwd: List[List[Tuple[int, float]]] = []
        for rank in range(self.cm.cluster.n):
            ms = [m for m in self.elastic.probe_ms if m <= self.batch]
            fs = [(m, self.oracle(rank, m, "fwd")) for m in ms]
            bs = [(m, self.oracle(rank, m, "bwd")) for m in ms]
            if rank < self.telemetry.n:
                # passive window first so the fresh probe wins the dedupe
                # (stale pre-drift samples at the same m must not survive)
                fs = self.telemetry.fwd[rank] + fs
                bs = self.telemetry.bwd[rank] + bs
            fwd.append(sorted({m: t for m, t in fs}.items()))
            bwd.append(sorted({m: t for m, t in bs}.items()))
        return fwd, bwd

    def _lap(self, seconds: Dict[str, float], stage: str,
             t0: float) -> float:
        """Record ``stage``'s seconds since ``t0`` (after a device
        synchronise on the card); returns the new start."""
        device = torch.device(self._mk["device"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[stage] = now - t0
        return now

    def _rebuild(self, new_cm: ClusterCostModel, new_plan: Plan,
                 state: Any, seconds: Dict[str, float]) -> Any:
        # _mk captures every knob (schedule, device, and a fleet's
        # transport, hub/ring topology, overlap_rounds, sanitize,
        # timeouts), so a replan rebuilds on the same device with the
        # same wiring — a ring fleet stays a ring fleet and an
        # overlapped fleet stays overlapped.
        t0 = time.perf_counter()
        new_engine = build_train_step(self.cfg, new_plan, **self._mk)
        t0 = self._lap(seconds, "build", t0)
        state = migrate_state(self.engine, state, new_engine)
        t0 = self._lap(seconds, "migrate", t0)
        self.engine.close()     # release the old plan's worker fleet
        self._lap(seconds, "close", t0)
        self.engine = new_engine
        self.plan = new_plan
        self.cm = new_cm
        if hasattr(self.oracle, "bind"):
            # re-aim a live-measurement oracle (WallClockOracle) at the
            # new fleet; it re-applies any injected slowdowns so a slow
            # *machine* stays slow across a replan.
            self.oracle.bind(new_engine)
        self.telemetry = TelemetryBuffer(new_plan.n,
                                         self.elastic.telemetry_window)
        self.steps_since_replan = 0
        return state

    def _replan(self, state: Any, reason: str) -> Any:
        seconds: Dict[str, float] = {}
        t0 = time.perf_counter()
        fwd, bwd = self._probe()
        t0 = self._lap(seconds, "probe", t0)
        new_cm = refit_cluster_model(self.cm, fwd, bwd)
        t0 = self._lap(seconds, "refit", t0)
        new_plan = auto_solve(new_cm, self.batch)
        self._lap(seconds, "solve", t0)
        obs_layer = self.telemetry.observed_bottleneck()
        ev = ReplanEvent(step=self.step_count, reason=reason,
                         adopted=False, observed_layer_s=obs_layer,
                         old_predicted_layer_s=self._predicted_bottleneck(),
                         old_plan=self.plan, seconds=seconds)
        if not new_plan.feasible:
            ev.reason += f" | new plan infeasible: {new_plan.infeasible_reason}"
            self.events.append(ev)
            self.steps_since_replan = 0      # hysteresis on failure too
            return state
        # compare like with like: old plan *under the refitted model* vs
        # the new plan's prediction (same model, same Alg. 1 time).
        old_now = evaluate_plan(new_cm, self.plan)["iter_s"]
        gain = 1.0 - new_plan.predicted_iter_s / old_now if old_now else 0.0
        ev.new_predicted_layer_s = max(
            (r.t_fwd_s + r.t_bwd_s for r in new_plan.ranks if r.b > 0),
            default=0.0)
        ev.new_plan = new_plan
        if gain < self.elastic.min_gain:
            ev.reason += f" | not adopted: predicted gain {gain:.1%} < " \
                         f"{self.elastic.min_gain:.1%}"
            self.events.append(ev)
            self.steps_since_replan = 0
            return state
        state = self._rebuild(new_cm, new_plan, state, seconds)
        ev.adopted = True
        self.events.append(ev)
        return state

    # --- rank set changes ----------------------------------------------------
    def on_cluster_change(self, new_cm: ClusterCostModel, state: Any,
                          oracle: Optional[Callable] = None) -> Any:
        """A rank joined or left: solve on the new cluster's cost model
        and migrate immediately (no threshold — the old plan's rank set
        no longer exists).  ``new_cm`` may have any rank count; state
        moves through the full-tree interchange format.

        A replacement :class:`CostModelOracle` carries the old oracle's
        degradation factors over *positionally* (a throttled survivor
        must not read as healthy).  If the change renumbers ranks, pass
        an explicit ``oracle`` — positional carry-over cannot know the
        mapping."""
        if oracle is not None:
            self.oracle = oracle
        elif isinstance(self.oracle, CostModelOracle):
            fresh = CostModelOracle(new_cm)
            fresh.factors = {r: f for r, f in self.oracle.factors.items()
                             if r < new_cm.cluster.n}
            self.oracle = fresh
        seconds: Dict[str, float] = {}
        t0 = time.perf_counter()
        new_plan = auto_solve(new_cm, self.batch)
        self._lap(seconds, "solve", t0)
        if not new_plan.feasible:
            raise ValueError(
                f"no feasible plan on the new cluster: "
                f"{new_plan.infeasible_reason}")
        ev = ReplanEvent(step=self.step_count, reason="cluster change",
                         adopted=True,
                         observed_layer_s=self.telemetry.observed_bottleneck(),
                         old_predicted_layer_s=self._predicted_bottleneck(),
                         old_plan=self.plan, new_plan=new_plan,
                         seconds=seconds)
        state = self._rebuild(new_cm, new_plan, state, seconds)
        self.events.append(ev)
        return state
