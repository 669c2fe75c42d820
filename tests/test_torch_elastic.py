"""The port's elastic runtime (``core/engine/elastic.py``) against the JAX
package's, on the CPU.

* ``CostModelOracle`` answers every (rank, m, phase) of the mini cluster
  with the reference's seconds; ``degrade``/``restore`` scale and unscale
  a rank; a phase other than fwd/bwd raises.
* ``TelemetryBuffer``: the same sample windows, per-step layer seconds
  and ``observed_bottleneck`` as the reference's on seeded samples, the
  window trimmed.
* ``migrate_state`` between loopback plans (3 ranks to 2) after 2 steps:
  the export round-trips exactly, the shards equal ``shard_state`` of the
  export, and the next step continues.
* The control loop on reduced tiny-llama, mini cluster, seq 32, batch 48,
  the largest-b rank 3x slower from step 2, 7 steps, from the same
  params (the reference engine's init, carried across through numpy):
  the same replan events (step, adopted, reason, old and new plan), the
  same refit model, losses within 1e-5, the step counter at 7, and the
  adopted plan within 10% of the fresh optimum under the degraded model
  (``tests/test_elastic_engine.py``'s gate).  A healthy cluster never
  replans.
* ``on_cluster_change``: the reference's plan, params bit for bit across
  it, and the oracle's factors carried over by position.
* ``build_train_step``'s elastic arguments.
* Fault 6: on a shared device the ``WallClockOracle`` refits a 3x
  straggler at 3x from probes in turns.  Fault 7: the launcher profiles
  a fleet's first plan as the oracle probes (``_best_seconds`` warms up
  for ``warmup_s``), and the fleet phase's straggler moves the plan on
  two H100s on NVLink, where on Cluster A's link every plan ties.
* A two-process ring fleet on wall-clock telemetry
  (``tests/test_multiproc.py``'s elastic cycle): rank 0 8x slower, an
  adopted replan that sheds its batch, and training that continues; a
  loopback engine that takes the same blocks and migrates to the same
  plans at the same steps ends with the fleet's losses and state, bit
  for bit.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_arch
from repro.core import device_specs as JD
from repro.core.cost_model import analytic_cluster_model as jax_cluster_model
from repro.core.engine import build_train_step as jax_build
from repro.core.engine import elastic as jax_elastic
from repro.core.model_stats import build_model_stats as jax_stats
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import device_specs as D
from repro_torch.core import fsdp
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.engine import (CostModelOracle, ElasticConfig,
                                     ElasticEngine, TelemetryBuffer,
                                     WallClockOracle, build_train_step,
                                     migrate_state)
from repro_torch.core.engine.elastic import PROBE_MS
from repro_torch.core.engine.multiproc import (SHARED_PROBE_REPEATS,
                                               SHARED_PROBE_TURNS,
                                               SHARED_PROBE_WARMUP_S)
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.core.planner import auto_solve, evaluate_plan
from repro_torch.core.profiler import (refit_cluster_model,
                                       wallclock_cluster_model)
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

MINI = [("L4", "A6000", "P40", "P100"), ("L4", "A6000", "P40")]


def _cms(arch, seq, names=MINI[0]):
    """The port's and the reference's analytic cost models of a mini
    cluster of ``names``."""
    out = []
    for dmod, build, stats, a in ((D, analytic_cluster_model,
                                   build_model_stats, get_arch),
                                  (JD, jax_cluster_model, jax_stats,
                                   jax_arch)):
        cluster = dmod.Cluster([getattr(dmod, n) for n in names], 50,
                               f"mini{len(names)}")
        out.append(build(cluster, stats(a(arch).reduced(), seq)))
    return out


def _plan(ranks_spec, batch):
    return Plan(model="toy", cluster="toy", global_batch=batch,
                ranks=[RankPlan(i, d, m=m, ell=ell, state_ratio=r)
                       for i, (d, m, ell, r) in enumerate(ranks_spec)])


def _leaves(tree):
    return [t.numpy() for t in fsdp.tree_flatten(tree)[0]]


def _assert_exports_equal(a, b):
    assert a["step"] == b["step"]
    for part in ("p", "m", "v"):
        xs, ys = _leaves(a[part]), _leaves(b[part])
        assert len(xs) == len(ys) > 0
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y, err_msg=part)


def _jax_init_into(jeng, eng):
    """The reference engine's init state, and the same state laid out on
    the port's engine (through numpy)."""
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(jeng.export_state(jstate))
    return jstate, eng.import_state({"step": init["step"], **{
        k: params_from_numpy(init[k], "cpu") for k in "pmv"}})


# --- oracle and telemetry ------------------------------------------------------

def test_cost_model_oracle_matches_reference():
    cm, jcm = _cms("tiny-llama", 16)
    oracle, joracle = CostModelOracle(cm), jax_elastic.CostModelOracle(jcm)
    for rank in range(4):
        for m in range(0, 13):
            for phase in ("fwd", "bwd"):
                assert oracle(rank, m, phase) == joracle(rank, m, phase)
    base = oracle(2, 4, "bwd")
    oracle.degrade(2, 3.0)
    joracle.degrade(2, 3.0)
    assert oracle.factors == joracle.factors == {2: 3.0}
    assert oracle(2, 4, "bwd") == joracle(2, 4, "bwd") == 3.0 * base
    assert oracle(1, 4, "bwd") == joracle(1, 4, "bwd")
    oracle.restore(2)
    oracle.restore(3)           # restoring a healthy rank is a no-op
    assert oracle.factors == {} and oracle(2, 4, "bwd") == base
    with pytest.raises(ValueError, match="phase"):
        oracle(0, 2, "backward")


def test_telemetry_buffer_matches_reference():
    cm, jcm = _cms("tiny-llama", 32)
    plan, jplan = auto_solve(cm, 48), jax_elastic.auto_solve(jcm, 48)
    assert plan.to_json() == jplan.to_json()
    rng = np.random.default_rng(7)
    buf = TelemetryBuffer(plan.n, window=3)
    jbuf = jax_elastic.TelemetryBuffer(jplan.n, window=3)
    for step in range(6):
        # a sample for every rank with work, one rank left out at step 4
        samples = [(r.rank, r.m, float(rng.uniform(1e-3, 5e-3)),
                    float(rng.uniform(2e-3, 9e-3)))
                   for r in plan.ranks if r.b > 0 or step % 2
                   if not (step == 4 and r.rank == 1)]
        buf.record_step(plan, samples)
        jbuf.record_step(jplan, samples)
        assert buf.fwd == jbuf.fwd and buf.bwd == jbuf.bwd
        assert len(buf.layer_seconds) == min(step + 1, 3)
        for got, want in zip(buf.layer_seconds, jbuf.layer_seconds):
            np.testing.assert_array_equal(got, want)
        for last in (1, 2, 4):
            assert buf.observed_bottleneck(last) == \
                jbuf.observed_bottleneck(last)
        assert buf.steps_observed() == jbuf.steps_observed()
    assert all(len(s) <= 3 for s in buf.fwd + buf.bwd)
    assert TelemetryBuffer(2).observed_bottleneck() == 0.0


# --- migration ------------------------------------------------------------------

def test_loopback_migration_is_exact():
    cfg = get_arch("tiny-llama").reduced()
    seq = 16
    plan_a = _plan([("A", 2, 2, 0.5), ("B", 3, 1, 0.25), ("C", 1, 2, 0.25)],
                   batch=9)
    plan_b = _plan([("A", 3, 2, 0.7), ("B", 3, 1, 0.3)], batch=9)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=2))
    mk = dict(substrate="loopback", adam=AdamConfig(lr=1e-3), seq_len=seq,
              device="cpu")
    eng_a = build_train_step(cfg, plan_a, **mk)
    state = eng_a.init_state(torch.Generator().manual_seed(0))
    for step in range(2):
        state, _ = eng_a.step(state, stream.sample(step, 9))
    eng_b = build_train_step(cfg, plan_b, **mk)
    state_b = migrate_state(eng_a, state, eng_b)

    exported = eng_a.export_state(state)
    assert exported["step"] == 2
    assert max(np.abs(x).max() for x in _leaves(exported["m"])) > 0
    # (1) the round trip through the new plan's layouts is exact
    _assert_exports_equal(exported, eng_b.export_state(state_b))
    # (2) each rank's shards equal a from-scratch reshard of the export
    scratch = eng_b.trainer.substrate.shard_state(
        exported["p"], exported["m"], exported["v"])
    for r in range(plan_b.n):
        assert state_b[r]["step"] == 2
        for g in eng_b.trainer.groups:
            for part in ("p", "m", "v"):
                assert torch.equal(state_b[r][g.name][part],
                                   scratch[r][g.name][part])
    # (3) training continues: the same global step (Eq. 1) on either plan
    big = stream.sample(2, 9)
    state_b, loss_b = eng_b.step(state_b, big)
    _, loss_a = eng_a.step(state, big)
    assert np.isfinite(loss_b) and abs(loss_b - loss_a) < 1e-4
    assert eng_b.export_state(state_b)["step"] == 3


# --- the control loop --------------------------------------------------------------

def _elastic_pair(arch, seq, batch, names=MINI[0], **ecfg):
    """The port's and the reference's elastic loopback engines on the
    mini cluster's plan, each with its CostModelOracle, from the same
    params."""
    cm, jcm = _cms(arch, seq, names)
    ecfg = dict(warmup_steps=1, min_steps_between_replans=1, **ecfg)
    oracle, joracle = CostModelOracle(cm), jax_elastic.CostModelOracle(jcm)
    plan, jplan = auto_solve(cm, batch), jax_elastic.auto_solve(jcm, batch)
    assert plan.feasible and plan.to_json() == jplan.to_json()
    eng = build_train_step(
        get_arch(arch).reduced(), plan, substrate="loopback",
        adam=AdamConfig(lr=1e-3), seq_len=seq, device="cpu",
        cost_model=cm, oracle=oracle, elastic=ElasticConfig(**ecfg))
    jeng = jax_build(
        jax_arch(arch).reduced(), jplan, substrate="loopback",
        adam=jax_elastic.AdamConfig(lr=1e-3), seq_len=seq,
        cost_model=jcm, oracle=joracle,
        elastic=jax_elastic.ElasticConfig(**ecfg))
    assert isinstance(eng, ElasticEngine)
    return (eng, oracle, plan), (jeng, joracle, jplan)


def _event_key(ev):
    return (ev.step, ev.adopted, ev.reason,
            ev.old_plan.to_json() if ev.old_plan else None,
            ev.new_plan.to_json() if ev.new_plan else None)


def _same_model(a, b):
    for x, y in zip(a.per_rank, b.per_rank):
        for lm, jlm in ((x.t_fwd, y.t_fwd), (x.t_bwd, y.t_bwd)):
            np.testing.assert_array_equal(lm._m, jlm._m)
            np.testing.assert_array_equal(lm._t, jlm._t)
            assert (lm._t0, lm._t1) == (jlm._t0, jlm._t1)


def test_straggler_replan_matches_reference():
    seq, batch = 32, 48
    (eng, oracle, plan0), (jeng, joracle, _) = _elastic_pair(
        "tiny-llama", seq, batch)
    straggler = max(plan0.ranks, key=lambda r: r.b).rank
    factor = 3.0
    stream = SyntheticStream(DataConfig(eng.cfg.vocab_size, seq, seed=3))
    jstate, state = _jax_init_into(jeng, eng)
    losses, jlosses = [], []
    for step in range(7):
        if step == 2:
            assert not eng.events and not jeng.events
            oracle.degrade(straggler, factor)
            joracle.degrade(straggler, factor)
        big = stream.sample(step, batch)
        state, loss = eng.step(state, big)
        jstate, jloss = jeng.step(jstate, big)
        losses.append(loss)
        jlosses.append(jloss)
    assert [_event_key(e) for e in eng.events] == \
        [_event_key(e) for e in jeng.events]
    assert any(e.adopted for e in eng.events)
    assert eng.plan.to_json() == jeng.plan.to_json()
    assert eng.plan.ranks[straggler].b < plan0.ranks[straggler].b
    _same_model(eng.cm, jeng.cm)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    assert all(np.isfinite(losses))
    adopted = next(e for e in eng.events if e.adopted)
    assert {"probe", "refit", "solve", "build", "migrate", "close"} <= \
        set(adopted.seconds)
    # the refit reflects the degradation (refit == truth: the oracle was
    # probed after it, on the profiler's grid)
    assert eng.cm.per_rank[straggler].t_fwd.one(4) == pytest.approx(
        factor * oracle.cm.per_rank[straggler].t_fwd.one(4), rel=1e-6)
    grid = [m for m in PROBE_MS if m <= batch]
    true_cm = refit_cluster_model(
        oracle.cm,
        [[(m, oracle(r, m, "fwd")) for m in grid] for r in range(4)],
        [[(m, oracle(r, m, "bwd")) for m in grid] for r in range(4)])
    fresh = auto_solve(true_cm, batch)
    post = evaluate_plan(true_cm, eng.plan)
    assert post["throughput"] >= 0.9 * fresh.predicted_throughput
    assert eng.export_state(state)["step"] == eng.step_count == 7


def test_healthy_cluster_never_churns():
    cm, _ = _cms("tiny-llama", 16)
    eng = build_train_step(
        get_arch("tiny-llama").reduced(), auto_solve(cm, 12),
        substrate="loopback", adam=AdamConfig(lr=1e-3), seq_len=16,
        device="cpu", cost_model=cm,
        elastic=ElasticConfig(warmup_steps=1, min_steps_between_replans=1))
    stream = SyntheticStream(DataConfig(eng.cfg.vocab_size, 16, seed=4))
    state = eng.init_state(torch.Generator().manual_seed(0))
    for step in range(5):
        state, _ = eng.step(state, stream.sample(step, 12))
    assert eng.events == [] and eng.step_count == 5


def test_cluster_change_matches_reference():
    seq, batch = 16, 12
    (eng, oracle, _), (jeng, joracle, _) = _elastic_pair(
        "tiny-llama", seq, batch)
    stream = SyntheticStream(DataConfig(eng.cfg.vocab_size, seq, seed=5))
    jstate, state = _jax_init_into(jeng, eng)
    for step in range(2):
        state, _ = eng.step(state, stream.sample(step, batch))
        jstate, _ = jeng.step(jstate, stream.sample(step, batch))
    # a throttled survivor (rank 1) and a throttled leaver (rank 3)
    for o in (oracle, joracle):
        o.degrade(1, 2.0)
        o.degrade(3, 5.0)
    before = eng.export_state(state)
    cm3, jcm3 = _cms("tiny-llama", seq, MINI[1])
    state = eng.on_cluster_change(cm3, state)
    jstate = jeng.on_cluster_change(jcm3, jstate)
    assert eng.plan.n == 3
    assert eng.plan.to_json() == jeng.plan.to_json()
    assert _event_key(eng.events[-1]) == _event_key(jeng.events[-1])
    assert eng.events[-1].reason == "cluster change"
    assert isinstance(eng.oracle, CostModelOracle)
    assert eng.oracle is not oracle and eng.oracle.cm is cm3
    assert eng.oracle.factors == jeng.oracle.factors == {1: 2.0}
    _assert_exports_equal(before, eng.export_state(state))
    state, loss = eng.step(state, stream.sample(2, batch))
    assert np.isfinite(loss)


@pytest.mark.parametrize("kwargs,match", [
    (dict(elastic=True), "cost_model"),
    (dict(elastic=ElasticConfig()), "cost_model"),
    (dict(cost_model="cm"), "only apply with elastic"),
    (dict(oracle=CostModelOracle(None)), "only apply with elastic"),
    (dict(elastic=False, cost_model="cm"), "only apply with elastic")])
def test_build_train_step_elastic_arguments(kwargs, match):
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan([("A", 2, 1, 1.0)], batch=2)
    with pytest.raises(ValueError, match=match):
        build_train_step(cfg, plan, substrate="loopback", seq_len=16,
                         device="cpu", **kwargs)


def test_elastic_engine_needs_a_plan_or_batch():
    cm, _ = _cms("tiny-llama", 16)
    with pytest.raises(ValueError, match="plan= or batch="):
        ElasticEngine(get_arch("tiny-llama").reduced(), cm, device="cpu")
    eng = ElasticEngine(get_arch("tiny-llama").reduced(), cm, batch=12,
                        seq_len=16, device="cpu")
    assert eng.plan.to_json() == auto_solve(cm, 12).to_json()
    assert eng.schedule.name == "layered"


# --- the process fleet, on wall-clock telemetry ------------------------------------

def _replay(cfg, plan0, events, blocks, seq):
    """The loopback engine on ``plan0``, migrated after each adopted
    event's step to its new plan: the losses and the final export."""
    mk = dict(substrate="loopback", adam=AdamConfig(lr=1e-3), seq_len=seq,
              device="cpu")
    eng = build_train_step(cfg, plan0, **mk)
    state = eng.init_state(torch.Generator().manual_seed(0))
    moves = {ev.step: ev.new_plan for ev in events if ev.adopted}
    losses = []
    for i, big in enumerate(blocks):
        state, loss = eng.step(state, big)
        losses.append(loss)
        if i + 1 in moves:
            new = build_train_step(cfg, moves[i + 1], **mk)
            state = migrate_state(eng, state, new)
            eng = new
    return losses, eng.export_state(state)


@pytest.fixture
def one_thread():
    """One intra-op thread in this process and so in each worker (a
    fleet's workers take the coordinator's count): with several, two
    workers and the test runner oversubscribe the cores and the CPU's
    reductions need not repeat bit for bit from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _SharedCardFleet:
    """A fleet's wall-clock surface without processes.  An isolated probe
    takes ``base(m, phase)`` times the rank's injected slowdown, and
    ``cold`` times that right after a probe of another, slowed rank (its
    sleep leaves the card and host the workers share idle); the passive
    samples of the last step read ``inflate`` times the base (taken
    right after a step on a device the other worker has just used)."""

    def __init__(self, plan, inflate, cold):
        self.n = plan.n
        self.cold = cold
        self.slow, self.calls, self.last = {}, [], None
        self.last_step_samples = {
            r.rank: (r.m, inflate * self._base(r.m, "fwd"),
                     inflate * self._base(r.m, "bwd"))
            for r in plan.ranks}

    @staticmethod
    def _base(m, phase):
        return (1e-3 + 5e-4 * m) * (1.0 if phase == "fwd" else 2.0)

    def probe(self, rank, m, phase, repeats=2, warmup_s=0.0):
        self.calls.append((rank, m, phase, repeats, warmup_s))
        t = self._base(m, phase) * self.slow.get(rank, 1.0)
        if self.last not in (None, rank) and self.slow.get(self.last, 1) > 1:
            t *= self.cold
        self.last = rank
        return t

    def inject_slowdown(self, rank, factor):
        self.slow[rank] = factor


def _refit_ratio(oracle, plan, cm):
    """The control loop's ingest (twice), probe sweep and refit
    (``ElasticEngine._ingest``, ``_probe``, ``refit_cluster_model``) with
    ``oracle``: rank 0's refit t_fwd(1) over rank 1's."""
    from types import SimpleNamespace
    loop = SimpleNamespace(
        oracle=oracle, plan=plan, cm=cm, batch=plan.global_batch,
        elastic=ElasticConfig(), telemetry=TelemetryBuffer(plan.n, 16))
    for _ in range(2):
        ElasticEngine._ingest(loop)
    fwd, bwd = ElasticEngine._probe(loop)
    refit = refit_cluster_model(cm, fwd, bwd)
    return refit.per_rank[0].t_fwd.one(1) / refit.per_rank[1].t_fwd.one(1)


def test_shared_device_refit_sees_the_slowdown():
    """Fault 6 of the port: two workers on one card, rank 0 3x slower,
    passive samples inflated 2x, a probe right after the straggler's
    1.6x slow.  The refit must give rank 0 3x rank 1
    (within 10%): every query warmed-up probes of 5 passes, taken in
    turns with the other rank's at the same m, so no rank's best is its
    probe right after the straggler's.  Probing rank by rank, as the
    control loop asks, reads rank 1's first probe slow (below 2x)."""
    cm, _ = _cms("tiny-llama", 16, ("L4", "A6000"))
    plan = _plan([("L4", 4, 1, 0.5), ("A6000", 1, 1, 0.5)], 5)
    fleet = _SharedCardFleet(plan, inflate=2.0, cold=1.6)
    oracle = WallClockOracle()
    oracle.bind(fleet)
    oracle.degrade(0, 3.0)
    ratio = _refit_ratio(oracle, plan, cm)
    assert ratio == pytest.approx(3.0, rel=0.1)
    assert {c[3:] for c in fleet.calls} == {(SHARED_PROBE_REPEATS,
                                             SHARED_PROBE_WARMUP_S)}
    # each (m, phase) in SHARED_PROBE_TURNS turns: 0, 1, 1, 0, ...
    assert [c[0] for c in fleet.calls[:2 * SHARED_PROBE_TURNS]] == \
        [0, 1, 1, 0] * (SHARED_PROBE_TURNS // 2)

    def rank_by_rank(rank, m, phase):
        return fleet.probe(rank, m, phase)
    assert _refit_ratio(rank_by_rank, plan, cm) < 2.0


def test_fleet_profile_is_measured_as_the_probes_are(monkeypatch):
    """Fault 7: the launcher solves a fleet's first plan from samples
    taken as the ``WallClockOracle`` takes its probes, since the elastic
    trigger holds those probes against the plan's prediction; and
    ``--cluster h100`` plans the fleet for H100s."""
    from repro_torch.core import profiler
    from repro_torch.launch import train as launch
    seen = {}
    real = profiler.wallclock_cluster_model

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **{**kwargs, "ms": (1, 2), "repeats": 1})
    monkeypatch.setattr(profiler, "wallclock_cluster_model", spy)
    args = launch.parser().parse_args([
        "--arch", "tiny-llama", "--reduced", "--seq", "16", "--batch", "8",
        "--cluster", "h100", "--substrate", "multiproc", "--nprocs", "2",
        "--device", "cpu"])
    _, plan, cm = launch.solve_plan(args)
    assert seen["repeats"] == SHARED_PROBE_REPEATS * SHARED_PROBE_TURNS
    assert seen["warmup_s"] == SHARED_PROBE_WARMUP_S
    assert [d.name for d in cm.cluster.devices] == ["H100", "H100"]
    assert plan.feasible


def test_best_seconds_warms_up_for_warmup_s():
    from repro_torch.core import profiler
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.002)
    profiler._best_seconds(fn, torch.device("cpu"), 3, warmup_s=0.05)
    assert calls[-3] - calls[0] >= 0.05
    before = len(calls)
    profiler._best_seconds(fn, torch.device("cpu"), 3)
    assert len(calls) - before == 4


def test_fleet_probes_time_the_device_alone(monkeypatch):
    """Fault 8: on one card two unslowed workers' probes at m 1 read up to
    35% apart (the refit of a 3x straggler 2.2x against the 2x gate): a
    layer at m 1 is bound by its launches, and CUDA events around a pass
    read the host the fleet's processes share.  The cause is the card's
    launch queue, which the CPU does not have; what is checked here is
    that every measurement the oracle and the fleet's first plan rest on
    asks for queued timing (the device's work alone), and the queued
    timer's wait: doubled until the host has enqueued the whole call
    before it ends, refused for a call that waits on the host."""
    from repro_torch.core import profiler
    from repro_torch.core.engine import multiproc as MP
    from repro_torch.launch import train as launch

    sent = []

    class _Sub:
        def request(self, rank, tag, meta):
            sent.append((rank, tag, meta))
            return {"seconds": 1e-3}, {}

    class _Engine:
        n, substrate = 2, _Sub()

    MP.ProcessEngine.probe(_Engine(), 1, 4, "fwd", repeats=5,
                           warmup_s=0.02)
    assert sent[-1] == (1, "probe", {"m": 4, "phase": "fwd", "repeats": 5,
                                     "warmup_s": 0.02})
    timed = []
    monkeypatch.setattr(profiler, "_best_seconds",
                        lambda fn, dev, repeats, warmup_s, queued:
                        timed.append(queued) or 1e-3)

    class _Worker:
        slowdown, device = 1.0, torch.device("cpu")

        def _probe_fn(self, phase, m):
            return lambda: None
    MP._Worker.probe(_Worker(), 2, "bwd", 5, 0.02)
    assert timed == [True]
    seen = {}
    monkeypatch.setattr(profiler, "wallclock_cluster_model",
                        lambda *a, **kw: seen.update(kw) or 1 / 0)
    args = launch.parser().parse_args([
        "--arch", "tiny-llama", "--reduced", "--seq", "16", "--batch", "8",
        "--cluster", "h100", "--substrate", "multiproc", "--nprocs", "2",
        "--device", "cpu"])
    with pytest.raises(ZeroDivisionError):
        launch.solve_plan(args)
    assert seen["queued"] is True

    # the queued timer on a stand-in for the card's stream: the host's
    # enqueue of the call outlasts the first two waits
    waits, state = [], {"left": 2}

    class _Event:
        def __init__(self, enable_timing=False):
            self.timing = enable_timing

        def record(self):
            pass

        def query(self):
            state["left"] -= 1
            return state["left"] >= 0

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 0.25

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "_sleep", waits.append)
    seconds, cycles = profiler._queued_call_seconds(lambda: None, 1000)
    assert (seconds, cycles) == (0.25e-3, 4000)
    assert waits == [1000, 2000, 4000]
    state["left"] = 10 ** 9
    with pytest.raises(RuntimeError, match="synchronises with the host"):
        profiler._queued_call_seconds(lambda: None,
                                      profiler.QUEUE_MAX_CYCLES // 2)


def _flat_cm(cluster, cfg, seq, slow=None):
    """A cost model whose every rank is launch-bound as gpt-1.3b's layer
    reads on one H100 (~2.4 ms forward, ~6 ms forward and backward at m
    1 to 8, the fleet phase's profile), rank ``r`` ``slow[r]`` times
    slower."""
    from repro_torch.core.cost_model import (ClusterCostModel, CommModel,
                                             DeviceCost, LatencyModel)
    from repro_torch.core.profiler import PROFILE_MS, analytic_memory
    per = []
    for i, spec in enumerate(cluster.devices):
        k = (slow or {}).get(i, 1.0)
        tf = LatencyModel(PROFILE_MS, [k * (2.4 + 0.05 * m) * 1e-3
                                       for m in PROFILE_MS])
        tb = LatencyModel(PROFILE_MS, [k * (6.0 + 0.15 * m) * 1e-3
                                       for m in PROFILE_MS])
        per.append(DeviceCost(spec, tf, tb, analytic_memory(cfg, seq), None))
    comm = CommModel(link_gbps=cluster.link_gbps * cluster.link_efficiency,
                     n=cluster.n)
    return ClusterCostModel(cluster, build_model_stats(cfg, seq), per, comm)


def test_fleet_phase_straggler_moves_the_plan_only_on_its_own_link():
    """Fault 7's input: gpt-1.3b on 4 layers, seq 512, batch 16, two
    ranks, rank 0 three times slower.  On Cluster A's 50 Gbps link the
    plan's layer time is its AllGathers and ReduceScatter (every plan
    whose compute fits under them ties, so which one is solved varies
    with the profile); on two H100s on NVLink the plan is compute-bound
    and even, the straggler crosses the trigger, and the re-solved plan
    sheds rank 0 with a gain above ``min_gain``."""
    import dataclasses
    from repro_torch.launch.train import CLUSTERS
    cfg = dataclasses.replace(get_arch("gpt-1.3b"), n_layers=4)
    seq, batch, e = 512, 16, ElasticConfig()

    def pair(name):
        c = CLUSTERS[name]()
        return dataclasses.replace(c, devices=list(c.devices[:2]))
    cm = _flat_cm(pair("cluster-a"), cfg, seq)
    plan = auto_solve(cm, batch)
    ag, rs = cm.ag_latency(False), cm.rs_latency(False)
    assert plan.predicted_layer_s == pytest.approx(2 * ag + rs)
    assert all(r.t_fwd_s < ag and r.t_bwd_s < ag + rs for r in plan.ranks)

    cm = _flat_cm(pair("h100"), cfg, seq)
    plan = auto_solve(cm, batch)
    assert [r.b for r in plan.ranks] == [8, 8]
    pred = max(r.t_fwd_s + r.t_bwd_s for r in plan.ranks)
    assert plan.predicted_layer_s == pytest.approx(pred)
    slow = _flat_cm(pair("h100"), cfg, seq, slow={0: 3.0})
    r0 = plan.ranks[0]
    observed = r0.ell * (slow.per_rank[0].t_fwd.one(r0.m)
                         + slow.per_rank[0].t_bwd.one(r0.m))
    assert observed > (1 + e.imbalance_threshold) * pred
    new = auto_solve(slow, batch)
    gain = 1 - new.predicted_iter_s / evaluate_plan(slow, plan)["iter_s"]
    assert new.ranks[0].b < plan.ranks[0].b and gain >= e.min_gain


def test_wallclock_straggler_replans_the_ring_fleet(one_thread):
    cfg = get_arch("tiny-llama").reduced()
    seq, batch = 16, 8
    cluster = D.Cluster([D.L4, D.L4], 50, "mini2")
    cm = wallclock_cluster_model(cluster, cfg, seq, ms=(1, 2), repeats=1,
                                 device="cpu")
    plan = auto_solve(cm, batch)
    assert plan.feasible, plan.infeasible_reason
    oracle = WallClockOracle()
    eng = build_train_step(
        cfg, plan, substrate="multiproc", topology="ring", sanitize=True,
        adam=AdamConfig(lr=1e-3), seq_len=seq, device="cpu",
        cost_model=cm, oracle=oracle,
        elastic=ElasticConfig(warmup_steps=1, min_steps_between_replans=1,
                              probe_ms=(1, 2)))
    assert isinstance(eng, ElasticEngine)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=3))
    blocks, losses = [], []
    with eng:
        state = eng.init_state(torch.Generator().manual_seed(0))
        # a big slowdown dominates host noise; 12 steps bound the loop
        oracle.degrade(0, 8.0)
        for step in range(12):
            blocks.append(stream.sample(step, batch))
            state, loss = eng.step(state, blocks[-1])
            losses.append(loss)
            if any(ev.adopted for ev in eng.events):
                break
        assert any(ev.adopted for ev in eng.events), \
            f"no adopted replan; events: {[e.reason for e in eng.events]}"
        # the refit models the actually-slow process as slower
        assert eng.cm.per_rank[0].t_fwd.one(1) > \
            2.0 * eng.cm.per_rank[1].t_fwd.one(1)
        assert eng.plan.ranks[0].b < plan.ranks[0].b
        assert eng.engine.topology == "ring" and eng.engine.sanitize
        assert oracle.engine is eng.engine
        # training continues on the respawned fleet
        blocks.append(stream.sample(len(blocks), batch))
        state, loss = eng.step(state, blocks[-1])
        losses.append(loss)
        assert np.isfinite(losses).all()
        exported = eng.export_state(state)
    assert exported["step"] == len(blocks)
    want_losses, want = _replay(cfg, plan, eng.events, blocks, seq)
    assert losses == want_losses
    _assert_exports_equal(exported, want)
