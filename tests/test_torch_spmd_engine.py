"""The port's SPMD engine, its migrations and its launcher, on the CPU.

* The SPMD engine (``build_train_step(..., substrate="shard_map")``, gloo
  rank processes) against the JAX ``SpmdEngine`` on 2 fake host devices,
  on the parity matrix's plan (``tests/test_parity_matrix.py:37-45``:
  reduced tiny-llama, seq 16, ranks m/ell/ratio 2/2/0.6 and 1/1/0.4) for
  layered, per_microbatch and interleaved, from the JAX engine's initial
  state: each step's loss within 1e-4, params after the first step within
  2e-4 wherever that Adam step was well conditioned and within lr
  everywhere (``test_torch_spmd.p_close``), and Adam's m, ``(1 - b1) g``,
  within 1e-4 relative (``m_close``).  The same engine against the
  port's loopback engine from the same state: losses within 1e-5,
  params and m after each of two steps as above.
* The collectives each schedule makes, counted as they run: every unit
  gathered once a round and again in the backward's recompute, one
  ReduceScatter per gather; per_microbatch pays ℓ x layered's
  ReduceScatters (the port's ``test_layered_ga_reduces_collective_traffic``).
* The port's ``test_spmd_migration_parity``: shard_map → shard_map with
  other uneven ratios and shard_map → loopback, each bit for bit, and the
  continued step's losses within 1e-4; the elastic engine on the
  shard_map substrate across a cluster change, bit for bit.
* ``--runtime spmd --device cpu`` through the launcher, its checkpoint,
  its geometry; CUDA asked for and absent raises before a process starts.
"""

import multiprocessing
import pickle
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointing as CK
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import device_specs as DS
from repro_torch.core import fsdp
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.engine import (ElasticConfig, ElasticEngine, Mesh,
                                     MpmdEngine, SpmdEngine,
                                     build_train_step, migrate_state)
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import train as launch
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)
from test_torch_spmd import M_TOL, m_close, p_close  # noqa: E402

SCHEDULES = ("layered", "per_microbatch", "interleaved")
RANKS = [("A", 2, 2, 0.6), ("B", 1, 1, 0.4)]
SEQ = 16
LR = 1e-3


def _plan(ranks, batch=None):
    rs = [RankPlan(i, d, m=m, ell=ell, state_ratio=r)
          for i, (d, m, ell, r) in enumerate(ranks)]
    return Plan(model="toy", cluster="toy",
                global_batch=batch or sum(r.b for r in rs), ranks=rs)


def _leaves(tree):
    return [t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in fsdp.tree_flatten(tree)[0]]


def _assert_exports_equal(a, b):
    assert a["step"] == b["step"]
    for part in "pmv":
        xs, ys = _leaves(a[part]), _leaves(b[part])
        assert len(xs) == len(ys) > 0
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _imported(init):
    return {"step": int(init["step"]),
            **{k: params_from_numpy(init[k], "cpu") for k in "pmv"}}


ORACLE = """
import pickle
import jax, numpy as np
from repro.configs.base import get_arch
from repro.core.engine import build_train_step
from repro.core.partition import Plan, RankPlan
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.optim.adam import AdamConfig

RANKS = RANKS_
cfg = get_arch("tiny-llama").reduced()
ranks = [RankPlan(i, d, m=m, ell=ell, state_ratio=r)
         for i, (d, m, ell, r) in enumerate(RANKS)]
plan = Plan(model="toy", cluster="toy",
            global_batch=sum(r.b for r in ranks), ranks=ranks)
stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ_, seed=2))
blocks = [stream.sample(i, plan.global_batch) for i in range(2)]
out = {"blocks": blocks}
for sched in SCHEDULES_:
    eng = build_train_step(cfg, plan, substrate="shard_map", schedule=sched,
                           adam=AdamConfig(lr=LR_), seq_len=SEQ_)
    state = eng.init_state(jax.random.PRNGKey(0))
    out.setdefault("init", jax.device_get(eng.export_state(state)))
    state, l1 = eng.step(state, blocks[0])
    ex = jax.device_get(eng.export_state(state))
    state, l2 = eng.step(state, blocks[1])
    out[sched] = {"losses": [l1, l2],
                  "p1": [np.asarray(a) for a in jax.tree.leaves(ex["p"])],
                  "m1": [np.asarray(a) for a in jax.tree.leaves(ex["m"])],
                  "v1": [np.asarray(a) for a in jax.tree.leaves(ex["v"])]}
pickle.dump(out, open(PATH_, "wb"))
print("ORACLE-OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, subproc):
    path = tmp_path_factory.mktemp("spmd_engine") / "out.pkl"
    code = ORACLE.replace("RANKS_", repr(RANKS)).replace("SEQ_", str(SEQ)) \
        .replace("SCHEDULES_", repr(SCHEDULES)).replace("LR_", repr(LR)) \
        .replace("PATH_", repr(str(path)))
    assert "ORACLE-OK" in subproc(code, n_devices=2, timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


def _run(engine, init, blocks):
    """Two steps from ``init``: losses, the export after the first and
    after the second step, and the SPMD engine's records."""
    with engine:
        state = engine.import_state(_imported(init))
        out = {"losses": [], "records": [], "exports": []}
        for blk in blocks:
            state, loss = engine.step(state, blk)
            out["losses"].append(loss)
            out["records"].append(getattr(engine, "last_step", None))
            out["exports"].append(engine.export_state(state))
    return out


@pytest.fixture(scope="module")
def runs(oracle):
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan(RANKS)
    out = {}
    for sched in SCHEDULES:
        # "auto" with a mesh is the SPMD engine, as in the reference
        eng = build_train_step(cfg, plan, substrate="auto", schedule=sched,
                               adam=AdamConfig(lr=LR), seq_len=SEQ,
                               device="cpu", mesh=Mesh((2,), ("data",)))
        assert isinstance(eng, SpmdEngine)
        out[sched] = {"spmd": _run(eng, oracle["init"], oracle["blocks"])}
        lb = build_train_step(cfg, plan, substrate="auto", schedule=sched,
                              adam=AdamConfig(lr=LR), seq_len=SEQ,
                              device="cpu")
        assert isinstance(lb, MpmdEngine)
        out[sched]["loopback"] = _run(lb, oracle["init"], oracle["blocks"])
    return out


@pytest.mark.parametrize("sched", SCHEDULES)
def test_spmd_engine_against_jax(sched, runs, oracle):
    ref, got = oracle[sched], runs[sched]["spmd"]
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-4, (got["losses"], ref["losses"])
    p1 = _leaves(got["exports"][0]["p"])
    assert len(p1) == len(ref["p1"])
    assert p_close(p1, ref["p1"], ref["v1"], lr=LR) <= 2e-4
    assert m_close(_leaves(got["exports"][0]["m"]), ref["m1"]) <= M_TOL
    assert got["exports"][0]["step"] == 1


@pytest.mark.parametrize("sched", SCHEDULES)
def test_spmd_engine_against_loopback(sched, runs):
    got, ref = runs[sched]["spmd"], runs[sched]["loopback"]
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-5, (got["losses"], ref["losses"])
    for k in (0, 1):
        assert p_close(_leaves(got["exports"][k]["p"]),
                       _leaves(ref["exports"][k]["p"]),
                       _leaves(ref["exports"][k]["v"]),
                       lr=LR * (k + 1)) <= 2e-4
        assert m_close(_leaves(got["exports"][k]["m"]),
                       _leaves(ref["exports"][k]["m"])) <= M_TOL


def _units_per_round(cfg):
    """Units a round gathers in its forward: the embedding, every stage
    element, the misc unit (the head's final norm) and the head; the misc
    unit a second time in the embedding only with learned positions."""
    from repro_torch.core.engine.units import UnitPlanner
    groups = UnitPlanner(cfg, [0.5, 0.5]).groups
    n = sum(g.count for g in groups)
    return n + (1 if cfg.learned_pos else 0)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_collectives_per_schedule(sched, runs):
    """Counted per step on every rank: each round gathers each unit in
    its forward and again in the backward's recompute, and ReduceScatters
    each gather's gradient."""
    from repro_torch.core.engine.schedules import get_schedule
    cfg = get_arch("tiny-llama").reduced()
    rounds = len(get_schedule(sched).chunks(2))
    units = _units_per_round(cfg)
    for records in runs[sched]["spmd"]["records"]:
        for rec in records:
            assert rec["collectives"] == {"all_gather": 2 * rounds * units,
                                          "reduce_scatter": rounds * units,
                                          "all_reduce": 0}
            assert (rec["backend"], rec["staged"], rec["device"]) == \
                ("gloo", False, "cpu")
            assert rec["host_bytes"] == 0 and rec["peak_bytes"] == 0
            assert rec["launches"] == {}


def test_per_microbatch_pays_ell_times_layered_reduce_scatters(runs):
    """Fig. 4/8: with ℓ_pad = 2, the FSDP-GA baseline makes 2x layered
    GA's ReduceScatters and AllGathers; interleaved (rounds of 2) the
    same as layered."""
    def rs(sched):
        return runs[sched]["spmd"]["records"][0][0]["collectives"]
    ell = 2
    assert rs("per_microbatch")["reduce_scatter"] == \
        ell * rs("layered")["reduce_scatter"]
    assert rs("per_microbatch")["all_gather"] == \
        ell * rs("layered")["all_gather"]
    assert rs("interleaved") == rs("layered")


PLAN_A = [("A", 2, 2, 0.5), ("B", 3, 1, 0.25), ("C", 1, 2, 0.125),
          ("D", 1, 1, 0.125)]
PLAN_B = [("A", 3, 2, 0.1), ("B", 2, 1, 0.4), ("C", 1, 1, 0.4),
          ("D", 1, 1, 0.1)]


def test_spmd_migration_parity():
    """shard_map → shard_map with other uneven ratios, and shard_map →
    loopback: the exported (p, m, v, step) bit for bit, and the continued
    step's loss within 1e-4 of the loopback continuation."""
    cfg = get_arch("tiny-llama").reduced()
    stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=5))
    kw = dict(adam=AdamConfig(lr=LR), seq_len=SEQ, device="cpu")
    with build_train_step(cfg, _plan(PLAN_A, 10), substrate="shard_map",
                          **kw) as eng_a:
        state = eng_a.init_state(torch.Generator().manual_seed(0))
        for step in range(2):
            state, _ = eng_a.step(state, stream.sample(step, 10))
        exported = eng_a.export_state(state)
        assert exported["step"] == 2
        assert max(np.abs(x).max() for x in _leaves(exported["m"])) > 0
        with build_train_step(cfg, _plan(PLAN_B, 10), substrate="shard_map",
                              **kw) as eng_b:
            state_b = migrate_state(eng_a, state, eng_b)
            _assert_exports_equal(exported, eng_b.export_state(state_b))
            eng_l = build_train_step(cfg, _plan(PLAN_B, 10),
                                     substrate="loopback", **kw)
            state_l = migrate_state(eng_a, state, eng_l)
            _assert_exports_equal(exported, eng_l.export_state(state_l))
            big = stream.sample(2, 10)
            _, loss_b = eng_b.step(state_b, big)
            _, loss_l = eng_l.step(state_l, big)
    assert abs(loss_b - loss_l) <= 1e-4, (loss_b, loss_l)


def test_elastic_engine_on_shard_map_across_a_cluster_change():
    """ElasticEngine(substrate="shard_map"): a rank leaves, the engine
    re-solves on the three survivors and rebuilds its world; the state
    crosses bit for bit and the next step trains."""
    cfg = get_arch("tiny-llama").reduced()
    batch = 12
    cm4 = analytic_cluster_model(
        DS.Cluster([DS.L4, DS.A6000, DS.P40, DS.P100], 50, "mini"),
        build_model_stats(cfg, SEQ))
    eng = ElasticEngine(cfg, cm4, batch=batch, substrate="shard_map",
                        seq_len=SEQ, device="cpu", elastic=ElasticConfig())
    with eng:
        assert isinstance(eng.engine, SpmdEngine)
        stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=5))
        state = eng.init_state(torch.Generator().manual_seed(0))
        for step in range(2):
            state, _ = eng.step(state, stream.sample(step, batch))
        before = eng.export_state(state)
        cm3 = analytic_cluster_model(
            DS.Cluster([DS.L4, DS.A6000, DS.P40], 50, "mini3"),
            build_model_stats(cfg, SEQ))
        state = eng.on_cluster_change(cm3, state)
        assert eng.plan.n == 3 and isinstance(eng.engine, SpmdEngine)
        assert eng.engine.mesh.size == 3
        _assert_exports_equal(before, eng.export_state(state))
        state, loss = eng.step(state, stream.sample(2, batch))
        assert np.isfinite(loss)
        assert eng.events[-1].reason == "cluster change"


ARGV = ["--arch", "tiny-llama", "--reduced", "--steps", "3", "--batch",
        "12", "--seq", "32", "--runtime", "spmd", "--ell", "2"]


def test_launcher_runtime_spmd_on_the_cpu(capsys):
    """One rank on the CPU (mesh (1, 1)), 3 steps of 2 microbatches of 6;
    the checkpoint holds the exported state after the last step."""
    with tempfile.TemporaryDirectory() as d:
        launch.main(ARGV + ["--device", "cpu", "--checkpoint", d])
        out = capsys.readouterr().out
        assert "spmd: mesh (1, 1) ('data', 'model'), 1 rank(s) on cpu, " \
               "ell 2, m 6, global batch 12" in out
        losses = [float(ln.split()[3]) for ln in out.splitlines()
                  if ln.startswith("step ")]
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert f"saved checkpoint to {d}" in out
        man = CK._read_manifest(d)
        assert man["step"] == 3 and man["meta"]["format"] == "exported"
        plan = Plan.from_json(man["meta"]["plan"])
        assert plan.n == 1 and plan.global_batch == 12


def test_run_spmd_returns_each_steps_record():
    args = launch.parser().parse_args(ARGV + ["--device", "cpu",
                                              "--steps", "2"])
    records = launch.run_spmd(args)
    assert len(records) == 2
    for rec in records:
        assert np.isfinite(rec["loss"]) and rec["step_ms"] > 0
        assert len(rec["ranks"]) == 1
        assert rec["ranks"][0]["loss"] == rec["loss"]


@pytest.mark.parametrize("cards,shape,m", [(1, (1, 1), 8), (4, (2, 2), 2),
                                           (3, (3, 1), 2), (8, (4, 2), 1)])
def test_spmd_world_geometry(cards, shape, m, monkeypatch):
    """As the reference sizes its mesh from the device count: (n//2, 2)
    for an even count, (n, 1) for an odd one; batch // n // ell rows a
    microbatch."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = launch.parser().parse_args(["--arch", "tiny-llama", "--batch",
                                       "16", "--ell", "2", "--runtime",
                                       "spmd"])
    mesh, plan = launch.spmd_world(args)
    assert mesh.shape == shape and mesh.axis_names == ("data", "model")
    assert plan.n == cards
    assert {(r.ell, r.m) for r in plan.ranks} == {(2, m)}


def test_shard_map_refuses_before_any_process_starts():
    """CUDA asked for and absent, or a mesh that does not fit the plan,
    raise before a rank process exists."""
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan(RANKS)
    before = len(multiprocessing.active_children())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_train_step(cfg, plan, substrate="shard_map", seq_len=SEQ)
    with pytest.raises(ValueError, match="mesh"):
        build_train_step(cfg, plan, substrate="shard_map", seq_len=SEQ,
                         device="cpu", mesh=Mesh((3,), ("data",)))
    with pytest.raises(ValueError, match="ratios"):
        build_train_step(cfg, plan, substrate="shard_map", seq_len=SEQ,
                         device="cpu", mesh=Mesh((1, 2), ("data", "model")),
                         state_axes=("data",))
    assert len(multiprocessing.active_children()) == before
