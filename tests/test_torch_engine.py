"""The port's MPMD loopback runtime against the JAX package's, on the CPU.

* Plan, schedules and data: the port's copies give the same
  ``Schedule.chunks``, ``SyntheticStream`` blocks and padded grids.
* Layout: shard sizes and flat buffers equal the reference's, element by
  element, for the parity-matrix plan's ratios and the ratio vectors of
  ``tests/test_layout_properties.py`` (uneven, a zero-size rank, one rank).
* Engine: the parity-matrix plan (``tests/test_parity_matrix.py:37-45``) ×
  {layered, per_microbatch, interleaved}, 2 steps on reduced tiny-llama
  from the same params: per-step losses within 1e-5, exported ``m`` and
  ``v`` within 1e-4 of their max, collective counts equal.  ``p`` is held
  to 1e-5 after the first step wherever that Adam step was well
  conditioned, and to lr per step everywhere.  Adam divides m by
  sqrt(v) + 1e-8, so where a grad is near 1e-8 an fp32-level difference
  of the grad moves p by a fraction of lr (one w_down element: grad 3e-9
  here, 7e-9 there, p 1.9e-4 apart at lr 1e-3), and the second step's
  grads are taken at those params.  Well conditioned: the reference's
  sqrt(v_hat) >= 1e-6, 100x Adam's eps.  Elements with no grad yet
  (unseen tokens' embedding rows) must not move at all.
* mamba2-370m (SSM stages): the units' leaf order, shapes, shard sizes
  and flat buffers equal the reference's, reduced and at full width, for
  the parity-matrix ratios and those of the Cluster A plan at seq 2048,
  batch 32; 2 loopback steps of reduced mamba2 from the same params:
  losses within 1e-5, ``m`` and ``v`` within 1e-4 of their max.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_arch
from repro.core.engine import build_train_step as jax_build
from repro.core.engine import schedules as jax_schedules
from repro.core.engine.substrate import LoopbackSubstrate as JaxSubstrate
from repro.core.engine.units import UnitPlanner as JaxPlanner
from repro.core.partition import Plan as JaxPlan
from repro.core.partition import RankPlan as JaxRankPlan
from repro.data import pipeline as jax_pipeline
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdam
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.engine import (LoopbackSubstrate, Mesh,
                                     MultiProcessSubstrate,
                                     UnitPlanner, build_train_step,
                                     get_schedule, homogeneous_plan,
                                     list_schedules)
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

SCHEDULES = ("layered", "per_microbatch", "interleaved")
#: the parity-matrix plan: uneven m/ell and ratios
RANKS = [("A", 2, 2, 0.6), ("B", 1, 1, 0.4)]
SEQ = 16
#: the ratio vectors: the plan's, and the shapes of
#: tests/test_layout_properties.py (uneven, zero-size rank, one rank)
RATIOS = [[0.6, 0.4], [1.0], [0.0, 1.0], [0.2, 0.3, 0.5],
          [0.0, 0.35, 0.15, 0.5], [0.1, 0.2, 0.3, 0.4]]


def _plans():
    mk = [(RankPlan, Plan), (JaxRankPlan, JaxPlan)]
    return [P(model="toy", cluster="toy",
              global_batch=sum(m * ell for _, m, ell, _ in RANKS),
              ranks=[R(i, d, m=m, ell=ell, state_ratio=r)
                     for i, (d, m, ell, r) in enumerate(RANKS)])
            for R, P in mk]


def test_schedules_match_reference():
    assert list_schedules() == jax_schedules.list_schedules()
    plan, _ = _plans()
    for name in SCHEDULES:
        for ell in range(0, 7):
            assert get_schedule(name).chunks(ell) == \
                jax_schedules.get_schedule(name).chunks(ell)
        assert get_schedule(name).chunks(plan.ell_pad) == \
            jax_schedules.get_schedule(name).chunks(plan.ell_pad)


def test_plan_geometry_matches_reference():
    plan, jplan = _plans()
    for attr in ("n", "m_pad", "ell_pad", "padded_batch", "padding_waste"):
        assert getattr(plan, attr) == getattr(jplan, attr)
    np.testing.assert_array_equal(plan.example_weights(),
                                  jplan.example_weights())
    plan.check()
    assert Plan.from_json(plan.to_json()) == plan
    hp = homogeneous_plan(3, 2, 4)
    assert hp.global_batch == 24 and hp.state_ratios().sum() == 1.0


def test_synthetic_stream_and_grid_match_reference():
    plan, jplan = _plans()
    cfg = pipeline.DataConfig(vocab_size=512, seq_len=SEQ, seed=2)
    jcfg = jax_pipeline.DataConfig(vocab_size=512, seq_len=SEQ, seed=2)
    stream, jstream = (pipeline.SyntheticStream(cfg),
                       jax_pipeline.SyntheticStream(jcfg))
    for step in range(3):
        np.testing.assert_array_equal(stream.sample(step, 5),
                                      jstream.sample(step, 5))
    got = pipeline.make_plan_batch(stream, 1, plan)
    want = jax_pipeline.make_plan_batch(jstream, 1, jplan)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _filled(planner_cfg, seed):
    """The JAX package's param tree shapes, filled with distinct values."""
    shapes = jax.eval_shape(
        lambda: JM.init_params(planner_cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        rng.standard_normal(x.shape).astype(np.float32) for x in leaves])


@pytest.mark.parametrize("ratios", RATIOS,
                         ids=["-".join(map(str, r)) for r in RATIOS])
def test_layout_and_flat_buffers_match_reference(ratios):
    jcfg = jax_arch("tiny-llama").reduced()
    cfg = get_arch("tiny-llama").reduced()
    jplanner, planner = JaxPlanner(jcfg, ratios), UnitPlanner(cfg, ratios)
    assert [g.name for g in planner.groups] == \
        [g.name for g in jplanner.groups]
    for g, jg in zip(planner.groups, jplanner.groups):
        assert g.count == jg.count
        assert g.layout.shapes == jg.layout.shapes
        assert (g.layout.size, g.layout.padded, g.layout.shard_sizes) == \
            (jg.layout.size, jg.layout.padded, jg.layout.shard_sizes)
    tree = _filled(jcfg, seed=len(ratios))
    jsub = JaxSubstrate(jplanner)
    sub = LoopbackSubstrate(planner, "cpu")
    tparams = params_from_numpy(tree, "cpu")
    flats, jflats = sub.flatten_tree(tparams), jsub.flatten_tree(tree)
    for name in jflats:
        np.testing.assert_array_equal(flats[name].numpy(), jflats[name])
    slices, jslices = sub.slice_flats(flats), jsub.slice_flats(jflats)
    for r, js in enumerate(jslices):
        for name in js:
            np.testing.assert_array_equal(slices[r][name].numpy(), js[name])
    back = sub.unflatten_flats(sub.concat_slices(slices))
    for a, b in zip(fsdp.tree_flatten(back)[0], jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def _export(engine, state, leaves):
    """{"p","m","v"}: each a list of numpy leaves (``leaves`` flattens a
    tree in jax.tree.flatten's order); the export's gathers are not
    counted in the engine's collective stats."""
    stats = engine.trainer.substrate.stats
    counts = dict(stats)
    out = engine.export_state(state)
    stats.update(counts)
    return {k: [np.asarray(x, dtype=np.float32) for x in leaves(out[k])]
            for k in "pmv"}


@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_arch("tiny-llama").reduced()
    return jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_engine_matches_reference_loopback(schedule, jax_init):
    plan, jplan = _plans()
    jcfg = jax_arch("tiny-llama").reduced()
    cfg = get_arch("tiny-llama").reduced()
    stream = pipeline.SyntheticStream(pipeline.DataConfig(
        cfg.vocab_size, SEQ, seed=2))
    jeng = jax_build(jcfg, jplan, substrate="loopback", schedule=schedule,
                     adam=JaxAdam(lr=1e-3), seq_len=SEQ)
    eng = build_train_step(cfg, plan, substrate="loopback",
                           schedule=schedule, adam=AdamConfig(lr=1e-3),
                           seq_len=SEQ, device="cpu")
    jstate = jeng.import_state({"step": 0, "p": jax_init})
    state = eng.import_state({"step": 0,
                              "p": params_from_numpy(jax_init, "cpu")})
    steps, lr = 2, 1e-3
    for step in range(steps):
        big = stream.sample(step, plan.global_batch)
        jstate, jloss = jeng.step(jstate, big)
        state, loss = eng.step(state, big)
        assert abs(loss - jloss) <= 1e-5, (step, loss, jloss)
        got = _export(eng, state, lambda t: fsdp.tree_flatten(t)[0])
        want = _export(jeng, jstate, jax.tree.leaves)
        err = {k: [np.abs(g - w) for g, w in zip(got[k], want[k])]
               for k in "pmv"}
        for k in "mv":
            scale = max(np.abs(w).max() for w in want[k])
            assert max(e.max() for e in err[k]) <= 1e-4 * scale, (step, k)
        for e, v in zip(err["p"], want["v"]):
            assert e.max() <= lr * (step + 1)
            assert not e[v == 0].any()    # no grad yet: not moved
            if step == 0:   # v_hat = v / (1 - b2)
                well = np.sqrt(v / (1 - JaxAdam().b2)) >= 1e-6
                assert e[well].max(initial=0.0) <= 1e-5
    assert eng.trainer.substrate.stats == jeng.trainer.substrate.stats
    assert eng.export_state(state)["step"] == steps
    assert "rank1" in eng.memory_report(state)


def test_engine_init_state_and_substrates():
    cfg = get_arch("gpt-1.3b").reduced()
    plan, _ = _plans()
    eng = build_train_step(cfg, plan, device="cpu", seq_len=SEQ)
    state = eng.init_state(torch.Generator().manual_seed(0))
    assert [s["step"] for s in state] == [0, 0]
    sizes = {name: t["p"].shape[-1] for name, t in state[0].items()
             if name != "step"}
    for g in eng.trainer.groups:
        assert sizes[g.name] == g.layout.shard_sizes[0]
        assert not state[0][g.name]["m"].any()
    # the SPMD engine checks its mesh against the plan before it spawns
    with pytest.raises(ValueError, match="mesh"):
        build_train_step(cfg, plan, substrate="shard_map", device="cpu",
                         mesh=Mesh((3,), ("data",)))
    # the process fleet refuses a bad knob before it spawns a worker
    with pytest.raises(ValueError, match="ring"):
        build_train_step(cfg, plan, substrate="multiproc", device="cpu",
                         topology="hub", overlap_rounds=True)
    with pytest.raises(ValueError, match="knobs"):
        build_train_step(cfg, plan, device="cpu", topology="ring")
    with pytest.raises(ValueError):
        build_train_step(cfg, plan, substrate="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_train_step(cfg, plan)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_train_step(cfg, plan, substrate="multiproc")
        # the fleet's coordinator reshards on the card unless asked not
        # to: it raises before it spawns a worker
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiProcessSubstrate(UnitPlanner(cfg, [0.6, 0.4]), [])


#: the state ratios of the plan ``launch.train`` solves for mamba2-370m on
#: Cluster A at seq 2048, batch 32 (tests/test_torch_launch.py)
MAMBA_RATIOS = [0.0, 0.0, 0.310546875, 0.23046875, 0.2294921875,
                0.2294921875, 0.0, 0.0]


@pytest.mark.parametrize("reduced,ratios", [
    (True, [0.6, 0.4]), (True, "plan"), (False, "plan")],
    ids=["reduced-parity", "reduced-cluster-a", "full-cluster-a"])
def test_mamba2_layout_matches_reference(reduced, ratios):
    """The uneven FSDP layout of an SSM model: units, leaf order (the
    reference's sorted keys), shapes and shard sizes; reduced, the flat
    buffers and each rank's slice element by element."""
    from repro_torch.launch import train as launch
    jcfg, cfg = jax_arch("mamba2-370m"), get_arch("mamba2-370m")
    if ratios == "plan":
        args = launch.parser().parse_args(
            ["--arch", "mamba2-370m", "--seq", "2048", "--batch", "32",
             "--cluster", "cluster-a", "--device", "cpu"])
        ratios = list(launch.solve_plan(args)[1].state_ratios())
        assert ratios == MAMBA_RATIOS
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jplanner, planner = JaxPlanner(jcfg, ratios), UnitPlanner(cfg, ratios)
    assert [g.name for g in planner.groups] == \
        [g.name for g in jplanner.groups] == \
        ["embed", "head", "misc", "stage0"]
    for g, jg in zip(planner.groups, jplanner.groups):
        assert (g.count, g.layout.shapes, g.layout.size, g.layout.padded,
                g.layout.shard_sizes) == \
            (jg.count, jg.layout.shapes, jg.layout.size, jg.layout.padded,
             jg.layout.shard_sizes)
    if not reduced:
        assert sum(g.layout.size * g.count for g in planner.groups) == \
            419_825_152
        return
    tree = _filled(jcfg, seed=7)
    jsub, sub = JaxSubstrate(jplanner), LoopbackSubstrate(planner, "cpu")
    flats = sub.flatten_tree(params_from_numpy(tree, "cpu"))
    jflats = jsub.flatten_tree(tree)
    for name in jflats:
        np.testing.assert_array_equal(flats[name].numpy(), jflats[name])
    for r, js in enumerate(jsub.slice_flats(jflats)):
        for name in js:
            np.testing.assert_array_equal(
                sub.slice_flats(flats)[r][name].numpy(), js[name])


def _two_loopback_steps(arch, skew=False, layers=2):
    """Two loopback steps of reduced ``arch`` (``layers`` layers) on the
    parity-matrix plan, from the same params, port against reference:
    losses within 1e-5, exported ``m`` and ``v`` within 1e-4 of their
    max, collective counts equal.  ``skew`` maps the tokens onto 8 ids, so
    that MoE routing is skewed and each rank's capacity dispatch drops."""
    plan, jplan = _plans()
    jcfg = jax_arch(arch).reduced(n_layers=layers)
    cfg = get_arch(arch).reduced(n_layers=layers)
    init = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    stream = pipeline.SyntheticStream(pipeline.DataConfig(
        cfg.vocab_size, SEQ, seed=2))
    jeng = jax_build(jcfg, jplan, substrate="loopback", schedule="layered",
                     adam=JaxAdam(lr=1e-3), seq_len=SEQ)
    eng = build_train_step(cfg, plan, substrate="loopback",
                           schedule="layered", adam=AdamConfig(lr=1e-3),
                           seq_len=SEQ, device="cpu")
    jstate = jeng.import_state({"step": 0, "p": init})
    state = eng.import_state({"step": 0,
                              "p": params_from_numpy(init, "cpu")})
    for step in range(2):
        big = stream.sample(step, plan.global_batch)
        if skew:
            big = big % 8
        jstate, jloss = jeng.step(jstate, big)
        state, loss = eng.step(state, big)
        assert abs(loss - jloss) <= 1e-5, (step, loss, jloss)
        got = _export(eng, state, lambda t: fsdp.tree_flatten(t)[0])
        want = _export(jeng, jstate, jax.tree.leaves)
        for k in "mv":
            scale = max(np.abs(w).max() for w in want[k])
            err = max(np.abs(g - w).max() for g, w in zip(got[k], want[k]))
            assert err <= 1e-4 * scale, (step, k, err, scale)
    assert eng.trainer.substrate.stats == jeng.trainer.substrate.stats


def test_mamba2_engine_matches_reference_loopback():
    """Two loopback steps of reduced mamba2-370m on the parity-matrix plan,
    from the same params: losses within 1e-5, exported ``m`` and ``v``
    within 1e-4 of their max, collective counts equal."""
    _two_loopback_steps("mamba2-370m")


MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_reference_loopback(arch):
    """Two loopback steps of a reduced MoE model on the parity-matrix
    plan, tokens skewed so that routing overflows: each rank's
    microbatch (m x seq tokens) is its own capacity dispatch, as in the
    reference's ``HeteroTrainer``, so ranks of uneven m drop differently
    and the step must still equal the reference's.  The port's dispatches
    are recorded: both ranks' token counts occur, and some drop."""
    from repro_torch.models.layers import moe
    with moe.counting_drops() as seen:
        _two_loopback_steps(arch, skew=True)
    assert len({t for t, _ in seen}) == 2     # the ranks' uneven calls
    assert sum(int(d) for _, d in seen) > 0


def _layout_matches(arch, ratios, seed):
    """The uneven FSDP layout of ``arch`` (units in the reference's
    order, its sorted leaf order, shapes, shard sizes) at full width and
    reduced; reduced, the flat buffers and each rank's slice element by
    element.  Returns the unit names at full width."""
    names = None
    for jcfg, cfg in ((jax_arch(arch), get_arch(arch)),
                      (jax_arch(arch).reduced(), get_arch(arch).reduced())):
        jplanner = JaxPlanner(jcfg, ratios)
        planner = UnitPlanner(cfg, ratios)
        assert [g.name for g in planner.groups] == \
            [g.name for g in jplanner.groups]
        names = names or [g.name for g in planner.groups]
        for g, jg in zip(planner.groups, jplanner.groups):
            assert (g.count, g.layout.shapes, g.layout.size,
                    g.layout.padded, g.layout.shard_sizes) == \
                (jg.count, jg.layout.shapes, jg.layout.size,
                 jg.layout.padded, jg.layout.shard_sizes)
    tree = _filled(jcfg, seed=seed)
    jsub, sub = JaxSubstrate(jplanner), LoopbackSubstrate(planner, "cpu")
    flats = sub.flatten_tree(params_from_numpy(tree, "cpu"))
    jflats = jsub.flatten_tree(tree)
    # a stage of count 1 keeps its count dim in the port: (1, padded)
    # where the reference has (padded,), the same elements
    for name in jflats:
        np.testing.assert_array_equal(
            flats[name].numpy().reshape(jflats[name].shape), jflats[name])
    for r, js in enumerate(jsub.slice_flats(jflats)):
        for name in js:
            np.testing.assert_array_equal(
                sub.slice_flats(flats)[r][name].numpy().reshape(
                    js[name].shape), js[name])
    return names


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layout_matches_reference(arch):
    """An MoE model's uneven FSDP layout (units, the reference's sorted
    leaf order with ``moe`` in each layer, shapes, shard sizes) at full
    width and reduced; reduced, the flat buffers and each rank's slice
    element by element."""
    _layout_matches(arch, [0.6, 0.4], seed=8)


#: unit groups at full width: gemma2 ties its head to the embedding;
#: zamba2's shared block is a unit of its own, before the stages
PAIR_HYBRID_UNITS = {
    "gemma2-9b": ["embed", "misc", "stage0"],
    "zamba2-7b": ["embed", "head", "misc", "shared", "stage0", "stage1"]}


@pytest.mark.parametrize("ratios", [[0.6, 0.4], [0.0, 0.35, 0.15, 0.5]],
                         ids=["parity", "zero-rank"])
@pytest.mark.parametrize("arch", list(PAIR_HYBRID_UNITS))
def test_pair_hybrid_layout_matches_reference(arch, ratios):
    """gemma2-9b's pair units (the ``global`` leaves before the ``local``
    ones) and zamba2-7b's (the ``shared`` family; each zamba element's
    SSM blocks stacked a second time): groups, layouts and, reduced, flat
    buffers and rank slices element by element against the reference's
    ``UnitPlanner``."""
    assert _layout_matches(arch, ratios, seed=9) == PAIR_HYBRID_UNITS[arch]


@pytest.mark.parametrize("arch", list(PAIR_HYBRID_UNITS))
def test_pair_hybrid_engine_matches_reference_loopback(arch):
    """Two loopback steps of reduced gemma2-9b and zamba2-7b on the
    parity-matrix plan, from the same params, against the reference's
    ``HeteroTrainer``: losses within 1e-5, exported ``m`` and ``v`` (the
    shared block's among them) within 1e-4 of their max, collectives
    equal.  At 4 layers: 2 pairs, 2 zamba groups (the reference's trainer
    cannot run a stage of one element, ROADMAP §3)."""
    _two_loopback_steps(arch, layers=4)


@pytest.mark.parametrize("arch", list(PAIR_HYBRID_UNITS))
def test_single_element_stage_trains(arch):
    """A stage of one element (reduced gemma2-9b: one pair; zamba2-7b: one
    group) keeps its count dim through the layout: the engine's first
    loss equals the reference's ``loss_fn`` over the whole block (Eq. 1
    weights 1/(B seq)) within 1e-5, and the second is finite and lower."""
    plan, _ = _plans()
    jcfg, cfg = jax_arch(arch).reduced(), get_arch(arch).reduced()
    assert [s.count for s in M.build_stages(cfg)] == [1]
    init = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    eng = build_train_step(cfg, plan, substrate="loopback",
                           schedule="layered", adam=AdamConfig(lr=1e-3),
                           seq_len=SEQ, device="cpu")
    state = eng.import_state({"step": 0,
                              "p": params_from_numpy(init, "cpu")})
    gathered = eng.gather_params(state)["stages"][0]
    assert all(t.shape[0] == 1 for t in fsdp.tree_flatten(gathered)[0])
    stream = pipeline.SyntheticStream(pipeline.DataConfig(
        cfg.vocab_size, SEQ, seed=2))
    big = stream.sample(0, plan.global_batch)
    b = plan.global_batch
    want, _ = JM.loss_fn(jcfg, init, {
        "tokens": big[:, :-1], "labels": big[:, 1:],
        "weights": np.full((b, SEQ), 1.0 / (b * SEQ), np.float32)})
    state, loss = eng.step(state, big)
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    _, loss2 = eng.step(state, big)
    assert np.isfinite(loss2) and loss2 < loss


def test_tree_flatten_makes_no_reference_cycle():
    """``fsdp.tree_flatten`` and ``tree_unflatten`` hold no leaf past
    their return: with the cyclic collector off, a flattened tree's
    tensor is freed as soon as its last reference goes.  Their recursive
    walks were closures that referred to themselves, a cycle that kept
    every leaf (a step's gradients, a gathered params tree) alive until
    the collector ran; a rank process of the fleet ran the card out of
    memory on them (ROADMAP queue 3)."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        t = torch.ones(4)
        ref = weakref.ref(t)
        leaves, treedef = fsdp.tree_flatten({"b": [t, {"c": t}], "a": t})
        back = fsdp.tree_unflatten(treedef, leaves)
        assert back["b"][0] is t and len(leaves) == 3
        del t, leaves, back
        assert ref() is None
    finally:
        gc.enable()
