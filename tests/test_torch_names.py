"""The last public names of the reference the port lacked, against the
reference on the CPU: ``data.pipeline.iterate``, ``UnitPlanner.group`` /
``has_group``, ``HeteroTrainer.software_reduce_scatter`` and the example
``hetero_vs_even`` (``repro_torch.examples.hetero_vs_even``)."""

import itertools

import jax
import numpy as np
import pytest

from repro.configs.base import get_arch as jax_arch
from repro.core import device_specs as JD
from repro.core.cost_model import analytic_cluster_model as j_cluster_model
from repro.core.engine.units import UnitPlanner as JUnitPlanner
from repro.core.hetero_trainer import HeteroTrainer as JTrainer
from repro.core.model_stats import build_model_stats as j_stats
from repro.core.planner import plan_even as j_plan_even
from repro.core.planner import solve as j_solve
from repro.data import pipeline as JPipe
from repro.optim.adam import AdamConfig as JAdam
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import device_specs as D
from repro_torch.core.cost_model import analytic_cluster_model
from repro_torch.core.engine.units import UnitPlanner
from repro_torch.core.hetero_trainer import HeteroTrainer
from repro_torch.core.model_stats import build_model_stats
from repro_torch.core.planner import solve
from repro_torch.data import pipeline as Pipe
from repro_torch.examples import hetero_vs_even as example

import torch_threads  # noqa: F401,E402  (caps torch's threads)

SEQ, BATCH = 32, 12


def _mini(devices):
    return devices.Cluster([devices.L4, devices.A6000, devices.P40,
                            devices.P100], 50, "c4")


def _plans():
    cfg, jcfg = get_arch("tiny-llama").reduced(), \
        jax_arch("tiny-llama").reduced()
    plan = solve(analytic_cluster_model(_mini(D), build_model_stats(cfg, SEQ)),
                 BATCH)
    jplan = j_solve(j_cluster_model(_mini(JD), j_stats(jcfg, SEQ)), BATCH)
    return cfg, jcfg, plan, jplan


@pytest.mark.parametrize("by_plan", [True, False])
def test_iterate_yields_the_references_batches(by_plan):
    cfg, jcfg, plan, jplan = _plans()
    stream = Pipe.SyntheticStream(Pipe.DataConfig(cfg.vocab_size, SEQ,
                                                  seed=3))
    jstream = JPipe.SyntheticStream(JPipe.DataConfig(cfg.vocab_size, SEQ,
                                                     seed=3))
    kw = {"plan": plan} if by_plan else {"batch": BATCH}
    jkw = {"plan": jplan} if by_plan else {"batch": BATCH}
    got = itertools.islice(Pipe.iterate(stream, start_step=2, **kw), 3)
    want = itertools.islice(JPipe.iterate(jstream, start_step=2, **jkw), 3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_unit_planner_groups_as_the_reference():
    cfg, jcfg, plan, _ = _plans()
    ratios = [r.state_ratio for r in plan.ranks]
    up = UnitPlanner(cfg, ratios)
    jup = JUnitPlanner(jcfg, ratios)
    names = [g.name for g in jup.groups]
    assert [g.name for g in up.groups] == names
    for name in names + ["stage9", "nope"]:
        assert up.has_group(name) == jup.has_group(name)
    for name in names:
        assert up.group(name).name == jup.group(name).name == name
        lay, jlay = up.group(name).layout, jup.group(name).layout
        assert (lay.size, lay.padded, lay.shard_sizes) == \
            (jlay.size, jlay.padded, list(jlay.shard_sizes))
    with pytest.raises(KeyError):
        up.group("nope")


def test_software_reduce_scatter_matches_the_reference():
    """The reference's elastic test (``tests/test_elastic_and_cache.py``):
    params gathered after two steps of the 4-rank plan, re-sliced for the
    3-rank plan; the port's slices equal the reference's exactly."""
    jcfg = jax_arch("tiny-llama").reduced()
    cfg = get_arch("tiny-llama").reduced()
    seq, batch = 32, 12
    c3 = [JD.L4, JD.A6000, JD.P40]
    stats = j_stats(jcfg, seq)
    plan4 = j_solve(j_cluster_model(_mini(JD), stats), batch)
    plan3 = j_solve(j_cluster_model(JD.Cluster(c3, 50, "c3"), stats), batch)
    tr4 = JTrainer(jcfg, plan4, JAdam(lr=2e-3), seq_len=seq)
    stream = JPipe.SyntheticStream(JPipe.DataConfig(jcfg.vocab_size, seq,
                                                    seed=5))
    shards4 = tr4.init_shards(jax.random.PRNGKey(0))
    for step in range(2):
        shards4, _ = tr4.step(shards4, stream.sample(step, batch))
    params_mid = jax.device_get(tr4.software_allgather(shards4))
    want = JTrainer(jcfg, plan3, JAdam(lr=2e-3), seq_len=seq
                    ).software_reduce_scatter(params_mid)
    pplan3 = solve(analytic_cluster_model(
        D.Cluster([D.L4, D.A6000, D.P40], 50, "c3"),
        build_model_stats(cfg, seq)), batch)
    tr3 = HeteroTrainer(cfg, pplan3, seq_len=seq, device="cpu")
    got = tr3.software_reduce_scatter(params_from_numpy(params_mid, "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]))


@pytest.fixture(scope="module")
def example_runs():
    """The example's plans and losses, the port's and the reference's
    (its own loop) from the same JAX-drawn params."""
    cfg, cephalo, even = example.plans()
    jcfg = jax_arch("tiny-llama").reduced()
    jcm = j_cluster_model(JD.Cluster([JD.L4, JD.L4, JD.P40, JD.P40],
                                     link_gbps=50, name="l4-p40"),
                          j_stats(jcfg, example.SEQ))
    jplans = {"cephalo": j_solve(jcm, example.BATCH),
              "even": j_plan_even(jcm, example.BATCH)}
    params = None
    out = {}
    for name, plan in (("cephalo", cephalo), ("even", even)):
        jplan = jplans[name]
        tr = JTrainer(jcfg, jplan, JAdam(lr=2e-3), seq_len=example.SEQ)
        shards = tr.init_shards(jax.random.PRNGKey(0))
        if params is None:
            params = jax.device_get(tr.software_allgather(shards))
        stream = JPipe.SyntheticStream(JPipe.DataConfig(
            jcfg.vocab_size, example.SEQ, seed=0))
        want = []
        for step in range(example.STEPS):
            shards, loss = tr.step(shards, stream.sample(step, example.BATCH))
            want.append(float(loss))
        got = example.train(cfg, plan, "cpu",
                            params=params_from_numpy(params, "cpu"))
        out[name] = (plan, jplan, got, want)
    return out


@pytest.mark.parametrize("name", ["cephalo", "even"])
def test_example_plans_are_the_references(example_runs, name):
    plan, jplan, _, _ = example_runs[name]
    assert plan.feasible and plan.to_json() == jplan.to_json()


@pytest.mark.parametrize("name", ["cephalo", "even"])
def test_example_losses_match_the_references(example_runs, name):
    """Five steps of each plan within the reference example's own
    ``atol=1e-3`` of the reference's losses (and, as the example asserts,
    of each other)."""
    _, _, got, want = example_runs[name]
    assert len(got) == len(want) == example.STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, example_runs["cephalo"][2], rtol=0,
                               atol=1e-3)


def test_example_runs_from_the_command_line():
    """``python -m repro_torch.examples.hetero_vs_even --device cpu``:
    both plans train, their losses the same within 1e-3 and falling."""
    losses = example.main(["--device", "cpu"])
    assert set(losses) == {"cephalo", "even"}
    assert losses["cephalo"][-1] < losses["cephalo"][0]
