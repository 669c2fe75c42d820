"""The port's training launcher, its quickstart and the frontend stub,
against the JAX package's, on the CPU.

* ``python -m repro_torch.launch.train --device cpu`` prints the plan,
  the memory report and the predicted iteration of
  ``python -m repro.launch.train``, line for line.
* From the same state (the reference engine's exported init, carried
  across through numpy), the two launchers' ``_train_loop`` give the same
  losses within 1e-5.
* ``--runtime spmd`` exits with the ROADMAP item that ports it; the
  elastic flags' misuses exit with the reference's messages;
  ``--overlap`` needs ``--topology ring``; ``--checkpoint`` writes the
  reference's layout.
* ``--elastic`` runs on the loopback substrate and on a fleet (hub,
  overlapped ring); with ``--straggler`` the launcher prints the
  reference launcher's replan events and final plan for the same argv,
  and ``--checkpoint`` saves the final plan.
* ``--substrate multiproc --nprocs 2 --topology ring`` prints the loss
  lines of the loopback launcher on the same plan, exactly.
* ``python -m repro_torch.examples.quickstart --device cpu``: the loss
  falls.
* The frontend stub (vit-g, vit-e): init params carried from JAX give
  ``loss_fn`` and its grads of ``jax.value_and_grad(M.loss_fn)``, with and
  without ``frontend_embed`` (loss 1e-5, grads 1e-4 of max), the same
  stub embeddings from the pipeline, the same flat unit layout and shard
  sizes, and the same loopback steps (the runtime feeds ranks no
  ``frontend_embed``, so ``frontend_proj`` gets zero grads in both).
"""

import argparse
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as JCK
from repro.configs.base import get_arch as jax_arch
from repro.core.engine import build_train_step as jax_build
from repro.core.engine.units import UnitPlanner as JaxPlanner
from repro.data import pipeline as jax_pipeline
from repro.launch import train as jax_launch
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdam
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.engine import UnitPlanner, build_train_step
from repro_torch.data import pipeline
from repro_torch.examples import quickstart
from repro_torch.launch import train as launch
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

ARGV = ["--arch", "tiny-llama", "--reduced", "--steps", "3", "--batch",
        "12", "--seq", "32", "--cluster", "mini"]


def _run(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.splitlines()
    return [ln for ln in lines if not ln.startswith("step ")], \
        [ln for ln in lines if ln.startswith("step ")]


@pytest.mark.parametrize("extra", [[], ["--cluster", "cluster-a",
                                        "--batch", "32"]],
                         ids=["mini", "cluster-a"])
def test_launcher_prints_the_reference_plan(extra, capsys, monkeypatch):
    argv = ARGV + extra

    def jax_main(a):
        monkeypatch.setattr(sys, "argv", ["train"] + a)
        jax_launch.main()

    got, got_steps = _run(launch.main, argv + ["--device", "cpu"], capsys)
    want, want_steps = _run(jax_main, argv, capsys)
    assert got == want
    assert got[0].startswith("Plan[tiny-llama-smoke @ ")
    assert any(ln.startswith("predicted iteration") for ln in got)
    assert len(got_steps) == len(want_steps) == 3


MAMBA_ARGV = ["--arch", "mamba2-370m", "--cluster", "cluster-a", "--batch",
              "32"]


@pytest.mark.parametrize("extra", [["--reduced", "--steps", "2", "--seq",
                                    "32"], ["--seq", "2048"]],
                         ids=["reduced-run", "full-plan"])
def test_launcher_plans_mamba2_as_the_reference(extra, capsys, monkeypatch):
    """mamba2-370m on Cluster A at batch 32: reduced, the whole launcher
    run (plan, memory report, prediction, 2 steps) prints the reference's
    lines; at full width and seq 2048, the plan ``solve_plan`` prints and
    returns is the reference's: m = 7, 7, 10, 2, 2, 2, 1, 1 (ell 1), 8
    rank calls a step."""
    argv = MAMBA_ARGV + extra
    if "--reduced" in extra:
        def jax_main(a):
            monkeypatch.setattr(sys, "argv", ["train"] + a)
            jax_launch.main()
        got, got_steps = _run(launch.main, argv + ["--device", "cpu"],
                              capsys)
        want, want_steps = _run(jax_main, argv, capsys)
        assert got == want
        assert got[0].startswith("Plan[mamba2-370m-smoke @ cluster-a]")
        assert len(got_steps) == len(want_steps) == 2
        return
    args = launch.parser().parse_args(argv + ["--device", "cpu"])
    cfg, plan, _ = launch.solve_plan(args)
    got = capsys.readouterr().out
    jcfg = jax_arch("mamba2-370m")
    jplan = jax_launch.auto_solve(jax_launch.analytic_cluster_model(
        jax_launch.CLUSTERS["cluster-a"](),
        jax_launch.build_model_stats(jcfg, 2048)), 32)
    assert got.splitlines() == jplan.summary().splitlines()
    assert plan.to_json() == jplan.to_json()
    assert [(r.m, r.ell) for r in plan.ranks] == \
        [(m, 1) for m in (7, 7, 10, 2, 2, 2, 1, 1)]
    assert cfg.n_layers == 48 and cfg.d_model == 1024


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b"])
def test_launcher_trains_pair_and_hybrid_on_the_reference_plan(arch,
                                                                capsys):
    """Reduced gemma2-9b (one local/global pair) and zamba2-7b (one SSM
    group and the shared block) on Cluster A at batch 32: the plan the
    launcher prints and solves is the reference's, and its two steps'
    losses are finite.  (The reference's own trainer cannot run these
    stages of one element: ROADMAP §3.)"""
    argv = ["--arch", arch, "--reduced", "--cluster", "cluster-a",
            "--batch", "32", "--seq", "32", "--steps", "2", "--device",
            "cpu"]
    got, steps = _run(launch.main, argv, capsys)
    jcfg = jax_arch(arch).reduced()
    jplan = jax_launch.auto_solve(jax_launch.analytic_cluster_model(
        jax_launch.CLUSTERS["cluster-a"](),
        jax_launch.build_model_stats(jcfg, 32)), 32)
    assert jplan.feasible
    want = jplan.summary().splitlines()
    assert got[:len(want)] == want
    args = launch.parser().parse_args(argv)
    _, plan, _ = launch.solve_plan(args)
    assert plan.to_json() == jplan.to_json()
    losses = [float(ln.split()[3]) for ln in steps]
    assert len(losses) == 2 and all(np.isfinite(losses))


class _Losses:
    """An engine as ``_train_loop`` sees it, its losses kept."""

    def __init__(self, engine):
        self.engine, self.cfg, self.losses = engine, engine.cfg, []

    def step(self, state, big):
        state, loss = self.engine.step(state, big)
        self.losses.append(float(loss))
        return state, loss


def test_train_loops_agree_from_the_same_state(capsys):
    args = argparse.Namespace(arch="tiny-llama", reduced=True, steps=3,
                              batch=12, seq=32, seed=0, cluster="mini",
                              nprocs=0, device="cpu", substrate="loopback")
    cfg, plan, _ = launch.solve_plan(args)
    jcfg = jax_arch("tiny-llama").reduced()
    jcm = jax_launch.analytic_cluster_model(
        jax_launch.CLUSTERS["mini"](),
        jax_launch.build_model_stats(jcfg, args.seq))
    jplan = jax_launch.auto_solve(jcm, args.batch)
    assert jplan.to_json() == plan.to_json()
    jeng = jax_build(jcfg, jplan, substrate="loopback",
                     adam=JaxAdam(lr=1e-3), seq_len=args.seq)
    eng = build_train_step(cfg, plan, substrate="loopback",
                           adam=AdamConfig(lr=1e-3), seq_len=args.seq,
                           device="cpu")
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(jeng.export_state(jstate))
    state = eng.import_state({"step": init["step"], **{
        k: params_from_numpy(init[k], "cpu") for k in "pmv"}})
    jrec, rec = _Losses(jeng), _Losses(eng)
    jax_launch._train_loop(jrec, args, jplan, state=jstate)
    launch._train_loop(rec, args, plan, state=state)
    printed = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("step ") for ln in printed) == 6
    assert len(rec.losses) == len(jrec.losses) == 3
    for a, b in zip(rec.losses, jrec.losses):
        assert abs(a - b) <= 1e-5, (rec.losses, jrec.losses)


@pytest.mark.parametrize("flags,message", [
    (["--runtime", "spmd"], "item 10"),
    (["--substrate", "multiproc", "--topology", "ring", "--straggler",
      "0:2.0@1"], "--straggler needs --elastic"),
    (["--straggler", "1:3.0@1"], "--straggler needs --elastic"),
    (["--elastic", "--straggler", "4:3.0@1"], "out of range for mini"),
    (["--elastic", "--straggler", "1@3"], "expected RANK:FACTOR@STEP"),
    (["--runtime", "spmd", "--elastic"], "require --runtime mpmd"),
    (["--runtime", "spmd", "--straggler", "1:3.0@1"],
     "require --runtime mpmd")])
def test_refused_flags_exit_with_their_reason(flags, message):
    """The SPMD runtime exits with its ROADMAP item; the elastic flags'
    misuses exit with the reference's messages, on the process fleet
    too, before a worker spawns."""
    with pytest.raises(SystemExit, match=message):
        launch.main(ARGV + ["--device", "cpu"] + flags)


FLEET = ["--substrate", "multiproc", "--nprocs", "2", "--batch", "8",
         "--seq", "16"]


@pytest.mark.parametrize("flags", [
    ["--elastic"],
    ["--elastic", "--straggler", "1:3.0@5"],
    FLEET + ["--elastic"],
    FLEET + ["--topology", "ring", "--overlap", "--elastic"]],
    ids=["loopback", "straggler-after-the-run", "hub-fleet",
         "overlapped-ring-fleet"])
def test_elastic_flags_run(flags, capsys):
    """``--elastic`` trains on the elastic engine, on the loopback
    substrate (a healthy cluster: no replan) and on a fleet of two
    worker processes, hub or overlapped ring (wall-clock telemetry: a
    replan may fire on the host's noise); a straggler due after the last
    step is never injected."""
    launch.main(ARGV + ["--device", "cpu"] + flags)
    out = capsys.readouterr().out.splitlines()
    steps = [ln for ln in out if ln.startswith("step ")]
    assert len(steps) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert not any("injecting straggler" in ln for ln in out)
    if "--substrate" not in flags:
        assert not any(ln.startswith(("replan@", "final plan"))
                       for ln in out)


ELASTIC = ["--arch", "tiny-llama", "--reduced", "--steps", "8", "--batch",
           "48", "--seq", "32", "--cluster", "mini", "--elastic",
           "--straggler", "1:3.0@2"]


def test_elastic_launcher_prints_the_reference_replans(capsys,
                                                       monkeypatch):
    """The same argv on both launchers: the same plan, memory report,
    straggler line, replan events and final plan (the losses differ:
    each launcher draws its own init)."""
    def jax_main(a):
        monkeypatch.setattr(sys, "argv", ["train"] + a)
        jax_launch.main()

    got, got_steps = _run(launch.main, ELASTIC + ["--device", "cpu"],
                          capsys)
    want, want_steps = _run(jax_main, ELASTIC, capsys)
    assert got == want
    assert len(got_steps) == len(want_steps) == 8
    assert "-- injecting straggler: rank 1 x3.0 --" in got
    replans = [ln for ln in got if ln.startswith("replan@")]
    assert replans and replans[0].startswith("replan@3 adopted=True: "
                                             "imbalance")
    assert "final plan after replanning:" in got


def test_elastic_checkpoint_saves_the_final_plan(capsys):
    with tempfile.TemporaryDirectory() as d:
        launch.main(ELASTIC + ["--device", "cpu", "--checkpoint", d])
        out = capsys.readouterr().out.splitlines()
        assert f"saved checkpoint to {d}" in out
        man = JCK._read_manifest(d)
    assert man["step"] == 8
    saved = launch.Plan.from_json(man["meta"]["plan"])
    first = out.index("final plan after replanning:")
    final = out[first + 1: first + 2 + saved.n]
    assert saved.summary().splitlines() == final
    assert out[0] != final[0] or out[1:1 + saved.n] != final[1:]


@pytest.mark.parametrize("flags", [
    ["--substrate", "multiproc", "--overlap"],
    ["--substrate", "multiproc", "--topology", "hub", "--overlap"]])
def test_overlap_needs_the_ring(flags):
    with pytest.raises(SystemExit, match="--overlap needs --topology ring"):
        launch.main(ARGV + ["--device", "cpu"] + flags)


def test_multiproc_launcher_prints_the_loopback_losses(capsys,
                                                       monkeypatch):
    """``--substrate multiproc --nprocs 2 --topology ring`` on the CPU:
    the plan comes from wall-clock latency models, so it is caught and
    the loopback launcher runs on it; both print the same loss lines,
    exactly, and the fleet's memory report names each worker's pid."""
    argv = ["--arch", "tiny-llama", "--reduced", "--steps", "2", "--batch",
            "8", "--seq", "16", "--cluster", "mini", "--device", "cpu"]
    solved = []
    solve = launch.solve_plan

    def caught(args):
        solved.append(solve(args))
        return solved[-1]
    monkeypatch.setattr(launch, "solve_plan", caught)
    launch.main(argv + ["--substrate", "multiproc", "--nprocs", "2",
                        "--topology", "ring"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("profiling wall-clock latency models on cpu")
    pids = [ln for ln in out if ln.startswith("rank") and "pid " in ln]
    assert len(pids) == solved[0][1].n == 2
    monkeypatch.setattr(launch, "solve_plan", lambda args: solved[0])
    launch.main(argv)
    want = capsys.readouterr().out.splitlines()

    def losses(lines):
        return [ln.split(" (")[0] for ln in lines if ln.startswith("step ")]
    assert losses(out) == losses(want) and len(losses(out)) == 2


def test_launcher_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(ARGV)


def test_launcher_checkpoint_has_the_reference_layout(capsys):
    with tempfile.TemporaryDirectory() as d:
        launch.main(ARGV + ["--device", "cpu", "--checkpoint", d])
        assert f"saved checkpoint to {d}" in capsys.readouterr().out
        man = JCK._read_manifest(d)
        assert man["step"] == 3
        plan = launch.Plan.from_json(man["meta"]["plan"])
        jcfg = jax_arch("tiny-llama").reduced()
        jeng = jax_build(jcfg, jax_launch.auto_solve(
            jax_launch.analytic_cluster_model(
                jax_launch.CLUSTERS["mini"](),
                jax_launch.build_model_stats(jcfg, 32)), 12),
            substrate="loopback", seq_len=32)
        template = jeng.init_state(jax.random.PRNGKey(0))
        step, shards, _, _ = JCK.load(d, template[0], {})
        assert step == 3 and len(shards) == plan.n
        for got, want in zip(shards, template):
            assert int(got["step"]) == 3
            got, want = JCK._flatten_dict(got), JCK._flatten_dict(want)
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in want.items()}


def test_quickstart_loss_falls(capsys):
    losses = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "--- plan ---" in out and "simulated iteration" in out
    assert len(losses) == quickstart.STEPS
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5


# --- the frontend stub ------------------------------------------------------

VIT = "vit-g"
SEQ = 16


@pytest.fixture(scope="module")
def vit_params():
    cfg = jax_arch(VIT).reduced()
    return jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))


def _vit_batch(with_frontend):
    cfg = get_arch(VIT).reduced()
    dcfg = pipeline.DataConfig(cfg.vocab_size, SEQ, seed=4,
                               frontend_dim=cfg.frontend_dim)
    batch = pipeline.make_homogeneous_batch(pipeline.SyntheticStream(dcfg),
                                            2, 3)
    jdcfg = jax_pipeline.DataConfig(cfg.vocab_size, SEQ, seed=4,
                                    frontend_dim=cfg.frontend_dim)
    want = jax_pipeline.make_homogeneous_batch(
        jax_pipeline.SyntheticStream(jdcfg), 2, 3)
    assert batch.keys() == want.keys() == {"tokens", "labels", "weights",
                                           "frontend_embed"}
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
    if not with_frontend:
        del batch["frontend_embed"]
    return batch


@pytest.mark.parametrize("with_frontend", [True, False],
                         ids=["frontend_embed", "tokens-only"])
def test_frontend_loss_and_grads_match_jax(with_frontend, vit_params):
    batch = _vit_batch(with_frontend)
    jcfg, cfg = jax_arch(VIT).reduced(), get_arch(VIT).reduced()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch)[0])(vit_params)
    params = params_from_numpy(vit_params, "cpu")
    leaves, _ = fsdp.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    loss, _ = M.loss_fn(cfg, params, tb)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    stub = next(i for i, t in enumerate(leaves)
                if t is params["frontend_proj"])
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        scale = np.abs(jg).max()
        if i == stub and not with_frontend:
            assert scale == 0 and not g.any()
            continue
        assert scale > 0
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * scale


RATIOS = [0.056640625, 0.056640625, 0.3037109375, 0.1640625,
          0.1630859375, 0.193359375, 0.03125, 0.03125]   # Cluster A's plan


@pytest.mark.parametrize("arch,reduced", [("vit-g", True), ("vit-g", False),
                                          ("vit-e", False)])
def test_frontend_layout_matches_reference(arch, reduced):
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jplanner, planner = JaxPlanner(jcfg, RATIOS), UnitPlanner(cfg, RATIOS)
    assert [g.name for g in planner.groups] == \
        [g.name for g in jplanner.groups]
    for g, jg in zip(planner.groups, jplanner.groups):
        assert (g.count, g.layout.shapes, g.layout.size, g.layout.padded,
                g.layout.shard_sizes) == \
            (jg.count, jg.layout.shapes, jg.layout.size, jg.layout.padded,
             jg.layout.shard_sizes)
    misc = next(g for g in planner.groups if g.name == "misc")
    assert (cfg.frontend_dim, cfg.d_model) in misc.layout.shapes
    shapes = M.init_params(cfg, torch.Generator(), "meta", all_fp32=True)
    jshapes = jax.eval_shape(lambda: JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert [tuple(t.shape) for t in fsdp.tree_flatten(shapes)[0]] == \
        [tuple(t.shape) for t in jax.tree.leaves(jshapes)]


def test_frontend_loopback_steps_match_reference(vit_params):
    """The MPMD runtime feeds ranks tokens only: the loss of each step
    matches the reference's, and ``frontend_proj`` gets zero grads in
    both, so Adam leaves it where it was."""
    from repro.core.partition import Plan as JaxPlan
    from repro.core.partition import RankPlan as JaxRankPlan
    from repro_torch.core.partition import Plan, RankPlan
    ranks = [("A", 2, 2, 0.6), ("B", 1, 1, 0.4)]

    def plan(R, P):
        return P(model=VIT, cluster="toy", global_batch=5,
                 ranks=[R(i, d, m=m, ell=ell, state_ratio=r)
                        for i, (d, m, ell, r) in enumerate(ranks)])

    jcfg, cfg = jax_arch(VIT).reduced(), get_arch(VIT).reduced()
    jeng = jax_build(jcfg, plan(JaxRankPlan, JaxPlan), substrate="loopback",
                     seq_len=SEQ)
    eng = build_train_step(cfg, plan(RankPlan, Plan), seq_len=SEQ,
                           device="cpu")
    jstate = jeng.import_state({"step": 0, "p": vit_params})
    state = eng.import_state({"step": 0,
                              "p": params_from_numpy(vit_params, "cpu")})
    stream = pipeline.SyntheticStream(pipeline.DataConfig(cfg.vocab_size,
                                                          SEQ, seed=5))
    for step in range(2):
        big = stream.sample(step, 5)
        jstate, jloss = jeng.step(jstate, big)
        state, loss = eng.step(state, big)
        assert abs(loss - jloss) <= 1e-5, (step, loss, jloss)
    stub = eng.export_state(state)["p"]["frontend_proj"]
    np.testing.assert_array_equal(stub.numpy(), vit_params["frontend_proj"])
    np.testing.assert_array_equal(
        np.asarray(jeng.export_state(jstate)["p"]["frontend_proj"]),
        vit_params["frontend_proj"])
