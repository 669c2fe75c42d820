"""The port's planner side against the JAX package's, exactly, on the CPU.

Both packages compute the model stats, the analytic cost models and the
plans with numpy on the same inputs, so every number must be equal, not
close:

* ``build_model_stats`` for every arch the port registers, at seq 64 and
  512;
* ``analytic_cluster_model``'s latencies, memory and comm models at m in
  {1, 2, 4, 8, 16}, on the mini cluster, the paper's Cluster A and
  Cluster B;
* ``plan.to_json()`` of ``solve``, ``solve_scaled``, ``auto_solve``,
  ``plan_even``, ``plan_compute_only``, ``plan_memory_only`` and
  ``plan_whale``, and ``evaluate_plan``'s prices, for (mini, cluster-a,
  cluster-b) x (gpt-1.3b, bert-large, vit-g, llama-7b) x batch (32, 128);
* the device registry: the paper's Table 3 GPUs and clusters as the
  reference has them, and the port's H100.
"""

import dataclasses

import pytest

from repro.configs.base import get_arch as jax_arch
from repro.core import cost_model as JC
from repro.core import device_specs as JD
from repro.core import model_stats as JS
from repro.core import planner as JP
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core import cost_model as C
from repro_torch.core import device_specs as D
from repro_torch.core import model_stats as S
from repro_torch.core import planner as P

import torch_threads  # noqa: F401,E402  (caps torch's threads)

ARCHS = list(list_archs())
SEQS = (64, 512)
MS = (1, 2, 4, 8, 16)
PLAN_ARCHS = ("gpt-1.3b", "bert-large", "vit-g", "llama-7b")
PLAN_BATCHES = (32, 128)


def _clusters(devices):
    return {
        "mini": lambda: devices.Cluster(
            [devices.L4, devices.A6000, devices.P40, devices.P100],
            link_gbps=50, name="mini"),
        "cluster-a": devices.cluster_a,
        "cluster-b": devices.cluster_b,
    }


CLUSTERS, JAX_CLUSTERS = _clusters(D), _clusters(JD)


def _stats_fields(stats):
    return (stats.name, [(dataclasses.astuple(s), c) for s, c in stats.layers],
            stats.embed_params, stats.seq_len, stats.d_model,
            stats.vocab_size, stats.n_layers, stats.total_params,
            stats.active_params, stats.flops_fwd_per_sample(),
            stats.head_flops_fwd_per_sample(), stats.state_bytes())


def test_registry_keeps_the_papers_gpus_and_adds_the_h100():
    for name in ("P40", "P100", "A6000", "L4", "V100", "T4", "A10G"):
        assert dataclasses.astuple(D.get(name)) == \
            dataclasses.astuple(JD.get(name))
    for make in ("cluster_a", "cluster_b", "cluster_b_subset",
                 "homogeneous_a10g", "v100_cluster"):
        got, want = getattr(D, make)(), getattr(JD, make)()
        assert got.describe() == want.describe()
        assert [dataclasses.astuple(d) for d in got.devices] == \
            [dataclasses.astuple(d) for d in want.devices]
        assert (got.link_efficiency, got.gpus_per_node) == \
            (want.link_efficiency, want.gpus_per_node)
    h100 = D.get("H100")
    assert (h100.peak_tflops, h100.memory_gib, h100.hbm_gbps) == \
        (66.9, 80.0, 3350.0)
    assert not any(n.startswith("tpu") for n in D.known_devices())


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_stats_match_reference(arch, seq):
    got = S.build_model_stats(get_arch(arch), seq)
    want = JS.build_model_stats(jax_arch(arch), seq)
    assert _stats_fields(got) == _stats_fields(want)
    assert S.param_count(get_arch(arch)) == JS.param_count(jax_arch(arch))


def _cost_numbers(cm):
    out = [cm.layer_param_bytes(), cm.even_state_bytes_per_rank(),
           cm.ag_latency(False), cm.ag_latency(True),
           cm.rs_latency(False), cm.rs_latency(True),
           dataclasses.astuple(cm.comm)]
    for dc in cm.per_rank:
        out.append((dc.spec.name, dc.mem_cap(), dc.t_fwd.linear_coeffs,
                    dc.t_bwd.linear_coeffs, dc.memory.c0, dc.memory.c1))
        for m in MS:
            out.append((dc.t_fwd(m), dc.t_bwd(m), dc.t_fwd(m, ell=3),
                        dc.memory(m), dc.head_time(m, 1),
                        dc.head_time(m, 2)))
    return out


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cluster_model_matches_reference(arch, seq):
    stats = S.build_model_stats(get_arch(arch), seq)
    jstats = JS.build_model_stats(jax_arch(arch), seq)
    for name in CLUSTERS:
        got = C.analytic_cluster_model(CLUSTERS[name](), stats)
        want = JC.analytic_cluster_model(JAX_CLUSTERS[name](), jstats)
        assert _cost_numbers(got) == _cost_numbers(want), name


def _plans(planner, cm, batch):
    out = {"solve": planner.solve(cm, batch),
           "solve_scaled": planner.solve_scaled(cm, batch),
           "auto_solve": planner.auto_solve(cm, batch),
           "plan_even": planner.plan_even(cm, batch),
           "plan_compute_only": planner.plan_compute_only(cm, batch),
           "plan_memory_only": planner.plan_memory_only(cm, batch),
           "plan_whale": planner.plan_whale(cm, batch)}
    json = {k: p.to_json() for k, p in out.items()}
    for k, p in out.items():
        if p.feasible:
            json[f"evaluate_plan({k})"] = planner.evaluate_plan(cm, p)
    return json


@pytest.mark.parametrize("batch", PLAN_BATCHES)
@pytest.mark.parametrize("arch", PLAN_ARCHS)
@pytest.mark.parametrize("cluster", list(CLUSTERS))
def test_plans_match_reference(cluster, arch, batch):
    cm = C.analytic_cluster_model(CLUSTERS[cluster](),
                                  S.build_model_stats(get_arch(arch), 512))
    jcm = JC.analytic_cluster_model(
        JAX_CLUSTERS[cluster](),
        JS.build_model_stats(jax_arch(arch), 512))
    got, want = _plans(P, cm, batch), _plans(JP, jcm, batch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_partition_state_matches_reference():
    stats = S.build_model_stats(get_arch("gpt-1.3b"), 512)
    jstats = JS.build_model_stats(jax_arch("gpt-1.3b"), 512)
    cm = C.analytic_cluster_model(D.cluster_a(), stats)
    jcm = JC.analytic_cluster_model(JD.cluster_a(), jstats)
    compute = [dc.memory(m) for dc, m in zip(cm.per_rank,
                                             (27, 27, 34, 9, 9, 4, 7, 7))]
    got, want = P.partition_state(cm, compute), JP.partition_state(jcm,
                                                                   compute)
    assert got.tolist() == want.tolist()
    # a compute footprint that leaves no room: both refuse
    full = [dc.mem_cap() for dc in cm.per_rank]
    assert P.partition_state(cm, full) is None
    assert JP.partition_state(jcm, full) is None


def test_evaluate_plan_refuses_a_mismatched_plan():
    cm = C.analytic_cluster_model(CLUSTERS["mini"](), S.build_model_stats(
        get_arch("gpt-1.3b"), 512))
    plan = P.auto_solve(C.analytic_cluster_model(
        D.cluster_a(), cm.model), 32)
    with pytest.raises(ValueError, match="1:1"):
        P.evaluate_plan(cm, plan)
