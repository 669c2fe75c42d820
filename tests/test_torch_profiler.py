"""The port's profiler (``repro_torch.core.profiler``) and its fitting path.

On the CPU, against the JAX package where both compute the same thing:

* ``fit_piecewise`` gives the reference's models (coefficients and
  predictions, exactly) on the reference's own test data
  (``tests/test_profiler_fit.py``): known linear data, a measured table;
* ``refit_cluster_model`` on degraded telemetry and on sparse telemetry
  gives the reference's models, and the planner's plans on them are
  equal;
* ``analytic_memory`` equals the reference's;
* the measured profile of a reduced tiny-llama layer gives finite,
  positive samples, feeds the layer the training step's compute dtype,
  and ``profiled_cluster_model`` on the mini cluster gives a feasible
  plan in which the A6000 gets no less batch than the P100 (as
  ``tests/test_planner.py::test_profiled_workflow_end_to_end``);
* ``wallclock_cluster_model`` gives every rank the same measured models.

On the card (``cuda`` marker): the profiled gpt-1.3b layer runs only the
bf16 tensor-core flash kernels.  The card's machine has no JAX, so the
JAX package is imported inside the CPU tests (the ``ref`` fixture).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import cost_model as C
from repro_torch.core import device_specs as D
from repro_torch.core import model_stats as S
from repro_torch.core import planner as P
from repro_torch.core import profiler as PR
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M

import torch_threads  # noqa: F401,E402  (caps torch's threads)

FIT_CASES = {
    # tests/test_profiler_fit.py:24-34: known linear latency data
    "linear": [(m, 2e-4 + 5e-4 * m) for m in (1, 2, 3, 4, 6, 8, 12, 16)],
    # tests/test_profiler_fit.py:37-43: a measured table
    "table": [(1, 3e-4), (2, 4.5e-4), (4, 9e-4), (8, 2e-3)],
    "one-sample": [(4, 1.0)],
    "unsorted": [(6, 2.0e-3), (1, 4e-4), (3, 9e-4), (2, 7e-4)],
}
PROBE_MS = (0, 1, 2, 3, 4, 5, 8, 12, 16, 32, 64, 100)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules this file compares against."""
    from repro.configs.base import get_arch as jax_arch
    from repro.core import cost_model, device_specs, model_stats, planner
    from repro.core import profiler
    return types.SimpleNamespace(arch=jax_arch, C=cost_model,
                                 D=device_specs, S=model_stats, P=planner,
                                 PR=profiler)


def _model_numbers(model):
    return (model.linear_coeffs,
            [model.one(m) for m in PROBE_MS],
            [model(m, ell=3) for m in PROBE_MS])


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_piecewise_matches_reference(case, ref):
    samples = FIT_CASES[case]
    want = _model_numbers(ref.C.fit_piecewise(samples))
    assert _model_numbers(C.fit_piecewise(samples)) == want
    assert _model_numbers(PR.fit_latency(samples)) == want
    mem, jmem = (C.MemoryModel.fit([1, 2, 4], [3.0, 5.0, 9.0]),
                 ref.C.MemoryModel.fit([1, 2, 4], [3.0, 5.0, 9.0]))
    assert (mem.c0, mem.c1) == (jmem.c0, jmem.c1)


def _mini(devices, cost, stats, arch):
    cluster = devices.Cluster([devices.L4, devices.A6000, devices.P40,
                               devices.P100], 50, "mini")
    return cost.analytic_cluster_model(
        cluster, stats.build_model_stats(arch("tiny-llama").reduced(), 32))


def _cm_numbers(cm):
    out = []
    for dc in cm.per_rank:
        out.append((dc.t_fwd.linear_coeffs, dc.t_bwd.linear_coeffs,
                    [dc.t_fwd.one(m) for m in PROBE_MS],
                    [dc.t_bwd.one(m) for m in PROBE_MS],
                    dc.memory.c0, dc.memory.c1))
    return out


def _telemetry(cm, factor, straggler, grid=(1, 2, 3, 4, 6, 8)):
    def t(model, r, m):
        return model.one(m) * (factor if r == straggler else 1.0)
    return ([[(m, t(cm.per_rank[r].t_fwd, r, m)) for m in grid]
             for r in range(cm.cluster.n)],
            [[(m, t(cm.per_rank[r].t_bwd, r, m)) for m in grid]
             for r in range(cm.cluster.n)])


@pytest.mark.parametrize("factor,straggler", [(2.0, 1), (3.5, 3), (1.0, 0)])
def test_refit_cluster_model_matches_reference(factor, straggler, ref):
    cm = _mini(D, C, S, get_arch)
    jcm = _mini(ref.D, ref.C, ref.S, ref.arch)
    fwd, bwd = _telemetry(cm, factor, straggler)
    jfwd, jbwd = _telemetry(jcm, factor, straggler)
    assert (fwd, bwd) == (jfwd, jbwd)
    refit = PR.refit_cluster_model(cm, fwd, bwd)
    jrefit = ref.PR.refit_cluster_model(jcm, jfwd, jbwd)
    assert _cm_numbers(refit) == _cm_numbers(jrefit)
    assert refit.comm is cm.comm
    plan = P.auto_solve(refit, 48)
    assert plan.feasible
    plan.check()
    assert plan.to_json() == ref.P.auto_solve(jrefit, 48).to_json()


def test_refit_keeps_old_models_on_sparse_telemetry(ref):
    cm = _mini(D, C, S, get_arch)
    n = cm.cluster.n
    one_sample = [[(4, 1.0)]] + [[] for _ in range(n - 1)]
    refit = PR.refit_cluster_model(cm, one_sample, one_sample,
                                   min_samples=2)
    jcm = _mini(ref.D, ref.C, ref.S, ref.arch)
    jrefit = ref.PR.refit_cluster_model(jcm, one_sample, one_sample,
                                        min_samples=2)
    for r in range(n):
        assert refit.per_rank[r].t_fwd is cm.per_rank[r].t_fwd
        assert refit.per_rank[r].memory is cm.per_rank[r].memory
    assert _cm_numbers(refit) == _cm_numbers(jrefit)
    # one sample is enough when min_samples allows it
    refit1 = PR.refit_cluster_model(cm, one_sample, one_sample,
                                    min_samples=1)
    jrefit1 = ref.PR.refit_cluster_model(jcm, one_sample, one_sample,
                                         min_samples=1)
    assert _cm_numbers(refit1) == _cm_numbers(jrefit1)


@pytest.mark.parametrize("seq", (64, 512))
@pytest.mark.parametrize("arch", ("tiny-llama", "gpt-1.3b", "vit-g",
                                  "mamba2-370m"))
def test_analytic_memory_matches_reference(arch, seq, ref):
    got = PR.analytic_memory(get_arch(arch), seq)
    want = ref.PR.analytic_memory(ref.arch(arch), seq)
    assert (got.c0, got.c1) == (want.c0, want.c1)


TINY = get_arch("tiny-llama").reduced(n_layers=1, d_model=256)


@pytest.mark.parametrize("which", ("forward", "backward"))
def test_profile_samples_are_finite_and_positive(which):
    fn = getattr(PR, f"profile_layer_{which}")
    samples = fn(TINY, 32, ms=(1, 2, 4), repeats=1, device="cpu")
    assert [m for m, _ in samples] == [1, 2, 4]
    assert all(np.isfinite(t) and t > 0 for _, t in samples)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_profile_feeds_the_training_dtype(dtype, monkeypatch):
    """The timed layer gets activations in the training step's compute
    dtype and fp32 params, as the trainer's layers do."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    seen = []
    real = M.element_apply

    def spy(cfg_, spec, bp, x, pos, *shared):
        seen.append((x.dtype, {t.dtype for t in bp["attn"].values()}))
        return real(cfg_, spec, bp, x, pos, *shared)

    monkeypatch.setattr(M, "element_apply", spy)
    PR.profile_layer_backward(cfg, 16, ms=(1,), repeats=1, device="cpu")
    assert seen and all(x == M.compute_dtype(cfg) for x, _ in seen)
    assert all(p == {torch.float32} for _, p in seen)


def test_profiled_workflow_on_the_cpu():
    cluster = D.Cluster([D.L4, D.A6000, D.P40, D.P100], 50, "mini")
    cm = PR.profiled_cluster_model(cluster, TINY, seq=64, ms=(1, 2, 4),
                                   repeats=1, device="cpu")
    plan = P.solve(cm, 16)
    assert plan.feasible
    plan.check()
    by_dev = {r.device: r.b for r in plan.ranks}
    assert by_dev["A6000"] >= by_dev["P100"]


def test_wallclock_model_is_the_same_for_every_rank(ref):
    cluster = D.Cluster([D.L4, D.P100, D.P100], 50, "three")
    cm = PR.wallclock_cluster_model(cluster, TINY, 32, ms=(1, 2),
                                    repeats=1, device="cpu")
    assert len({id(dc.t_fwd) for dc in cm.per_rank}) == 1
    assert all(dc.t_head is None for dc in cm.per_rank)
    mem = ref.PR.analytic_memory(ref.arch("tiny-llama").reduced(
        n_layers=1, d_model=256), 32)
    assert (cm.per_rank[0].memory.c0, cm.per_rank[0].memory.c1) == \
        (mem.c0, mem.c1)
    assert P.auto_solve(cm, 8).feasible


def test_profile_refuses_the_hybrid_shared_block():
    """A hybrid was refused before the port had zamba stages; it is now
    profiled as the reference profiles it: ``_layer`` gives the first
    stage's element (its SSM blocks stacked) and the shared block, and
    both sweeps give finite, positive samples.  CUDA asked for and absent
    is still refused."""
    hybrid = get_arch("zamba2-7b").reduced()
    spec, bp, shared = PR._layer(hybrid, torch.device("cpu"))
    assert (spec.kind, spec.inner) == ("zamba", 2)
    assert bp["mamba"]["ssd"]["in_proj"].shape[0] == 2
    assert set(shared) == {"ln_attn", "attn", "ln_mlp", "mlp"}
    assert PR._layer(TINY, torch.device("cpu"))[2] is None
    for fn in (PR.profile_layer_forward, PR.profile_layer_backward):
        samples = fn(hybrid, 16, ms=(1, 2), repeats=1, device="cpu")
        assert all(np.isfinite(t) and t > 0 for _, t in samples)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PR.profile_layer_forward(TINY, 16, ms=(1,), repeats=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_profile_runs_the_bf16_kernels(cuda):
    cfg = get_arch("gpt-1.3b")
    flash_ops.VARIANT_LAUNCHES.update(
        dict.fromkeys(flash_ops.VARIANT_LAUNCHES, 0))
    flash_ops.BWD_VARIANT_LAUNCHES.update(
        dict.fromkeys(flash_ops.BWD_VARIANT_LAUNCHES, 0))
    fwd = PR.profile_layer_forward(cfg, 512, ms=(1, 2), repeats=2)
    bwd = PR.profile_layer_backward(cfg, 512, ms=(1, 2), repeats=2)
    assert all(np.isfinite(t) and t > 0 for _, t in fwd + bwd)
    calls = 2 * (1 + 2)
    assert flash_ops.VARIANT_LAUNCHES == {"fp32-fma": 0,
                                          "bf16-mma": 2 * calls}
    assert flash_ops.BWD_VARIANT_LAUNCHES == {"fp32-fma": 0,
                                              "bf16-mma": 2 * calls}
