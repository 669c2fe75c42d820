"""The port's process fleet against its loopback engine, bit for bit, on
the CPU: ``tests/test_parity_matrix.py``'s matrix on the port.

The parity-matrix plan (ragged on purpose: uneven m, ell and ratios, so
the schedules make different rounds and every collective is
variable-size) and reduced tiny-llama, 2 seeded steps from the same
``torch.Generator`` state: {hub, ring, ring + overlap} x {layered,
per_microbatch, interleaved} against the loopback engine.  Losses,
params and Adam moments are compared with ``torch.equal`` and the
collective counts must agree: the hub sums at the coordinator, the ring
accumulates then combines at each destination, in the same rank order
as the loopback's sum, and the overlapped pipeline only moves payloads
earlier.  One fleet a topology variant runs the three schedules in
turn, each from a fresh state (the ring's fleet also runs the JAX
case).  A sanitized
overlapped fleet (the fourth and last) is bitwise its unsanitized twin,
and a fleet started from the JAX package's init gives the losses of the
reference's ``HeteroTrainer`` within 1e-5 (``tests/test_torch_engine.py``'s
tolerance).
"""

import multiprocessing as mp

import jax
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.engine import build_train_step, get_schedule
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

SCHEDULES = ("layered", "per_microbatch", "interleaved")
RANKS = [("A", 2, 2, 0.6), ("B", 1, 1, 0.4)]
SEQ, STEPS = 16, 2
MP_VARIANTS = {
    "hub": {"topology": "hub"},
    "ring": {"topology": "ring"},
    "ring+overlap": {"topology": "ring", "overlap_rounds": True},
}
_CELLS: dict = {}
#: open fleets, by (variant, spawn-time knobs); closed when the module ends
_FLEETS: dict = {}
#: the fleets of this file fork from one server process that imported
#: the runtime once (``start_method="forkserver"``), not each a fresh
#: interpreter (``spawn``, the default, which the launcher's and the
#: death tests' fleets keep): numerics are what this file checks.  The
#: server also imports ``torch._dynamo``, which the first activation
#: checkpoint of a process would import (~2.5 s a worker)
START = "forkserver"
mp.get_context(START).set_forkserver_preload(
    ["repro_torch.core.engine.multiproc", "torch._dynamo"])


def _plan():
    ranks = [RankPlan(i, d, m=m, ell=ell, state_ratio=r)
             for i, (d, m, ell, r) in enumerate(RANKS)]
    return Plan(model="toy", cluster="toy",
                global_batch=sum(m * ell for _, m, ell, _ in RANKS),
                ranks=ranks)


@pytest.fixture(scope="module", autouse=True)
def _close_fleets():
    yield
    while _FLEETS:
        _FLEETS.popitem()[1].close()


def _engine(cfg, plan, schedule, label, **extra):
    """A loopback engine of its own, or the fleet of ``label`` and
    ``extra``.  A fleet's schedule lives in its coordinator (the workers
    run the rounds it sends), so one fleet a topology variant runs every
    schedule in turn, each from a fresh state; a knob that is fixed when
    the workers start (``sanitize``) has a fleet of its own."""
    kw = dict(adam=AdamConfig(lr=1e-3), seq_len=SEQ, device="cpu")
    if label == "loopback":
        return build_train_step(cfg, plan, substrate="loopback",
                                schedule=schedule, **kw)
    key = (label, tuple(sorted(extra.items())))
    if key not in _FLEETS:
        _FLEETS[key] = build_train_step(
            cfg, plan, substrate="multiproc", schedule=schedule,
            start_method=START, **MP_VARIANTS[label], **extra, **kw)
    eng = _FLEETS[key]
    eng.schedule = get_schedule(schedule)
    return eng


def _run(schedule, label, init=None, **extra):
    """STEPS seeded steps on one engine: (losses, exported state, the
    collective counts of these steps)."""
    cfg = get_arch("tiny-llama").reduced()
    plan = _plan()
    stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=2))
    eng = _engine(cfg, plan, schedule, label, **extra)
    fleet = label != "loopback"
    counts = eng.substrate.stats if fleet else eng.trainer.substrate.stats
    before = dict(counts)
    try:
        state = eng.init_state(torch.Generator().manual_seed(0)) \
            if init is None else eng.import_state({"step": 0, "p": init})
        losses = []
        for step in range(STEPS):
            state, loss = eng.step(state, stream.sample(
                step, plan.global_batch))
            losses.append(loss)
        exported = eng.export_state(state)
        stats = {k: n - before.get(k, 0) for k, n in counts.items()}
        if fleet:
            # the full gather is the exported p, and the memory report
            # names each worker's pid
            _assert_equal(exported["p"], eng.gather_params(state), label)
            assert "pid " in eng.memory_report(state)
    finally:
        if not fleet:
            eng.close()
    return losses, exported, stats


def _cell(schedule, label):
    if (schedule, label) not in _CELLS:
        _CELLS[schedule, label] = _run(schedule, label)
    return _CELLS[schedule, label]


def _leaves(tree):
    return fsdp.tree_flatten(tree)[0]


def _assert_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x.cpu(), y.cpu()), (what, i)


@pytest.mark.parametrize("label", list(MP_VARIANTS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fleet_is_bitwise_the_loopback(schedule, label):
    ref_losses, ref_export, ref_stats = _cell(schedule, "loopback")
    # the reference must be non-trivial or the bitwise claim is vacuous
    assert ref_export["step"] == STEPS
    assert max(float(t.abs().max()) for t in _leaves(ref_export["m"])) > 0
    losses, exported, stats = _cell(schedule, label)
    assert losses == ref_losses, (label, losses, ref_losses)
    assert stats == ref_stats, (label, stats, ref_stats)
    assert exported["step"] == STEPS
    for part in ("p", "m", "v"):
        _assert_equal(ref_export[part], exported[part], (label, part))


def test_sanitized_overlapped_fleet_is_bitwise_unsanitized():
    """The live comm sanitizer only observes: a sanitized overlapped ring
    fleet is bitwise the unsanitized one."""
    losses, exported, stats = _run("per_microbatch", "ring+overlap",
                                   sanitize=True)
    ref_losses, ref_export, ref_stats = _cell("per_microbatch",
                                              "ring+overlap")
    assert losses == ref_losses and stats == ref_stats
    for part in ("p", "m", "v"):
        _assert_equal(ref_export[part], exported[part], part)


def test_fleet_losses_match_the_jax_hetero_trainer():
    """A ring fleet started from the JAX package's init takes the losses
    of the reference's loopback ``HeteroTrainer`` on the same blocks."""
    from repro.configs.base import get_arch as jax_arch
    from repro.core.engine import build_train_step as jax_build
    from repro.core.partition import Plan as JaxPlan
    from repro.core.partition import RankPlan as JaxRankPlan
    from repro.models import model as JM
    from repro.optim.adam import AdamConfig as JaxAdam

    jcfg = jax_arch("tiny-llama").reduced()
    init = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jplan = JaxPlan(model="toy", cluster="toy", global_batch=5,
                    ranks=[JaxRankPlan(i, d, m=m, ell=ell, state_ratio=r)
                           for i, (d, m, ell, r) in enumerate(RANKS)])
    jeng = jax_build(jcfg, jplan, substrate="loopback",
                     schedule="per_microbatch", adam=JaxAdam(lr=1e-3),
                     seq_len=SEQ)
    jstate = jeng.import_state({"step": 0, "p": init})
    stream = SyntheticStream(DataConfig(jcfg.vocab_size, SEQ, seed=2))
    want = []
    for step in range(STEPS):
        jstate, loss = jeng.step(jstate, stream.sample(step, 5))
        want.append(float(loss))
    losses, exported, _ = _run("per_microbatch", "ring",
                               init=params_from_numpy(init, "cpu"))
    assert exported["step"] == STEPS
    for got, ref in zip(losses, want):
        assert abs(got - ref) <= 1e-5, (losses, want)

