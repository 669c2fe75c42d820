"""The port's roofline terms and its collective counts, on the CPU.

* The analytic terms (``repro_torch.roofline.analysis``) evaluated at the
  reference's hardware constants (``repro.roofline.analysis``'s
  ``PEAK_FLOPS``, ``HBM_BPS``, ``ICI_BPS``) equal the reference's for
  every assigned arch × every ``INPUT_SHAPES`` entry × chips 1, 256 and
  512: every field of the row within 1e-9 relative, ``dominant`` and the
  bottleneck hint equal.  The H100's constants are the port's default.
* The collectives one SPMD step issues, counted as they run
  (``CollectiveStats.from_substrate``) in a gloo world of 2, equal the
  analytic ``program_collectives`` of the same program built on the mesh
  alone, for each schedule (layered, per_microbatch, interleaved at ℓ 4)
  and for an untied model, a tied one (the embedding gathered again in
  the head), learned positions (the misc unit in the embedding too) and
  no remat (one gather a site): counts and padded bytes exactly, and the
  unpadded bytes no more than the run's.
"""

import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.roofline import analysis as JR
from repro_torch.configs import base as pt_base
from repro_torch.core import device_specs
from repro_torch.core.engine import world as W
from repro_torch.core.layered_ga import CephaloProgram
from repro_torch.roofline import analysis as R

import torch_threads  # noqa: F401,E402  (caps torch's threads)

REF_HW = R.Hardware("v5e", JR.PEAK_FLOPS, JR.HBM_BPS, JR.ICI_BPS)
CHIPS = (1, 256, 512)


@pytest.mark.parametrize("arch", pt_base.ASSIGNED)
def test_terms_match_reference(arch):
    jcfg, pcfg = jax_base.get_arch(arch), pt_base.get_arch(arch)
    for name, jshape in jax_base.INPUT_SHAPES.items():
        shape = pt_base.INPUT_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        for chips in CHIPS:
            ref = JR.terms_for(jcfg, jshape, chips)
            got = R.terms_for(pcfg, shape, chips, hw=REF_HW)
            want, row = ref.row(), got.row()
            assert set(row) == set(want)
            for k, v in want.items():
                if isinstance(v, str):
                    assert row[k] == v, (name, chips, k)
                else:
                    assert row[k] == pytest.approx(v, rel=1e-9, abs=0), \
                        (name, chips, k)
            assert R.what_would_move_it(got, shape.kind) == \
                JR.what_would_move_it(ref, jshape.kind)
            assert got.bound_s == pytest.approx(ref.bound_s, rel=1e-9)


def test_h100_constants():
    """The default hardware: dense bf16 tensor-core peak, HBM3 and NVLink
    a direction, from the device registry."""
    assert R.H100.peak_flops == 989.4e12
    assert R.H100.hbm_bps == 3350e9
    assert R.H100.link_bps == 450e9
    assert device_specs.H100.hbm_gbps * 1e9 == R.H100.hbm_bps
    cfg, shape = pt_base.get_arch("llama-7b"), pt_base.INPUT_SHAPES[
        "prefill_32k"]
    t = R.terms_for(cfg, shape, 256)
    assert t.hw is R.H100
    assert t.compute_s == t.flops / 989.4e12


# ---------------------------------------------------------------------------
# The collectives a step issues, counted against the analytic ones
# ---------------------------------------------------------------------------

SCHEDULES = ("layered", "per_microbatch", "interleaved")
#: (arch, program knobs): untied, tied, learned positions, no remat
PROGRAMS = [("tiny-llama", {}), ("gemma-2b", {}), ("gpt-1.3b", {}),
            ("tiny-llama", {"remat": "none"})]
ELL, M, SEQ = 4, 1, 8
MESH = W.Mesh((2,), ("data",))


def _kwargs(sched, knobs):
    return dict(ratios=[0.6, 0.4], ell=ELL, m=M, seq=SEQ, schedule=sched,
                **knobs)


def _rank_collectives(ctx, cases):
    """One step of each (arch, schedule, knobs) program from seeded
    state: what the substrate counted."""
    out = []
    for arch, sched, knobs in cases:
        cfg = pt_base.get_arch(arch).reduced()
        prog = CephaloProgram(cfg, ctx, **_kwargs(sched, knobs))
        state = prog.init_state(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(ctx.rank)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (ELL, M, SEQ + 1)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                 "weights": torch.full((ELL, M, SEQ), 1.0 / (2 * ELL * SEQ))}
        prog.substrate.reset_stats()
        prog.step(state, batch)
        stats = R.CollectiveStats.from_substrate(prog.substrate)
        out.append((stats.counts, stats.bytes_by_op))
    return out


CASES = [(a, s, k) for a, k in PROGRAMS for s in SCHEDULES]


@pytest.fixture(scope="module")
def counted():
    with W.World(MESH, "cpu") as world:
        return world.call(_rank_collectives, (CASES,))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-{s}-{'-'.join(k.values()) or 'full'}"
                              for a, s, k in CASES])
def test_counted_collectives_are_the_analytic_ones(counted, case):
    arch, sched, knobs = CASES[case]
    cfg = pt_base.get_arch(arch).reduced()
    prog = CephaloProgram(cfg, MESH, **_kwargs(sched, knobs))
    want = R.program_collectives(prog)
    unpadded = R.program_collectives(prog, padded=False)
    rounds = len(prog.schedule.chunks(ELL))
    assert want.counts["reduce_scatter"] == rounds * sum(
        R.gather_sites(cfg, prog.groups).values())
    for rank in (0, 1):
        counts, nbytes = counted[rank][case]
        assert counts == want.counts
        assert nbytes == {k: int(v) for k, v in want.bytes_by_op.items()}
        for op, v in nbytes.items():
            assert unpadded.bytes_by_op[op] <= v
