"""The port's offline protocol checker (``core/engine/verify``) against the
JAX package's, on the CPU.

* The grid: every cell of the port's ``verify_grid`` has the reference's
  verdict — rejected or not, and on each data plane (rendezvous pipe,
  buffered shm) the same violation kinds, events run and buffer peaks —
  for the baseline protocol and for each seeded mutant's variant run
  over the whole grid.
* The mutation harness catches every mutant, with the reference's names
  and violation kinds.
* The determinism lint reads the port's own data plane
  (``src/repro_torch/core/engine``) and finds nothing there; a DET-1
  violation seeded into a copy of the port's ``multiproc.py`` is
  flagged, as are the reference's lint snippets.
* The single-cell cases of ``tests/test_verify_protocol.py``: each
  mutant's violation class on its minimal cell, the send-first deadlock
  on the pipe plane only, the model's round geometry, hub x overlap
  rejected by construction, the default layouts, the overlap plan.
* ``python -m repro_torch.core.engine.verify`` exits 0 and reports the
  132-cell grid.
"""

import os
import subprocess
import sys

import pytest

from repro.core.engine import verify as jax_verify
from repro.core.engine.verify import mutations as jax_mutations
from repro_torch.core.engine import multiproc, ring
from repro_torch.core.engine.verify import (BASELINE, Cell, RankShape,
                                            Variant, default_layouts,
                                            grid_cells, lint, lint_determinism,
                                            rounds_for, run_mutation_harness,
                                            verify_cell, verify_grid)
from repro_torch.core.engine.verify.model import overlap_plan_depth
from repro_torch.core.engine.verify.mutations import (RING_ORDER_SNIPPET,
                                                      STATIC_MUTANTS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _uniform(n, ell=2, m=1, chunk=4):
    return tuple(RankShape(ell=ell, m=m, chunk=chunk) for _ in range(n))


def _verdicts(report):
    """Cell label → (rejected, per plane: plane, ok, violation kinds,
    events run, queue and parking peaks)."""
    return {r.cell.label(): (
        r.rejected,
        [(p.plane, p.ok, sorted(v.check for v in p.violations),
          p.events_run, sorted(p.max_queue.items()),
          sorted(p.max_parked.items())) for p in r.planes])
        for r in report.reports}


def _variant_pair(name):
    if name == "baseline":
        return BASELINE, jax_verify.BASELINE
    variant = STATIC_MUTANTS[name][0]
    return variant, jax_mutations.STATIC_MUTANTS[name][0]


# --- the grid and the harness ---------------------------------------------------

@pytest.mark.parametrize("variant", ["baseline", *STATIC_MUTANTS])
def test_grid_verdicts_match_reference(variant):
    ours, theirs = _variant_pair(variant)
    assert ours == Variant(**vars(theirs))
    got = verify_grid(variant=ours)
    want = jax_verify.verify_grid(variant=theirs)
    assert len(got.reports) == len(grid_cells()) == 132
    assert _verdicts(got) == _verdicts(want)
    assert (got.ok, got.checked, got.rejected) == \
        (want.ok, want.checked, want.rejected)
    if variant == "baseline":
        assert got.ok and got.checked == 99 and got.rejected == 33
        for r in got.reports:
            if r.rejected is None:
                assert [p.plane for p in r.planes] == ["pipe", "shm"]
                assert all(p.events_run > 0 for p in r.planes)
    else:   # each mutant fails somewhere on the grid
        assert not got.ok


def test_mutation_harness_matches_reference():
    got, want = run_mutation_harness(), jax_verify.run_mutation_harness()
    assert got.ok, got.summary()
    assert [(r.name, r.detected, r.expected) for r in got.results] == \
        [(r.name, r.detected, r.expected) for r in want.results]
    assert {r.name for r in got.results} == \
        set(STATIC_MUTANTS) | {"ring_order_accumulation"}
    assert got.summary().splitlines()[-1] == \
        "mutation harness: 5 seeded bugs, 0 escaped"


# --- the determinism lint ------------------------------------------------------------

def test_lint_reads_the_ports_data_plane():
    engine_dir = os.path.dirname(os.path.abspath(multiproc.__file__))
    assert lint._engine_dir() == engine_dir
    assert engine_dir.endswith(os.path.join("repro_torch", "core",
                                            "engine"))
    for module in lint.DATA_PLANE_MODULES:
        assert os.path.isfile(os.path.join(engine_dir, module))
    # every allowlisted function exists in the port's modules
    for base, qualname in (*lint.DICT_REDUCTION_ALLOWLIST,
                           *lint.ACCUM_CALL_ALLOWLIST):
        with open(os.path.join(engine_dir, base)) as f:
            assert f"def {qualname.split('.')[-1]}(" in f.read()
    assert lint_determinism() == []


def test_lint_flags_a_seeded_det1_in_the_ports_multiproc():
    with open(multiproc.__file__) as f:
        source = f.read()
    line = "\n        round_sum = ring.combine_fixed_order(collected)\n"
    assert source.count(line) == 1
    mutant = source.replace(line, (
        "\n        round_sum = {}\n"
        "        for origin, chunks in dict(enumerate(collected)).items():\n"
        "            for u, a in (chunks or {}).items():\n"
        "                round_sum[u] = round_sum[u] + a "
        "if u in round_sum else a\n"))
    assert lint_determinism(paths=[], extra_sources=[
        ("multiproc.py", source)]) == []
    findings = lint_determinism(paths=[], extra_sources=[
        ("multiproc.py", mutant)])
    assert {f.rule for f in findings} == {"DET-1", "DET-2"}
    assert {f.qualname for f in findings} == {"_Worker.ring_round"}


ORDER_DEP_SNIPPET = '''\
def bad(self, arrival):
    acc = None
    for origin, chunks in arrival.items():
        acc = chunks if acc is None else merge(acc, chunks)
    self.accum_grads(acc)
'''

PER_KEY_SNIPPET = '''\
def fine(self, shards):
    out = {}
    for k, v in shards.items():
        out[k] = v * 2
    return out
'''

UNBOUND_ACCUM_SNIPPET = '''\
def bad2(self, grads):
    total = grads
    self.accum_grads(total)
'''


@pytest.mark.parametrize("snippet,rules", [
    (ORDER_DEP_SNIPPET, {"DET-2"}),
    (PER_KEY_SNIPPET, set()),
    (UNBOUND_ACCUM_SNIPPET, {"DET-2"}),
    (RING_ORDER_SNIPPET, {"DET-1", "DET-2"})],
    ids=["order-dependent", "per-key", "unbound-accum", "ring-order"])
def test_lint_snippets_match_reference(snippet, rules):
    got = lint_determinism(paths=[], extra_sources=[("<m>", snippet)])
    want = jax_verify.lint_determinism(paths=[],
                                       extra_sources=[("<m>", snippet)])
    assert [str(f) for f in got] == [str(f) for f in want]
    assert {f.rule for f in got} == rules


# --- single cells ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STATIC_MUTANTS))
def test_each_mutant_is_caught_on_its_minimal_cell(name):
    variant, cell, expected = STATIC_MUTANTS[name]
    assert verify_cell(cell).ok, f"{name}: the baseline fails its cell"
    assert expected in {v.check for v in
                        verify_cell(cell, variant).violations()}


def test_send_first_order_deadlocks_on_pipe_plane_only():
    cell = Cell("ring", "layered", False, _uniform(2), "uniform")
    report = verify_cell(cell, Variant(name="x", send_order="send_first"))
    by_plane = {p.plane: p for p in report.planes}
    assert any(v.check == "deadlock" for v in by_plane["pipe"].violations)
    assert not any(v.check == "deadlock"
                   for v in by_plane["shm"].violations)


@pytest.mark.parametrize("layout,schedule,active", [
    (_uniform(3, ell=2), "per_microbatch", [(0, 1, 2), (0, 1, 2)]),
    ((RankShape(ell=2, m=1, chunk=4), RankShape(ell=1, m=1, chunk=4),
      RankShape(ell=2, m=0, chunk=4)), "per_microbatch", [(0, 1), (0,)]),
    (_uniform(3, ell=2), "layered", [(0, 1, 2)])],
    ids=["uniform", "sheds-short-and-idle", "layered"])
def test_rounds_for_geometry(layout, schedule, active):
    cell = Cell("ring", schedule, False, layout, "x")
    rounds = rounds_for(cell)
    assert [r.active for r in rounds] == active
    assert verify_cell(cell).ok


def test_hub_overlap_rejected_by_construction():
    cell = Cell("hub", "layered", True, _uniform(2), "uniform")
    assert cell.rejected_reason
    report = verify_cell(cell)
    assert report.ok and report.rejected and report.planes == []


def test_default_layouts_cover_zero_shard_and_idle_rank():
    layouts = default_layouts(5)
    assert set(layouts) == {"uniform", "ragged", "idle-rank"}
    assert any(rs.chunk == 0 for rs in layouts["ragged"])
    idle = layouts["idle-rank"]
    assert idle[-1].b == 0 and all(rs.b > 0 for rs in idle[:-1])
    assert set(default_layouts(1)) == {"uniform", "ragged"}


def test_overlap_plan_depths():
    for n in range(1, 7):
        assert overlap_plan_depth(n, 1) == ring.overlap_plan(n)
    with pytest.raises(ValueError):
        overlap_plan_depth(3, 0)
    ops = overlap_plan_depth(4, 2)
    idx = ops.index(("reduce_scatter", 0))
    assert {k for op, k in ops[:idx] if op == "allgather"} == {0, 1, 2}


# --- the command line -----------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--grid"], []], ids=["grid", "all"])
def test_verify_cli_exits_zero(flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.engine.verify", *flags],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "(grid size: 132 cells)"
    assert ("grid: 99 cells verified on both planes, 33 "
            "rejected-by-construction, 0 failing") in lines
    if not flags:
        assert "determinism lint: 0 finding(s)" in lines
        assert "mutation harness: 5 seeded bugs, 0 escaped" in lines
