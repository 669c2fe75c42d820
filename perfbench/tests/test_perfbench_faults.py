"""The check fails what it must: a run of a cell at a test's size with the
timed path broken underneath comes out not correct, once for each fault
a training step can have, and the float8 control reads above the
bfloat16 program at the same size."""

import time

import pytest
import torch

from perfbench.tests import tiny
from perfbench import checks, control
from perfbench.roofline import peaks
from perfbench.runners import train_mpmd as R
from repro_torch.core import hetero_trainer as HT


def _run(family="dense", dtype="float32", seed=21):
    return R.run(tiny.cell(family, dtype), seed, 0.2, False,
                 time.perf_counter(), device="cpu",
                 peaks=peaks.PEAKS["H100"])


def _unchanged(mp):
    """A step that returns its state unchanged: Adam never applied."""
    mp.setattr(HT, "adam_update", lambda *a, **k: None)


def _half_batch(mp):
    """Half of every pass's rows left out, the mean over the rest."""
    orig = HT.HeteroTrainer.rank_batches

    def rank_batches(self, big):
        out = []
        for b in orig(self, big):
            if b is None or b["tokens"].shape[0] < 2:
                out.append(b)
                continue
            n = b["tokens"].shape[0] // 2
            out.append({"tokens": b["tokens"][:n], "labels": b["labels"][:n],
                        "weights": b["weights"][:n] * 2})
        return out
    mp.setattr(HT.HeteroTrainer, "rank_batches", rank_batches)


def _exchange(mp):
    """Only the first pass's gradient reaches the sum: every other pass's
    rows are weighted 0."""
    orig = HT.HeteroTrainer.rank_batches

    def rank_batches(self, big):
        out, seen = [], False
        for b in orig(self, big):
            if b is not None and seen:
                b = dict(b, weights=b["weights"] * 0)
            seen = seen or b is not None
            out.append(b)
        return out
    mp.setattr(HT.HeteroTrainer, "rank_batches", rank_batches)


def _answer(mp):
    """Each pass's loss altered where it is produced (by 1%)."""
    orig = HT.rank_loss_and_grads

    def rank_loss_and_grads(*a, **k):
        loss, grads = orig(*a, **k)
        return loss * 1.01, grads
    mp.setattr(HT, "rank_loss_and_grads", rank_loss_and_grads)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("plant,fails", [
    (_unchanged, "change_gap"), (_half_batch, "grad_gap"),
    (_exchange, "grad_gap"), (_answer, "loss_gap")],
    ids=["unchanged", "half_batch", "exchange", "answer"])
def test_a_broken_step_is_not_correct(monkeypatch, plant, fails):
    plant(monkeypatch)
    out = _run()
    assert not out["correct"]
    assert out["checks"][fails]["value"] > out["checks"][fails]["limit"]


def test_the_float8_control_reads_above_the_bfloat16_program():
    """At a test's size, on three seeds: the control's worst reading of
    each number is above the bfloat16 program's worst, and the control
    and each fault that ``control.py`` reads come out not correct against
    limits that the program meets (set from the program's readings, as a
    cell's are)."""
    cell = tiny.cell("dense", "bfloat16")
    prog = []
    for seed in (31, 32, 33):
        out = R.run(cell, seed, 0.2, False, time.perf_counter(),
                    device="cpu", peaks=peaks.PEAKS["H100"])
        prog.append({k: v["value"] for k, v in out["checks"].items()})
    worst = {n: max(r[n] for r in prog) for n in checks.NUMBERS}
    cell.checks["limits"] = {n: 1.5 * worst[n] for n in checks.NUMBERS}
    ctl = []
    for seed in (31, 32, 33):
        out = control.readings(cell, seed, [7, 7, 34], "cpu")
        assert set(out["verdicts"]) == set(control.READINGS)
        for name, v in out["verdicts"].items():
            assert v["correct"] is False, (seed, name, v)
        ctl.append(out["control"])
    for n in ("loss_gap", "grad_gap"):
        assert min(r[n] for r in ctl) > worst[n], (n, ctl, prog)


def test_verdicts_judge_each_reading_by_the_limits():
    limits = {"loss_gap": 0.1, "grad_gap": 0.1, "change_gap": 0.5}
    out = {"control": {"loss_gap": 0.01, "grad_gap": 0.2,
                       "change_gap": 0.01},
           "half_batch": {"loss_gap": 0.01, "grad_gap": 0.05},
           "exchange": {"loss_gap": 0.2, "grad_gap": 0.2},
           "answer": {"loss_gap": 0.2},
           "unchanged": {"change_gap": 1.0}}
    v = control.verdicts(out, limits)
    assert {n: x["correct"] for n, x in v.items()} == {
        "control": False, "half_batch": True, "exchange": False,
        "answer": False, "unchanged": False}
    assert v["control"]["checks"]["grad_gap"] == {"value": 0.2,
                                                  "limit": 0.1}


def test_gaps_read_each_number():
    ref = {"losses": [10.0, 9.0],
           "grad_norms": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0},
           "change_norms": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0}}
    got = {"losses": [10.01, 9.09],
           "grad_norms": {"a": 1.0, "b": 1.01, "c": 1.02, "d": 1.5},
           "change_norms": {"a": 1.0, "b": 1.0, "c": 1.1, "d": 1.0}}
    assert checks.gaps(got, ref) == pytest.approx(
        {"loss_gap": 0.01, "grad_gap": 0.5, "change_gap": 0.1})
    q = checks.gap_quantiles(got, ref, "grad_norms")
    assert q == pytest.approx([0.02, 0.5, 0.5])
    missing = dict(got, grad_norms={"a": 1.0})
    assert checks.gaps(missing, ref)["grad_gap"] == float("inf")
