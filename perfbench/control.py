"""The readings that a cell's limits are set against: the control, and
the faults a training step can have, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--out control.jsonl]

For each seed the plain reference follows the check's steps twice: in
float32 (the reference), and one step of precision below each that the
configuration states (the control, put in the program's place): the
inputs of every weight product in float8 for its bfloat16 products, and
the weights and Adam's moments kept in bfloat16 for its float32 state.  At the first
step it also reads three faults against the reference: half of each
pass's rows left out with the mean taken over the rest
(``half_batch``), every pass's gradient but the first left out of the
sum (``exchange``), and the first pass's loss counted twice
(``answer``).  A state returned unchanged reads ``change_gap`` 1 by the
check's measure and needs no run.  Each reading is judged against the
cell's limits in ``checks/<cell>.json`` as a run's are, under
``verdicts``: each of them has to come out not correct.  Prints one JSON
line a seed, and each verdict on standard error.

Not run by the benchmark's own runs; the card is needed at a cell's
size, the CPU does at a test's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List

if __package__ in (None, ""):
    _HERE = os.path.dirname(os.path.abspath(__file__))
    _ROOT = os.path.dirname(_HERE)
    sys.path[:] = [_ROOT, os.path.join(_ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import torch  # noqa: E402

from perfbench import checks, leaves as LV, spec  # noqa: E402
from perfbench.feed import Feed  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


def pass_rows(passes: List[int]) -> List[range]:
    """The block's rows of each pass, in plan order."""
    out, cursor = [], 0
    for b in passes:
        out.append(range(cursor, cursor + b))
        cursor += b
    return out


def fault_hook(config: Dict[str, Any], passes: List[int],
               tokens_per_block: int, out: Dict[str, Any]):
    """The reference's first-step hook that reads the faults' gradients
    and losses into ``out``, leaving the step's own gradients in place."""
    rows = pass_rows(passes)

    def hook(params, block):
        seq = block.shape[1] - 1
        leaves = [t for _, t in LV.walk(params)]
        saved = [t.grad for t in leaves]
        half = [i for r in rows for i in list(r)[: len(r) // 2]]
        runs = {"half_batch": (half, 1.0 / (len(half) * seq)),
                "exchange": (list(rows[0]), 1.0 / (block.shape[0] * seq))}
        for name, (idx, weight) in runs.items():
            for t in leaves:
                t.grad = None
            loss = ref_train.add_grads(config, params, block, idx, weight,
                                       "float32", tokens_per_block)
            out[name] = {"loss": loss, "grad_norms": LV.leaf_norms(
                params, lambda _, t: t.grad)}
        for t, g in zip(leaves, saved):
            t.grad = g
    return hook


def first_step_gaps(fault: Dict[str, Any], ref: Dict[str, Any],
                    loss: float) -> Dict[str, float]:
    names = sorted(ref["grad_norms"])
    return {"loss_gap": abs(loss - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": checks.leaf_gap(fault["grad_norms"],
                                         ref["grad_norms"], names)}


#: the readings that stand in for the program, each of which the cell's
#: limits have to refuse
READINGS = ("control", "half_batch", "exchange", "answer", "unchanged")


def verdicts(out: Dict[str, Any], limits: Dict[str, float]
             ) -> Dict[str, Dict[str, Any]]:
    """``{reading: {"correct", "checks"}}``: each reading of ``out`` judged
    against ``limits`` as a run's numbers are."""
    judged = {}
    for name in READINGS:
        j = checks.judge(out[name], limits)
        judged[name] = {"correct": checks.passed(j), "checks": j}
    return judged


def readings(cell: spec.Cell, seed: int, passes: List[int],
             device: str) -> Dict[str, Any]:
    feed = Feed(cell.traffic, cell.config["model"]["vocab_size"], seed)
    blocks = [feed.block(i) for i in range(int(cell.checks["steps"]))]
    tpb = int(cell.checks["tokens_per_block"])
    faults: Dict[str, Any] = {}
    t0 = time.perf_counter()
    ref = ref_train.follow(cell.config, seed, blocks, "float32", device,
                           tpb, first_step=fault_hook(cell.config, passes,
                                                      tpb, faults))
    t1 = time.perf_counter()
    ctl = ref_train.follow(cell.config, seed, blocks, "float8", device, tpb,
                           state="bfloat16")
    t2 = time.perf_counter()
    out = {"seed": seed, "reference_s": t1 - t0, "control_s": t2 - t1,
           "reference_losses": ref["losses"],
           "control": checks.gaps(ctl, ref),
           "half_batch": first_step_gaps(faults["half_batch"], ref,
                                         faults["half_batch"]["loss"]),
           "exchange": first_step_gaps(faults["exchange"], ref,
                                       faults["exchange"]["loss"]),
           "answer": {"loss_gap": abs(faults["exchange"]["loss"])
                      / abs(ref["losses"][0])},
           "unchanged": {"change_gap": 1.0}}
    out["verdicts"] = verdicts(out, cell.checks["limits"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    from perfbench.runners.train_mpmd import arch_config, solve
    cell = spec.cell(args.workload)
    plan = solve(arch_config(cell.config), cell.traffic)
    passes = [r.b for r in plan.ranks if r.b]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload,
                           "device": torch.cuda.get_device_name(0),
                           **readings(cell, seed, passes, "cuda")})
        print(line, flush=True)
        for name, v in json.loads(line)["verdicts"].items():
            print(f"seed {seed} {name}: correct {v['correct']}; " + ", ".join(
                f"{n} {c['value']!r} limit {c['limit']!r}"
                for n, c in v["checks"].items()), file=sys.stderr)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
