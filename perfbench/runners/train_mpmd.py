"""Runner ``train_mpmd``: the Cephalo MPMD training step on the loopback
substrate, as ``python -m repro_torch.launch.train --runtime mpmd``
trains.

The model is the configuration's; the plan is ``auto_solve`` over the
analytic cost model of the mix's cluster for its global batch; the engine
is ``build_train_step(cfg, plan, substrate="loopback")``, and every rank
of the plan runs on the one card with its own rows and state share.  The
benchmark makes the weights and the token blocks from the seed and hands
them to the engine (``import_state``, ``step``).

Set-up builds that one engine, drives it through the check's first steps
(which also warm up every shape the window runs), reads the first
gradient from Adam's first moment and the parameters' change after those
steps from ``export_state``, runs one more step, and hands the same
engine to the window.
After the window the engine is freed and the plain reference follows the
same steps from the same weights and blocks.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, Optional

import torch

from perfbench import checks, leaves as LV, spec, trace
from perfbench.feed import Feed
from perfbench.reference import train as ref_train
from perfbench.roofline import model_flops, peaks as P

#: the traced run profiles whole steps until this many seconds have
#: passed, or ``--seconds`` where that is less
TRACE_SECONDS = 5.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def arch_config(config: Dict[str, Any]):
    """The port's ``ArchConfig`` of the configuration file: its named
    architecture with every field the file gives."""
    from repro_torch.configs.base import AttnKind, get_arch
    fields = dict(config["model"])
    if "attn_kind" in fields:
        fields["attn_kind"] = AttnKind(fields["attn_kind"])
    return dataclasses.replace(get_arch(config["arch"]), **fields)


def solve(cfg, traffic: Dict[str, Any]):
    """The planner's plan of the mix's cluster and global batch."""
    from repro_torch.core.cost_model import analytic_cluster_model
    from repro_torch.core.model_stats import build_model_stats
    from repro_torch.core.planner import auto_solve
    from repro_torch.launch.train import CLUSTERS
    seq = int(traffic["seq_len"])
    cm = analytic_cluster_model(CLUSTERS[traffic["cluster"]](),
                                build_model_stats(cfg, seq))
    plan = auto_solve(cm, int(traffic["global_batch"]))
    if not plan.feasible:
        raise RuntimeError(f"infeasible plan: {plan.infeasible_reason}")
    return plan


@dataclasses.dataclass
class Timed:
    """What the end-to-end readers read of a timed window."""

    tokens: int
    seconds: float
    steps: int
    flops: float
    peak_bytes: int
    setup_s: float
    peaks: Dict[str, float]


class TrainRun:
    """One run of a training cell on ``device``."""

    def __init__(self, cell: spec.Cell, seed: int, device: str):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.steps_checked = int(cell.checks["steps"])
        self.feed = Feed(self.traffic, self.config["model"]["vocab_size"],
                         seed)
        self.next_block = 0
        self.readings: Dict[str, Any] = {"losses": []}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.engine import build_train_step
        from repro_torch.optim.adam import AdamConfig
        stages: Dict[str, Any] = {}
        t = time.perf_counter()

        def mark(name: str) -> None:
            nonlocal t
            self.sync()
            now = time.perf_counter()
            stages[name] = round(now - t, 3)
            t = now

        cfg = arch_config(self.config)
        self.plan = solve(cfg, self.traffic)
        mark("plan")
        log(f"plan {self.plan.cluster}: rows a pass "
            f"{[r.b for r in self.plan.ranks]}, state ratios "
            f"{[round(r.state_ratio, 3) for r in self.plan.ranks]}")
        self.weights = ref_train.weights(self.config, self.seed, self.device)
        tree = self.weights.tree()
        mark("weights")
        self.engine = build_train_step(
            cfg, self.plan, substrate="loopback", device=self.device,
            seq_len=int(self.traffic["seq_len"]),
            adam=AdamConfig(**self.config["optimizer"]))
        mark("engine")
        self.state = self.engine.import_state({"step": 0, "p": tree})
        del tree
        mark("import_state")
        b1 = float(self.config["optimizer"]["b1"])
        for k in range(self.steps_checked):
            loss = self.step()
            self.readings["losses"].append(loss)
            mark(f"step{k}")
            if k == 0:
                m = self.engine.export_state(self.state)["m"]
                self.readings["grad_norms"] = {
                    n: v / (1.0 - b1) for n, v in LV.leaf_norms(m).items()}
                del m
                mark("export_m")
        p = self.engine.export_state(self.state)["p"]
        with torch.no_grad():
            self.readings["change_norms"] = LV.leaf_norms(
                p, lambda path, t: t - self.weights.tensor(path))
        del p
        mark("export_p")
        # the exports leave the allocator's cache in another state than a
        # step does: one more step, so that the window's first is like
        # the rest
        self.step()
        mark(f"step{self.steps_checked}")
        log(f"set-up stages (s): {stages}")

    def step(self) -> float:
        self.state, loss = self.engine.step(
            self.state, self.feed.block(self.next_block))
        self.next_block += 1
        return float(loss)

    # --- the window -------------------------------------------------------
    def timed(self, seconds: float, setup_start: float,
              peaks: Dict[str, float]) -> Timed:
        """Whole steps from a synchronised start until ``seconds`` have
        passed; every step ends in a synchronise."""
        self.sync()
        t0 = time.perf_counter()
        setup_s = t0 - setup_start
        steps = self.bad = 0
        ends = [t0]
        while True:
            loss = self.step()
            self.sync()
            ends.append(time.perf_counter())
            steps += 1
            self.bad += not math.isfinite(loss)
            if ends[-1] - t0 >= seconds:
                break
        took = ends[-1] - t0
        tokens = steps * self.feed.batch * self.feed.seq
        log(f"window: {steps} steps in {took:.3f} s; a step "
            f"{[round(b - a, 4) for a, b in zip(ends, ends[1:])]} s")
        return Timed(tokens=tokens, seconds=took, steps=steps,
                     flops=tokens * model_flops.per_token(
                         self.config, self.feed.seq),
                     peak_bytes=self.peak_bytes(), setup_s=setup_s,
                     peaks=peaks)

    def traced(self, seconds: float, peaks: Dict[str, float]
               ) -> trace.Context:
        self.bad = 0

        def one() -> None:
            self.bad += not math.isfinite(self.step())

        win = trace.traced(one, min(seconds, TRACE_SECONDS), self.sync)
        log(f"traced: {win.steps} steps in {win.window_s:.3f} s "
            f"({win.window_s / win.steps:.4f} s a step under the profiler)")
        return trace.Context(
            window=win, config=self.config, traffic=self.traffic,
            passes=[r.b for r in self.plan.ranks if r.b], peaks=peaks)

    def peak_bytes(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    # --- the check --------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("state", "engine"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, Dict[str, float]]:
        t0 = time.perf_counter()
        blocks = [self.feed.block(i) for i in range(self.steps_checked)]
        ref = ref_train.follow(self.config, self.seed, blocks, "float32",
                               self.device,
                               int(self.cell.checks["tokens_per_block"]))
        self.sync()
        log(f"reference: {self.steps_checked} steps in "
            f"{time.perf_counter() - t0:.1f} s; losses "
            f"{ref['losses']} against {self.readings['losses']}")
        log(f"leaves left out of change_gap: {checks.quiet_leaves(ref)} of "
            f"{len(ref['grad_norms'])}")
        for key in ("grad_norms", "change_norms"):
            log(f"{key} farthest apart (leaf, gap, program, reference): "
                f"{checks.worst_leaves(self.readings, ref, key)}")
            log(f"{key} gaps of the leaves at quantiles 0.5, 0.9, 1: "
                f"{checks.gap_quantiles(self.readings, ref, key)}")
        return checks.judge(checks.gaps(self.readings, ref),
                            self.cell.checks["limits"])


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
        setup_start: float, device: str = "cuda",
        peaks: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """One run: the result line's fields, ``checks`` last."""
    kind = torch.cuda.get_device_name(0) if device == "cuda" else device
    peaks = peaks if peaks is not None else P.of(kind)
    run_ = TrainRun(cell, seed, device)
    log(f"set-up before the runner (imports, the card): "
        f"{time.perf_counter() - setup_start:.3f} s")
    run_.setup()
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else device,
                           "kind": kind, "count": cell.chips}
    out: Dict[str, Any] = {}
    if trace_on:
        ctx = run_.traced(seconds, peaks)
        steps = ctx.window.steps
        mods = spec.readers("metrics", cell.per_layer, cell.root)
        metrics = spec.read_all(mods, cell.per_layer, ctx)
        dev.update(busy_s=ctx.window.busy_s, window_s=ctx.window.window_s)
        out["breakdown"] = ctx.window.breakdown()
    else:
        win = run_.timed(seconds, setup_start, peaks)
        steps = win.steps
        mods = spec.readers("end_to_end", cell.end_to_end, cell.root)
        metrics = spec.read_all(mods, cell.end_to_end, win)
    dev["memory_peak_bytes"] = run_.peak_bytes()
    bad = run_.bad
    run_.release()
    judged = run_.check()
    result = {"correct": bad == 0 and checks.passed(judged),
              "attempted": steps, "failed": bad, "metrics": metrics,
              "device": dev}
    result.update(out)
    result["checks"] = judged
    return result
