"""The traced window: whole steps under ``torch.profiler``, read back as
intervals of device work and of host work on one clock.

Events stay in memory; no trace file is written.  The window runs from
the start of the first traced step to the end of the last (each ends in
a device synchronise), marked by ``perfbench.step`` ranges.  The device
is busy where any kernel, copy or memset runs; the rest of the window is
idle, and each idle gap is named by the host operation that covered most
of it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

STEP = "perfbench.step"
_GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")
_COPY_MARKS = ("copy", "memcpy", "memset", "catarray")
#: entries of each list of the breakdown
TOP = 10


def kind(name: str) -> str:
    """The kind of a device operation by its name: the port's flash
    attention and SSD scan kernels forward and backward, cuBLAS products,
    NCCL collectives, copies (device copies, casts, concatenations,
    memsets), and the rest of the elementwise work."""
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention"
    if "flash_bwd_" in low:
        return "flash_attention_bwd"
    if "ssd_scan_kernel" in low:
        return "ssd_scan"
    if "ssd_scan_bwd_kernel" in low:
        return "ssd_scan_bwd"
    if any(m in low for m in _GEMM_MARKS):
        return "matmul"
    if "nccl" in low:
        return "collective"
    if any(m in low for m in _COPY_MARKS):
        return "copy"
    return "elementwise"


@dataclasses.dataclass
class Window:
    """A traced window: device operations ``(name, start, end)`` and host
    operations in seconds from the window's start, its length and how
    many whole steps it holds."""

    device: List[Tuple[str, float, float]]
    host_names: List[str]
    host_start: np.ndarray
    host_end: np.ndarray
    window_s: float
    steps: int

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds(self, pick: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``pick`` takes."""
        return sum(e - s for n, s, e in self.device if pick(n))

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [0.0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.window_s)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_op(self, s: float, e: float) -> str:
        """The host operation that covered most of [s, e]: among those
        covering nearly as much, the shortest (the innermost)."""
        if not len(self.host_start):
            return "no_host_op"
        cover = np.clip(np.minimum(self.host_end, e)
                        - np.maximum(self.host_start, s), 0.0, None)
        best = cover.max()
        if best <= 0.0:
            return "no_host_op"
        near = np.flatnonzero(cover >= 0.99 * best)
        dur = self.host_end[near] - self.host_start[near]
        return self.host_names[int(near[int(np.argmin(dur))])]

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, float] = collections.Counter()
        for n, s, e in self.device:
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[self.host_op(s, e), e - s] for s, e in gaps]}


def _events(prof) -> List[Any]:
    inner = getattr(prof, "profiler", None)
    results = getattr(inner, "kineto_results", None)
    if results is not None:
        return list(results.events())
    return list(prof.events())


def _span(e) -> Tuple[str, bool, bool, float, float]:
    """(name, on the device's timeline, an annotated range rather than
    work, start ns, end ns) of a raw or parsed event."""
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        note = hasattr(e, "is_user_annotation") and e.is_user_annotation()
        return (e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                bool(note), float(start), float(start + e.duration_ns()))
    tr = e.time_range
    return (e.name, e.device_type == torch.autograd.DeviceType.CUDA, False,
            tr.start * 1e3, tr.end * 1e3)


def traced(step: Callable[[], None], min_seconds: float,
           sync: Callable[[], None]) -> Window:
    """Whole steps under the profiler, at least one, until ``min_seconds``
    have passed; each step ends in ``sync()``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    steps = 0
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while True:
            with record_function(STEP):
                step()
                sync()
            steps += 1
            if time.perf_counter() - t0 >= min_seconds:
                break
    marks, device, host = [], [], []
    for e in _events(prof):
        name, on_device, note, s, t = _span(e)
        if on_device:
            if not note:            # the ranges' copies on the device's
                device.append((name, s, t))     # timeline are no work
        elif name == STEP:
            marks.append((s, t))
        elif not name.startswith("ProfilerStep"):
            host.append((name, s, t))
    if len(marks) != steps:
        raise RuntimeError(f"{len(marks)} step marks in the trace for "
                           f"{steps} steps")
    w0 = min(s for s, _ in marks)
    w1 = max(t for _, t in marks)
    ns = 1e-9
    return Window(
        device=[(n, (s - w0) * ns, (t - w0) * ns) for n, s, t in device
                if t > w0 and s < w1],
        host_names=[n for n, _, _ in host],
        host_start=np.array([(s - w0) * ns for _, s, _ in host]),
        host_end=np.array([(t - w0) * ns for _, _, t in host]),
        window_s=(w1 - w0) * ns, steps=steps)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window, the cell's
    configuration and traffic, the passes of rows a step runs, and the
    card's peaks."""

    window: Window
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    passes: List[int]
    peaks: Dict[str, float]

    @property
    def esize(self) -> int:
        """Bytes of an activation element in the configuration's dtype."""
        return 2 if self.config["model"]["dtype"] == "bfloat16" else 4

    @property
    def seq(self) -> int:
        return int(self.traffic["seq_len"])

    def per_step_ms(self, pick: Callable[[str], bool]) -> float:
        return 1e3 * self.window.seconds(pick) / self.window.steps

    def share_of_bound(self, pick: Callable[[str], bool],
                       least_per_step_s: float) -> Optional[float]:
        """100 x the least time over the device time of the operations
        ``pick`` takes, or None where none ran."""
        took = self.window.seconds(pick)
        if took <= 0.0 or least_per_step_s <= 0.0:
            return None
        return 100.0 * least_per_step_s * self.window.steps / took
