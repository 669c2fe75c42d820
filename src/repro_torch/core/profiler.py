"""Profiler (paper Sec. 3.1): measure single-layer latency at small batch
sizes, fit the linear models the optimizer consumes.

The port of ``repro.core.profiler``.  The timed layer is the model's own
training layer, :func:`repro_torch.models.model.element_apply` over one
element's fp32 params (the trainer's gathered params are fp32), fed
activations in the compute dtype the training step feeds a layer
(:func:`repro_torch.models.model.compute_dtype`: bf16 for the full-size
models), so on the card it runs the kernels a training step runs.  The
device decides how a call is timed: on CUDA tensors by CUDA events around
the call, on CPU tensors by the host clock.  A first call warms up (on
the card it builds the kernels, as the reference's compile call does);
each sample is the minimum over ``repeats`` calls.

Memory stays analytic (:func:`analytic_memory`): the paper's memory model
is linear in m with coefficients from activation byte counts, which the
model stats give exactly.

:func:`refit_cluster_model` is the *online* half of the same machinery:
per-rank ``(m, seconds)`` telemetry collected mid-training rebuilds the
cost model through the identical :func:`fit_piecewise` path.  Its
caller is the elastic runtime
(:class:`repro_torch.core.engine.elastic.ElasticEngine`), which probes
on :data:`PROFILE_MS`.  :func:`wallclock_cluster_model` bootstraps the planner of the
process fleet (``launch.train --substrate multiproc``), whose worker
probes time an element through :func:`layer_call`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import (ClusterCostModel, CommModel,
                                         DeviceCost, LatencyModel,
                                         MemoryModel, analytic_latency_model,
                                         fit_piecewise)
from repro_torch.core.model_stats import build_model_stats
from repro_torch.models import blocks as B
from repro_torch.models import model as M

#: The standard small-m profiling sweep (Sec. 3.1).  Shared by the
#: offline profile below and the elastic runtime's active probe, so both
#: fit on the same grid.
PROFILE_MS: Tuple[int, ...] = (1, 2, 3, 4, 6, 8)


def _layer(cfg: ArchConfig, device: torch.device):
    """(spec, fp32 params of one element of the first stage, fp32 params of
    the shared block of a hybrid or None), drawn from a seeded generator
    on ``device``: a zamba2 element is its SSM blocks and the shared
    block applied after them."""
    spec = M.build_stages(cfg)[0]
    gen = torch.Generator(device).manual_seed(0)
    bp = M._element_init(gen, cfg, spec, device)
    shared = B.dense_block_init(gen, cfg, local=False, device=device) \
        if cfg.is_hybrid else None
    return spec, bp, shared


def _input(cfg: ArchConfig, m: int, seq: int, device: torch.device):
    gen = torch.Generator(device).manual_seed(m)
    x = torch.randn((m, seq, cfg.d_model), generator=gen, device=device)
    pos = torch.arange(seq, device=device)[None].expand(m, seq)
    return x.to(M.compute_dtype(cfg)), pos


def layer_call(cfg: ArchConfig, spec, bp, shared, x: torch.Tensor,
               pos: torch.Tensor, leaves: List[torch.Tensor] | None = None
               ) -> Callable[[], object]:
    """One element's pass as a call: its forward (no graph) when
    ``leaves`` is None, else its forward and the grads of ``sum(y*y)``
    with respect to ``leaves``."""
    if leaves is None:
        @torch.no_grad()
        def fn():
            return M.element_apply(cfg, spec, bp, x, pos, shared)[0]
    else:
        def fn():
            y, _ = M.element_apply(cfg, spec, bp, x, pos, shared)
            return torch.autograd.grad(torch.sum(y * y), leaves)
    return fn


#: GPU clock cycles of the first device-side wait a queued timing puts
#: before a timed call (about 5 ms at the H100's clock), doubled while
#: the host is still enqueuing the call when the wait ends, up to
#: QUEUE_MAX_CYCLES
QUEUE_CYCLES = 10_000_000
QUEUE_MAX_CYCLES = 2_000_000_000


def _queued_call_seconds(fn: Callable[[], object], cycles: int
                         ) -> Tuple[float, int]:
    """(device seconds of one call of ``fn``, the wait's cycles it took):
    a device-side wait (``torch.cuda._sleep``) holds the stream while the
    host enqueues the call, so the CUDA events around it time the device's
    work alone and not the host's launches.  Where the wait ended before
    the host had enqueued the whole call, the call runs again behind a
    wait twice as long; a call that synchronises with the host cannot be
    timed so, and raises."""
    while True:
        torch.cuda._sleep(cycles)
        waited = torch.cuda.Event()
        waited.record()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        caught_up = waited.query()
        end.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / 1e3, cycles
        if cycles >= QUEUE_MAX_CYCLES:
            raise RuntimeError(
                f"a call still not enqueued after a wait of {cycles} GPU "
                "cycles: it synchronises with the host and cannot be "
                "timed queued")
        cycles *= 2


def _best_seconds(fn: Callable[[], object], device: torch.device,
                  repeats: int, warmup_s: float = 0.0,
                  queued: bool = False) -> float:
    """Minimum over ``repeats`` timed calls of ``fn``, after one warm-up
    call and further ones for at least ``warmup_s`` seconds (a device
    and a host left idle come back to speed): CUDA events on the card,
    the host clock on the CPU.  ``queued`` times on the card the
    device's work alone, each call enqueued behind a device-side wait
    (:func:`_queued_call_seconds`): a pass at small m is bound by its
    launches, and on a host other processes load the events around it
    read the host's speed."""
    fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    best = float("inf")
    cycles = QUEUE_CYCLES
    for _ in range(repeats):
        if device.type == "cuda" and queued:
            t, cycles = _queued_call_seconds(fn, cycles)
            best = min(best, t)
        elif device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def profile_layer_forward(cfg: ArchConfig, seq: int,
                          ms: Sequence[int] = PROFILE_MS,
                          repeats: int = 3,
                          device: torch.device | str = "cuda",
                          warmup_s: float = 0.0, queued: bool = False
                          ) -> List[Tuple[int, float]]:
    """Measured (m, seconds) samples for one block's forward pass
    (``queued``: :func:`_best_seconds`'s)."""
    device = M.resolve_device(device)
    spec, bp, shared = _layer(cfg, device)
    out = []
    for m in ms:
        x, pos = _input(cfg, m, seq, device)
        fn = layer_call(cfg, spec, bp, shared, x, pos)
        out.append((m, _best_seconds(fn, device, repeats, warmup_s,
                                      queued)))
    return out


def profile_layer_backward(cfg: ArchConfig, seq: int,
                           ms: Sequence[int] = PROFILE_MS,
                           repeats: int = 3,
                           device: torch.device | str = "cuda",
                           warmup_s: float = 0.0, queued: bool = False
                           ) -> List[Tuple[int, float]]:
    """Measured (m, seconds) samples for one block's forward and backward:
    the grads of ``sum(y*y)`` with respect to the block's params (a
    hybrid's shared block is applied, as in the reference, and not
    differentiated)."""
    device = M.resolve_device(device)
    spec, bp, shared = _layer(cfg, device)
    bp = M.tree_map(bp, lambda _, t: t.requires_grad_(True))
    leaves: List[torch.Tensor] = []
    M.tree_map(bp, lambda _, t: leaves.append(t))
    out = []
    for m in ms:
        x, pos = _input(cfg, m, seq, device)
        fn = layer_call(cfg, spec, bp, shared, x, pos, leaves)
        out.append((m, _best_seconds(fn, device, repeats, warmup_s,
                                      queued)))
    return out


def fit_latency(samples: Sequence[Tuple[int, float]]) -> LatencyModel:
    ms, ts = zip(*samples)
    return LatencyModel(ms, ts)


def refit_cluster_model(cm: ClusterCostModel,
                        fwd_samples: Sequence[Sequence[Tuple[int, float]]],
                        bwd_samples: Sequence[Sequence[Tuple[int, float]]],
                        min_samples: int = 2) -> ClusterCostModel:
    """Refit per-rank latency models from runtime telemetry.

    ``fwd_samples[i]`` / ``bwd_samples[i]`` — rank *i*'s observed
    ``(m, seconds)`` single-layer samples.  Ranks with fewer than
    ``min_samples`` points keep their previous model, so a partial
    telemetry window never degrades the planner's inputs.  Memory, head,
    and comm models are latency-drift-invariant and carried over.

    Returns a new :class:`~repro_torch.core.cost_model.ClusterCostModel`;
    the input is not mutated.
    """
    per_rank = []
    for i, dc in enumerate(cm.per_rank):
        fs = list(fwd_samples[i]) if i < len(fwd_samples) else []
        bs = list(bwd_samples[i]) if i < len(bwd_samples) else []
        t_fwd = fit_piecewise(fs) if len(fs) >= min_samples else dc.t_fwd
        t_bwd = fit_piecewise(bs) if len(bs) >= min_samples else dc.t_bwd
        per_rank.append(DeviceCost(dc.spec, t_fwd, t_bwd, dc.memory,
                                   dc.t_head))
    return ClusterCostModel(cm.cluster, cm.model, per_rank, cm.comm)


def wallclock_cluster_model(cluster, cfg: ArchConfig, seq: int,
                            ms: Sequence[int] = PROFILE_MS,
                            repeats: int = 2,
                            device: torch.device | str = "cuda",
                            warmup_s: float = 0.0, queued: bool = False
                            ) -> ClusterCostModel:
    """Cost model in *this device's* wall-clock units, no spec rescaling:
    every rank gets the same measured fwd/bwd
    :class:`~repro_torch.core.cost_model.LatencyModel`, memory stays
    analytic and comm comes from the cluster spec.  The bootstrap of a
    rank fleet whose ranks share one kind of silicon (the multiproc
    substrate, :mod:`repro_torch.core.engine.multiproc`).  Each sample
    is the best of ``repeats`` calls after ``warmup_s`` seconds of the
    same call, ``queued`` or not (:func:`_best_seconds`)."""
    fwd = profile_layer_forward(cfg, seq, ms=ms, repeats=repeats,
                                device=device, warmup_s=warmup_s,
                                queued=queued)
    bwd = profile_layer_backward(cfg, seq, ms=ms, repeats=repeats,
                                 device=device, warmup_s=warmup_s,
                                 queued=queued)
    t_fwd = LatencyModel([m for m, _ in fwd], [t for _, t in fwd])
    t_bwd = LatencyModel([m for m, _ in bwd], [t for _, t in bwd])
    mem = analytic_memory(cfg, seq)
    per_rank = [DeviceCost(spec, t_fwd, t_bwd, mem, None)
                for spec in cluster.devices]
    comm = CommModel(link_gbps=cluster.link_gbps * cluster.link_efficiency,
                     n=cluster.n)
    return ClusterCostModel(cluster, build_model_stats(cfg, seq),
                            per_rank, comm)


def analytic_memory(cfg: ArchConfig, seq: int) -> MemoryModel:
    stats = build_model_stats(cfg, seq)
    per_sample = sum(s.act_bytes * c for s, c in stats.layers) + \
        max((s.workspace_bytes for s, _ in stats.layers), default=0)
    return MemoryModel(1.5 * (1 << 30), per_sample)


def profiled_cluster_model(cluster, cfg: ArchConfig, seq: int,
                           ms: Sequence[int] = (1, 2, 3, 4, 6),
                           repeats: int = 3,
                           device: torch.device | str = "cuda"
                           ) -> ClusterCostModel:
    """The paper's full workflow with REAL measurements: profile one layer
    on this device, fit the piecewise-linear models, and rescale per
    device by peak-FLOPs ratio (each GPU's own profile in the paper; one
    measured profile × spec ratios here).

    Returns a :class:`~repro_torch.core.cost_model.ClusterCostModel` the
    planner consumes exactly like the analytic one.
    """
    stats = build_model_stats(cfg, seq)
    fwd_samples = profile_layer_forward(cfg, seq, ms=ms, repeats=repeats,
                                        device=device)
    bwd_samples = profile_layer_backward(cfg, seq, ms=ms, repeats=repeats,
                                         device=device)
    # measured throughput from the largest profiled point
    m_big, t_big = fwd_samples[-1]
    host_flops = stats.flops_fwd_per_sample() / max(stats.n_layers, 1) \
        * m_big / t_big

    per_rank = []
    mem = analytic_memory(cfg, seq)
    head_flops = stats.head_flops_fwd_per_sample() * 4.0
    for spec in cluster.devices:
        scale = host_flops / spec.peak_flops / 0.45   # spec at ~45% MFU
        t_fwd = LatencyModel([m for m, _ in fwd_samples],
                             [t * scale for _, t in fwd_samples])
        t_bwd = LatencyModel([m for m, _ in bwd_samples],
                             [t * scale for _, t in bwd_samples])
        t_head = analytic_latency_model(head_flops, seq, spec) \
            if head_flops else None
        per_rank.append(DeviceCost(spec, t_fwd, t_bwd, mem, t_head))
    comm = CommModel(link_gbps=cluster.link_gbps * cluster.link_efficiency,
                     n=cluster.n)
    return ClusterCostModel(cluster, stats, per_rank, comm)
