"""Linear performance models (paper Sec. 2.3).

A copy of ``repro.core.cost_model`` (numpy only): the port keeps its
own, so that it imports nothing of the JAX package.

Cephalo models, per device type:

* forward / backward latency of one transformer layer as a function of the
  microbatch size ``m``:  sub-linear for small ``m`` (device not saturated),
  linear beyond;
* compute memory (activations + workspace) as a *linear* function of ``m``;
* collective latency (AllGather / ReduceScatter) as a function of bytes
  moved, with a conservative ``UNEVEN_OVERHEAD`` factor when the training
  state is unevenly sharded (paper App. C measures ≤15%).

Two ways to obtain a model:

* :func:`fit_piecewise` — from profiled ``(m, latency)`` samples, exactly the
  paper's profiler output (see :mod:`repro_torch.core.profiler`);
* :func:`analytic_latency_model` — from first principles (FLOPs / peak
  with a saturation curve), used for the paper-cluster simulations (the
  paper's GPUs are not at hand).  The *planner* is agnostic to which one
  it gets.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device_specs import Cluster, DeviceSpec

#: Paper App. C: uneven collective inputs cost at most ~15% extra.
UNEVEN_OVERHEAD = 1.15

#: Paper Sec. 3.2: cap memory usage at 80% of capacity to avoid allocator
#: thrashing near the limit.
MEMORY_CAP_FRACTION = 0.80

#: Adam full-precision training state: 4 (param) + 4 (grad) + 8 (moments).
BYTES_PER_PARAM_STATE = 16


# ---------------------------------------------------------------------------
# Layer statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Static per-layer workload numbers the cost model consumes.

    These are *per layer, per sequence* (one training sample at the given
    sequence length).  ``flops_fwd`` is the forward FLOP count;
    backward ≈ 2x forward (recompute under activation checkpointing adds
    another forward, captured by ``remat_factor``).
    """

    params: int                  # parameters in one layer (total, incl. all experts)
    active_params: int           # parameters touched per token (MoE: top-k share)
    flops_fwd: float             # forward FLOPs for one sample (one full sequence)
    act_bytes: int               # boundary activation bytes per sample (checkpointed)
    workspace_bytes: int = 0     # per-sample transient workspace (attention, logits)
    remat_factor: float = 1.0    # extra fwd recompute in bwd (1.0 = full remat)

    @property
    def flops_bwd(self) -> float:
        return self.flops_fwd * (2.0 + self.remat_factor)


@dataclasses.dataclass(frozen=True)
class ModelStats:
    """Whole-model statistics: a mix of layer types plus embedding state."""

    name: str
    layers: Sequence[Tuple[LayerStats, int]]   # (stats, count) per block type
    embed_params: int                          # embedding + head params
    seq_len: int
    d_model: int = 0
    vocab_size: int = 0

    def head_flops_fwd_per_sample(self) -> float:
        """LM/classification head: logits matmul (the layer-only profile
        misses it; for small-d models it is a large fraction)."""
        return 2.0 * self.seq_len * self.d_model * self.vocab_size

    @property
    def n_layers(self) -> int:
        return sum(c for _, c in self.layers)

    @property
    def total_params(self) -> int:
        return self.embed_params + sum(s.params * c for s, c in self.layers)

    @property
    def active_params(self) -> int:
        return self.embed_params + sum(s.active_params * c for s, c in self.layers)

    def flops_fwd_per_sample(self) -> float:
        return sum(s.flops_fwd * c for s, c in self.layers)

    def state_bytes(self) -> int:
        return self.total_params * BYTES_PER_PARAM_STATE


# ---------------------------------------------------------------------------
# Latency models
# ---------------------------------------------------------------------------

class LatencyModel:
    """Latency (seconds) of one layer pass as a function of microbatch size.

    Piecewise: a lookup table for the profiled small-``m`` region (captures
    the sub-linear unsaturated regime) and a least-squares linear fit
    ``t0 + t1*m`` for extrapolation (paper Fig. 5 shows the large-``m``
    region is strongly linear).
    """

    def __init__(self, table_m: Sequence[int], table_t: Sequence[float]):
        if len(table_m) != len(table_t) or not table_m:
            raise ValueError("need equal, nonempty sample arrays")
        order = np.argsort(np.asarray(table_m))
        self._m = np.asarray(table_m, dtype=np.int64)[order]
        self._t = np.asarray(table_t, dtype=np.float64)[order]
        if len(self._m) >= 2:
            # Fit the linear tail on the saturated half of the samples.
            half = len(self._m) // 2
            xs, ys = self._m[half:], self._t[half:]
            if len(xs) == 1:
                self._t1 = ys[0] / max(int(xs[0]), 1)
                self._t0 = 0.0
            else:
                a = np.vstack([xs, np.ones_like(xs)]).T
                (self._t1, self._t0), *_ = np.linalg.lstsq(a, ys, rcond=None)
        else:
            self._t1 = self._t[0] / max(int(self._m[0]), 1)
            self._t0 = 0.0
        self._t1 = max(float(self._t1), 1e-12)
        self._t0 = max(float(self._t0), 0.0)

    def one(self, m: int) -> float:
        """Latency of a single microbatch of size ``m``."""
        if m <= 0:
            return 0.0
        if m <= int(self._m[-1]):
            return float(np.interp(m, self._m, self._t))
        return self._t0 + self._t1 * m

    def __call__(self, m: int, ell: int = 1) -> float:
        """Total latency of ``ell`` sequential microbatches of size ``m``
        (paper: linear scaling in the microbatch count)."""
        return self.one(m) * ell

    @property
    def linear_coeffs(self) -> Tuple[float, float]:
        return self._t0, self._t1


class MemoryModel:
    """Compute memory (bytes) as a linear function of microbatch size,
    ``M(m) = c0 + c1*m`` (paper Fig. 5 right).  Independent of the number of
    microbatches because activations are checkpointed/offloaded."""

    def __init__(self, c0: float, c1: float):
        self.c0 = float(c0)
        self.c1 = float(c1)

    def __call__(self, m: int) -> float:
        if m <= 0:
            return 0.0
        return self.c0 + self.c1 * m

    @classmethod
    def fit(cls, ms: Sequence[int], bytes_: Sequence[float]) -> "MemoryModel":
        a = np.vstack([np.asarray(ms, dtype=np.float64),
                       np.ones(len(ms))]).T
        (c1, c0), *_ = np.linalg.lstsq(a, np.asarray(bytes_, np.float64),
                                       rcond=None)
        return cls(max(c0, 0.0), max(c1, 0.0))


def fit_piecewise(samples: Sequence[Tuple[int, float]]) -> LatencyModel:
    """Fit a :class:`LatencyModel` from ``(m, seconds)`` samples — the
    single fitting path shared by the offline profiler (Sec. 3.1) and
    the elastic runtime's telemetry refit
    (:func:`repro_torch.core.profiler.refit_cluster_model`)."""
    ms, ts = zip(*samples)
    return LatencyModel(ms, ts)


# ---------------------------------------------------------------------------
# Analytic models (no-GPU path)
# ---------------------------------------------------------------------------

#: Devices reach ~``_EFF_MAX`` of peak when saturated; a microbatch of ``m``
#: sequences over width ``d`` reaches ``_EFF_MAX * x/(x + _SAT_ELEMS)``
#: with ``x = m*seq*d`` (activations elements — a proxy for matmul tile
#: parallelism).  This reproduces the paper's sub-linear → linear latency
#: shape (Fig. 5 left).  ``_EFF_MAX``/``_SAT_ELEMS`` are calibrated once
#: against the paper's own measured Cephalo rows (Table 4); all baseline
#: comparisons share the constants, so relative claims are unaffected.
_EFF_MAX = 0.50
_SAT_ELEMS = 1.5e6
_LAUNCH_OVERHEAD_S = 3e-4   # per-microbatch kernel launch / framework overhead

#: Short-sequence encoder stacks (ViT @197 patches) profile ~2x below the
#: LM efficiency on GPUs (small attention tiles, patchify overhead) —
#: single calibration factor, see EXPERIMENTS.md §Table4.
_SHORT_SEQ_EFF = 0.33


def _analytic_latency(flops_per_sample: float, seq: int,
                      spec: DeviceSpec,
                      width: int = 2048) -> Callable[[int], float]:
    short = _SHORT_SEQ_EFF if seq < 256 else 1.0

    def one(m: int) -> float:
        if m <= 0:
            return 0.0
        x = float(m * seq * width)
        eff = short * _EFF_MAX * x / (x + _SAT_ELEMS)
        return _LAUNCH_OVERHEAD_S + flops_per_sample * m / (spec.peak_flops * eff)
    return one


def analytic_latency_model(flops_per_sample: float, seq: int,
                           spec: DeviceSpec,
                           sample_ms: Sequence[int] = (1, 2, 3, 4, 6, 8, 12, 16),
                           width: int = 2048,
                           ) -> LatencyModel:
    """Build a LatencyModel by 'profiling' the analytic device curve —
    the exact procedure the real profiler uses on hardware."""
    f = _analytic_latency(flops_per_sample, seq, spec, width)
    return LatencyModel(list(sample_ms), [f(m) for m in sample_ms])


def analytic_memory_model(layer: LayerStats, n_layers: int, seq: int,
                          bytes_per_el: int = 4) -> MemoryModel:
    """M(m) = framework base + m * (boundary activations for all layers +
    one layer's transient workspace).  With checkpoint+offload only the
    layer-boundary activations and the live layer's workspace count."""
    del bytes_per_el  # folded into LayerStats byte counts
    base = 1.5 * (1 << 30)   # CUDA/XLA context, fragmentation headroom
    per_sample = layer.act_bytes * n_layers + layer.workspace_bytes
    return MemoryModel(base, per_sample)


# ---------------------------------------------------------------------------
# Communication model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommModel:
    """Ring-collective latency model.

    AllGather of ``S`` bytes total over ``N`` ranks on a ``link_gbps`` ring
    moves ``S * (N-1)/N`` bytes through the slowest link.  ReduceScatter is
    symmetric.  ``uneven`` applies the paper's conservative 15% overhead.
    """

    link_gbps: float
    n: int
    latency_s: float = 20e-6   # per-collective software latency

    def _bytes_time(self, nbytes: float) -> float:
        wire = nbytes * (self.n - 1) / max(self.n, 1)
        return self.latency_s + wire / (self.link_gbps * 1e9 / 8)

    def all_gather(self, nbytes: float, uneven: bool = False) -> float:
        t = self._bytes_time(nbytes)
        return t * UNEVEN_OVERHEAD if uneven else t

    def reduce_scatter(self, nbytes: float, uneven: bool = False) -> float:
        t = self._bytes_time(nbytes)
        return t * UNEVEN_OVERHEAD if uneven else t


# ---------------------------------------------------------------------------
# Bundled per-cluster cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceCost:
    """All fitted models for one rank."""

    spec: DeviceSpec
    t_fwd: LatencyModel
    t_bwd: LatencyModel
    memory: MemoryModel
    t_head: Optional[LatencyModel] = None   # embed+head fwd+bwd per pass

    def mem_cap(self) -> float:
        return self.spec.memory_bytes * MEMORY_CAP_FRACTION

    def head_time(self, m: int, ell: int) -> float:
        if self.t_head is None:
            return 0.0
        return self.t_head(m, ell)


@dataclasses.dataclass
class ClusterCostModel:
    """Everything the planner needs: per-rank models + comm + model stats."""

    cluster: Cluster
    model: ModelStats
    per_rank: Sequence[DeviceCost]
    comm: CommModel

    #: bytes of parameters in one layer (AllGather unit size), fp32 wire.
    def layer_param_bytes(self) -> int:
        # weighted mean over block types — collectives move each layer once.
        total = sum(s.params * c for s, c in self.model.layers)
        return int(total / max(self.model.n_layers, 1)) * 4

    def even_state_bytes_per_rank(self) -> float:
        return self.model.state_bytes() / self.cluster.n

    def ag_latency(self, uneven: bool = False) -> float:
        return self.comm.all_gather(self.layer_param_bytes(), uneven)

    def rs_latency(self, uneven: bool = False) -> float:
        return self.comm.reduce_scatter(self.layer_param_bytes(), uneven)


def analytic_cluster_model(cluster: Cluster, model: ModelStats,
                           ) -> ClusterCostModel:
    """Build the full analytic cost model for a cluster+model pair."""
    # Per-layer averages over block types (planner works on the mean layer;
    # zamba2-style mixed stacks weight by count — see DESIGN.md §7.5).
    n_layers = max(model.n_layers, 1)
    flops_fwd = model.flops_fwd_per_sample() / n_layers
    flops_bwd = sum(s.flops_bwd * c for s, c in model.layers) / n_layers
    mean_layer = LayerStats(
        params=sum(s.params * c for s, c in model.layers) // n_layers,
        active_params=sum(s.active_params * c for s, c in model.layers) // n_layers,
        flops_fwd=flops_fwd,
        act_bytes=int(sum(s.act_bytes * c for s, c in model.layers) / n_layers),
        workspace_bytes=max((s.workspace_bytes for s, _ in model.layers),
                            default=0),
    )
    width = max(mean_layer.act_bytes // max(model.seq_len * 4, 1), 256)
    head_flops = model.head_flops_fwd_per_sample() * 4.0   # fwd + bwd
    per_rank = []
    for spec in cluster.devices:
        t_fwd = analytic_latency_model(flops_fwd, model.seq_len, spec,
                                       width=width)
        t_bwd = analytic_latency_model(flops_bwd, model.seq_len, spec,
                                       width=width)
        mem = analytic_memory_model(mean_layer, n_layers, model.seq_len)
        t_head = analytic_latency_model(head_flops, model.seq_len, spec,
                                        width=width) if head_flops else None
        per_rank.append(DeviceCost(spec, t_fwd, t_bwd, mem, t_head))
    comm = CommModel(
        link_gbps=cluster.link_gbps * cluster.link_efficiency,
        n=cluster.n)
    return ClusterCostModel(cluster, model, per_rank, comm)
