"""Roofline analysis: three terms per (arch × shape × mesh).

    compute term    = FLOPs / (chips × peak)
    memory term     = HBM bytes / (chips × HBM bw)
    collective term = collective bytes / (chips × link bw)

The port of ``repro.roofline.analysis``'s analytic half: the terms are
napkin math over the unit layouts and :mod:`repro_torch.core.model_stats`,
the reference's arithmetic line for line.  The hardware is an argument
(:class:`Hardware`), by default the port's card, :data:`H100`: its dense
bf16 tensor-core peak, HBM bandwidth and NVLink bandwidth in one
direction (:mod:`repro_torch.core.device_specs`, each with its datasheet).

The reference's measured half reads HLO and StableHLO text
(``parse_collectives``, ``parse_collectives_stablehlo``), which an eager
runtime has none of.  Its analogue here is :class:`CollectiveStats` built
from what the SPMD runtime counts as its collectives run
(:meth:`CollectiveStats.from_substrate`: the substrate's counts and the
output bytes of each collective, as the HLO parse sums an op's output
shape), held against :func:`step_collectives`, the AllGathers and
ReduceScatters a step of a schedule should issue per unit, as
:func:`train_terms` reckons them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ArchConfig, AttnKind, InputShape
from repro_torch.core import device_specs
from repro_torch.core.model_stats import build_model_stats
from repro_torch.models.blocks import attn_spec


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip's peaks: dense FLOP/s, HBM bytes/s, link bytes/s."""

    name: str
    peak_flops: float
    hbm_bps: float
    link_bps: float


#: NVIDIA H100 SXM5 80 GB: 989.4 TFLOP/s bf16 (dense), 3.35 TB/s HBM3,
#: 450 GB/s NVLink a direction.
H100 = Hardware("H100", device_specs.H100_BF16_TFLOPS * 1e12,
                device_specs.H100.hbm_gbps * 1e9,
                device_specs.H100_NVLINK_GBPS * 1e9)


@dataclasses.dataclass
class CollectiveStats:
    """Collectives of a step: a count and output bytes per op (keys
    ``all_gather``, ``reduce_scatter``, ``all_reduce``)."""

    counts: Dict[str, int]
    bytes_by_op: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    @classmethod
    def from_substrate(cls, substrate) -> "CollectiveStats":
        """What a rank's SPMD substrate counted since its last
        ``reset_stats()``: each collective as it ran, with the bytes of
        its output buffer."""
        return cls(dict(substrate.stats), dict(substrate.comm.bytes))


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device (wire)
    model_flops: float = 0.0   # 6·N·D useful-model flops, per device
    hw: Hardware = H100

    @property
    def compute_s(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bps

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.hw.link_bps

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
        }


# ---------------------------------------------------------------------------
# Analytic terms per step kind
# ---------------------------------------------------------------------------

def _attn_read_bytes_per_token(cfg: ArchConfig, cache_len: int,
                               act_bytes: int = 2) -> float:
    """KV bytes read when decoding one token (per sequence)."""
    if not cfg.has_attention or cfg.n_heads == 0:
        return 0.0
    per_layer = 2 * cfg.n_kv_heads * cfg.head_dim * act_bytes

    def layer_cache(local: bool) -> int:
        w = attn_spec(cfg, local).window
        return min(w, cache_len) if w > 0 else cache_len

    if cfg.is_hybrid:
        apps = max(1, cfg.n_layers // cfg.hybrid_attn_every)
        return per_layer * layer_cache(False) * apps
    if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
        half = cfg.n_layers // 2
        return per_layer * (layer_cache(True) * half +
                            layer_cache(False) * (cfg.n_layers - half))
    local = cfg.attn_kind == AttnKind.SLIDING
    return per_layer * layer_cache(local) * cfg.n_layers


def train_terms(cfg: ArchConfig, shape: InputShape, chips: int,
                gather_bytes: int = 4, remat_factor: float = 1.0,
                hw: Hardware = H100) -> RooflineTerms:
    """Cephalo FSDP train step, per device.

    FLOPs: fwd + bwd(2×) + remat recompute (+head).  HBM: Adam state
    touched 5× (p,g read + p,m,v write ≈ 5·4B per param per N) +
    activations + gathered-param reads.  Collectives: per unit per step,
    AG (fwd) + AG (bwd regather) + RS(grad, fp32) of the padded unit.
    """
    stats = build_model_stats(cfg, shape.seq_len)
    samples_dev = shape.global_batch / chips
    fwd = stats.flops_fwd_per_sample()
    head = 2 * shape.seq_len * cfg.d_model * cfg.vocab_size
    flops_dev = (fwd * (3.0 + remat_factor) + head * 4.0) * samples_dev
    model_flops = 6 * stats.active_params * shape.seq_len * samples_dev

    params = stats.total_params
    adam_bytes = params * 5 * 4 / chips
    gathered_reads = params * gather_bytes * (2 + remat_factor)
    act_bytes = sum(s.act_bytes * c for s, c in stats.layers) * \
        samples_dev * 3          # write fwd, read+write bwd
    hbm = adam_bytes + gathered_reads + act_bytes

    wire = params * gather_bytes * (2.0) + params * 4.0   # 2 AG + 1 RS(f32)
    wire *= (chips - 1) / chips
    return RooflineTerms(flops_dev, hbm, wire, model_flops, hw)


def prefill_terms(cfg: ArchConfig, shape: InputShape, chips: int,
                  model_par: int, hw: Hardware = H100) -> RooflineTerms:
    """TP serving prefill: weights resident; per-layer activation
    all-reduces (2 per block over the model axis)."""
    stats = build_model_stats(cfg, shape.seq_len)
    samples_dev = shape.global_batch / (chips / model_par)
    flops_dev = stats.flops_fwd_per_sample() * samples_dev / model_par
    head = 2 * shape.seq_len * cfg.d_model * cfg.vocab_size
    flops_dev += head * samples_dev / model_par
    model_flops = 2 * stats.active_params * shape.seq_len * samples_dev \
        / model_par

    params_bytes = stats.total_params * 2 / model_par     # bf16 resident
    act = sum(s.act_bytes * c for s, c in stats.layers) * samples_dev / 2
    hbm = params_bytes + act

    ar_bytes = 2 * stats.n_layers * samples_dev * shape.seq_len * \
        cfg.d_model * 2 * 2 * (model_par - 1) / model_par
    return RooflineTerms(flops_dev, hbm, ar_bytes, model_flops, hw)


def decode_terms(cfg: ArchConfig, shape: InputShape, chips: int,
                 model_par: int, hw: Hardware = H100) -> RooflineTerms:
    """TP serving decode of ONE token per sequence with a seq_len cache."""
    stats = build_model_stats(cfg, 1)
    data_par = max(chips // model_par, 1)
    seqs_dev = max(shape.global_batch / data_par, 1.0)
    flops_dev = 2 * stats.active_params * seqs_dev / model_par
    # attention reads: score+av flops ≈ 2·2·H·hd per cache token
    attn_read = _attn_read_bytes_per_token(cfg, shape.seq_len)
    flops_dev += attn_read * 2 * seqs_dev / model_par     # ~2 flops/byte
    model_flops = flops_dev

    params_bytes = stats.total_params * 2 / model_par
    cache_bytes = attn_read * seqs_dev / model_par
    if cfg.ssm_state:
        cache_bytes += (cfg.d_inner * cfg.ssm_state * 4 * cfg.n_layers *
                        seqs_dev / model_par)
    hbm = params_bytes + cache_bytes

    ar_bytes = 2 * stats.n_layers * seqs_dev * cfg.d_model * 2 * \
        2 * (model_par - 1) / model_par
    return RooflineTerms(flops_dev, hbm, ar_bytes, model_flops, hw)


def terms_for(cfg: ArchConfig, shape: InputShape, chips: int,
              model_par: int = 16, hw: Hardware = H100,
              **kw) -> RooflineTerms:
    if shape.kind == "train":
        return train_terms(cfg, shape, chips, hw=hw, **kw)
    if shape.kind == "prefill":
        return prefill_terms(cfg, shape, chips, model_par, hw)
    return decode_terms(cfg, shape, chips, model_par, hw)


def what_would_move_it(t: RooflineTerms, shape_kind: str) -> str:
    """One sentence per the §Roofline requirement."""
    if t.dominant == "compute":
        return ("compute-bound: raise MFU (larger per-device batch/seq "
                "tiles, fused kernels); remat removal trades memory for "
                "~25% fewer FLOPs")
    if t.dominant == "memory":
        if shape_kind == "decode":
            return ("HBM-bound on weight/KV reads: quantize weights/KV, "
                    "batch more sequences per chip, or shrink the cache "
                    "(windowing/GQA)")
        return ("HBM-bound: fuse ops to cut activation round-trips, "
                "bf16 activations, larger tiles")
    return ("collective-bound: shrink wire bytes (bf16 gathers, HSDP "
            "hierarchy to cut AG hops) or overlap collectives with "
            "compute")


# ---------------------------------------------------------------------------
# The collectives a step issues (the analogue of the HLO parse)
# ---------------------------------------------------------------------------

def gather_sites(cfg: ArchConfig, groups: Sequence,
                 frontend_batch: bool = False) -> Dict[str, int]:
    """{unit: gathers of it in one round's forward} of the SPMD program
    (``repro_torch.core.layered_ga``): the embedding (again in the head
    when tied), every stage element, the shared block of a hybrid, the
    misc unit in the head (and in the embedding with learned positions
    or a frontend batch), the head of an untied model."""
    sites: Dict[str, int] = {}
    for g in groups:
        n = g.count
        if g.name == "embed" and cfg.tie_embeddings:
            n = 2
        elif g.name == "misc" and (cfg.learned_pos or frontend_batch):
            n = 2
        sites[g.name] = n
    return sites


def step_collectives(cfg: ArchConfig, groups: Sequence, rounds: int,
                     gather_bytes: int = 4, grad_bytes: int = 4,
                     remat: str = "full", frontend_batch: bool = False,
                     padded: bool = True,
                     replicas: int = 1) -> CollectiveStats:
    """The collectives one rank's step issues under a schedule of
    ``rounds`` collective rounds, as :func:`train_terms` reckons them: per
    unit gather a round, one AllGather in the forward, one more in the
    backward's recompute (remat ``full``/``offload``; the shared block is
    gathered outside the checkpoints, once), and one ReduceScatter of its
    gradient (plus an all-reduce over the replicas with HSDP).

    Bytes are each collective's output: the gathered unit (``padded``:
    ``N · P_max`` elements, as the runtime moves it; else the unit's own
    elements) and the rank's ``P_max`` share of the gradient (else
    ``1/N`` of the unit)."""
    sites = gather_sites(cfg, groups, frontend_batch)
    counts = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    nbytes = {k: 0.0 for k in counts}
    for g in groups:
        lay = g.layout
        full = lay.n * lay.p_max if padded else lay.size
        share = lay.p_max if padded else lay.size / lay.n
        n = sites[g.name] * rounds
        ag = n if (remat == "none" or g.name == "shared") else 2 * n
        counts["all_gather"] += ag
        counts["reduce_scatter"] += n
        nbytes["all_gather"] += ag * full * gather_bytes
        nbytes["reduce_scatter"] += n * share * grad_bytes
        if replicas > 1:
            counts["all_reduce"] += n
            nbytes["all_reduce"] += n * share * grad_bytes
    return CollectiveStats(counts, nbytes)


def program_collectives(prog, rounds: Optional[int] = None,
                        padded: bool = True) -> CollectiveStats:
    """:func:`step_collectives` of a ``CephaloProgram`` (a rank's, or one
    on a mesh alone), its schedule's rounds for its ℓ unless given."""
    if rounds is None:
        rounds = len(prog.schedule.chunks(prog.ell))
    return step_collectives(
        prog.cfg, prog.groups, rounds,
        gather_bytes=prog.gather_dtype.itemsize,
        grad_bytes=prog.grad_dtype.itemsize, remat=prog.remat,
        frontend_batch=prog.has_frontend, padded=padded,
        replicas=prog.n // prog.n_state)


def main(argv=None) -> None:
    """Print the terms of every (arch × shape) at a chip count, on the
    H100 by default."""
    import argparse
    from repro_torch.configs.base import (ASSIGNED, INPUT_SHAPES, get_arch,
                                          shape_applicable)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="repeatable; all assigned archs if none")
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--model-par", type=int, default=16)
    args = ap.parse_args(argv)
    print(f"{'arch':<20} {'shape':<12} {'compute_s':>11} {'memory_s':>11} "
          f"{'collective_s':>12}  dominant  ({H100.name}, {args.chips} "
          f"chips)")
    for arch in args.arch or ASSIGNED:
        cfg = get_arch(arch)
        for name in args.shape or INPUT_SHAPES:
            shape = INPUT_SHAPES[name]
            if not shape_applicable(cfg, shape)[0]:
                continue
            t = terms_for(cfg, shape, args.chips, model_par=args.model_par)
            print(f"{arch:<20} {name:<12} {t.compute_s:11.4g} "
                  f"{t.memory_s:11.4g} {t.collective_s:12.4g}  {t.dominant}")


if __name__ == "__main__":
    main()
