"""CollectiveSubstrate — how gather/scatter are performed.

The port of ``repro.core.engine.substrate``'s loopback half.  Schedules
(:mod:`repro_torch.core.engine.schedules`) decide *when* the per-unit
collectives of the paper's Fig. 4 rounds happen; a substrate decides
*how* (uneven-shard AllGather/ReduceScatter, paper Sec. 2 / App. C).

:class:`LoopbackSubstrate` runs the MPMD process model's collectives in
one process: full-tree reassembly from per-rank ragged shards (AllGatherv
semantics, zero padding overhead) and full-grad → per-rank-slice scatter.
Shards are torch tensors on the engine's device.  It counts collective
*events* (``stats``) so tests can assert a schedule's round structure.

:class:`ShardMapSubstrate` runs the SPMD runtime's collectives inside
each rank process of a :class:`~repro_torch.core.engine.world.World`:
the forward AllGather and the backward ReduceScatter are one
differentiable gather (``fsdp.make_mixed_gather``) with independent
forward / backward precision, plus the HSDP replica all-reduce.  Its
``stats`` count each collective as it runs, so they are exact — where
the reference's, inside a traced program, would count tracing, not
execution.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import fsdp
from repro_torch.core.engine.units import UnitGroup, UnitPlanner


class CollectiveSubstrate(abc.ABC):
    """Common surface of the per-unit gather/scatter machinery."""

    name: str = "abstract"

    def __init__(self) -> None:
        self.stats: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0}

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0


class ShardMapSubstrate(CollectiveSubstrate):
    """Per-rank collectives of the SPMD runtime.

    ``state_group`` — the process group the state is sharded over (ZeRO-3
    over the whole world by default); ``replica_group`` — HSDP: the group
    the state is replicated over, whose gradient all-reduce rides on the
    gather's backward.  ``comm`` is the rank's
    :class:`~repro_torch.core.engine.world.Comm`; the substrate runs its
    collectives through a scope of it, whose ``calls`` and ``bytes``
    (each output buffer's, as it runs) hold the unit collectives alone.
    """

    name = "shard_map"

    def __init__(self, state_group, comm, replica_group=None,
                 gather_dtype: torch.dtype = torch.float32,
                 grad_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stats["all_reduce"] = 0
        self.state_group = state_group
        self.replica_group = replica_group
        self.comm = comm.scope()
        self.gather_dtype = gather_dtype
        self.grad_dtype = grad_dtype

    def reset_stats(self) -> None:
        super().reset_stats()
        self.comm.reset()

    def unit_gather_fn(self, group: UnitGroup) -> Callable[[torch.Tensor],
                                                           Any]:
        """``(P_max,)`` local shard → the unit's full param tree in
        ``gather_dtype`` (views of one gathered buffer).  Differentiable:
        the backward is one ReduceScatter of the cotangent (plus the HSDP
        replica all-reduce) — the schedule's per-round collective pair."""
        fn = fsdp.make_mixed_gather(group.layout, self.state_group,
                                    self.comm, self.gather_dtype,
                                    self.grad_dtype,
                                    replica_group=self.replica_group,
                                    stats=self.stats)

        def gather(shard: torch.Tensor) -> Any:
            return fsdp.unflatten_unit(group.layout, fn(shard))

        return gather


class LoopbackSubstrate(CollectiveSubstrate):
    """In-process software collectives for the MPMD loopback runtime.

    State lives as per-rank *ragged* shards (physical memory ∝ r_i — the
    paper's memory-balancing claim); gather reassembles the full tree,
    scatter slices a full gradient tree back into rank shards.
    """

    name = "loopback"

    def __init__(self, planner: UnitPlanner, device: torch.device):
        super().__init__()
        self.planner = planner
        self.n = planner.n
        self.device = torch.device(device)

    # --- flat wire format ---------------------------------------------------
    # One layout path for params, gradients and optimizer moments: a
    # model-shaped tree ⇄ per-unit flat fp32 buffers (``(padded,)``, or
    # ``(count, padded)`` for stage units, whose leaves keep their count
    # dim even at count 1) ⇄ per-rank ragged slices.

    def flatten_tree(self, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Full model-shaped tree → {unit: flat padded buffer} on the
        engine's device.  A stage may be stacked or a list of per-layer
        trees (the trainer's gradients)."""
        grouped = self.planner.split(tree)
        out: Dict[str, torch.Tensor] = {}
        for g in self.planner.groups:
            sub = grouped[g.name]
            lead = (g.count,) if g.stage_idx >= 0 else ()
            flat = torch.zeros(lead + (g.layout.padded,),
                               dtype=torch.float32, device=self.device)
            if isinstance(sub, list):
                for i, elem in enumerate(sub):
                    fsdp.flatten_unit(g.layout, elem, out=flat[i])
            else:
                fsdp.flatten_unit(g.layout, sub, out=flat)
            out[g.name] = flat
        return out

    def slice_flats(self, flats: Dict[str, torch.Tensor]
                    ) -> List[Dict[str, torch.Tensor]]:
        """{unit: flat buffer} → per-rank {unit: ragged slice} (the
        scatter half of AllGatherv/ReduceScatterv)."""
        out: List[Dict[str, torch.Tensor]] = [dict() for _ in range(self.n)]
        for g in self.planner.groups:
            for r, s in enumerate(fsdp.shard_unit_ragged(g.layout,
                                                         flats[g.name])):
                out[r][g.name] = s
        return out

    def concat_slices(self, slices: Sequence[Dict[str, Any]],
                      key: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Per-rank ragged slices → {unit: flat buffer} (the gather half
        of AllGatherv).  ``key`` indexes {"p","m","v"} state shards;
        ``None`` takes the slice itself (gradient buffers)."""
        out: Dict[str, torch.Tensor] = {}
        for g in self.planner.groups:
            parts = []
            for r in range(self.n):
                s = slices[r][g.name]
                if key is not None:
                    s = s[key]
                parts.append(s[..., : g.layout.shard_sizes[r]])
            out[g.name] = torch.cat(parts, dim=-1)
        return out

    def unflatten_flats(self, flats: Dict[str, torch.Tensor]
                        ) -> Dict[str, Any]:
        """{unit: flat buffer} → full model-shaped tree, its leaves views
        of the buffers (stage leaves stacked on the count dim)."""
        grouped = {g.name: fsdp.unflatten_unit(g.layout, flats[g.name])
                   for g in self.planner.groups}
        return self.planner.merge(grouped)

    # --- state layout -------------------------------------------------------
    def shard_tree(self, tree: Dict[str, Any]
                   ) -> List[Dict[str, torch.Tensor]]:
        """Any full model-shaped tree → per-rank {unit: ragged buffer}.
        The single layout path for params, gradients and moments."""
        return self.slice_flats(self.flatten_tree(tree))

    def shard_state(self, params: Dict[str, Any],
                    m_tree: Optional[Dict[str, Any]] = None,
                    v_tree: Optional[Dict[str, Any]] = None,
                    ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Full params (+ optional Adam moment trees) → per-rank
        {unit: {"p","m","v"}} ragged shards.  Missing moments init to 0."""
        parts = {"p": self.shard_tree(params)}
        for key, tree in (("m", m_tree), ("v", v_tree)):
            if tree is not None:
                parts[key] = self.shard_tree(tree)
        shards: List[Dict[str, Any]] = [dict() for _ in range(self.n)]
        for g in self.planner.groups:
            for r in range(self.n):
                p = parts["p"][r][g.name]
                shards[r][g.name] = {
                    k: parts[k][r][g.name] if k in parts
                    else torch.zeros_like(p) for k in ("p", "m", "v")}
        return shards

    # --- collectives --------------------------------------------------------
    def allgather_params(self, shards: List[Dict[str, Any]],
                         key: str = "p") -> Dict[str, Any]:
        """Reassemble the full params tree from all ranks' shards."""
        self.stats["all_gather"] += 1
        return self.unflatten_flats(self.concat_slices(shards, key))

    def reduce_scatter_grads(self, grads_full: Any
                             ) -> List[Dict[str, torch.Tensor]]:
        """Full-grad tree (already summed over ranks) → per-rank shard
        slices, through the same layout path as :meth:`shard_state`."""
        self.stats["reduce_scatter"] += 1
        return self.shard_tree(grads_full)

    def accumulate_grad_shards(self, acc, new):
        """Shard-space gradient accumulation across collective rounds,
        into ``acc`` in place (its tensors are the substrate's own)."""
        if acc is None:
            return new
        for r in range(self.n):
            for name, t in new[r].items():
                acc[r][name].add_(t)
        return acc
