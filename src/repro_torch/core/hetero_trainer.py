"""MPMD heterogeneous trainer — the paper-faithful execution model.

The port of ``repro.core.hetero_trainer``.  PyTorch FSDP is MPMD at
heart: each GPU process runs its *own* loop with its *own* batch size;
only the collectives synchronize.  Cephalo's compute balancing (uneven
``b_i``) depends on that.  This runtime reproduces the model in one
process:

* every rank owns a *state shard* sized by the planner's ratio ``r_i``;
  the unit grouping and flat layouts come from
  :class:`~repro_torch.core.engine.units.UnitPlanner`;
* every rank runs its own forward and backward over its *unpadded*
  ``(ell_i, m_i)`` rows, through the model's kernels on CUDA tensors;
* AllGather / ReduceScatter are the
  :class:`~repro_torch.core.engine.substrate.LoopbackSubstrate`'s
  software collectives: all ranks share one device;
* the gradient-accumulation :class:`~repro_torch.core.engine.schedules.
  Schedule` partitions each step into collective rounds — ``layered``
  gathers once per step, ``per_microbatch`` once per microbatch index.

Gradients are summed over ranks in rank order and accumulated over
rounds in shard space, as in the reference; Adam then updates each rank's
shard in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fsdp
from repro_torch.core.engine.schedules import Schedule, get_schedule
from repro_torch.core.engine.substrate import LoopbackSubstrate
from repro_torch.core.engine.units import (UnitGroup, UnitPlanner,
                                           normalized_ratios)
from repro_torch.core.partition import Plan
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig, adam_update


def trainable(params: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                               List[torch.Tensor]]:
    """A gathered params tree as autograd leaves: each leaf detached (no
    copy) and requiring grad, each stage as a list of per-layer trees.
    Returns (tree, leaves in :func:`fsdp.tree_flatten` order)."""
    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach().requires_grad_(True)

    tree = {k: M.tree_map(v, lambda _, t: leaf(t))
            for k, v in params.items() if k != "stages"}
    tree["stages"] = [[M.tree_map(M.layer(sp, i), lambda _, t: leaf(t))
                       for i in range(_count(sp))]
                      for sp in params["stages"]]
    leaves, _ = fsdp.tree_flatten(tree)
    return tree, leaves


def rank_loss_and_grads(cfg: ArchConfig, params: Dict[str, Any],
                        leaves: List[torch.Tensor], batch: Dict
                        ) -> Tuple[float, List[torch.Tensor]]:
    """One rank call: the loss of ``batch`` and its grads with respect
    to ``leaves`` (from :func:`trainable`).  The loopback engine and the
    process fleet's workers both compute through it, so they agree bit
    for bit.  A leaf the loss does not use (the frontend stub's
    projection: ranks get no frontend embeddings) has a zero grad, as in
    the reference."""
    loss, _ = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return float(loss.detach()), list(grads)


def _count(stacked: Any) -> int:
    leaves, _ = fsdp.tree_flatten(stacked)
    return leaves[0].shape[0]


class HeteroTrainer:
    """Loopback MPMD Cephalo runtime for one (cfg, plan) pair on one
    device (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: ArchConfig, plan: Plan,
                 adam: AdamConfig = AdamConfig(), seq_len: int = 512,
                 schedule: Union[str, Schedule] = "layered",
                 device: torch.device | str = "cuda"):
        if not plan.feasible:
            raise ValueError(f"infeasible plan: {plan.infeasible_reason}")
        self.cfg = cfg
        self.plan = plan
        self.adam = adam
        self.seq = seq_len
        self.n = plan.n
        self.device = M.resolve_device(device)
        self.schedule = get_schedule(schedule)
        # guard against all-zero ratio degeneracies in tiny tests
        self.ratios = normalized_ratios(plan.state_ratios())
        self.planner = UnitPlanner(cfg, self.ratios)
        self.groups: List[UnitGroup] = self.planner.groups
        self.substrate = LoopbackSubstrate(self.planner, self.device)

    # --- state ------------------------------------------------------------
    def init_shards(self, generator: torch.Generator
                    ) -> List[Dict[str, Any]]:
        """Per-rank state shards {unit: {"p","m","v"}} on the device, from
        fp32 params drawn from ``generator`` (which lives on the device)."""
        params = M.init_params(self.cfg, generator, self.device,
                               all_fp32=True)
        shards = self.substrate.shard_state(params)
        for s in shards:
            s["step"] = 0
        return shards

    def software_allgather(self, shards: List[Dict[str, Any]]
                           ) -> Dict[str, Any]:
        """Reassemble the full params tree from all ranks' shards."""
        return self.substrate.allgather_params(shards)

    def software_reduce_scatter(self, grads_full: Any
                                ) -> List[Dict[str, torch.Tensor]]:
        """Full-grad tree → per-rank shard slices (already summed)."""
        return self.substrate.reduce_scatter_grads(grads_full)

    # --- per-rank work --------------------------------------------------------
    def rank_batches(self, big: np.ndarray) -> List[Optional[Dict]]:
        """Slice a (B, seq+1) global sample block by the plan's b_i —
        *unpadded* per-rank shapes (the MPMD difference) — with Eq. 1
        weights ``1/(B·seq)``."""
        if big.shape[0] < self.plan.global_batch:
            raise ValueError(
                f"sample block has {big.shape[0]} rows; the plan's "
                f"global_batch needs {self.plan.global_batch}")
        out: List[Optional[Dict]] = []
        cursor = 0
        b = self.plan.global_batch
        w_val = 1.0 / (b * self.seq) if b else 0.0
        for r in self.plan.ranks:
            if r.b == 0:
                out.append(None)
                continue
            rows = torch.from_numpy(np.asarray(
                big[cursor: cursor + r.b], dtype=np.int64)).to(self.device)
            cursor += r.b
            out.append({
                "tokens": rows[:, :-1],
                "labels": rows[:, 1:],
                "weights": torch.full((r.b, self.seq), w_val,
                                      dtype=torch.float32,
                                      device=self.device),
            })
        if cursor != self.plan.global_batch:
            raise ValueError(
                f"plan rank batches consumed {cursor} rows, expected "
                f"global_batch {self.plan.global_batch} "
                f"(Σ b_i = {sum(r.b for r in self.plan.ranks)})")
        return out

    def _round_loss_and_grads(self, full_params: Dict[str, Any], batches,
                              mb_lo: int, mb_hi: int
                              ) -> Tuple[float, Optional[Dict[str, Any]]]:
        """Fwd+bwd for microbatch indices [mb_lo, mb_hi) on every rank.

        Rank *i* contributes its microbatches with index < ell_i in the
        range; each is m_i rows of its unpadded batch slice.  Returns the
        summed loss and the gradient tree summed over ranks in rank order
        (stages as per-layer lists), or None if no rank had work.
        """
        params, leaves = trainable(full_params)
        total_loss = 0.0
        grads_sum: Optional[List[torch.Tensor]] = None
        for rank in range(self.n):
            r = self.plan.ranks[rank]
            lo, hi = min(mb_lo, r.ell), min(mb_hi, r.ell)
            if r.b == 0 or hi <= lo:
                continue
            b = batches[rank]
            rows = slice(lo * r.m, hi * r.m)
            loss, grads = rank_loss_and_grads(
                self.cfg, params, leaves, {k: t[rows] for k, t in b.items()})
            total_loss += loss
            grads_sum = grads if grads_sum is None else \
                [a + g for a, g in zip(grads_sum, grads)]
        if grads_sum is None:
            return total_loss, None
        _, treedef = fsdp.tree_flatten(params)
        return total_loss, fsdp.tree_unflatten(treedef, grads_sum)

    def step(self, shards: List[Dict[str, Any]], big: np.ndarray
             ) -> Tuple[List[Dict[str, Any]], float]:
        """One training iteration.  ``big``: (B, seq+1) token block.

        The schedule's collective rounds are walked over the *padded*
        microbatch index space (ℓ_pad = max_i ℓ_i): each round re-gathers
        the full params (AG), runs its microbatch range on every rank, and
        ReduceScatters the round's summed gradient into shard space, where
        it accumulates.  ``layered`` ⇒ exactly one AG + one RS per step.
        The shards are updated in place and returned.
        """
        batches = self.rank_batches(big)
        chunks = self.schedule.chunks(max(self.plan.ell_pad, 1))
        total_loss = 0.0
        grad_shards: Optional[List[Dict[str, torch.Tensor]]] = None
        mb_off = 0
        for size in chunks:
            full_params = self.software_allgather(shards)       # AG
            loss, grads = self._round_loss_and_grads(
                full_params, batches, mb_off, mb_off + size)
            del full_params
            mb_off += size
            if grads is None:
                continue        # every rank exhausted its ℓ_i already
            total_loss += loss
            round_shards = self.substrate.reduce_scatter_grads(grads)  # RS
            del grads
            grad_shards = self.substrate.accumulate_grad_shards(
                grad_shards, round_shards)
        if grad_shards is None:
            # no round produced gradients (every active rank has ell_i ==
            # 0): no optimizer update
            return shards, total_loss
        # local Adam on each rank's shard (ZeRO-3: fully local)
        for r in range(self.n):
            shards[r]["step"] += 1
            for g in self.groups:
                st = shards[r][g.name]
                adam_update(self.adam, st["p"], grad_shards[r][g.name],
                            st["m"], st["v"], shards[r]["step"])
        return shards, total_loss

    # --- simulated wall-clock ----------------------------------------------
    def simulated_iteration_seconds(self) -> Dict[str, float]:
        """Timeline from the plan's cost model: what the plan predicts
        for the cluster it was solved for, not a time of this device."""
        return {
            "layer_s": self.plan.predicted_layer_s,
            "iteration_s": self.plan.predicted_iter_s,
            "throughput_samples_s": self.plan.predicted_throughput,
        }

    def memory_report(self, shards: List[Dict[str, Any]]) -> str:
        lines = []
        for r in range(self.n):
            nbytes = sum(
                v.numel() * v.element_size() for g in self.groups
                for v in shards[r][g.name].values())
            lines.append(
                f"rank{r} {self.plan.ranks[r].device:<8} state "
                f"{nbytes / (1 << 20):8.1f} MiB  "
                f"(ratio {self.plan.ranks[r].state_ratio:.3f})")
        return "\n".join(lines)
