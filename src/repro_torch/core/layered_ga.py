"""SPMD Cephalo train step: uneven FSDP + layered gradient accumulation.

The port of ``repro.core.layered_ga``.  The reference builds one
``jax.jit``-ed ``shard_map`` program over the flattened data-parallel
mesh; here every mesh position is a rank process of a
:class:`~repro_torch.core.engine.world.World`, and :class:`CephaloProgram`
is what one rank runs: every rank is a ZeRO-3 worker holding padded
``(P_max,)`` shards of every unit (the ``model`` mesh axis shards state
only — paper Sec. 2).  The unit grouping, GA schedule and collective
machinery come from the shared engine:

* **UnitPlanner** supplies the param→unit grouping and flat shard layouts
  (one copy, shared with the MPMD runtime).
* **Schedule** partitions the ℓ microbatches into collective rounds:
  ``layered`` (Cephalo, paper Fig. 4 bottom — one AllGather per unit per
  forward, one re-gather + one ReduceScatter per unit per backward, all
  microbatches between collectives), ``per_microbatch`` (the FSDP-GA
  baseline, Fig. 4 top), ``interleaved``, or any registered schedule.
  The layered schedule falls out of the loop structure (unit loop outer,
  microbatch loop inner) and full rematerialization: each unit's work
  runs under ``torch.utils.checkpoint``, so the backward re-gathers
  instead of keeping gathered params.
* **ShardMapSubstrate** provides the differentiable mixed-precision
  gather whose backward is the unit's ReduceScatter (plus the HSDP
  replica all-reduce).

A rank's batch is its slice of the plan's padded grid ``(ell, m, seq)``
with Eq. 1 weights zeroing the padding
(``repro_torch.data.pipeline.plan_grid_from_block``).

Knobs beyond the paper: ``gather_dtype`` (fp32 paper-faithful / bf16
halves collective bytes), ``grad_dtype``, ``remat`` (``"full"``
recompute, ``"none"``, or ``"offload"``: the boundary activations go to
host memory under ``torch.autograd.graph.save_on_cpu``), ``ce_chunk``,
``state_axes`` (HSDP) and ``unroll``, which is accepted and has no
effect: eager loops are always unrolled.

Where the reference gathers a unit whose output a function then leaves
unused (the misc unit in the embedding without learned positions, the
embedding in the head of an untied model), XLA drops the dead gather;
eager code does not, so this program gathers only what it uses.  Every
stage unit's state is ``(count, P_max)``, a count of 1 included.
``state_shardings``, ``batch_shardings`` and ``jit_step`` (the
reference's DeviceMesh/dry-run surface) belong to ROADMAP queue 1 item
11 and are not here.

The module also holds the rank-side functions of
:class:`~repro_torch.core.engine.api.SpmdEngine` (``rank_*``), which the
engine runs through ``World.call``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fsdp
from repro_torch.core.engine.schedules import Schedule, get_schedule
from repro_torch.core.engine.substrate import ShardMapSubstrate
from repro_torch.core.engine.units import (UnitGroup, UnitPlanner,
                                           merge_params, split_params)
from repro_torch.core.engine.world import Payload, RankContext
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig, adam_update

REMATS = ("full", "none", "offload")


def _dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"dtype {name!r}: 'float32' or 'bfloat16'")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class CephaloProgram:
    """One rank's SPMD train step for one arch, in the world of ``ctx``.

    Every rank of the world constructs it with the same arguments at the
    same time (it creates the mesh's process groups)."""

    def __init__(self, cfg: ArchConfig, ctx: RankContext,
                 ratios: Optional[Sequence[float]] = None,
                 ell: int = 1, m: int = 1, seq: int = 512,
                 ga_mode: Union[str, Schedule] = "layered",
                 gather_dtype: Union[str, torch.dtype] = "float32",
                 grad_dtype: Union[str, torch.dtype] = "float32",
                 remat: str = "full",
                 unroll: bool = False,
                 adam: AdamConfig = AdamConfig(),
                 ce_chunk: int = 512,
                 has_frontend_batch: bool = False,
                 state_axes: Optional[Sequence[str]] = None,
                 schedule: Union[str, Schedule, None] = None):
        self.cfg = cfg
        self.ctx = ctx
        self.mesh = ctx.mesh
        self.device = ctx.device
        self.axes = self.mesh.axis_names
        # HSDP (beyond-paper): shard state over a SUBSET of mesh axes and
        # replicate across the rest.  Default: ZeRO-3 over all axes.
        self.state_axes = tuple(state_axes) if state_axes is not None \
            else self.axes
        self.replica_axes = tuple(a for a in self.axes
                                  if a not in self.state_axes)
        self.n = self.mesh.size
        self.n_state = self.mesh.axis_size(self.state_axes)
        self.ratios = list(ratios) if ratios is not None \
            else [1.0 / self.n_state] * self.n_state
        if len(self.ratios) != self.n_state:
            raise ValueError(f"{len(self.ratios)} ratios for a state "
                             f"group of {self.n_state} ranks")
        self.ell, self.m, self.seq = ell, m, seq
        # ``schedule`` (engine API) wins over the legacy ``ga_mode`` alias
        self.schedule = get_schedule(schedule if schedule is not None
                                     else ga_mode)
        self.ga_mode = self.schedule.name
        self.gather_dtype = _dtype(gather_dtype)
        self.grad_dtype = _dtype(grad_dtype)
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}: one of {REMATS}")
        self.remat = remat
        self.unroll = unroll        # eager loops are always unrolled
        self.adam = adam
        self.ce_chunk = ce_chunk
        self.has_frontend = bool(cfg.frontend_dim) and has_frontend_batch
        self.planner = UnitPlanner(cfg, self.ratios)
        self.stages = self.planner.stages
        self.groups = self.planner.groups
        state_group, self.state_index = ctx.axis_group(self.state_axes)
        replica_group = ctx.axis_group(self.replica_axes)[0] \
            if self.replica_axes else None
        self.world_group = ctx.axis_group(self.axes)[0]
        self.substrate = ShardMapSubstrate(
            state_group, ctx.comm, replica_group=replica_group,
            gather_dtype=self.gather_dtype, grad_dtype=self.grad_dtype)
        self._gathers = {g.name: self.substrate.unit_gather_fn(g)
                         for g in self.groups}

    # --- layouts ----------------------------------------------------------
    def group(self, name: str) -> UnitGroup:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def has_group(self, name: str) -> bool:
        return any(g.name == name for g in self.groups)

    # --- state ------------------------------------------------------------
    def state_shapes(self) -> Dict[str, Tuple[Tuple[int, ...],
                                              torch.dtype]]:
        """Global (all ranks') shapes and dtypes of the training state: a
        unit's ``(n_state · P_max,)``, a stage's ``(count, n_state ·
        P_max)``.  A rank holds its ``P_max`` columns."""
        out = {"step": ((), torch.int64)}
        for g in self.groups:
            shape = (self.n_state * g.layout.p_max,)
            if g.stage_idx >= 0:
                shape = (g.count,) + shape
            for part in ("p", "m", "v"):
                out[f"{g.name}/{part}"] = (shape, torch.float32)
        return out

    def batch_shapes(self) -> Dict[str, Tuple[Tuple[int, ...],
                                              torch.dtype]]:
        """Global shapes and dtypes of a step's batch ``(n, ell, m, seq)``;
        a rank gets row ``rank``."""
        b = (self.n, self.ell, self.m, self.seq)
        out = {"tokens": (b, torch.int64), "labels": (b, torch.int64),
               "weights": (b, torch.float32)}
        if self.has_frontend:
            out["frontend_embed"] = (b + (self.cfg.frontend_dim,),
                                     torch.float32)
        return out

    def _shard_group_tree(self, g: UnitGroup, tree: Any) -> torch.Tensor:
        """One unit's full tree → this rank's padded shard, ``(P_max,)``
        or ``(count, P_max)`` for a stage unit."""
        return fsdp.padded_shard(g.layout, fsdp.flatten_unit(g.layout, tree),
                                 self.state_index)

    def state_from_trees(self, params: Dict[str, Any],
                         m_tree: Optional[Dict[str, Any]] = None,
                         v_tree: Optional[Dict[str, Any]] = None,
                         step: int = 0) -> Dict[str, Any]:
        """This rank's state from full model-shaped trees (leaves on any
        device): params and (optionally) Adam moments laid out on the
        shard layouts, moments zero where missing.  The trees' leaves are
        dropped unit by unit as their shards are cut."""
        grouped = {part: split_params(self.cfg, tree)
                   for part, tree in (("p", params), ("m", m_tree),
                                      ("v", v_tree)) if tree is not None}
        del params, m_tree, v_tree
        out: Dict[str, Any] = {"step": int(step)}
        for g in self.groups:
            for part in ("p", "m", "v"):
                if part in grouped:
                    out[f"{g.name}/{part}"] = self._shard_group_tree(
                        g, grouped[part].pop(g.name)).to(self.device)
                else:
                    out[f"{g.name}/{part}"] = torch.zeros_like(
                        out[f"{g.name}/p"])
        return out

    def init_state(self, generator: torch.Generator) -> Dict[str, Any]:
        """This rank's state from fp32 params drawn from ``generator`` on
        the rank's device: every rank draws the whole tree (the loopback
        engine's draw, bit for bit) and keeps its shard."""
        return self.state_from_trees(M.init_params(
            self.cfg, generator, self.device, all_fp32=True))

    @torch.no_grad()
    def gather_flats(self, state: Dict[str, Any],
                     part: str = "p") -> Dict[str, torch.Tensor]:
        """{unit: full flat ``(padded,)`` / ``(count, padded)``} of one
        state part, gathered over the state group (collective: every rank
        calls it)."""
        return {g.name: fsdp.gather_unit(g.layout, state[f"{g.name}/{part}"],
                                         self.substrate.state_group,
                                         self.ctx.comm)
                for g in self.groups}

    def gather_part(self, state: Dict[str, Any],
                    part: str = "p") -> Dict[str, Any]:
        """One full model-shaped tree from the sharded state: ``part`` —
        "p" (params), "m" or "v" (moments).  Collective."""
        flats = self.gather_flats(state, part)
        return merge_params({g.name: fsdp.unflatten_unit(g.layout,
                                                         flats[g.name])
                             for g in self.groups}, len(self.stages))

    def gather_params(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self.gather_part(state, "p")

    # -----------------------------------------------------------------
    # The step itself
    # -----------------------------------------------------------------
    def _gather(self, name: str, shard: torch.Tensor) -> Any:
        return self._gathers[name](shard)

    def _cast(self, tree: Any) -> Any:
        cdt = M.compute_dtype(self.cfg)
        return M.tree_map(tree, lambda _, a: a.to(cdt))

    def _remat(self, fn, *args):
        """``fn(*args)`` under the remat policy: ``full`` recomputes it
        (and its gathers) in the backward; ``offload`` too, with what the
        checkpoint saves — its inputs: the boundary activations, and the
        shards, which are copied too — in host memory
        (``torch.autograd.graph.save_on_cpu``, pinned on the card);
        ``none`` keeps its activations."""
        if self.remat == "none":
            return fn(*args)
        if self.remat == "offload":
            with torch.autograd.graph.save_on_cpu(
                    pin_memory=self.device.type == "cuda"):
                return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False)

    def _embed(self, eshard, mshard, toks, fe):
        ell_r, m, seq = toks.shape
        p = {"embed": self._gather("embed", eshard)["embed"]}
        if mshard is not None:
            p.update(self._gather("misc", mshard))
        positions = torch.arange(seq, device=toks.device)[None].expand(
            ell_r * m, seq)
        x = M.embed_tokens(self.cfg, p, toks.reshape(ell_r * m, seq),
                           positions, None if fe is None
                           else fe.reshape(ell_r * m, seq, -1))
        return x.reshape(ell_r, m, seq, -1)

    def _element(self, g: UnitGroup, spec, shard, x_all, positions, shared):
        """One stage element (= one FSDP unit) over every microbatch of
        the round: gather once, then the microbatches in order."""
        w = self._cast(self._gather(g.name, shard))
        ys, aux = [], torch.zeros((), dtype=torch.float32,
                                  device=x_all.device)
        for x_mb in x_all.unbind(0):
            y, a = M.element_apply(self.cfg, spec, w, x_mb, positions,
                                   shared)
            ys.append(y)
            aux = aux + a
        return torch.stack(ys), aux

    def _head(self, eshard, mshard, hshard, x_all, labels, weights):
        """Gather once, Σ w·CE over every microbatch of the round."""
        p = dict(self._gather("misc", mshard))
        if eshard is not None:
            p["embed"] = self._gather("embed", eshard)["embed"]
        if hshard is not None:
            p["head"] = self._gather("head", hshard)["head"]
        tot = torch.zeros((), dtype=torch.float32, device=x_all.device)
        for x_mb, y_mb, w_mb in zip(x_all.unbind(0), labels.unbind(0),
                                    weights.unbind(0)):
            tot = tot + M.chunked_ce(self.cfg, p, x_mb, y_mb, w_mb,
                                     self.ce_chunk)
        return tot

    def _loss_from_shards(self, ps: Dict[str, Any], tokens, labels,
                          weights, frontend) -> torch.Tensor:
        """Forward + loss for this rank's ``(ell_r, m, seq)`` rows of a
        round, collectives inside.  Its backward puts each unit's
        ReduceScattered gradient into the shard leaves' ``.grad``."""
        cfg = self.cfg
        cdt = M.compute_dtype(cfg)
        positions = torch.arange(self.seq, device=tokens.device)[None]\
            .expand(self.m, self.seq)
        need_misc = cfg.learned_pos or frontend is not None
        x_all = self._remat(self._embed, ps["embed"],
                            ps["misc"] if need_misc else None, tokens,
                            None if frontend is None
                            else frontend.to(cdt)).to(cdt)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        shared = self._cast(self._gather("shared", ps["shared"])) \
            if self.has_group("shared") else None
        for g in self.groups:
            if g.stage_idx < 0:
                continue
            spec = self.stages[g.stage_idx]
            for shard in ps[g.name]:
                x_all, a = self._remat(self._element, g, spec, shard, x_all,
                                       positions, shared)
                aux = aux + a
        ce = self._remat(self._head,
                         ps["embed"] if cfg.tie_embeddings else None,
                         ps["misc"], ps.get("head"), x_all, labels, weights)
        return ce + cfg.router_aux_coef * aux

    def _leaves(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The p shards as autograd leaves (views, no copy): one per
        unit, one per element of a stage unit, so each element's
        gradient lands in its own tensor."""
        out: Dict[str, Any] = {}
        for g in self.groups:
            p = state[f"{g.name}/p"]
            out[g.name] = [p[i].detach().requires_grad_(True)
                           for i in range(g.count)] if g.stage_idx >= 0 \
                else p.detach().requires_grad_(True)
        return out

    def _run_schedule(self, ps: Dict[str, Any], tokens, labels, weights,
                      frontend) -> torch.Tensor:
        """The summed loss of every round under the GA schedule; the
        rounds' shard-space gradients accumulate in the leaves' ``.grad``.

        The schedule partitions the ℓ microbatches into collective
        rounds; each round gathers every unit (and under full remat
        re-gathers it in the backward) and ReduceScatters its gradient
        contribution.  One round == layered GA; ℓ rounds of 1 == the
        FSDP-GA baseline."""
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        off = 0
        for size in self.schedule.chunks(self.ell):
            sl = slice(off, off + size)
            li = self._loss_from_shards(
                ps, tokens[sl], labels[sl], weights[sl],
                frontend[sl] if frontend is not None else None)
            li.backward()
            loss = loss + li.detach()
            off += size
        return loss

    def step(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, Any], float]:
        """One step on this rank's batch ``(ell, m, seq)`` (tokens,
        labels, weights and, with a frontend batch, ``frontend_embed``):
        the schedule's rounds, then Adam on the local shards (ZeRO-3: a
        fully local update), in place.  Returns the state and the loss
        summed over the world (every rank gets the same)."""
        dev = self.device
        tokens = batch["tokens"].to(dev, torch.int64)
        labels = batch["labels"].to(dev, torch.int64)
        weights = batch["weights"].to(dev, torch.float32)
        frontend = batch.get("frontend_embed") if self.has_frontend \
            else None
        if frontend is not None:
            frontend = frontend.to(dev, torch.float32)
        ps = self._leaves(state)
        loss = self._run_schedule(ps, tokens, labels, weights, frontend)
        step_no = state["step"] + 1
        with torch.no_grad():
            for g in self.groups:
                p, m, v = (state[f"{g.name}/{k}"] for k in ("p", "m", "v"))
                if g.stage_idx >= 0:
                    for i, leaf in enumerate(ps[g.name]):
                        adam_update(self.adam, p[i], _grad(leaf), m[i],
                                    v[i], step_no)
                else:
                    adam_update(self.adam, p, _grad(ps[g.name]), m, v,
                                step_no)
        del ps
        state["step"] = step_no
        total = loss.reshape(1)
        self.ctx.comm.all_reduce(total, self.world_group)
        return state, float(total)


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's accumulated gradient; zeros where the loss did not reach
    it (Adam still decays the moments, as in the reference)."""
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


# ---------------------------------------------------------------------------
# Rank-side functions of SpmdEngine (run on every rank by World.call)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FixedRounds:
    """A schedule's rounds for the program's ℓ, fixed by the controller:
    a picklable ``chunk_fn`` (a registered schedule's may be a lambda,
    and a rank process has only the built-in registry)."""

    rounds: Tuple[int, ...]

    def __call__(self, ell: int) -> List[int]:
        return list(self.rounds)


def rank_build(ctx: RankContext, cfg: ArchConfig, kwargs: dict) -> None:
    """Construct this rank's :class:`CephaloProgram`."""
    ctx.objects["program"] = CephaloProgram(cfg, ctx, **kwargs)


def rank_init(ctx: RankContext, gen_state: bytes) -> None:
    """This rank's state from the controller's generator state."""
    gen = torch.Generator(device=ctx.device)
    gen.set_state(torch.frombuffer(bytearray(gen_state), dtype=torch.uint8))
    prog = ctx.objects["program"]
    ctx.objects["state"] = None
    ctx.objects["state"] = prog.init_state(gen)
    _release(ctx)


def rank_step(ctx: RankContext, batch: Payload) -> dict:
    """One step on this rank's slice of the grid; its loss, seconds,
    device and backend, collectives, host bytes, kernel launches and
    peak device memory."""
    from repro_torch.core.engine.multiproc import kernel_launches
    prog: CephaloProgram = ctx.objects["program"]
    before = kernel_launches()
    host0 = ctx.comm.host_bytes
    prog.substrate.reset_stats()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t0 = time.perf_counter()
    arrays = {k: torch.from_numpy(np.asarray(a))
              for k, a in batch.arrays.items()}
    _, loss = prog.step(ctx.objects["state"], arrays)
    seconds = time.perf_counter() - t0
    after = kernel_launches()
    out = {"loss": loss, "seconds": seconds, "device": str(ctx.device),
           "backend": torch.distributed.get_backend(),
           "staged": ctx.comm.staged,
           "collectives": dict(prog.substrate.stats),
           "host_bytes": ctx.comm.host_bytes - host0,
           "launches": {k: after[k] - before.get(k, 0) for k in after
                        if after[k] != before.get(k, 0)},
           "peak_bytes": torch.cuda.max_memory_allocated(ctx.device)
           if ctx.device.type == "cuda" else 0}
    _release(ctx)
    return out


def rank_export(ctx: RankContext, part: str) -> Optional[Payload]:
    """This rank's padded shards of one state part (with the step), from
    the ranks of the first state group (a replica holds the same); the
    controller reassembles them on the host, as the reference's
    ``gather_part`` does, with no collective."""
    prog: CephaloProgram = ctx.objects["program"]
    if ctx.rank not in ctx.mesh.groups(prog.state_axes)[0]:
        return None
    state = ctx.objects["state"]
    return Payload({"step": state["step"]},
                   {g.name: state[f"{g.name}/{part}"].cpu().numpy()
                    for g in prog.groups})


def rank_import(ctx: RankContext, shards: Payload) -> None:
    """Take this rank's padded shards of one state part (``"<unit>|<part>"``
    arrays) and the step; the first part of an import (``meta["fresh"]``)
    drops the state held before."""
    if shards.meta["fresh"]:
        ctx.objects["state"] = None
        ctx.objects["state"] = {}
    state = ctx.objects["state"]
    for key, a in shards.arrays.items():
        state[key.replace("|", "/")] = torch.from_numpy(
            np.array(a)).to(ctx.device)
    state["step"] = int(shards.meta["step"])


def _release(ctx: RankContext) -> None:
    """Ranks that share a card return their cached device memory after
    their work: a block one keeps cached is one the other cannot have."""
    if ctx.comm.staged:
        torch.cuda.empty_cache()
