"""Tensor-parallel serving: the serving rules and the runtime that runs them.

The port of ``repro.launch.serving`` ("GSPMD tensor-parallel prefill and
decode").  Cephalo is a *training* system; the serving shapes
(prefill_32k, decode_32k, long_500k) use standard inference sharding
instead (DESIGN.md §5):

* weights resident, tensor-parallel over the ``model`` axis (heads / d_ff /
  experts / vocab / SSM channels), batch over the data axes — per-leaf
  rules in :func:`param_shardings`;
* KV caches sharded over batch (when it divides) and over *sequence* on
  the ``model`` axis, SSM state over heads — :func:`cache_shardings`;
* sub-axis-size dims are left replicated.

A rule is a :data:`~repro_torch.core.engine.world.ShardSpec` over a
:class:`~repro_torch.core.engine.world.Mesh`: for each dim the axes it is
split over, as the reference's ``PartitionSpec``.

The reference's ``build_prefill`` and ``build_decode`` jit
``model.prefill`` / ``model.decode_step`` under those shardings and let
GSPMD insert the collectives.  The eager port runs the same placement on
a :class:`~repro_torch.core.engine.world.World` of rank processes: each
rank holds exactly its shard of every weight (:func:`shard_params`, at
rest in the compute dtype, bf16 at full size, as the reference's
``serving_param_shapes``) and of every cache leaf
(:func:`rank_caches`), computes on them and issues on its
:class:`~repro_torch.core.engine.world.Comm` the collectives GSPMD would
insert (``models.layers.attention.TensorAxis``; each layer's docstring
names them).  :func:`rank_serve` is one rank of that, the counterpart of
both builders, and :func:`serve_sharded` runs it on a world.  The
whole-weight, sequence-split decode stays a function of the
model (``decode_step(..., seq_shard_axis)`` on :func:`shard_cache`'s
cuts, the SSM state whole on every rank).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine.world import (Mesh, Payload, RankContext,
                                           ShardSpec, World)
from repro_torch.launch.mesh import (all_axes, axis_size, data_axes,
                                     make_test_mesh)
from repro_torch.models import model as M
from repro_torch.models.layers.attention import SeqShardAxis, TensorAxis
from repro_torch.models.layers.moe import recording_routes

#: the KV cache groups of each stage kind, by ``decode_step``'s names
_KV_GROUPS = {"dense": ("k",), "pair": ("local", "global"),
              "zamba": ("attn",)}


def _maybe(mesh: Mesh, axis, dim: int):
    """Use ``axis`` for a dim only if the dim divides evenly over it."""
    n = axis_size(mesh, axis)
    return axis if dim >= n and dim % n == 0 else None


def _tree_map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: a spec); a list entry's name is ``"[i]"``, as the reference's
    ``_path_names`` spells it."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_with_path(fn, v, path + (f"[{i}]",))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


# ---------------------------------------------------------------------------
# Parameter shardings (rule-based, per leaf)
# ---------------------------------------------------------------------------

def _leaf_spec(mesh: Mesh, names: List[str], shape: Tuple[int, ...]
               ) -> ShardSpec:
    name = names[-1]
    parents = set(names[:-1])
    nd = len(shape)

    def at(pos: int, axis="model") -> Optional[ShardSpec]:
        """'model' at dim ``pos`` counted from the END (None if the dim
        does not divide — caller can try another dim)."""
        idx = nd + pos if pos < 0 else pos
        n = axis_size(mesh, axis)
        if shape[idx] < n or shape[idx] % n != 0:
            return None
        spec: List[Any] = [None] * nd
        spec[idx] = axis
        return tuple(spec)

    def first(*cands) -> ShardSpec:
        for c in cands:
            if c is not None:
                return c
        return ()

    if name == "embed":
        return first(at(0), at(-1))       # vocab rows, else d_model
    if name == "head":
        return first(at(-1), at(-2))      # (D, V) → V, else D
    if name in ("pos_embed", "frontend_proj"):
        return ()
    if name in ("wq", "wk", "wv"):
        return first(at(-2), at(-1))      # heads, else head_dim
    if name == "wo":
        return first(at(-3), at(-1))      # heads, else d_model
    if name in ("w_gate", "w_up"):
        if "moe" in parents:
            return first(at(-3), at(-1))  # experts, else d_ff
        return first(at(-1))              # d_ff
    if name == "w_down":
        if "moe" in parents:
            return first(at(-3), at(-2))  # experts, else d_ff
        return first(at(-2))              # d_ff
    if name == "router":
        return ()
    if name == "b_up":
        return first(at(-1))
    if name in ("in_proj", "conv_w"):
        return first(at(-1))              # conv channels / proj out
    if name == "conv_b":
        return first(at(-1))
    if name == "out_proj":
        return first(at(-2))              # d_inner
    return ()                             # norms, biases, scalars


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The param tree of ``M.init_params(cfg, ...)`` on the meta device."""
    return M.init_params(cfg, torch.Generator(), device="meta")


def param_shardings(cfg: ArchConfig, mesh: Mesh) -> Any:
    """A spec tree matching ``M.init_params(cfg, ...)``."""
    return _tree_map_with_path(
        lambda names, leaf: _leaf_spec(mesh, names, tuple(leaf.shape)),
        param_shapes(cfg))


def serving_param_shapes(cfg: ArchConfig) -> Any:
    """Serving keeps weights resident in bf16 (inference does not need the
    fp32 master copies; DESIGN.md §5): meta tensors."""
    return _tree_map_with_path(
        lambda _, t: torch.empty(t.shape, device="meta", dtype=(
            torch.bfloat16 if t.dtype == torch.float32 else t.dtype)),
        param_shapes(cfg))


# ---------------------------------------------------------------------------
# Cache shardings
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> List[Dict]:
    """``M.init_cache(cfg, batch, max_len)`` on the meta device."""
    return M.init_cache(cfg, batch, max_len, device="meta")


def seq_axes(mesh: Mesh, batch: int) -> Tuple[str, ...]:
    """The mesh axes the KV caches' sequence is split over."""
    data_ax = data_axes(mesh)
    return ("model",) if _maybe(mesh, data_ax, batch) is not None \
        else data_ax + ("model",)


def cache_shardings(cfg: ArchConfig, mesh: Mesh, batch: int,
                    max_len: int) -> Any:
    """A spec tree matching ``M.init_cache(cfg, batch, max_len)``.

    Batch over the data axes when it divides; sequence (and SSM heads)
    over 'model'.  For batch < data size, sequence shards over *all* axes
    (the long_500k single-sequence case)."""
    data_ax = data_axes(mesh)
    bspec = _maybe(mesh, data_ax, batch)
    sspec_kv = seq_axes(mesh, batch)

    def one(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: List[Any] = [None] * nd
        if name in ("k", "v", "pos"):     # (L, B, S, [KV, hd])
            spec[1] = _maybe(mesh, data_ax, shape[1]) \
                if bspec is not None else None
            spec[2] = _maybe(mesh, sspec_kv, shape[2])
            return tuple(spec)
        if name == "h":                   # (..., B, H, P, N)
            spec[nd - 4] = _maybe(mesh, data_ax, shape[nd - 4]) \
                if bspec is not None else None
            spec[nd - 3] = _maybe(mesh, "model", shape[nd - 3])
            return tuple(spec)
        if name == "conv":                # (..., B, W-1, Cd)
            spec[nd - 3] = _maybe(mesh, data_ax, shape[nd - 3]) \
                if bspec is not None else None
            spec[nd - 1] = _maybe(mesh, "model", shape[nd - 1])
            return tuple(spec)
        return ()

    return _tree_map_with_path(one, cache_shapes(cfg, batch, max_len))


def batch_sharding(mesh: Mesh, batch: int) -> Tuple[ShardSpec, ShardSpec]:
    """(tokens (B, 1), positions (B,)) specs: batch over the data axes
    when it divides."""
    bspec = _maybe(mesh, data_axes(mesh), batch)
    return (bspec, None), (bspec,)


def tree_bytes(mesh: Mesh, shapes: Any, specs: Any) -> int:
    """Bytes one rank holds of a tree of meta tensors placed by a spec
    tree of the same structure."""
    leaves: List[torch.Tensor] = []
    _tree_map_with_path(lambda _, t: leaves.append(t), shapes)
    spec_leaves: List[ShardSpec] = []
    _tree_map_with_path(lambda _, s: spec_leaves.append(s), specs)
    return sum(math.prod(mesh.shard_shape(t.shape, s)) * t.element_size()
               for t, s in zip(leaves, spec_leaves))


# ---------------------------------------------------------------------------
# The sequence split that decode runs
# ---------------------------------------------------------------------------

def _kv_groups(cfg: ArchConfig, caches: List[Dict]):
    """(group name, that group's ``{"k", "v", "pos"}``) of every KV cache
    group of a cache list."""
    for spec, cache in zip(M.build_stages(cfg), caches):
        for name in _KV_GROUPS.get(spec.kind, ()):
            yield name, (cache if name == "k" else cache[name])


def cache_totals(cfg: ArchConfig, batch: int, max_len: int
                 ) -> Dict[str, int]:
    """{cache group: global length} for ``decode_step``'s
    ``cache_total``."""
    return {name: c["k"].shape[2] for name, c in
            _kv_groups(cfg, cache_shapes(cfg, batch, max_len))}


def seq_shard_axis(ctx: RankContext, batch: int) -> SeqShardAxis:
    """The :class:`SeqShardAxis` of this rank: the process group over the
    axes its caches' sequence is split over (collective: every rank of
    the world calls it)."""
    axes = seq_axes(ctx.mesh, batch)
    group, index = ctx.axis_group(axes)
    return SeqShardAxis(group, ctx.comm, index)


def batch_rows(mesh: Mesh, rank: int, batch: int) -> slice:
    """The rows of the batch that rank ``rank`` decodes: its block along
    the data axes where :func:`cache_shardings` splits the batch over
    them, else the whole batch."""
    ax = data_axes(mesh)
    if _maybe(mesh, ax, batch) is None:
        return slice(0, batch)
    size = batch // axis_size(mesh, ax)
    start = mesh.coord(rank, ax) * size
    return slice(start, start + size)


def shard_cache(cfg: ArchConfig, caches: List[Dict], mesh: Mesh, rank: int,
                batch: int, max_len: int) -> List[Dict]:
    """Rank ``rank``'s blocks of full caches (as ``prefill`` builds them),
    copied (the full caches can go): each KV leaf (``k``, ``v``, ``pos``)
    cut along every dim :func:`cache_shardings` splits, so to the rank's
    :func:`batch_rows` and its slots.  SSM state is cut to the rank's
    rows only, for the whole-weight decode, in which every rank of a
    sequence group steps its rows' whole state alike (its rule's split of
    the heads is the tensor-parallel path's: :func:`rank_caches`).
    """
    specs = cache_shardings(cfg, mesh, batch, max_len)

    def cut(name: str, t: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
        kv = name in ("k", "v", "pos")
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            if not kv and "model" in axes:
                continue                # SSM heads: not split
            n = mesh.axis_size(axes)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.coord(rank, axes) * size, size)
        return t.clone()

    def walk(tree, spec, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return cut(name, tree, spec)

    return walk(caches, specs)


# ---------------------------------------------------------------------------
# The tensor-parallel split that serving runs
# ---------------------------------------------------------------------------

def _map2(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec, name)`` over a tree and its spec tree."""
    def walk(t, s, name=""):
        if isinstance(t, dict):
            return {k: walk(v, s[k], k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, x) for v, x in zip(t, s)]
        return fn(t, s, name)
    return walk(tree, specs)


def _block(t: torch.Tensor, spec: ShardSpec, mesh: Mesh,
           rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` (a view) under ``spec``."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        size = t.shape[dim] // mesh.axis_size(axes)
        t = t.narrow(dim, mesh.coord(rank, axes) * size, size)
    return t


def shard_params(cfg: ArchConfig, params: Dict[str, Any], mesh: Mesh,
                 rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s shard of every leaf of a whole params tree (as
    ``M.init_params`` builds it, or its meta shapes), copied, so the whole
    tree can go: each leaf cut along the dim :func:`param_shardings`
    splits, to ``mesh.shard_shape(leaf.shape, spec)``."""
    return _map2(lambda t, spec, _: _block(t, spec, mesh, rank).clone(),
                 params, param_shardings(cfg, mesh))


def rank_params(cfg: ArchConfig, seed: int, mesh: Mesh, rank: int,
                device: torch.device | str) -> Dict[str, Any]:
    """Rank ``rank``'s weights at rest: the whole params drawn from
    ``seed`` on ``device`` (every rank draws the same; the whole tree
    exists only while it is cut), its shard kept (:func:`shard_params`),
    every floating leaf in the compute dtype — bf16 at full size, norms
    and the SSM block's scalars too, as the reference's
    :func:`serving_param_shapes` keeps them."""
    whole = M.init_params(cfg, torch.Generator(device).manual_seed(seed),
                          device)
    return _at_rest(cfg, shard_params(cfg, whole, mesh, rank))


def _at_rest(cfg: ArchConfig, tree: Any) -> Any:
    dtype = M.compute_dtype(cfg)
    return _tree_map_with_path(
        lambda _, t: t.to(dtype) if t.is_floating_point() else t, tree)


def rank_caches(cfg: ArchConfig, mesh: Mesh, batch: int, max_len: int,
                device: torch.device | str) -> List[Dict]:
    """A rank's empty cache shards (zeros, ``pos`` -1) at the shapes
    :func:`cache_shardings` gives every rank: its rows, its slots of each
    KV cache, its heads of the SSM state, its channels of the conv
    state."""
    def one(t, spec, name):
        shape = mesh.shard_shape(t.shape, spec)
        if name == "pos":
            return torch.full(shape, -1, dtype=t.dtype, device=device)
        return torch.zeros(shape, dtype=t.dtype, device=device)
    return _map2(one, cache_shapes(cfg, batch, max_len),
                 cache_shardings(cfg, mesh, batch, max_len))


def tensor_axis(ctx: RankContext, comm=None) -> TensorAxis:
    """The :class:`TensorAxis` of this rank: the process group over the
    ``model`` axis, its index there, ``comm`` (default the rank's)
    (collective: every rank of the world calls it)."""
    group, index = ctx.axis_group(("model",))
    return TensorAxis(group, comm or ctx.comm, index,
                      ctx.mesh.axis_size(("model",)))


def gather_tree(ctx: RankContext, tree: Any, specs: Any) -> Any:
    """The whole tree on every rank from every rank's shards of it, placed
    by ``specs`` (an all-gather over the world, leaf by leaf; collective)."""
    mesh = ctx.mesh
    group, _ = ctx.axis_group(all_axes(mesh))

    def one(t, spec, _):
        parts = t.new_empty((mesh.size,) + tuple(t.shape))
        ctx.comm.all_gather(parts, t.contiguous(), group)
        whole = t.new_empty(tuple(
            n * (1 if axes is None else mesh.axis_size(
                (axes,) if isinstance(axes, str) else axes))
            for n, axes in zip(t.shape, tuple(spec) + (None,) * t.dim())))
        for r in range(mesh.size):
            _block(whole, spec, mesh, r).copy_(parts[r])
        return whole
    return _map2(one, tree, specs)


# ---------------------------------------------------------------------------
# Sequence-sharded serving on a world of ranks
# ---------------------------------------------------------------------------

def _nbytes(tree: Any, names: Optional[Tuple[str, ...]] = None) -> int:
    """Bytes of the leaves of a tree (of those named ``names``)."""
    total = 0

    def one(path, t):
        nonlocal total
        if names is None or path[-1] in names:
            total += t.numel() * t.element_size()

    _tree_map_with_path(one, tree)
    return total


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fp32(tree: Any) -> Any:
    """A copy of a tree (every leaf copied, an fp32 one too) with its
    floating leaves in fp32."""
    return _tree_map_with_path(
        lambda _, t: t.to(torch.float32, copy=True) if t.is_floating_point()
        else t.clone(), tree)


def _greedy(cfg: ArchConfig, params, caches, first: torch.Tensor, plen: int,
            steps: int, axis: Optional[SeqShardAxis] = None,
            totals: Optional[Dict[str, int]] = None,
            teacher: Optional[torch.Tensor] = None,
            tp: Optional[TensorAxis] = None):
    """``steps`` decode steps from token ``first`` at position ``plen``:
    greedy, or fed ``teacher[i]`` at step ``i``.  Returns the tokens
    (B, steps + 1), the steps' logits (steps, B, V) fp32 and the
    seconds (a device synchronise at each end)."""
    device = first.device
    tok, logits, tokens = first, [], [first]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        feed = tok if teacher is None else teacher[i]
        lg, caches = M.decode_step(
            cfg, params, caches, feed[:, None],
            torch.full((first.shape[0],), plen + i, device=device),
            seq_shard_axis=axis, cache_total=totals, tp=tp)
        logits.append(lg[:, 0].float())
        tok = lg[:, -1].argmax(-1)
        tokens.append(tok)
    _sync(device)
    seconds = time.perf_counter() - t0
    return (torch.stack(tokens, 1),
            torch.stack(logits) if logits else None, seconds)


def _delta(comm, calls0: Dict[str, int], counter: str = "calls"
           ) -> Dict[str, int]:
    """The change of a Comm's ``calls`` (or ``bytes``) since ``calls0``."""
    now = getattr(comm, counter)
    return {k: now[k] - calls0[k] for k in calls0}


@torch.inference_mode()
def rank_serve(ctx: RankContext, cfg: ArchConfig, seed: int,
               prompts: np.ndarray, gen: int, check: bool) -> Payload:
    """One rank of :func:`serve_sharded`, the counterpart of the
    reference's ``build_prefill`` and ``build_decode``: the rank's weights
    (:func:`rank_params`: drawn whole from ``seed``, its shard kept), its
    empty cache shards (:func:`rank_caches`), the tensor-parallel prefill
    of its rows (:func:`batch_rows`), then ``gen - 1`` greedy decode steps
    of them, attention merged across the ranks that split the sequence
    (``models.model.prefill`` / ``decode_step`` with a
    :class:`TensorAxis`).  Its weights and caches at rest are the
    dry-run's per-rank bytes (``meta``'s ``weight_bytes``,
    ``cache_bytes``); ``routes`` holds the experts each decode step's
    MoE layers chose (:func:`_routes`).

    With ``check``, the split is then held against the unsharded path on
    rank 0 (:func:`_check_split`): the prefill in the model's dtype, the
    decode in fp32."""
    from repro_torch.core.engine.multiproc import kernel_launches
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    device = ctx.device
    mesh = ctx.mesh
    bsz, plen = prompts.shape
    max_len = plen + gen
    rows = batch_rows(mesh, ctx.rank, bsz)
    axis = dataclasses.replace(seq_shard_axis(ctx, bsz),
                               comm=ctx.comm.scope())
    tp = tensor_axis(ctx, ctx.comm.scope())
    totals = cache_totals(cfg, bsz, max_len)
    params = rank_params(cfg, seed, mesh, ctx.rank, device)
    caches = rank_caches(cfg, mesh, bsz, max_len, device)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    meta: Dict[str, Any] = {
        "rank": ctx.rank, "index": axis.index, "tp_index": tp.index,
        "rows": (rows.start, rows.stop), "weight_bytes": _nbytes(params),
        "cache_bytes": _nbytes(caches),
        "kv_bytes": _nbytes(caches, ("k", "v", "pos"))}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = kernel_launches()
    heads0 = (dict(flash_ops.HEAD_LAUNCHES), dict(ssd_ops.HEAD_LAUNCHES))
    calls0, host0 = dict(tp.comm.calls), ctx.comm.host_bytes
    trace = [] if check else None
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, params, toks[rows], max_len, tp=tp,
                               seq_shard_axis=axis, caches=caches,
                               trace=trace)
    _sync(device)
    meta["prefill_s"] = time.perf_counter() - t0
    after = kernel_launches()
    meta["launches"] = {k: after[k] - before.get(k, 0) for k in after
                        if after[k] != before.get(k, 0)}
    # by head count: (query heads, KV heads) of flash, H of the SSD scan
    meta["launch_heads"] = {
        name: {str(k): n - old.get(k, 0) for k, n in ops.HEAD_LAUNCHES.items()
               if n != old.get(k, 0)}
        for name, ops, old in (("flash_attention", flash_ops, heads0[0]),
                               ("ssd_scan", ssd_ops, heads0[1]))}
    meta["prefill_collectives"] = _delta(tp.comm, calls0)
    meta["prefill_host_bytes"] = ctx.comm.host_bytes - host0
    first = logits[:, -1].argmax(-1)
    if check:
        kept = _check_inputs(ctx, cfg, caches, first, logits[:, -1], trace,
                             rows, bsz, max_len)
        del trace
    calls0, tp0 = dict(axis.comm.calls), dict(tp.comm.calls)
    bytes0 = (dict(axis.comm.bytes), dict(tp.comm.bytes))
    host0 = ctx.comm.host_bytes
    with recording_routes() as routes:
        tokens, logits, meta["decode_s"] = _greedy(
            cfg, params, caches, first, plen, gen - 1, axis, totals, tp=tp)
    meta["collectives"] = _delta(axis.comm, calls0)
    meta["tp_collectives"] = _delta(tp.comm, tp0)
    meta["collective_bytes"] = {
        k: _delta(axis.comm, bytes0[0], "bytes")[k] +
        _delta(tp.comm, bytes0[1], "bytes")[k] for k in bytes0[0]}
    meta["host_bytes"] = ctx.comm.host_bytes - host0
    out = {"tokens": tokens.cpu().numpy(), "logits": logits.cpu().numpy(),
           "routes": _routes(routes, gen - 1, first.shape[0])}
    del caches, logits
    meta["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if check:
        out.update(_check_split(ctx, cfg, seed, params, kept, toks, rows,
                                gen, axis, tp, totals, meta))
    del params
    if ctx.comm.staged:
        torch.cuda.empty_cache()
    return Payload(meta, out)


def _routes(log: list, steps: int, rows: int) -> np.ndarray:
    """The experts a greedy decode's MoE layers chose, from a
    ``recording_routes`` log of its ``steps`` steps over ``rows`` rows:
    (steps, MoE layers, rows, K), sorted along K (no layers without
    MoE)."""
    if not log:
        return np.zeros((steps, 0, rows, 0), dtype=np.int64)
    ids = torch.stack(log)                  # (steps * layers, 1, rows, K)
    return ids.reshape(steps, -1, rows, ids.shape[-1]).cpu().numpy()


def _cache_errs(got: Any, want: Any) -> Dict[str, float]:
    """Each leaf of cache tree ``got`` against the same leaf of ``want``,
    layer by layer along its leading dim: the worst layer's max|got -
    want| / max|want|; an integer leaf (``pos``) 0 where equal, else
    inf."""
    errs: Dict[str, float] = {}

    def one(path, t):
        w = want
        for name in path:
            w = w[int(name[1:-1])] if name.startswith("[") else w[name]
        key = ".".join(path)
        if not t.is_floating_point():
            errs[key] = 0.0 if torch.equal(t, w) else math.inf
            return
        errs[key] = max(_rel(t[i], w[i]) for i in range(t.shape[0]))

    _tree_map_with_path(one, got)
    return errs


def _check_inputs(ctx: RankContext, cfg: ArchConfig, caches, first, last,
                  trace, rows, batch: int, max_len: int):
    """What :func:`_check_split` starts from, taken before the decode
    writes into the caches: every row's first token (on every rank), and
    on rank 0 its prefill's last-position logits and trace (``prefill``'s
    ``trace``, its rows) and its rows of the whole prefilled caches
    (gathered from every rank's shards); the rank's shards in fp32."""
    world, _ = ctx.axis_group(all_axes(ctx.mesh))
    first_all = torch.full((batch,), -1, dtype=torch.long,
                           device=first.device)
    first_all[rows] = first
    ctx.comm.all_reduce(first_all, world, op="max")
    specs = cache_shardings(cfg, ctx.mesh, batch, max_len)
    whole = gather_tree(ctx, caches, specs)
    prefilled = None
    if ctx.rank == 0:
        data = set(data_axes(ctx.mesh))

        def data_only(axes):
            names = (axes,) if isinstance(axes, str) else tuple(axes or ())
            return axes if names and set(names) <= data else None
        prefilled = (last.float(), trace, _map2(
            lambda t, spec, _: _block(t, tuple(map(data_only, spec)),
                                      ctx.mesh, 0), whole, specs))
    return first_all, prefilled, whole if ctx.rank == 0 else None, \
        _fp32(caches)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max().clamp_min(1e-30))


def _check_split(ctx: RankContext, cfg: ArchConfig, seed: int, params,
                 kept, toks: torch.Tensor, rows: slice, gen: int,
                 axis: SeqShardAxis, tp: TensorAxis,
                 totals: Dict[str, int],
                 meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """:func:`rank_serve`'s check against the unsharded path, which rank 0
    runs on the whole weights (drawn again from ``seed``) while the
    others wait.

    The prefill, block by block in the model's dtype: rank 0 prefills its
    rows unsharded with each block fed the tensor-parallel prefill's
    input to it (``prefill``'s ``feed``), so bf16 rounding does not
    compound over the layers and the MoE router sees the same tokens;
    ``meta["prefill_check"]`` holds max|unsharded - split| / max|split|
    of the embedding's output (``embed``), of each block's output
    (``blocks``), of the last-position logits (``logits``) and, by
    :func:`_cache_errs`, of each leaf of the caches gathered from every
    rank's shards (``caches``).

    The decode, in fp32 (TF32 off), the port's rule for parity on the
    card, on fp32 copies of the weights and of the prefilled caches:
    rank 0 decodes the whole caches greedily (``whole_logits``,
    ``whole_tokens``, and ``whole_routes`` as :func:`_routes`), its
    tokens go to every rank, and each rank's tensor-parallel decode is
    teacher-forced on them (``check_logits``); then one step again from
    the prefilled state with every rank's partial sums of ``wo``,
    ``w_down``, the experts and ``out_proj`` skipped
    (``TensorAxis.drop_sums``, ``dropped_logits``), the logits a dropped
    shard gives."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        first, prefilled, whole, shard = kept
        mesh, device = ctx.mesh, ctx.device
        bsz, plen = toks.shape
        steps = gen - 1
        out = {}
        ref = torch.zeros((steps, bsz), dtype=torch.long, device=device)
        if ctx.rank == 0:
            last, trace, got = prefilled
            prefilled = None
            whole_params = _at_rest(cfg, M.init_params(
                cfg, torch.Generator(device).manual_seed(seed), device))
            mine = []
            lg, caches = M.prefill(
                cfg, whole_params, toks[batch_rows(mesh, 0, bsz)],
                plen + gen, trace=mine, feed=trace)
            meta["prefill_check"] = {
                "embed": _rel(mine[0], trace[0]),
                "blocks": [_rel(a, b) for a, b in zip(mine[1:], trace[1:])],
                "logits": _rel(lg[:, -1], last),
                "caches": _cache_errs(got, caches)}
            del caches, mine, trace, got
            whole_params = _fp32(whole_params)
            whole32, whole = _fp32(whole), None
            with recording_routes() as routes:
                tokens, logits, meta["whole_decode_s"] = _greedy(
                    cfg32, whole_params, whole32, first, plen, steps)
            del whole_params, whole32
            ref.copy_(tokens[:, :steps].t())
            out["whole_logits"] = logits.cpu().numpy()
            out["whole_tokens"] = tokens.cpu().numpy()
            out["whole_routes"] = _routes(routes, steps, bsz)
        del whole, prefilled
        world, _ = ctx.axis_group(all_axes(mesh))
        ctx.comm.all_reduce(ref, world)             # rank 0's tokens
        params32 = _fp32(params)
        prefilled = _fp32(shard)
        _, logits, meta["check_decode_s"] = _greedy(
            cfg32, params32, shard, first[rows], plen, steps, axis, totals,
            teacher=ref[:, rows], tp=tp)
        out["check_logits"] = logits.cpu().numpy()
        del shard
        dropped = dataclasses.replace(tp, drop_sums=True)
        _, logits, _ = _greedy(cfg32, params32, prefilled, first[rows],
                               plen, 1, axis, totals, tp=dropped)
        out["dropped_logits"] = logits[0].cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def serve_sharded(cfg: ArchConfig, prompts, gen: int, mesh: Mesh,
                  device: torch.device | str = "cuda", seed: int = 0,
                  check: bool = False,
                  world: Optional[World] = None) -> List[Payload]:
    """Greedy generation of ``gen`` tokens after ``prompts`` (B, S) under
    every serving rule: the weights tensor-parallel over the ``model``
    axis, the batch over the data axes where it divides, the KV caches'
    sequence split (over ``model``, else over every axis), on a world of
    ``mesh.size`` rank processes on ``device`` (cuda unless the caller
    asks for the CPU; ranks that share a card run gloo through pinned
    host copies): :func:`rank_serve` on every rank.  Returns each rank's
    :class:`Payload`: ``tokens`` (b, gen) of the rows ``meta["rows"]``
    (start, stop) of the batch it decoded (every row where the batch does
    not divide over the data axes), the decode's ``logits`` (gen - 1,
    b, V) in fp32 and the experts its MoE layers chose (``routes``, gen -
    1, layers, b, K); with ``check`` (:func:`_check_split`) the fp32
    ``check_logits`` (gen - 1, b, V) of its sharded decode and its first
    step's ``dropped_logits`` (b, V) with the partial sums skipped, and,
    on rank 0, the ``whole_logits`` (gen - 1, B, V), ``whole_tokens`` (B,
    gen) and ``whole_routes`` of the unsharded decode it was
    teacher-forced against and ``meta["prefill_check"]``, its prefill's
    block-by-block comparison; in ``meta`` the
    prefill and decode seconds, the prefill's kernel launches, the bytes
    of the rank's weights, caches and KV caches, the decode's collectives
    of the attention merge (``collectives``) and of the tensor-parallel
    layers (``tp_collectives``) and its host copy bytes, the prefill's,
    the world's start seconds.  A running ``world`` (of ``mesh``, on
    ``device``) serves in place of a new one, and stays open."""
    prompts = np.asarray(prompts, dtype=np.int64)
    if world is not None:
        if world.mesh != mesh:
            raise ValueError(f"world of {world.mesh}, serving on {mesh}")
        return world.call(rank_serve, (cfg, seed, prompts, gen, check))
    t0 = time.perf_counter()
    with World(mesh, device) as world:
        start_s = time.perf_counter() - t0
        out = world.call(rank_serve, (cfg, seed, prompts, gen, check))
    for p in out:
        p.meta["world_start_s"] = start_s
    return out


def main(argv=None) -> List[Payload]:
    """Tensor-parallel greedy serving from the command line: prints each
    rank's prefill and decode seconds, bytes and collectives and the
    tokens; with ``--check``, how far the sharded logits are from the
    unsharded ones."""
    import argparse
    from repro_torch.configs.base import get_arch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--mesh", default="1,2",
                    help="data,model: the ranks; the weights over 'model', "
                    "the batch over 'data' where it divides, the sequence "
                    "over 'model' (else over both)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    M.resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_test_mesh(*(int(x) for x in args.mesh.split(",")))
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    out = serve_sharded(cfg, prompts, args.gen, mesh, args.device,
                        args.seed, check=args.check)
    tokens = np.zeros((args.batch, args.gen), dtype=np.int64)
    for p in out:
        m = p.meta
        rows = slice(*m["rows"])
        tokens[rows] = p.arrays["tokens"]
        line = (f"rank {m['rank']} (rows {m['rows']}, model {m['tp_index']}"
                f", slots {m['index']}): prefill {m['prefill_s']:.3f}s, "
                f"decode {m['decode_s']:.3f}s, weights {m['weight_bytes']} "
                f"B, caches {m['cache_bytes']} B, collectives "
                f"{m['tp_collectives']} + merge {m['collectives']}")
        if args.check:
            err = np.abs(p.arrays["check_logits"] -
                         out[0].arrays["whole_logits"][:, rows]).max()
            line += f", max |sharded - unsharded| logits {err:.3g}"
        print(line)
    if args.check:
        pre = out[0].meta["prefill_check"]
        print(f"rank 0's prefill against the unsharded one, block by block "
              f"(max|diff| / max): embedding {pre['embed']:.3g}, blocks "
              f"{max(pre['blocks']):.3g}, logits {pre['logits']:.3g}, "
              f"caches {pre['caches']}")
    print("tokens:", tokens.tolist())
    return out


if __name__ == "__main__":
    main()
