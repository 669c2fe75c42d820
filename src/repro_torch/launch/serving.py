"""Serving rules: tensor-parallel weights and sequence-sharded caches.

The port of ``repro.launch.serving``'s rules.  Cephalo is a *training*
system; the serving shapes (prefill_32k, decode_32k, long_500k) use
standard inference sharding instead (DESIGN.md §5):

* weights resident, tensor-parallel over the ``model`` axis (heads / d_ff /
  experts), batch over the data axes — per-leaf rules in
  :func:`param_shardings`;
* KV caches sharded over batch (when it divides) and over *sequence* on
  the ``model`` axis;
* sub-axis-size dims are left replicated.

A rule is a :data:`~repro_torch.core.engine.world.ShardSpec` over a
:class:`~repro_torch.core.engine.world.Mesh`: for each dim the axes it is
split over, as the reference's ``PartitionSpec``.  The reference's
``build_prefill`` and ``build_decode`` return jitted functions to lower,
which an eager runtime has no analogue of; their memory half is the
dry-run's (``repro_torch.launch.dryrun``).  The tensor-parallel weight
split is not run: the rules are data for the dry-run.  What runs is the
sequence split of the caches: :func:`shard_cache` cuts a rank's slots out
of a prefilled cache and :func:`seq_shard_axis` joins the ranks that
split it, for ``models.model.decode_step``; :func:`serve_sharded` serves
that way on a world of rank processes.
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
from repro_torch.models.layers.attention import SeqShardAxis

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
    rows only: its rule splits its heads over 'model', for a
    tensor-parallel SSM block, which is not run; every rank of a sequence
    group steps its rows' whole state alike.
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
# Sequence-sharded serving on a world of ranks
# ---------------------------------------------------------------------------

def _kv_bytes(caches: List[Dict]) -> int:
    """Bytes of the KV leaves (``k``, ``v``, ``pos``) of a cache list."""
    total = 0

    def one(names, t):
        nonlocal total
        if names[-1] in ("k", "v", "pos"):
            total += t.numel() * t.element_size()

    _tree_map_with_path(one, caches)
    return total


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fp32(tree: Any) -> Any:
    """A copy of a tree with its floating leaves in fp32."""
    return _tree_map_with_path(
        lambda _, t: t.float() if t.is_floating_point() else t.clone(), tree)


def _greedy(cfg: ArchConfig, params, caches, first: torch.Tensor, plen: int,
            steps: int, axis: Optional[SeqShardAxis] = None,
            totals: Optional[Dict[str, int]] = None,
            teacher: Optional[torch.Tensor] = None):
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
            seq_shard_axis=axis, cache_total=totals)
        logits.append(lg[:, 0].float())
        tok = lg[:, -1].argmax(-1)
        tokens.append(tok)
    _sync(device)
    seconds = time.perf_counter() - t0
    return (torch.stack(tokens, 1),
            torch.stack(logits) if logits else None, seconds)


@torch.inference_mode()
def rank_serve(ctx: RankContext, cfg: ArchConfig, seed: int,
               prompts: np.ndarray, gen: int, check: bool) -> Payload:
    """One rank of :func:`serve_sharded`: the params drawn from ``seed`` on
    the rank's device (every rank draws the same), the full prefill, the
    rank's rows and slots of the caches (:func:`shard_cache`), then
    ``gen - 1`` greedy decode steps of its rows (:func:`batch_rows`)
    merging attention across the ranks that split the sequence.

    With ``check``, the split is then held against the whole cache in
    fp32 (TF32 off), the port's rule for parity on the card, on fp32
    copies of the weights and of the prefilled caches: rank 0 decodes
    greedily on the whole cache (the others wait), its tokens go to every
    rank, and each rank's sharded decode is teacher-forced on them.  In
    bf16 the two decodes may round one attention output apart, which a
    deep model of random weights carries to ~1% of its logits."""
    from repro_torch.core.engine.multiproc import kernel_launches
    device = ctx.device
    bsz, plen = prompts.shape
    max_len = plen + gen
    rows = batch_rows(ctx.mesh, ctx.rank, bsz)
    axis = seq_shard_axis(ctx, bsz)
    totals = cache_totals(cfg, bsz, max_len)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(seed),
                           device)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    before = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
    logits, full = M.prefill(cfg, params, toks, max_len=max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    after = kernel_launches()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    first = logits[:, -1].argmax(-1)
    caches = shard_cache(cfg, full, ctx.mesh, ctx.rank, bsz, max_len)
    meta: Dict[str, Any] = {"rank": ctx.rank, "index": axis.index,
                            "rows": (rows.start, rows.stop),
                            "prefill_s": prefill_s, "launches": launches,
                            "kv_bytes": _kv_bytes(caches)}
    if check:
        kept = (_fp32(full) if ctx.rank == 0 else None, _fp32(caches))
    del full
    calls0, host0 = dict(ctx.comm.calls), ctx.comm.host_bytes
    tokens, logits, meta["decode_s"] = _greedy(
        cfg, params, caches, first[rows], plen, gen - 1, axis, totals)
    meta["collectives"] = {k: ctx.comm.calls[k] - calls0[k]
                           for k in calls0}
    meta["host_bytes"] = ctx.comm.host_bytes - host0
    out = {"tokens": tokens.cpu().numpy(), "logits": logits.cpu().numpy()}
    del caches, logits
    if check:
        out.update(_check_split(ctx, cfg, params, kept, first, rows, plen,
                                gen, axis, totals, meta))
    meta["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del params
    if ctx.comm.staged:
        torch.cuda.empty_cache()
    return Payload(meta, out)


class _Alone:
    """A merge's comm with no other rank: each rank's partials stand as
    if the other shards were dropped."""

    def all_reduce(self, t: torch.Tensor, group, op: str = "sum") -> None:
        pass


def _check_split(ctx: RankContext, cfg: ArchConfig, params, kept, first,
                 rows: slice, plen: int, gen: int, axis: SeqShardAxis,
                 totals: Dict[str, int], meta: Dict[str, Any]
                 ) -> Dict[str, np.ndarray]:
    """:func:`rank_serve`'s check in fp32: ``check_logits`` of the sharded
    decode of the rank's ``rows``, on rank 0 ``whole_logits`` and
    ``whole_tokens`` of the whole one (every row; ``first`` is every
    row's first token), and ``dropped_logits``: the first step again,
    merged over this rank's shard alone, the logits a dropped shard gives
    (the scale a fault in the merge moves the logits by)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _fp32(params)
        whole, shard = kept
        steps = gen - 1
        ref = torch.zeros((steps, first.shape[0]), dtype=torch.long,
                          device=first.device)
        out = {}
        if ctx.rank == 0:
            tokens, logits, meta["whole_decode_s"] = _greedy(
                cfg32, params32, whole, first, plen, steps)
            ref.copy_(tokens[:, :steps].t())
            out["whole_logits"] = logits.cpu().numpy()
            out["whole_tokens"] = tokens.cpu().numpy()
        del whole
        world_group, _ = ctx.axis_group(all_axes(ctx.mesh))
        ctx.comm.all_reduce(ref, world_group)       # rank 0's tokens
        _, logits, meta["check_decode_s"] = _greedy(
            cfg32, params32, shard, first[rows], plen, steps, axis, totals,
            teacher=ref[:, rows])
        out["check_logits"] = logits.cpu().numpy()
        # slot plen is written again; the later steps' slots are masked
        alone = SeqShardAxis(axis.group, _Alone(), axis.index)
        _, logits, _ = _greedy(cfg32, params32, shard, first[rows], plen, 1,
                               alone, totals)
        out["dropped_logits"] = logits[0].cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def serve_sharded(cfg: ArchConfig, prompts, gen: int, mesh: Mesh,
                  device: torch.device | str = "cuda", seed: int = 0,
                  check: bool = False) -> List[Payload]:
    """Greedy generation of ``gen`` tokens after ``prompts`` (B, S) with
    the KV caches' sequence split over the ranks of ``mesh`` (a world of
    ``mesh.size`` rank processes on ``device``, cuda unless the caller
    asks for the CPU; ranks that share a card merge over gloo through
    pinned host copies): :func:`rank_serve` on every rank.  Returns each
    rank's :class:`Payload`: ``tokens`` (b, gen) of the rows
    ``meta["rows"]`` (start, stop) of the batch it decoded (every row
    where the batch does not divide over the data axes) and the decode's
    ``logits`` (gen - 1, b, V) in fp32; with ``check`` the fp32 ``check_logits`` (gen - 1, b, V) of its sharded decode and
    its first step's ``dropped_logits`` (b, V) on its shard alone, and,
    on rank 0, the ``whole_logits`` (gen - 1, B, V) and ``whole_tokens``
    (B, gen) of the unsharded decode it was teacher-forced against; in
    ``meta`` the prefill and
    decode seconds, the prefill's kernel launches, the KV shard's bytes,
    the decode's collectives and host copy bytes, the world's start
    seconds."""
    prompts = np.asarray(prompts, dtype=np.int64)
    t0 = time.perf_counter()
    with World(mesh, device) as world:
        start_s = time.perf_counter() - t0
        out = world.call(rank_serve, (cfg, seed, prompts, gen, check))
    for p in out:
        p.meta["world_start_s"] = start_s
    return out


def main(argv=None) -> List[Payload]:
    """Sequence-sharded greedy serving from the command line: prints each
    rank's prefill and decode seconds and the tokens; with ``--check``,
    how far the sharded logits are from the unsharded ones."""
    import argparse
    from repro_torch.configs.base import get_arch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--mesh", default="1,2",
                    help="data,model: the ranks; the batch over 'data' where "
                    "it divides, the sequence over 'model' (else over both)")
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
        line = (f"rank {m['rank']} (rows {m['rows']}, shard {m['index']}): "
                f"prefill {m['prefill_s']:.3f}s, decode "
                f"{m['decode_s']:.3f}s, KV shard {m['kv_bytes']} B, "
                f"collectives {m['collectives']}")
        if args.check:
            err = np.abs(p.arrays["check_logits"] -
                         out[0].arrays["whole_logits"][:, rows]).max()
            line += f", max |sharded - unsharded| logits {err:.3g}"
        print(line)
    print("tokens:", tokens.tolist())
    return out


if __name__ == "__main__":
    main()
