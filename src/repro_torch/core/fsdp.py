"""Uneven FSDP/ZeRO-3 state sharding on flat per-unit buffers.

The port of ``repro.core.fsdp``.  Every FSDP *unit* (one transformer
block, or the embed / head / misc params) is flattened into one fp32
vector, padded to a 128-element quantum, and split into per-rank shards
sized by the planner's ratios ``r_i`` (``even_shard_sizes``).  The MPMD
runtime keeps each rank's exact slice (:func:`shard_unit_ragged`):
physical memory per rank is ∝ r_i.  The SPMD runtime keeps a ``(P_max,)``
padded shard on every rank (:func:`shard_unit`, the reference's wire
format), and its collectives run on ``torch.distributed`` process groups
where the reference names ``shard_map`` axes: :func:`gather_unit` is one
AllGather, :func:`scatter_grad` one ReduceScatter, and
:func:`make_mixed_gather` ties them into one differentiable gather whose
backward is the ReduceScatter (plus the HSDP replica all-reduce).  Each
collective goes through a :class:`~repro_torch.core.engine.world.Comm`,
which stages it through pinned host memory where ranks share a card.

Leaves are ordered as ``jax.tree.flatten`` orders them (dict keys sorted,
list entries by index), so shard boundaries and flat buffers equal the
JAX package's element by element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.partition import even_shard_sizes

QUANTUM = 128


# ---------------------------------------------------------------------------
# Trees of dicts and lists, in jax.tree.flatten's order
# ---------------------------------------------------------------------------

def _flatten(t: Any, leaves: List[Any]) -> Any:
    if isinstance(t, dict):
        return {k: _flatten(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [_flatten(v, leaves) for v in t]
    leaves.append(t)
    return None


def _build(d: Any, it) -> Any:
    if isinstance(d, dict):
        return {k: _build(d[k], it) for k in sorted(d)}
    if isinstance(d, list):
        return [_build(v, it) for v in d]
    return next(it)


# The walks are module functions, not closures that call themselves: a
# closure that refers to itself is a reference cycle, which keeps every
# leaf it captured (a step's gradients, a gathered params tree) alive
# until Python's cyclic collector happens to run.


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef): dict keys sorted, list entries by index.  The
    treedef is the tree's skeleton (None at every leaf)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


# ---------------------------------------------------------------------------
# Flat layout of one unit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnitLayout:
    """Static description of one unit's flattened parameter buffer."""

    name: str
    treedef: Any
    shapes: List[Tuple[int, ...]]
    size: int                    # true element count
    padded: int                  # padded to Σ shard_sizes
    shard_sizes: List[int]       # per-rank valid lengths (sum == padded)

    @property
    def p_max(self) -> int:
        return max(self.shard_sizes)

    @property
    def even(self) -> bool:
        return len(set(self.shard_sizes)) == 1

    @property
    def n(self) -> int:
        return len(self.shard_sizes)

    def offsets(self) -> List[int]:
        out, off = [], 0
        for s in self.shard_sizes:
            out.append(off)
            off += s
        return out


def make_layout(name: str, tree: Any, ratios: Sequence[float]) -> UnitLayout:
    """Layout of ``tree`` (any leaves with a ``shape``: meta tensors do)."""
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(x.shape) for x in leaves]
    size = sum(math.prod(s) for s in shapes)
    n = len(ratios)
    padded = ((size + n * QUANTUM - 1) // (n * QUANTUM)) * (n * QUANTUM)
    shard_sizes = even_shard_sizes(padded, ratios, quantum=QUANTUM)
    return UnitLayout(name, treedef, shapes, size, padded, shard_sizes)


def flatten_unit(layout: UnitLayout, tree: Any,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unit's leaves as one fp32 buffer ``(..., padded)``, zeros past
    ``size``.  Leaves may carry leading dims before the layout's shapes
    (a stacked stage: ``(count, padded)``).  Writes into ``out`` where
    given (it must hold zeros past ``size``), else into a new buffer on
    the first leaf's device."""
    leaves, _ = tree_flatten(tree)
    lead = tuple(leaves[0].shape[:leaves[0].dim() - len(layout.shapes[0])])
    if out is None:
        out = torch.zeros(lead + (layout.padded,), dtype=torch.float32,
                          device=leaves[0].device)
    off = 0
    for x, shape in zip(leaves, layout.shapes):
        n = math.prod(shape)
        out[..., off: off + n].copy_(x.reshape(lead + (n,)))
        off += n
    return out


def unflatten_unit(layout: UnitLayout, flat: torch.Tensor) -> Any:
    """``(..., padded)`` buffer → the unit's tree, its leaves views of
    ``flat`` (no copy).  One ``split``, so that the gradient of a
    differentiable ``flat`` is one concatenation of the leaves' gradients
    (a slice per leaf would fill and add a ``flat``-sized buffer each)."""
    lead = tuple(flat.shape[:-1])
    sizes = [math.prod(shape) for shape in layout.shapes]
    pieces = flat.split(sizes + [layout.padded - layout.size], dim=-1)
    leaves = [p.view(lead + shape) for p, shape in zip(pieces, layout.shapes)]
    return tree_unflatten(layout.treedef, leaves)


def shard_unit_ragged(layout: UnitLayout,
                      flat: torch.Tensor) -> List[torch.Tensor]:
    """``(..., padded)`` → each rank's exact slice, a contiguous copy with
    *no padding*: the MPMD storage format, physical memory per rank ∝ r_i
    (the paper's memory-balancing claim)."""
    out, off = [], 0
    for s in layout.shard_sizes:
        out.append(flat[..., off: off + s].clone())
        off += s
    return out


def padded_shard(layout: UnitLayout, flat: torch.Tensor,
                 i: int) -> torch.Tensor:
    """Rank ``i``'s slice of ``(..., padded)`` as a ``(..., P_max)``
    buffer, zeros past its valid length: the SPMD wire format."""
    off, s = layout.offsets()[i], layout.shard_sizes[i]
    out = flat.new_zeros(tuple(flat.shape[:-1]) + (layout.p_max,))
    out[..., :s].copy_(flat[..., off: off + s])
    return out


def shard_unit(layout: UnitLayout, flat: torch.Tensor) -> List[torch.Tensor]:
    """``(..., padded)`` → every rank's ``(..., P_max)`` padded shard (the
    SPMD wire format: every rank holds a buffer of one size)."""
    return [padded_shard(layout, flat, i) for i in range(layout.n)]


def unshard(layout: UnitLayout, stacked: torch.Tensor) -> torch.Tensor:
    """``(..., N, P_max)`` padded shards of every rank → ``(..., padded)``.
    Even shards take the fast path (a reshape); uneven ones pay the
    concatenation of the valid slices."""
    lead = tuple(stacked.shape[:-2])
    if layout.even:
        return stacked.reshape(lead + (-1,))[..., : layout.padded]
    return torch.cat([stacked[..., i, : s]
                      for i, s in enumerate(layout.shard_sizes)], dim=-1)


# ---------------------------------------------------------------------------
# Collectives (every rank of ``group`` calls them in the same order)
# ---------------------------------------------------------------------------

def gather_unit(layout: UnitLayout, shard: torch.Tensor, group,
                comm) -> torch.Tensor:
    """``(..., P_max)`` local shard → ``(..., padded)`` full flat buffer:
    one AllGather of ``(N, ..., P_max)``, then :func:`unshard`."""
    stacked = shard.new_empty((layout.n,) + tuple(shard.shape))
    comm.all_gather(stacked, shard.contiguous(), group)
    return unshard(layout, stacked.movedim(0, -2))


def scatter_grad(layout: UnitLayout, grad_flat: torch.Tensor, group,
                 comm) -> torch.Tensor:
    """``(padded,)`` full grad → ``(P_max,)`` local shard summed over
    ``group``: one ReduceScatter of the padded rows ``(N, P_max)`` (even
    shards are those rows already)."""
    if layout.even:
        rows = grad_flat.reshape(layout.n, layout.p_max)
    else:
        rows = grad_flat.new_zeros((layout.n, layout.p_max))
        for i, off in enumerate(layout.offsets()):
            s = layout.shard_sizes[i]
            rows[i, :s] = grad_flat[off: off + s]
    out = grad_flat.new_empty((layout.p_max,))
    comm.reduce_scatter(out, rows.contiguous(), group)
    return out


class _MixedGather(torch.autograd.Function):
    """Forward: AllGather in ``fwd_dtype``.  Backward: ReduceScatter of
    the cotangent in ``bwd_dtype``, the replica all-reduce (HSDP), then
    fp32.  ``spec`` is the :class:`MixedGather` that holds the layout,
    the groups and the counters."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, spec: "MixedGather"):
        ctx.spec = spec
        spec.stats["all_gather"] += 1
        return gather_unit(spec.layout, shard.to(spec.fwd_dtype),
                           spec.group, spec.comm)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        spec = ctx.spec
        spec.stats["reduce_scatter"] += 1
        g = scatter_grad(spec.layout, ct.to(spec.bwd_dtype), spec.group,
                         spec.comm)
        if spec.replica_group is not None:
            spec.stats["all_reduce"] += 1
            spec.comm.all_reduce(g, spec.replica_group)
        return g.float(), None


@dataclasses.dataclass(eq=False)
class MixedGather:
    """A unit's differentiable gather with independent forward/backward
    precision: ``fwd_dtype`` (bf16 halves the AllGather's bytes) and
    ``bwd_dtype`` (fp32 keeps the paper's full-precision gradient
    averaging even with bf16 gathers).  The fp32 master shard never
    leaves its rank.  ``replica_group`` — HSDP: the state is sharded over
    ``group`` only and replicated over this group, whose all-reduce of
    the scattered gradient rides on the backward.  ``stats`` counts each
    collective as it runs."""

    layout: UnitLayout
    group: Any
    comm: Any
    fwd_dtype: torch.dtype
    bwd_dtype: torch.dtype
    replica_group: Any = None
    stats: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "all_gather": 0, "reduce_scatter": 0, "all_reduce": 0})

    def __call__(self, shard: torch.Tensor) -> torch.Tensor:
        return _MixedGather.apply(shard, self)


def make_mixed_gather(layout: UnitLayout, group, comm, fwd_dtype,
                      bwd_dtype, replica_group=None,
                      stats: Optional[Dict[str, int]] = None) -> MixedGather:
    """The reference's ``make_mixed_gather`` on process groups: a callable
    ``(P_max,)`` shard → ``(padded,)`` flat in ``fwd_dtype``, whose
    backward is one ReduceScatter (see :class:`MixedGather`).  ``stats``
    is the counter dict to add to (a substrate's), else its own."""
    spec = MixedGather(layout, group, comm, fwd_dtype, bwd_dtype,
                       replica_group)
    if stats is not None:
        spec.stats = stats
    return spec


# ---------------------------------------------------------------------------
# Vocab-sharded embedding / head (embeddings are too large to gather)
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over ``group``; its backward is the sum of the
    cotangents over ``group``, as JAX transposes ``psum`` inside
    ``shard_map``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, comm):
        ctx.group, ctx.comm = group, comm
        out = x.clone()
        comm.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        g = ct.clone()
        ctx.comm.all_reduce(g, ctx.group)
        return g, None, None


def psum(x: torch.Tensor, group, comm) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (see
    :class:`_AllReduceSum`)."""
    return _AllReduceSum.apply(x, group, comm)


def embed_rows_for_rank(vocab: int, n: int) -> List[Tuple[int, int]]:
    """Row ranges of the vocab-sharded embedding table."""
    per = (vocab + n - 1) // n
    return [(i * per, min((i + 1) * per, vocab)) for i in range(n)]


def sharded_embed_lookup(embed_shard: torch.Tensor, tokens: torch.Tensor,
                         v_start: int, group, comm) -> torch.Tensor:
    """Embedding lookup with a row-sharded table: ``embed_shard`` (V_loc,
    D) holds rows [v_start, v_start + V_loc).  A local masked gather, then
    a sum over ``group``."""
    v_loc = embed_shard.shape[0]
    local = tokens - v_start
    valid = (local >= 0) & (local < v_loc)
    idx = torch.clamp(local, 0, v_loc - 1)
    x = embed_shard[idx] * valid[..., None].to(embed_shard.dtype)
    return psum(x, group, comm)


def sharded_ce(h: torch.Tensor, embed_shard: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor, v_start: int,
               group, comm, final_softcap: float = 0.0) -> torch.Tensor:
    """Σ w·CE with a row-sharded (tied) unembedding.  h: (..., D);
    embed_shard: (V_loc, D).  Per-shard logits → the global logsumexp by
    a max over ``group`` and a sum of exps; the picked logit by a masked
    sum.  The max carries no gradient: the logsumexp does not depend on
    it (the reference's ``pmax`` has no differentiation rule)."""
    z = h.float() @ embed_shard.float().T                  # (..., V_loc)
    if final_softcap > 0:
        z = final_softcap * torch.tanh(z / final_softcap)
    m_glob = z.detach().amax(dim=-1)
    comm.all_reduce(m_glob, group, op="max")
    sumexp = torch.sum(torch.exp(z - m_glob[..., None]), dim=-1)
    lse = m_glob + torch.log(psum(sumexp, group, comm))
    local = labels - v_start
    v_loc = embed_shard.shape[0]
    valid = (local >= 0) & (local < v_loc)
    idx = torch.clamp(local, 0, v_loc - 1)
    picked = torch.gather(z, -1, idx[..., None])[..., 0]
    picked = psum(picked * valid.float(), group, comm)
    return torch.sum(weights * (lse - picked))
