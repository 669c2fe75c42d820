"""Uneven FSDP/ZeRO-3 state sharding on flat per-unit buffers.

The port of the layout half of ``repro.core.fsdp``.  Every FSDP *unit*
(one transformer block, or the embed / head / misc params) is flattened
into one fp32 vector, padded to a 128-element quantum, and split into
per-rank shards sized by the planner's ratios ``r_i``
(``even_shard_sizes``).  The MPMD runtime keeps each rank's exact slice
(:func:`shard_unit_ragged`): physical memory per rank is ∝ r_i.

Leaves are ordered as ``jax.tree.flatten`` orders them (dict keys sorted,
list entries by index), so shard boundaries and flat buffers equal the
JAX package's element by element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

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
    ``flat`` (no copy)."""
    lead = tuple(flat.shape[:-1])
    leaves, off = [], 0
    for shape in layout.shapes:
        n = math.prod(shape)
        leaves.append(flat[..., off: off + n].view(lead + shape))
        off += n
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
