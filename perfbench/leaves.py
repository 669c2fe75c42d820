"""Parameter trees as the port lays them out, and their leaves one layer
at a time.

A tree is nested dicts and lists of tensors: ``embed``, ``head``,
``final_norm``, and ``stages``, a list of stages whose tensors are
stacked over the stage's layers on their first dimension.  A *leaf* is
one layer's slice of one tensor (or a whole tensor outside the stages),
named by its path and layer: ``stages.0.attn.wq.3``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

Path = Tuple[str, ...]


def walk(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """Every tensor of ``tree`` with its path, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    else:
        yield path, tree


def get(tree: Any, path: Path) -> Any:
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stage's stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def put(tree: Dict[str, Any], path: Path, value: Any) -> None:
    """Set ``value`` at ``path``, making dicts (and the ``stages`` list)
    on the way."""
    node: Any = tree
    for i, k in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            k = int(k)
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if nxt.isdigit() else {})
    node[path[-1]] = value


def stacked(path: Path) -> bool:
    """Whether the tensor at ``path`` is stacked over layers."""
    return bool(path) and path[0] == "stages"


def leaf_norms(tree: Any, fn: Callable[[Path, torch.Tensor], torch.Tensor]
               = lambda _, t: t) -> Dict[str, float]:
    """``{leaf: 2-norm}`` of ``fn(path, tensor)`` over every tensor of
    ``tree``, a stacked tensor split into its layers; each norm in
    float64."""
    out: Dict[str, float] = {}
    for path, t in walk(tree):
        x = fn(path, t)
        name = ".".join(path)
        if stacked(path):
            norms = torch.linalg.vector_norm(
                x.reshape(x.shape[0], -1), dim=1, dtype=torch.float64)
            for i, n in enumerate(norms.tolist()):
                out[f"{name}.{i}"] = n
        else:
            out[name] = float(torch.linalg.vector_norm(
                x, dtype=torch.float64))
    return out


def median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
