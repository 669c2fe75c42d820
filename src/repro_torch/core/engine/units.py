"""UnitPlanner — the param→unit grouping and layout builder.

The port of ``repro.core.engine.units``.  An FSDP *unit* is the
granularity of Cephalo's gather/compute/scatter cycle: one transformer
stage element (stacked over the stage's count), or the embed / head /
misc param families, or the zamba2 hybrid's shared block.  The grouping is a function of the architecture's
param tree alone, so it is computed once from shapes: the tree of
``init_params`` on the meta device, where the reference uses
``jax.eval_shape``; nothing is allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fsdp
from repro_torch.models import model as M


@dataclasses.dataclass
class UnitGroup:
    """One FSDP unit family: 'embed' / 'head' / 'misc' / 'shared' /
    'stage<i>' (the latter stacked over the stage's element count)."""

    name: str
    layout: fsdp.UnitLayout
    count: int = 1               # >1 → stacked stage unit
    stage_idx: int = -1          # index into build_stages(cfg)


def split_params(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Regroup a model param tree into unit trees."""
    groups: Dict[str, Any] = {"embed": {"embed": params["embed"]}}
    if "head" in params:
        groups["head"] = {"head": params["head"]}
    misc = {"final_norm": params["final_norm"]}
    for k in ("pos_embed", "frontend_proj"):
        if k in params:
            misc[k] = params[k]
    groups["misc"] = misc
    if "shared" in params:
        groups["shared"] = params["shared"]
    for i, sp in enumerate(params["stages"]):
        groups[f"stage{i}"] = sp
    return groups


def merge_params(grouped: Dict[str, Any], n_stages: int) -> Dict[str, Any]:
    """Inverse of :func:`split_params`: unit trees → model param tree."""
    params: Dict[str, Any] = {
        "embed": grouped["embed"]["embed"],
        "final_norm": grouped["misc"]["final_norm"],
    }
    for k in ("pos_embed", "frontend_proj"):
        if k in grouped["misc"]:
            params[k] = grouped["misc"][k]
    if "head" in grouped:
        params["head"] = grouped["head"]["head"]
    if "shared" in grouped:
        params["shared"] = grouped["shared"]
    params["stages"] = [grouped[f"stage{i}"] for i in range(n_stages)]
    return params


def element_tree(stacked: Any) -> Any:
    """First element of a stacked stage tree (shapes without leading dim)."""
    return M.layer(stacked, 0)


class UnitPlanner:
    """Unit grouping + flat layouts for one ``(cfg, ratios)`` pair.

    ``ratios`` are the planner's per-rank state fractions ``r_i``; layouts
    quantize them to 128-element shard sizes (:mod:`repro_torch.core.fsdp`).
    """

    def __init__(self, cfg: ArchConfig, ratios: Sequence[float]):
        self.cfg = cfg
        self.ratios = [float(r) for r in ratios]
        self.n = len(self.ratios)
        self.stages = M.build_stages(cfg)
        shapes = M.init_params(cfg, torch.Generator(), device="meta",
                               all_fp32=True)
        grouped = split_params(cfg, shapes)
        self.groups: List[UnitGroup] = []
        for name, tree in grouped.items():
            if name.startswith("stage"):
                idx = int(name[len("stage"):])
                layout = fsdp.make_layout(name, element_tree(tree),
                                          self.ratios)
                self.groups.append(UnitGroup(
                    name, layout, count=self.stages[idx].count,
                    stage_idx=idx))
            else:
                self.groups.append(UnitGroup(
                    name, fsdp.make_layout(name, tree, self.ratios)))

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def group(self, name: str) -> UnitGroup:
        """The unit group named ``name``; raises ``KeyError``."""
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def has_group(self, name: str) -> bool:
        return any(g.name == name for g in self.groups)

    def split(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return split_params(self.cfg, params)

    def merge(self, grouped: Dict[str, Any]) -> Dict[str, Any]:
        return merge_params(grouped, self.n_stages)


def normalized_ratios(ratios: Sequence[float]) -> np.ndarray:
    """Guard against all-zero ratio degeneracies (tiny test plans)."""
    r = np.asarray(ratios, dtype=np.float64)
    if r.sum() <= 0:
        r = np.ones(len(r)) / max(len(r), 1)
    return r
