"""The plain reference of a training step, followed from the same weights
and token blocks as the program's first steps.

Each step takes the mean cross-entropy over every row of the block, in
blocks of rows whose gradients add up, then one Adam update.  It reads
what the program's readings are compared with: each step's loss, each
leaf's gradient norm at the first step, and each leaf's change after the
last step.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench import leaves as LV
from perfbench.reference import common as C
from perfbench.weights import Weights


def family(config: Dict[str, Any]):
    """The reference module of the configuration's family."""
    return importlib.import_module(f"perfbench.reference.{config['family']}")


def model_of(config: Dict[str, Any]) -> Dict[str, Any]:
    """The model's sizes, with the constants the port fixes in its code
    (``fixed``) beside them."""
    return {**config["model"], **config.get("fixed", {})}


def weights(config: Dict[str, Any], seed: int,
            device: torch.device | str) -> Weights:
    return Weights(family(config).param_specs(config["model"]), seed, device)


def add_grads(config: Dict[str, Any], params: Dict[str, Any],
              block: torch.Tensor, rows: Sequence[int], weight: float,
              precision: str, tokens_per_block: int) -> float:
    """Add to each parameter's ``.grad`` the gradient of ``weight`` times
    the summed cross-entropy over ``rows`` of ``block`` (rows of
    ``seq + 1`` tokens); returns that loss."""
    fam, model = family(config), model_of(config)
    seq = block.shape[1] - 1
    per = max(1, tokens_per_block // seq)
    rows = list(rows)
    total = 0.0
    for lo in range(0, len(rows), per):
        idx = torch.tensor(rows[lo:lo + per], device=block.device)
        part = block[idx]
        loss = fam.loss_sum(params, part[:, :-1], part[:, 1:], model,
                            precision) * weight
        loss.backward()
        total += float(loss.detach())
    return total


def follow(config: Dict[str, Any], seed: int, blocks: List[np.ndarray],
           precision: str, device: torch.device | str,
           tokens_per_block: int,
           first_step: Optional[Callable[[Dict[str, Any], torch.Tensor],
                                         None]] = None,
           state: str = "float32") -> Dict[str, Any]:
    """``len(blocks)`` steps from the weights of ``seed``.  Returns
    ``{"losses", "grad_norms", "change_norms"}``.  ``first_step(params,
    block)``, where given, runs before the first update with the first
    step's gradients in place (the control reads its faults there).
    ``state`` is the dtype the weights and Adam's moments are kept in,
    from the start: the reference keeps float32."""
    C.strict_float32()
    w = weights(config, seed, device)
    params = w.tree()
    kept = getattr(torch, state)
    for _, t in LV.walk(params):
        C.keep_as(t, kept)
    leaves = [t.requires_grad_() for _, t in LV.walk(params)]
    adam = C.Adam(**config["optimizer"], state=kept)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for k, big in enumerate(blocks):
        block = torch.from_numpy(np.asarray(big, dtype=np.int64)).to(device)
        rows, seq = block.shape[0], block.shape[1] - 1
        losses.append(add_grads(config, params, block, range(rows),
                                1.0 / (rows * seq), precision,
                                tokens_per_block))
        if k == 0:
            grad_norms = LV.leaf_norms(params, lambda _, t: t.grad)
            if first_step is not None:
                first_step(params, block)
        adam.step(leaves)
        for t in leaves:
            t.grad = None
    with torch.no_grad():
        change = LV.leaf_norms(params, lambda p, t: t - w.tensor(p))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
