"""The weights of a run, made on the device from ``--seed``.

Each tensor of the tree is drawn in one call (a stage's layers at once)
by a ``torch.Generator`` on the device, in float32, the type the training
state keeps.  The generator's state before each tensor is kept, so any
tensor can be drawn again alone: the reference and the check of the
parameters' change read the starting weights that way, after the
program's state is freed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from perfbench import leaves as LV

#: (path, shape, init): init is ("normal", std), ("trunc", std) (cut at
#: two std), ("uniform", lo, hi), ("log_linspace", lo, hi) (the log of
#: points evenly spaced over the last dimension), ("zeros",) or ("ones",)
Spec = Tuple[LV.Path, Tuple[int, ...], tuple]

#: seeds are whole numbers of any size; the generators take 63 bits
SEED_BITS = 63


def seed63(seed: int) -> int:
    return int(seed) % (1 << SEED_BITS)


def fan_in_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


def _draw(shape: Sequence[int], init: tuple, gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
    kind = init[0]
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "log_linspace":
        line = torch.log(torch.linspace(init[1], init[2], shape[-1],
                                        dtype=torch.float32, device=device))
        return line.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "normal":
        return out.normal_(0.0, init[1], generator=gen)
    if kind == "trunc":
        std = init[1]
        return torch.nn.init.trunc_normal_(out, std=std, a=-2.0 * std,
                                           b=2.0 * std, generator=gen)
    if kind == "uniform":
        return out.uniform_(init[1], init[2], generator=gen)
    raise ValueError(f"unknown init {init!r}")


class Weights:
    """The tree of ``specs`` drawn from ``seed`` on ``device``."""

    def __init__(self, specs: List[Spec], seed: int,
                 device: torch.device | str):
        self.specs = specs
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(seed63(seed))
        self._states: List[torch.Tensor] = []

    def tree(self) -> Dict[str, Any]:
        """Every tensor, drawn in order."""
        self._states = []
        out: Dict[str, Any] = {}
        for path, shape, init in self.specs:
            self._states.append(self.gen.get_state())
            LV.put(out, path, _draw(shape, init, self.gen, self.device))
        return out

    def tensor(self, path: LV.Path) -> torch.Tensor:
        """The tensor at ``path`` drawn again, as :meth:`tree` drew it."""
        if not self._states:
            raise RuntimeError("draw the tree first")
        for (p, shape, init), state in zip(self.specs, self._states):
            if p == tuple(path):
                gen = torch.Generator(self.device)
                gen.set_state(state)
                return _draw(shape, init, gen, self.device)
        raise KeyError(path)
