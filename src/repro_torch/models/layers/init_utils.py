"""Parameter initializers (fp32 values, drawn from a ``torch.Generator``).

Same distributions as ``repro.models.layers.init_utils``; the numbers
differ because the two packages' random generators differ, so a parity
test loads the JAX package's parameters through :mod:`repro_torch.convert`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               fan_in: int | None = None,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Truncated normal cut at ±2 std, std = 1/sqrt(fan_in)
    (fan_in = shape[-2])."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if out.is_meta:     # shapes only (a layout): nothing to draw
        return out
    # trunc_normal_'s bounds are absolute, not in units of std
    return torch.nn.init.trunc_normal_(out, std=std, a=-2.0 * std,
                                       b=2.0 * std, generator=generator)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Standard normal (std 1.0) embedding table."""
    out = torch.empty((vocab, d), dtype=torch.float32, device=device)
    if out.is_meta:     # shapes only (a layout): nothing to draw
        return out
    return torch.nn.init.normal_(out, std=1.0, generator=generator)
