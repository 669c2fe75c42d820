"""Adam on flat fp32 state shards (paper Sec. 1.1: 16 bytes of training
state per param — 4 param + 4 grad + 8 moments, all fp32).

The port of ``repro.optim.adam``.  Under ZeRO-3 each rank updates its own
shard; the update is element-wise, so sharded and unsharded execution give
the same numbers.  Each element goes through the reference's arithmetic in
its order, every product and sum rounded to fp32 as there.  Unlike the
reference, which returns new arrays, :func:`adam_update` updates the
shard's tensors in place: at full width a second copy of p, m and v
would not fit beside the rest of the training state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0      # 0 = off; global-norm clipping


def adam_init(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero first and second moments for the fp32 shard ``p``."""
    return (torch.zeros_like(p, dtype=torch.float32),
            torch.zeros_like(p, dtype=torch.float32))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32, summed in the
    order given."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        precomputed_norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """Clip; under ZeRO-3 pass the global norm over all ranks as
    ``precomputed_norm`` (one shard sees only its slice)."""
    norm = precomputed_norm if precomputed_norm is not None \
        else global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.device) for g in grads]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def adam_update(cfg: AdamConfig, p: torch.Tensor, g: torch.Tensor,
                m: torch.Tensor, v: torch.Tensor, step: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on fp32 tensors of one shape.  ``step`` is 1-based.
    Updates ``p``, ``m`` and ``v`` in place and returns them."""
    t = _f32(float(step))
    # fp32, as the reference's b ** t with t an fp32 array
    bc1 = float(_f32(1.0) - _f32(cfg.b1) ** t)
    bc2 = float(_f32(1.0) - _f32(cfg.b2) ** t)
    g = g.float()
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
    delta = m / bc1
    delta.div_(torch.sqrt(v / bc2).add_(cfg.eps))
    if cfg.weight_decay:
        delta.add_(cfg.weight_decay * p)
    p.sub_(delta.mul_(cfg.lr))
    return p, m, v


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr``, then a cosine decay to 0 at
    ``total``."""
    def lr(step: int) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * prog))
    return lr
