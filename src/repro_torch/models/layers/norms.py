"""Normalization layers (functional: init -> params dict, apply).

Scales and biases are fp32 and the arithmetic is fp32, as in
``repro.models.layers.norms``.
"""

from __future__ import annotations

import torch


def rmsnorm_init(d: int, device: torch.device | str = "cuda") -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: scale parameterized as (1 + w), zero-init."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"])).to(x.dtype)


def layernorm_init(d: int, device: torch.device | str = "cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
