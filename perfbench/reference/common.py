"""What the families of the plain reference share: products in a run's
precision, RMSNorm, the cross-entropy sum and Adam.

The reference is plain PyTorch in float32 with TF32 off.  The control
(``precision="float8"``) is the same reference with the inputs of every
weight product rounded to float8 e4m3 under one scale a tensor, as a
float8 training step keeps them; the products still sum in float32.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

E4M3_MAX = 448.0
PRECISIONS = ("float32", "float8")


def strict_float32() -> None:
    """float32 products stay float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under the scale that maps its largest
    magnitude to e4m3's largest, and back in float32."""
    t = t.detach()
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str
           ) -> torch.Tensor:
    """``x @ w`` over the last dim of ``x``; in the control each input
    rounded to float8, with the gradient passed straight through the
    rounding (the product's own backward uses the rounded values)."""
    if precision == "float8":
        x = x + (fp8_round(x) - x).detach()
        w = w + (fp8_round(w) - w).detach()
    elif precision != "float32":
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return x @ w


def token_specs(model: Dict[str, Any], head_std: float) -> List[tuple]:
    """The embedding, the final norm and the output head: with
    ``tie_embeddings`` the head is the embedding's transpose, and the
    embedding is drawn at std 0.02; otherwise at std 1, beside a head of
    its own at ``head_std``."""
    d, V = model["d_model"], model["vocab_size"]
    tied = bool(model.get("tie_embeddings", False))
    out = [(("embed",), (V, d), ("normal", 0.02 if tied else 1.0)),
           (("final_norm", "scale"), (d,), ("zeros",))]
    if not tied:
        out.append((("head",), (d, V), ("trunc", head_std)))
    return out


def head(params: Dict[str, Any]) -> torch.Tensor:
    """The output head, (d_model, vocab): the embedding's transpose where
    the model ties them."""
    return params["head"] if "head" in params else params["embed"].T


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """RMSNorm with the gain written as ``1 + scale``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum over rows of ``logits`` (N, V) of the cross-entropy of
    ``labels`` (N,)."""
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def keep_as(t: torch.Tensor, dtype: torch.dtype) -> None:
    """Round ``t`` in place to what ``dtype`` holds (a state kept in
    ``dtype``, computed in float32)."""
    if dtype != t.dtype:
        with torch.no_grad():
            t.copy_(t.to(dtype))


class Adam:
    """Adam without weight decay or clipping, each tensor updated in
    place: ``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g^2``, ``p -= lr
    (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``; ``m``, ``v`` and
    ``p`` kept in ``state``."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 state: torch.dtype = torch.float32):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.state = state
        self.m: Dict[int, torch.Tensor] = {}
        self.v: Dict[int, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p in params:
            g = p.grad
            m = self.m.setdefault(id(p), torch.zeros_like(p))
            v = self.v.setdefault(id(p), torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
            for t in (m, v, p):
                keep_as(t, self.state)
