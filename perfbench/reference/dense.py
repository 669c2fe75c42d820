"""Plain reference of the dense decoder (the configurations of family
``dense``), written from its equations.

Per layer, on the residual stream ``x`` (tokens x d_model)::

    h = rmsnorm(x) (1 + ln_attn)                      eps: norm_eps
    q, k, v = h wq, h wk, h wv                          heads of head_dim
    q, k = rope(q), rope(k)          half-split rotation, theta rope_theta
    a = softmax(q k^T / sqrt(head_dim), causal) v     query groups of
                                                      n_heads / n_kv_heads
    x = x + a wo
    h = rmsnorm(x) (1 + ln_mlp)
    x = x + gelu_tanh(h w_up + b_up) w_down + b_down

then ``logits = rmsnorm(x) (1 + final_norm) head`` (the embedding's
transpose where the model ties them) and the cross-entropy
of the next token.  Each layer is checkpointed so that a block of rows
holds one layer's activations at a time in the backward.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import leaves as LV
from perfbench.reference import common as C
from perfbench.weights import Spec, fan_in_std


def param_specs(model: Dict[str, Any]) -> List[Spec]:
    """The tree the port trains, with its initial distributions."""
    L, d = model["n_layers"], model["d_model"]
    H, KV, D, F_ = (model["n_heads"], model["n_kv_heads"],
                    model["head_dim"], model["d_ff"])
    s = ("stages", "0")
    return C.token_specs(model, fan_in_std(d)) + [
        (s + ("attn", "wq"), (L, d, H, D), ("trunc", fan_in_std(d))),
        (s + ("attn", "wk"), (L, d, KV, D), ("trunc", fan_in_std(d))),
        (s + ("attn", "wv"), (L, d, KV, D), ("trunc", fan_in_std(d))),
        (s + ("attn", "wo"), (L, H, D, d), ("trunc", fan_in_std(H * D))),
        (s + ("ln_attn", "scale"), (L, d), ("zeros",)),
        (s + ("ln_mlp", "scale"), (L, d), ("zeros",)),
        (s + ("mlp", "w_up"), (L, d, F_), ("trunc", fan_in_std(d))),
        (s + ("mlp", "b_up"), (L, F_), ("zeros",)),
        (s + ("mlp", "w_down"), (L, F_, d), ("trunc", fan_in_std(F_))),
        (s + ("mlp", "b_down"), (L, d), ("zeros",)),
    ]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, heads, D) rotated by positions 0..s-1."""
    s, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x: torch.Tensor, lp: Dict[str, Any], model: Dict[str, Any],
           precision: str) -> torch.Tensor:
    b, s, d = x.shape
    H, KV, D = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    at = lp["attn"]
    h = C.rmsnorm(x, lp["ln_attn"]["scale"], eps)
    q = C.linear(h, at["wq"].reshape(d, H * D), precision).view(b, s, H, D)
    k = C.linear(h, at["wk"].reshape(d, KV * D), precision).view(b, s, KV, D)
    v = C.linear(h, at["wv"].reshape(d, KV * D), precision).view(b, s, KV, D)
    q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (b, H, s, D)
    scores = (q @ k.transpose(-1, -2)) * D ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(
        b, s, H * D)
    x = x + C.linear(a, at["wo"].reshape(H * D, d), precision)
    mlp = lp["mlp"]
    h = C.rmsnorm(x, lp["ln_mlp"]["scale"], eps)
    u = F.gelu(C.linear(h, mlp["w_up"], precision) + mlp["b_up"],
               approximate="tanh")
    return x + C.linear(u, mlp["w_down"], precision) + mlp["b_down"]


def loss_sum(params: Dict[str, Any], tokens: torch.Tensor,
             labels: torch.Tensor, model: Dict[str, Any],
             precision: str) -> torch.Tensor:
    """Sum over ``tokens`` (b, s) of the cross-entropy of ``labels``."""
    x = params["embed"][tokens]
    st = params["stages"][0]
    for i in range(model["n_layers"]):
        x = checkpoint(_layer, x, LV.layer(st, i), model, precision,
                       use_reentrant=False)
    h = C.rmsnorm(x, params["final_norm"]["scale"], model["norm_eps"])
    logits = C.linear(h.reshape(-1, h.shape[-1]), C.head(params),
                      precision)
    return C.ce_sum(logits, labels.reshape(-1))
