"""Plain PyTorch version of the flash attention kernel.

Layout: q (B, H, Sq, D); k, v (B, KV, Sk, D) with H = KV * q_per_kv (GQA).
Same semantics as ``repro.kernels.flash_attention.ref.attention_reference``
and as the CUDA kernel in ``csrc/flash_attention.cu``: fp32 math, the
finite ``-1e30`` mask sentinel, scale fixed at ``D ** -0.5``.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        kv_len: int | None = None) -> torch.Tensor:
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    rep = h // kvh
    # upcast before the repeat: the same values, and autograd then sums a
    # GQA group's dK and dV in fp32 (repeated bf16 would sum them in bf16)
    k = k.float().repeat_interleave(rep, dim=1)
    v = v.float().repeat_interleave(rep, dim=1)
    scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= qp - kp < window
    if kv_len is not None:
        mask &= kp < kv_len
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.to(q.dtype)
