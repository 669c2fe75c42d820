"""Multi-head attention with GQA/MQA, sliding windows, and logit softcaps.

Three compute paths, numerically interchangeable:

* ``dense``      — naive O(S^2) scores; the oracle;
* ``blockwise``  — online-softmax loop over KV blocks in plain PyTorch;
                   bounds the logits' memory on long CPU sequences;
* kernel         — :mod:`repro_torch.kernels.flash_attention` for
                   self-attention over a fresh sequence (train/prefill).
                   On CUDA tensors it launches the kernel (which tiles
                   itself); on CPU tensors up to ``BLOCKWISE_THRESHOLD``
                   tokens it runs its plain PyTorch version, past it
                   ``blockwise``.

Decode (:func:`decode_attend`) is plain PyTorch, as in the JAX package.
With the KV cache split over ranks along the sequence (sequence-sharded
decode, DESIGN.md §5), each rank attends over its slots and
:func:`merge_decode_partials` merges the partials across a
:class:`SeqShardAxis` with the log-sum-exp trick.

Layout convention: activations ``(B, S, D)``, heads ``(B, S, H, hd)``,
KV cache ``(B, S_max, KV, hd)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers.init_utils import dense_init
from repro_torch.models.layers.rope import apply_rope

_NEG_INF = -1e30
#: Past this many query or key tokens, CPU self-attention goes blockwise
#: (the JAX package's ``blockwise_threshold``).
BLOCKWISE_THRESHOLD = 2048


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention hyperparameters for one layer."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int = 0            # 0 = full attention
    softcap: float = 0.0
    rope_theta: float = 10_000.0
    use_rope: bool = True      # encoders use learned/absolute positions
    query_scale: float = 0.0   # 0 → 1/sqrt(head_dim)

    @property
    def scale(self) -> float:
        return self.query_scale or self.head_dim ** -0.5

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def attention_init(generator: torch.Generator, d_model: int, spec: AttnSpec,
                   device: torch.device | str = "cuda") -> dict:
    hd = spec.head_dim
    return {
        "wq": dense_init(generator, (d_model, spec.n_heads, hd),
                         fan_in=d_model, device=device),
        "wk": dense_init(generator, (d_model, spec.n_kv_heads, hd),
                         fan_in=d_model, device=device),
        "wv": dense_init(generator, (d_model, spec.n_kv_heads, hd),
                         fan_in=d_model, device=device),
        "wo": dense_init(generator, (spec.n_heads, hd, d_model),
                         fan_in=spec.n_heads * hd, device=device),
    }


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def _expand_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV*q_per_kv, hd) by repetition."""
    if q_per_kv == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, q_per_kv, hd).reshape(
        b, s, kv * q_per_kv, hd)


def _group_q(q: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, H, hd) → (B, S, KV, G, hd): GQA-grouped query layout so the
    KV tensors are never materially expanded."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, h // q_per_kv, q_per_kv, hd)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    spec: AttnSpec,
                    q_positions: torch.Tensor,
                    kv_positions: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd);  k, v: (B, Sk, KV, hd);  positions: (B, S*)."""
    b, sq, h, hd = q.shape
    qg = _group_q(q, spec.q_per_kv)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", qg.float(),
                          k.float()) * spec.scale
    logits = _softcap(logits, spec.softcap)
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = kp >= 0
    if spec.causal:
        mask = mask & (kp <= qp)
    if spec.window > 0:
        mask = mask & (qp - kp < spec.window)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        spec: AttnSpec,
                        q_positions: torch.Tensor,
                        kv_positions: torch.Tensor,
                        block_kv: int = 1024,
                        block_q: int = 4096) -> torch.Tensor:
    """Online-softmax loop over KV blocks, outer-blocked over Q, in fp32;
    the logits held at once are O(block_q * block_kv).  KV is padded to
    the block with position -1 (masked).  Shapes as
    :func:`dense_attention`."""
    b, sq, h, hd = q.shape
    if sq > block_q and sq % block_q == 0:
        return torch.cat([
            blockwise_attention(qi, k, v, spec, pi, kv_positions, block_kv,
                                block_q)
            for qi, pi in zip(q.split(block_q, 1),
                              q_positions.split(block_q, 1))], dim=1)
    sk = k.shape[1]
    if sk % block_kv != 0:
        pad = block_kv - sk % block_kv
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
        sk += pad
    kvh = k.shape[2]
    g = spec.q_per_kv
    qg = _group_q(q, g).float()                  # (B, Sq, KV, G, hd)
    qp = q_positions[:, None, None, :, None]
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    for lo in range(0, sk, block_kv):
        kb = k[:, lo:lo + block_kv].float()
        vb = v[:, lo:lo + block_kv].float()
        kp = kv_positions[:, None, None, None, lo:lo + block_kv]
        logits = torch.einsum("bqcgd,bkcd->bcgqk", qg, kb) * spec.scale
        logits = _softcap(logits, spec.softcap)
        mask = kp >= 0
        if spec.causal:
            mask = mask & (kp <= qp)
        if spec.window > 0:
            mask = mask & (qp - kp < spec.window)
        logits = torch.where(mask, logits,
                             torch.full_like(logits, _NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bcgqk,bkcd->bcgqd",
                                                    p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]    # (B, KV, G, Sq, hd)
    return out.reshape(b, h, sq, hd).transpose(1, 2).to(q.dtype)


def decode_attend(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, cache_positions: torch.Tensor,
                  q_positions: torch.Tensor, spec: AttnSpec,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention for one query token over a (shard of a) cache.

    Returns ``(weighted_values, lse_max, lse_sum)`` so shards can be merged
    with the log-sum-exp trick:
    ``merge = Σ_s exp(m_s - m*) * wv_s / Σ_s exp(m_s - m*) * l_s``.

    q: (B, 1, H, hd);  cache: (B, S, KV, hd);  cache_positions: (B, S).
    """
    b, sq, h, hd = q.shape
    qg = _group_q(q, spec.q_per_kv).float()
    logits = torch.einsum("bqcgd,bkcd->bcgqk", qg,
                          cache_k.float()) * spec.scale
    logits = _softcap(logits, spec.softcap)
    qp = q_positions[:, None, None, None, None]
    kp = cache_positions[:, None, None, None, :]
    mask = (kp >= 0) & (kp <= qp)
    if spec.window > 0:
        mask = mask & (qp - kp < spec.window)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1)                      # (B, KV, G, 1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    wv = torch.einsum("bcgqk,bkcd->bcgqd", p, cache_v.float())
    return (wv.reshape(b, h, sq, hd), m.reshape(b, h, sq),
            l.reshape(b, h, sq))


@dataclasses.dataclass(frozen=True)
class SeqShardAxis:
    """The ranks a KV cache's sequence is split over (the reference's
    ``seq_shard_axis``, a mesh axis name inside ``shard_map``): their
    process ``group``, this rank's ``comm`` (``all_reduce(t, group,
    op)``: NCCL with a card per rank, gloo where ranks share a card or on
    the CPU) and this rank's ``index`` in the group: the block of the
    sequence it holds."""

    group: Any
    comm: Any
    index: int


def merge_decode_partials(wv: torch.Tensor, m: torch.Tensor,
                          l: torch.Tensor,
                          axis: Optional[SeqShardAxis] = None
                          ) -> torch.Tensor:
    """Merge per-shard decode partials; with ``axis`` the merge runs
    across its ranks (sequence-sharded KV): the max over the group, then
    the sums of ``exp(m - m*) wv`` and ``exp(m - m*) l``.  A rank whose
    slots are all masked holds ``m = -1e30``: its scale is 0, so it adds
    nothing (no NaN) as long as one rank of the group holds a valid slot.
    Without ``axis`` it normalises one shard's partials."""
    if axis is not None:
        m_glob = m.clone()
        axis.comm.all_reduce(m_glob, axis.group, op="max")
        scale = torch.exp(m - m_glob)
        wv = (wv * scale[..., None]).contiguous()
        l = (l * scale).contiguous()
        axis.comm.all_reduce(wv, axis.group, op="sum")
        axis.comm.all_reduce(l, axis.group, op="sum")
    out = wv / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2)   # (B, 1, H, hd)


def attention_apply(params: dict, x: torch.Tensor, spec: AttnSpec,
                    positions: torch.Tensor, return_kv: bool = False):
    """Self-attention over ``x`` (B, S, D) through the flash attention
    kernel, which assumes contiguous 0..S-1 positions (train/prefill); on
    the CPU past ``BLOCKWISE_THRESHOLD`` tokens through
    :func:`blockwise_attention`.  ``return_kv`` also returns the fresh
    (k, v) for cache fills.  (The JAX package's ``kv_override``
    cross-cache mode has no caller here yet.)
    """
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    if x.device.type == "cpu" and x.shape[1] > BLOCKWISE_THRESHOLD:
        out = blockwise_attention(q, k, v, spec, positions, positions)
    else:
        # kernel layout (B, H, S, D): transposed views, read through strides
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=spec.causal, window=spec.window,
            softcap=spec.softcap).transpose(1, 2)
    y = torch.einsum("bshk,hkd->bsd", out.to(dtype), params["wo"].to(dtype))
    if return_kv:
        return y, (k, v)
    return y
