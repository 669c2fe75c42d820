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

Tensor-parallel serving (the reference's GSPMD ``build_prefill`` /
``build_decode``): with a :class:`TensorAxis` each rank holds its shard of
the weights as ``launch.serving.param_shardings`` cuts them and issues the
collectives GSPMD would insert (:func:`attention_apply` says which).

Layout convention: activations ``(B, S, D)``, heads ``(B, S, H, hd)``,
KV cache ``(B, S_max, KV, hd)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """The ranks a layer's weights are split over: the reference's
    ``model`` mesh axis, under which GSPMD partitions each leaf as
    ``launch.serving.param_shardings`` says.  Their process ``group``,
    this rank's ``comm`` (a :class:`~repro_torch.core.engine.world.Comm`),
    its ``index`` in the group and the group's ``size``.  A layer computes
    on its shards and calls :meth:`sum_partials` where each rank holds a
    partial product of an output projection; ``drop_sums`` skips those
    sums (each rank's logits as if the other shards were dropped: the
    scale a fault in them would move the logits by)."""

    group: Any
    comm: Any
    index: int
    size: int
    drop_sums: bool = False

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` splits over the axis, by the serving
        rules' test (at least one element a rank, evenly)."""
        return n >= self.size and n % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of a dim of ``n`` split over the axis."""
        size = n // self.size
        return slice(self.index * size, (self.index + 1) * size)

    def gathers(self, items: Sequence[Tuple[torch.Tensor, int]]
                ) -> List[torch.Tensor]:
        """Each ``(t, dim)``'s ``t`` of every rank concatenated along
        ``dim`` in group order: one all-gather for the tensors of each
        dtype, packed flat."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        by_dtype: dict = {}
        for i, (t, _) in enumerate(items):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([items[i][0].reshape(-1) for i in idx]) \
                if len(idx) > 1 else items[idx[0]][0].reshape(-1)
            parts = flat.new_empty((self.size, flat.numel()))
            self.comm.all_gather(parts, flat.contiguous(), self.group)
            off = 0
            for i in idx:
                t, dim = items[i]
                part = parts[:, off:off + t.numel()].reshape(
                    (self.size,) + tuple(t.shape))
                out[i] = torch.cat(part.unbind(0), dim=dim)
                off += t.numel()
        return out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in group order."""
        return self.gathers([(t, dim)])[0]

    def wholes(self, items: Sequence[Tuple[torch.Tensor, int, int]]
               ) -> List[torch.Tensor]:
        """Each ``(t, dim, n)``'s ``t`` whole along ``dim`` (of ``n``):
        gathered (:meth:`gathers`, packed) where this rank holds a block
        of it."""
        split = [i for i, (t, dim, n) in enumerate(items) if t.shape[dim] < n]
        out = [t for t, _, _ in items]
        for i, t in zip(split, self.gathers([items[i][:2] for i in split])):
            out[i] = t
        return out

    def whole(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """``t`` whole along ``dim`` (of ``n``): gathered where this rank
        holds a block of it."""
        return self.wholes([(t, dim, n)])[0]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in ``t``'s dtype (a new
        tensor)."""
        buf = t.clone(memory_format=torch.contiguous_format)
        self.comm.all_reduce(buf, self.group)
        return buf

    def sum_partials(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`sum` of each rank's partial product of an output
        projection (``wo``, ``w_down``, the experts, ``out_proj``); the
        rank's own partial under ``drop_sums``."""
        return t if self.drop_sums else self.sum(t)


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


def tp_query(params: dict, spec: AttnSpec, tp: TensorAxis):
    """This rank's ``(wq, q0)`` under the serving rules: ``wq`` over its
    query heads from ``q0`` where the rule splits heads, else every head
    from 0 (gathered where it splits ``head_dim``)."""
    wq = params["wq"]
    if wq.shape[-2] < spec.n_heads:
        return wq, tp.index * wq.shape[-2]
    return tp.whole(wq, -1, spec.head_dim), 0


def tp_kv(params: dict, spec: AttnSpec, tp: TensorAxis,
          whole: bool = False):
    """This rank's ``(wk, wv, kv0)``: over its KV heads from ``kv0`` where
    the rule splits heads, unless ``whole``; else every KV head from 0,
    gathered where the rule splits heads or ``head_dim`` (fewer KV heads
    than ranks).  Query head ``h`` pairs with KV head ``h // rep`` of the
    whole layer, as unsharded."""
    wk, wv = params["wk"], params["wv"]
    if wk.shape[-2] < spec.n_kv_heads:
        if not whole:
            return wk, wv, tp.index * wk.shape[-2]
        wk, wv = tp.gathers([(wk, -2), (wv, -2)])
        return wk, wv, 0
    wk, wv = tp.wholes([(wk, -1, spec.head_dim), (wv, -1, spec.head_dim)])
    return wk, wv, 0


def tp_output(out: torch.Tensor, wo: torch.Tensor, spec: AttnSpec,
              tp: TensorAxis, d_model: int) -> torch.Tensor:
    """``out`` (B, S, heads, hd) — the rank's query heads, or every head —
    into the rank's ``wo`` shard: where the rule splits ``wo`` by heads,
    the rank's heads of ``out`` into its rows, summed over the ranks; else
    ``out`` holds every head, and a ``wo`` split by ``d_model`` gives the
    rank's columns, gathered."""
    dtype = out.dtype
    wo = wo.to(dtype)
    if wo.shape[-3] < spec.n_heads:
        if out.shape[2] == spec.n_heads:
            out = out[:, :, tp.block(spec.n_heads)]
        return tp.sum_partials(torch.einsum("bshk,hkd->bsd", out, wo))
    y = torch.einsum("bshk,hkd->bsd", out, wo)
    return tp.whole(y, -1, d_model)


def attention_apply(params: dict, x: torch.Tensor, spec: AttnSpec,
                    positions: torch.Tensor, return_kv: bool = False,
                    tp: Optional[TensorAxis] = None):
    """Self-attention over ``x`` (B, S, D) through the flash attention
    kernel, which assumes contiguous 0..S-1 positions (train/prefill); on
    the CPU past ``BLOCKWISE_THRESHOLD`` tokens through
    :func:`blockwise_attention`.  ``return_kv`` also returns the fresh
    (k, v) for cache fills.  (The JAX package's ``kv_override``
    cross-cache mode has no caller here yet.)

    With ``tp`` the weights are this rank's shards (:func:`tp_query`,
    :func:`tp_kv`): the kernel runs over the rank's query heads
    and the KV heads they pair with, and the output goes through
    :func:`tp_output` (a sum over the ranks, or a gather of ``d_model``).
    The returned (k, v) hold every KV head: where the rule splits KV
    heads, the layer gathers whichever moves fewer bytes, the K/V of its
    tokens or ``wk``/``wv`` (more tokens than ``d_model``: a long
    prefill), and projects every head itself.  Where the rule splits
    ``head_dim`` the layer gathers ``wq``, ``wk``, ``wv`` for its
    duration.
    """
    dtype = x.dtype
    if tp is None:
        wq, wk, wv, q0, kv0 = params["wq"], params["wk"], params["wv"], 0, 0
    else:
        many = return_kv and x.shape[0] * x.shape[1] > x.shape[-1]
        (wq, q0), (wk, wv, kv0) = tp_query(params, spec, tp), \
            tp_kv(params, spec, tp, whole=many)
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(dtype))
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    # the KV heads the query heads pair with
    rep = spec.q_per_kv
    lo = q0 // rep - kv0
    hi = (q0 + q.shape[2] - 1) // rep + 1 - kv0
    ka, va = k[:, :, lo:hi], v[:, :, lo:hi]
    if x.device.type == "cpu" and x.shape[1] > BLOCKWISE_THRESHOLD:
        out = blockwise_attention(q, ka, va, dataclasses.replace(
            spec, n_heads=q.shape[2], n_kv_heads=ka.shape[2]),
            positions, positions)
    else:
        # kernel layout (B, H, S, D): transposed views, read through strides
        out = flash_ops.flash_attention(
            q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
            causal=spec.causal, window=spec.window,
            softcap=spec.softcap).transpose(1, 2)
    if tp is None:
        y = torch.einsum("bshk,hkd->bsd", out.to(dtype),
                         params["wo"].to(dtype))
    else:
        y = tp_output(out.to(dtype), params["wo"], spec, tp, x.shape[-1])
        if k.shape[2] < spec.n_kv_heads:
            k, v = tp.gathers([(k, 2), (v, 2)])
    if return_kv:
        return y, (k, v)
    return y
