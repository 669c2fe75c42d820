"""The model's spine: config-driven decoder stacks (dense, MoE, SSM,
gemma2's local/global pairs and the zamba2 hybrid).

An architecture compiles to a list of :class:`StageSpec`s — homogeneous
groups of blocks whose parameters are stacked on a leading layer
dimension, exactly as in ``repro.models.model``: ``stages[0]["attn"]["wq"]``
is ``(L, d, H, hd)``.  A ``pair`` element holds a ``local`` and a
``global`` block; a ``zamba`` element holds ``mamba``, its ``inner`` SSM
blocks stacked a second time, ``(count, inner, ...)``, and applies the
top-level ``shared`` block after them.  The JAX package scans over these
dimensions; here a Python loop indexes them.

Public API (plain functions over a params dict, plus :class:`DecoderLM`,
the ``nn.Module`` that holds the parameters):

* :func:`init_params`
* :func:`loss_fn`       — training loss (chunked CE + router aux)
* :func:`forward_hidden` — activations for training
* :func:`init_cache`
* :func:`prefill`       — build KV / SSM caches, return last logits
* :func:`decode_step`   — one-token serving step (updates caches in place)

The training functions take a stage either stacked, as above, or as a
list of per-layer trees: the MPMD trainer passes one autograd leaf per
layer and leaf, so that each layer's gradient lands in its own tensor and
no stacked-size gradient is built per layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, AttnKind
from repro_torch.models import blocks as B
from repro_torch.models import kvcache as KV
from repro_torch.models.layers.attention import SeqShardAxis, TensorAxis
from repro_torch.models.layers.init_utils import dense_init, embed_init

#: Leaves the JAX package keeps in fp32 and uses in fp32 (norm scales, the
#: SSM block's decay, step and skip parameters) or casts at their use (the
#: conv bias); ``ln_*`` keys are norms too.
_FP32_KEYS = ("final_norm", "ln", "gate_norm", "a_log", "dt_bias", "d_skip",
              "conv_b")


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is
    none (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return dev


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def storage_dtype(path: Sequence[str], dtype: torch.dtype) -> torch.dtype:
    """Dtype a parameter at ``path`` is stored in: the leaves of
    ``_FP32_KEYS`` and ``ln_*`` stay fp32, as in the JAX package; every
    other leaf is only ever used cast to the compute dtype, so it is stored
    in ``dtype``."""
    if any(k.startswith("ln_") or k in _FP32_KEYS for k in path):
        return torch.float32
    return dtype


# ---------------------------------------------------------------------------
# Stage compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str          # dense | pair | ssm | zamba
    count: int
    local: bool = False
    inner: int = 0     # zamba: mamba blocks per group


def build_stages(cfg: ArchConfig) -> List[StageSpec]:
    """The stages of ``cfg``: Mamba2 one ``ssm`` stage; a hybrid (zamba2)
    ``zamba`` groups of ``hybrid_attn_every`` SSM blocks, then an ``ssm``
    stage of the layers left over; local/global attention (gemma2)
    ``pair`` stages, then one global ``dense`` layer if the count is odd;
    every other model one ``dense`` stage."""
    if cfg.is_ssm:
        return [StageSpec("ssm", cfg.n_layers)]
    if cfg.is_hybrid:
        groups = cfg.n_layers // cfg.hybrid_attn_every
        tail = cfg.n_layers - groups * cfg.hybrid_attn_every
        out = [StageSpec("zamba", groups, inner=cfg.hybrid_attn_every)]
        if tail:
            out.append(StageSpec("ssm", tail))
        return out
    if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
        out = [StageSpec("pair", cfg.n_layers // 2)]
        if cfg.n_layers % 2:
            out.append(StageSpec("dense", 1, local=False))
        return out
    local = cfg.attn_kind == AttnKind.SLIDING
    return [StageSpec("dense", cfg.n_layers, local=local)]


def tree_map(tree: Any, fn, path: Tuple[str, ...] = ()) -> Any:
    """Map ``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def layer(tree: Any, i: int) -> Any:
    """Views of layer ``i`` of a stacked params or cache tree."""
    return tree_map(tree, lambda _, t: t[i])


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: torch.device | str = "cuda",
                all_fp32: bool = False) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, names and shapes.

    Values are drawn in fp32 from ``generator`` (which must live on
    ``device``); all leaves but the fp32 ones are stored in the config dtype
    (see :func:`storage_dtype`), or every leaf in fp32 with ``all_fp32``
    (training state, which the JAX package keeps in fp32).  Elements are
    drawn one at a time into the stacked tensors, so fp32 copies of at
    most one element exist at once: one layer, a pair's two, or one SSM
    block of a zamba group, whose blocks are stacked as they are drawn.
    ``device="meta"`` gives shapes only.
    """
    device = resolve_device(device)
    dtype = torch.float32 if all_fp32 else compute_dtype(cfg)

    def store(path, t):
        return t.to(storage_dtype(path, dtype))

    params: Dict[str, Any] = {
        "embed": store(("embed",), embed_init(generator, cfg.vocab_size,
                                              cfg.d_model, device)),
        "final_norm": B.norm_init(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = store(("head",), dense_init(
            generator, (cfg.d_model, cfg.vocab_size), device=device))
    if cfg.learned_pos:
        pos = torch.empty((cfg.max_seq, cfg.d_model), dtype=torch.float32,
                          device=device)
        params["pos_embed"] = store(("pos_embed",), 0.02 * torch.nn.init.
                                    normal_(pos, generator=generator))
    if cfg.frontend_dim:
        params["frontend_proj"] = store(("frontend_proj",), dense_init(
            generator, (cfg.frontend_dim, cfg.d_model), device=device))
    if cfg.is_hybrid:
        params["shared"] = tree_map(
            B.dense_block_init(generator, cfg, local=False, device=device),
            lambda p, t: store(("shared",) + p, t))
    params["stages"] = [
        _stack(spec.count, lambda _s=spec: _element_init(
            generator, cfg, _s, device, dtype), dtype, device)
        for spec in build_stages(cfg)]
    return params


def _stack(count: int, draw, dtype: torch.dtype,
           device: torch.device) -> Any:
    """``count`` trees from ``draw()`` stacked on a new leading dimension,
    each stored (in its :func:`storage_dtype` under ``dtype``) as soon as
    it is drawn and freed before the next draw."""
    stacked = None
    for i in range(count):
        elem = draw()
        if stacked is None:
            stacked = tree_map(elem, lambda p, t: torch.empty(
                (count,) + tuple(t.shape), dtype=storage_dtype(p, dtype),
                device=device))
        dst = layer(stacked, i)
        tree_map(elem, lambda p, t, _d=dst: _get(_d, p).copy_(t))
        del elem    # before the next draws
    return stacked


def _element_init(generator: torch.Generator, cfg: ArchConfig,
                  spec: StageSpec, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """One element of a ``spec`` stage, drawn in fp32; a zamba element's
    SSM blocks are stacked as they are drawn, stored under ``dtype``."""
    if spec.kind == "dense":
        return B.dense_block_init(generator, cfg, local=spec.local,
                                  device=device)
    if spec.kind == "pair":
        return {"local": B.dense_block_init(generator, cfg, local=True,
                                            device=device),
                "global": B.dense_block_init(generator, cfg, local=False,
                                             device=device)}
    if spec.kind == "ssm":
        return B.ssm_block_init(generator, cfg, device)
    if spec.kind == "zamba":
        return {"mamba": _stack(spec.inner, lambda: B.ssm_block_init(
            generator, cfg, device), dtype, device)}
    raise ValueError(spec.kind)


def _get(tree: Any, path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def param_count(params: Any) -> int:
    total = []
    tree_map(params, lambda _, t: total.append(t.numel()))
    return sum(total)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed_lookup(cfg: ArchConfig, embed: torch.Tensor,
                  tokens: torch.Tensor, tp: Optional[TensorAxis]
                  ) -> torch.Tensor:
    """``embed[tokens]`` of the whole table.  With ``tp`` the table is the
    rank's shard: by vocab rows, each rank looks up the ids in its range,
    zero elsewhere, and the ranks' rows are summed; by ``d_model``, the
    rank's columns are gathered."""
    if tp is None or embed.shape == (cfg.vocab_size, cfg.d_model):
        return embed[tokens]
    if embed.shape[0] < cfg.vocab_size:
        lo = tp.index * embed.shape[0]
        ids = tokens - lo
        mine = (ids >= 0) & (ids < embed.shape[0])
        x = embed[ids.clamp(0, embed.shape[0] - 1)] * mine[..., None]
        return tp.sum(x)
    return tp.gather(embed[tokens], -1)


def embed_tokens(cfg: ArchConfig, params: Dict[str, Any],
                 tokens: torch.Tensor, positions: torch.Tensor,
                 frontend_embed: torch.Tensor | None = None,
                 tp: Optional[TensorAxis] = None) -> torch.Tensor:
    """Token embeddings (scaled, with the frontend's and the learned
    positions' where the model has them); ``tp``: ``params`` are this
    rank's tensor-parallel shards (:func:`_embed_lookup`)."""
    dtype = compute_dtype(cfg)
    x = _embed_lookup(cfg, params["embed"], tokens, tp).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    if frontend_embed is not None and "frontend_proj" in params:
        # Stubbed modality frontend: precomputed patch/frame embeddings are
        # projected and added (interleave handled by the data pipeline).
        x = x + (frontend_embed.to(dtype)
                 @ params["frontend_proj"].to(dtype))
    if cfg.learned_pos:
        x = x + params["pos_embed"].to(dtype)[positions]
    return x


def head_logits(cfg: ArchConfig, params: Dict[str, Any],
                h: torch.Tensor, tp: Optional[TensorAxis] = None
                ) -> torch.Tensor:
    """fp32 logits of the final-normed hidden states.  With ``tp`` the
    head (or the tied embedding) is this rank's shard: split by vocab, its
    logits are gathered along V; split by ``d_model``, the rank's rows of
    ``h`` give a partial product, summed over the ranks.  Every rank
    returns the whole logits, as the reference's replicated ``P()``."""
    h = B.norm_apply(cfg, params["final_norm"], h)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    if tp is not None and w.shape[1] < cfg.vocab_size:
        return _softcap_logits(cfg, tp.gather(
            (h @ w.to(h.dtype)).float(), -1))
    if tp is not None and w.shape[0] < cfg.d_model:
        part = (h[..., tp.block(cfg.d_model)] @ w.to(h.dtype)).float()
        return _softcap_logits(cfg, tp.sum(part))
    return _softcap_logits(cfg, (h @ w.to(h.dtype)).float())


def _softcap_logits(cfg: ArchConfig, z: torch.Tensor) -> torch.Tensor:
    """The final softcap, where the model has one."""
    if cfg.final_softcap > 0:
        z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
    return z


# ---------------------------------------------------------------------------
# Forward and loss (training)
# ---------------------------------------------------------------------------

def stage_layers(stage: Any, count: int) -> List[Any]:
    """The per-layer trees of a stage given stacked (views of each layer)
    or as a list of per-layer trees (returned as it is)."""
    if isinstance(stage, list):
        return stage
    return [layer(stage, i) for i in range(count)]


def element_apply(cfg: ArchConfig, spec: StageSpec, bp: Any, x: torch.Tensor,
                  positions: torch.Tensor, shared: Any = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ONE stage element (= one Cephalo FSDP unit) to ``x``.
    Returns (y, aux); aux, the MoE router loss, is 0 for dense-MLP and SSM
    blocks.  ``shared`` is the zamba2 shared block's params.  MoE layers
    take the capacity dispatch of training."""
    if spec.kind == "dense":
        y, a, _ = B.dense_block_apply(bp, x, cfg, positions,
                                      local=spec.local)
        return y, a
    if spec.kind == "pair":
        y, a1, _ = B.dense_block_apply(bp["local"], x, cfg, positions,
                                       local=True)
        y, a2, _ = B.dense_block_apply(bp["global"], y, cfg, positions,
                                       local=False)
        return y, a1 + a2
    if spec.kind == "ssm":
        y, _ = B.ssm_block_apply(bp, x, cfg)
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "zamba":
        # nested checkpoint, as the reference's nested remat: without it
        # the backward of a group keeps every SSM block's intermediates
        # alive at once
        for ip in stage_layers(bp["mamba"], spec.inner):
            x, _ = checkpoint(B.ssm_block_apply, ip, x, cfg,
                              use_reentrant=False)
        y, a, _ = B.dense_block_apply(shared, x, cfg, positions,
                                      local=False)
        return y, a
    raise ValueError(spec.kind)


def _stage_apply_train(cfg: ArchConfig, spec: StageSpec, stage: Any,
                       x: torch.Tensor, positions: torch.Tensor,
                       aux: torch.Tensor, remat: str, shared: Any = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage's layers in order.  ``remat="full"`` checkpoints each
    layer (its activations are recomputed in the backward, as
    ``jax.checkpoint`` over the reference's scan body); ``"none"`` keeps
    them."""
    if remat not in ("full", "none"):
        raise ValueError(f"remat {remat!r}: 'full' or 'none'")
    for bp in stage_layers(stage, spec.count):
        if remat == "full":
            y, a = checkpoint(element_apply, cfg, spec, bp, x, positions,
                              shared, use_reentrant=False)
        else:
            y, a = element_apply(cfg, spec, bp, x, positions, shared)
        x, aux = y, aux + a
    return x, aux


def forward_hidden(cfg: ArchConfig, params: Dict[str, Any],
                   tokens: torch.Tensor,
                   frontend_embed: torch.Tensor | None = None,
                   remat: str = "full"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence training forward.  Returns (hidden, aux_loss)."""
    bsz, seq = tokens.shape
    positions = torch.arange(seq, device=tokens.device)[None].expand(
        bsz, seq)
    x = embed_tokens(cfg, params, tokens, positions, frontend_embed)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, sp in zip(build_stages(cfg), params["stages"]):
        x, aux = _stage_apply_train(cfg, spec, sp, x, positions, aux, remat,
                                    params.get("shared"))
    return x, aux


def _ce_chunk(cfg: ArchConfig, params: Dict[str, Any], hc: torch.Tensor,
              yc: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    z = head_logits(cfg, params, hc)                 # (B, C, V) fp32
    lse = torch.logsumexp(z, dim=-1)
    picked = z.gather(-1, yc[..., None])[..., 0]
    return torch.sum(wc * (lse - picked))


def chunked_ce(cfg: ArchConfig, params: Dict[str, Any], h: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Σ_ij w_ij · CE_ij without materializing (B, S, V) logits: sequence
    chunks in order, each checkpointed, so the backward recomputes its
    logits and memory stays O(B · chunk · V)."""
    bsz, seq, _ = h.shape
    chunk = min(chunk, seq)
    if seq % chunk != 0:
        pad = chunk - seq % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))
        seq += pad
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, seq, chunk):
        sl = slice(lo, lo + chunk)
        tot = tot + checkpoint(_ce_chunk, cfg, params, h[:, sl],
                               labels[:, sl], weights[:, sl],
                               use_reentrant=False)
    return tot


def loss_fn(cfg: ArchConfig, params: Dict[str, Any], batch: Dict[str, Any],
            remat: str = "full", ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted-sum CE + router aux.  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) int64 and ``weights`` (B, S) fp32, the Eq. 1
    normalization (uniform 1/(B·S) for homogeneous training), and for a
    model with a frontend stub optionally ``frontend_embed`` (B, S,
    frontend_dim)."""
    h, aux = forward_hidden(cfg, params, batch["tokens"],
                            batch.get("frontend_embed"), remat)
    ce = chunked_ce(cfg, params, h, batch["labels"], batch["weights"],
                    ce_chunk)
    total_w = torch.clamp(torch.sum(batch["weights"]), min=1e-9)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce_sum": ce, "aux": aux, "weight_sum": total_w}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def _cache_len(cfg: ArchConfig, local: bool, max_len: int) -> int:
    spec = B.attn_spec(cfg, local)
    return min(spec.window, max_len) if spec.window > 0 else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> List[Dict]:
    """Empty caches, one entry per stage: ``{"k", "v", "pos"}`` for a dense
    stage; ``{"local", "global"}`` of those for a pair stage (the local
    one a ring of ``min(window, max_len)`` slots); ``{"h": (L, B, H, P, N)
    fp32, "conv": (L, B, W-1, conv_dim)}`` for an SSM stage; and for a
    zamba stage ``h`` and ``conv`` stacked ``(L, inner, ...)`` beside
    ``attn``, the KV cache of each application of the shared block."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)

    def kv(count, local):
        return KV.init_kv(count, batch, _cache_len(cfg, local, max_len),
                          cfg.n_kv_heads, cfg.head_dim, dtype, device)

    def ssm(lead):
        h, conv = B.init_ssm_state(cfg, batch, dtype, device)
        return {"h": h.expand(lead + h.shape).contiguous(),
                "conv": conv.expand(lead + conv.shape).contiguous()}

    caches: List[Dict] = []
    for spec in build_stages(cfg):
        if spec.kind == "dense":
            caches.append(kv(spec.count, spec.local))
        elif spec.kind == "pair":
            caches.append({"local": kv(spec.count, True),
                           "global": kv(spec.count, False)})
        elif spec.kind == "ssm":
            caches.append(ssm((spec.count,)))
        else:
            caches.append({**ssm((spec.count, spec.inner)),
                           "attn": kv(spec.count, False)})
    return caches


def _sub_blocks(cfg: ArchConfig, params: Dict[str, Any], caches: List[Dict]
                ) -> Iterator[Tuple[str, Any, Dict, Any]]:
    """Every block of the model in the order the forward applies them,
    beside its cache: ``("attn", params, its KV cache, (local, group))``
    for an attention block — ``group`` names its cache group as
    :func:`decode_step`'s ``cache_total`` does: ``"k"`` (a dense stage),
    ``"local"``/``"global"`` (a pair), ``"attn"`` (a zamba group) — and
    ``("ssm", params, the SSM caches it indexes, j)`` for an SSM block.  A
    pair is its local then its global layer; a zamba group its ``inner``
    SSM blocks, then the shared block with the group's own KV cache."""
    for spec, sp, cache in zip(build_stages(cfg), params["stages"], caches):
        for i in range(spec.count):
            bp = layer(sp, i)
            if spec.kind == "dense":
                yield "attn", bp, layer(cache, i), (spec.local, "k")
            elif spec.kind == "pair":
                yield ("attn", bp["local"], layer(cache["local"], i),
                       (True, "local"))
                yield ("attn", bp["global"], layer(cache["global"], i),
                       (False, "global"))
            elif spec.kind == "ssm":
                yield "ssm", bp, cache, i
            elif spec.kind == "zamba":
                c = layer(cache, i)
                for j in range(spec.inner):
                    yield "ssm", layer(bp["mamba"], j), c, j
                yield "attn", params["shared"], c["attn"], (False, "attn")
            else:
                raise ValueError(spec.kind)


def _shard_start(axis: Optional[SeqShardAxis], s_loc: int, total: int
                 ) -> int:
    """The first global slot of a rank's shard of ``s_loc`` slots of a
    cache group of ``total``: its index in the sequence group times its
    length where the group is split, else 0 (whole on every rank)."""
    return axis.index * s_loc if axis is not None and s_loc < total else 0


def prefill(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            max_len: int, frontend_embed: torch.Tensor | None = None,
            tp: Optional[TensorAxis] = None,
            seq_shard_axis: Optional[SeqShardAxis] = None,
            caches: Optional[List[Dict]] = None,
            trace: Optional[List[torch.Tensor]] = None,
            feed: Optional[Sequence[torch.Tensor]] = None,
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the full prompt (B, S), build caches.  Returns (last-token
    logits (B, 1, V) fp32, caches).  A model with a frontend stub takes
    its precomputed embeddings as ``frontend_embed`` (B, S, frontend_dim),
    projected and added to the token embeddings.  On CUDA tensors,
    attention goes through the flash attention kernel and the SSM scan
    through the SSD scan kernel.  MoE layers take the drop-free dispatch,
    here and in :func:`decode_step`.

    Tensor-parallel prefill (the reference's ``build_prefill``): with
    ``tp`` the params are this rank's shards under the serving rules and
    ``caches`` its empty cache shards (``launch.serving.rank_caches``);
    each layer computes on its shards and issues the collectives of
    :class:`TensorAxis`; each attention layer's K/V, split by heads,
    move to the rank's slots of the sequence (every KV head gathered,
    the slots of its index in ``seq_shard_axis`` kept: a cache group
    whose shard is its whole length is whole on every rank), the SSM
    state keeps the rank's heads and the conv state its channels.  The
    logits come back whole on every rank (only the last position's are
    computed).

    ``trace`` gets the embedding's output and then each block's output
    (B, S, D), in the order :func:`_sub_blocks` applies the blocks.  With
    ``feed`` (another run's trace) block ``j`` takes ``feed[j]`` as its
    input in place of the previous block's output and the head takes
    ``feed[-1]``: each block is compared with the other run's on the
    same input.
    """
    bsz, seq = tokens.shape
    positions = torch.arange(seq, device=tokens.device)[None].expand(
        bsz, seq)
    x = embed_tokens(cfg, params, tokens, positions, frontend_embed, tp)
    if trace is not None:
        trace.append(x)
    if caches is None:
        caches = init_cache(cfg, bsz, max_len, tokens.device)

    def attend(bp, x, c, arg):
        local = arg[0]
        x, _, kv = B.dense_block_apply(bp, x, cfg, positions, local=local,
                                       return_kv=True, dropless=True, tp=tp)
        window = B.attn_spec(cfg, local).window
        total = _cache_len(cfg, local, max_len)
        s_loc = c["k"].shape[-3]
        if s_loc < total:
            KV.fill_kv_shard(c, kv[0], kv[1], positions, window, total,
                             _shard_start(seq_shard_axis, s_loc, total))
        else:
            KV.fill_kv_from_prefill(c, kv[0], kv[1], positions,
                                    window=window)
        return x

    def scan(bp, x, c, j):
        x, (h, conv) = B.ssm_block_apply(bp, x, cfg, tp=tp)
        c["h"][j].copy_(h)
        c["conv"][j].copy_(conv)
        return x

    for j, (kind, bp, c, arg) in enumerate(_sub_blocks(cfg, params, caches)):
        if feed is not None:
            x = feed[j]
        x = (attend if kind == "attn" else scan)(bp, x, c, arg)
        if trace is not None:
            trace.append(x)
    if feed is not None:
        x = feed[-1]
    logits = head_logits(cfg, params, x[:, -1:], tp)
    return logits, caches


def decode_step(cfg: ArchConfig, params: Dict[str, Any], caches: List[Dict],
                tokens: torch.Tensor, positions: torch.Tensor,
                seq_shard_axis: Optional[SeqShardAxis] = None,
                cache_total: Optional[Dict[str, int]] = None,
                tp: Optional[TensorAxis] = None,
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One serving step: ``tokens`` (B, 1) at absolute ``positions`` (B,).

    Writes this token's (k, v), or the new SSM and conv state, into
    ``caches`` in place and returns (logits (B, 1, V) fp32, caches).

    With ``seq_shard_axis`` the KV caches are this rank's sequence shards
    and attention partials merge across the axis's ranks with the LSE
    trick.  ``cache_total`` maps a cache group (``"k"``, ``"local"``,
    ``"global"``, ``"attn"``) to its global length (default: the local
    one).  A split group's shard starts at the rank's index times its
    local length, one start per group (the reference passes one
    ``shard_start`` to every group, which a pair's ring of ``window``
    slots beside its global cache cannot share); a group whose local
    length is its global one is whole on every rank and starts at 0.
    Without ``tp`` the SSM state is whole: every rank steps it alike.

    Tensor-parallel decode (the reference's ``build_decode``): with
    ``tp`` the params and the caches are this rank's shards, as in
    :func:`prefill`; the new token's K/V and the query's heads are
    gathered (one token wide), every head attends over the rank's slots
    and merges across ``seq_shard_axis``, and the SSM steps the rank's
    heads.
    """
    x = embed_tokens(cfg, params, tokens, positions[:, None], tp=tp)
    totals = cache_total or {}

    def attend(bp, x, c, arg):
        local, group = arg
        # each layer cache's own length: the ring's for a window
        s_loc = c["k"].shape[-3]
        total = totals.get(group, s_loc)
        start = _shard_start(seq_shard_axis, s_loc, total)
        if tp is None:
            q = None
            k_new, v_new = B.decode_project_kv(bp, x, cfg, positions,
                                               local=local)
        else:
            q, k_new, v_new = B.decode_project_qkv(bp, x, cfg, positions,
                                                   local, tp)
        KV.write_kv(c["k"], c["v"], c["pos"], k_new, v_new, positions,
                    cache_total=total, shard_start=start)
        x, _, _ = B.dense_block_apply(bp, x, cfg, positions, local=local,
                                      kv_cache=(c["k"], c["v"], c["pos"]),
                                      seq_shard_axis=seq_shard_axis,
                                      dropless=True, tp=tp, q=q)
        return x

    def step(bp, x, c, j):
        x, (h, conv) = B.ssm_block_apply(bp, x, cfg,
                                         state=(c["h"][j], c["conv"][j]),
                                         decode=True, tp=tp)
        c["h"][j].copy_(h)
        c["conv"][j].copy_(conv)
        return x

    for kind, bp, c, arg in _sub_blocks(cfg, params, caches):
        x = (attend if kind == "attn" else step)(bp, x, c, arg)
    logits = head_logits(cfg, params, x, tp)
    return logits, caches


# ---------------------------------------------------------------------------
# nn.Module holder
# ---------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A params dict (of dicts, lists and tensors) as nested modules, with
    the tree's own key names, frozen (serving needs no gradients).
    ``nested`` is the same dict built once, its leaves these Parameters."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.nested: Dict[str, Any] = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                p = nn.Parameter(v, requires_grad=False)
                self.register_parameter(k, p)
                self.nested[k] = p
            elif isinstance(v, dict):
                sub = _ParamTree(v)
                self.add_module(k, sub)
                self.nested[k] = sub.nested
            else:
                subs = nn.ModuleList(_ParamTree(e) for e in v)
                self.add_module(k, subs)
                self.nested[k] = [e.nested for e in subs]


class DecoderLM(nn.Module):
    """A decoder's parameters (dense, MoE, Mamba2, gemma2's pairs or the
    zamba2 hybrid) and its serving entry points.

    The parameters keep the JAX package's tree (``embed``, ``final_norm``,
    ``head``, ``stages[i][...]`` stacked on a leading layer dimension) as
    nested submodules.  Matmul weights, the embedding and the head are
    stored in the config dtype (bf16 for the full-size models): the JAX
    package casts each of them to that dtype before every use, so storing
    them cast gives the same numbers with half the bytes.  Norm scales and
    biases and the SSM block's ``a_log``, ``dt_bias``, ``d_skip`` and
    ``conv_b`` stay fp32, as in the JAX package (:func:`storage_dtype`).
    """

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tree = _ParamTree(params)

    @classmethod
    def init(cls, cfg: ArchConfig, generator: torch.Generator,
             device: torch.device | str = "cuda") -> "DecoderLM":
        return cls(cfg, init_params(cfg, generator, device))

    @property
    def params(self) -> Dict[str, Any]:
        return self.tree.nested

    def prefill(self, tokens: torch.Tensor, max_len: int,
                frontend_embed: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, List[Dict]]:
        return prefill(self.cfg, self.params, tokens, max_len,
                       frontend_embed)

    def decode_step(self, caches: List[Dict], tokens: torch.Tensor,
                    positions: torch.Tensor,
                    seq_shard_axis: Optional[SeqShardAxis] = None,
                    cache_total: Optional[Dict[str, int]] = None
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        return decode_step(self.cfg, self.params, caches, tokens, positions,
                           seq_shard_axis, cache_total)
