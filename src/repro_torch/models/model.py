"""The model's spine: config-driven decoder stacks (dense, MoE and SSM
stages).

An architecture compiles to a list of :class:`StageSpec`s — homogeneous
groups of blocks whose parameters are stacked on a leading layer
dimension, exactly as in ``repro.models.model``: ``stages[0]["attn"]["wq"]``
is ``(L, d, H, hd)``.  The JAX package scans over that dimension; here a
Python loop indexes it.

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
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, AttnKind
from repro_torch.models import blocks as B
from repro_torch.models import kvcache as KV
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
    kind: str          # dense | ssm (pair | zamba: not ported yet)
    count: int
    local: bool = False


def build_stages(cfg: ArchConfig) -> List[StageSpec]:
    """The stages of ``cfg``: one ``dense`` stage or, for Mamba2, one
    ``ssm`` stage.  Hybrid (zamba2) and local/global pair stages raise."""
    if cfg.is_ssm:
        return [StageSpec("ssm", cfg.n_layers)]
    if cfg.is_hybrid:
        raise NotImplementedError("hybrid (zamba2) stages: later slice")
    if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
        raise NotImplementedError("local/global pair stages: later slice")
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
    (training state, which the JAX package keeps in fp32).  Layers are
    drawn one at a time into the stacked tensors, so fp32 copies of at most
    one layer exist at once.  ``device="meta"`` gives shapes only.
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
    stages = []
    for spec in build_stages(cfg):
        stacked = None
        for i in range(spec.count):
            elem = _element_init(generator, cfg, spec, device)
            if stacked is None:
                stacked = tree_map(elem, lambda p, t: torch.empty(
                    (spec.count,) + tuple(t.shape),
                    dtype=storage_dtype(p, dtype), device=device))
            dst = layer(stacked, i)
            tree_map(elem, lambda p, t, _d=dst: _get(_d, p).copy_(t))
            del elem    # before the next layer's draws
        stages.append(stacked)
    params["stages"] = stages
    return params


def _element_init(generator: torch.Generator, cfg: ArchConfig,
                  spec: StageSpec, device: torch.device) -> Dict[str, Any]:
    if spec.kind == "ssm":
        return B.ssm_block_init(generator, cfg, device)
    return B.dense_block_init(generator, cfg, local=spec.local,
                              device=device)


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

def embed_tokens(cfg: ArchConfig, params: Dict[str, Any],
                 tokens: torch.Tensor, positions: torch.Tensor,
                 frontend_embed: torch.Tensor | None = None
                 ) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
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
                h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final-normed hidden states."""
    h = B.norm_apply(cfg, params["final_norm"], h)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    z = (h @ w.to(h.dtype)).float()
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
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ONE stage element (= one Cephalo FSDP unit) to ``x``.
    Returns (y, aux); aux, the MoE router loss, is 0 for dense-MLP and SSM
    blocks.  MoE layers take the capacity dispatch of training."""
    if spec.kind == "ssm":
        y, _ = B.ssm_block_apply(bp, x, cfg)
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "dense":
        y, a, _ = B.dense_block_apply(bp, x, cfg, positions,
                                      local=spec.local)
        return y, a
    raise NotImplementedError(f"training through {spec.kind!r} stages: "
                              "later slice")


def _stage_apply_train(cfg: ArchConfig, spec: StageSpec, stage: Any,
                       x: torch.Tensor, positions: torch.Tensor,
                       aux: torch.Tensor, remat: str
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
                              use_reentrant=False)
        else:
            y, a = element_apply(cfg, spec, bp, x, positions)
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
        x, aux = _stage_apply_train(cfg, spec, sp, x, positions, aux, remat)
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
    stage, ``{"h": (L, B, H, P, N) fp32, "conv": (L, B, W-1, conv_dim)}``
    for an SSM stage."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    caches: List[Dict] = []
    for spec in build_stages(cfg):
        if spec.kind == "ssm":
            h, conv = B.init_ssm_state(cfg, batch, dtype, device)
            caches.append({
                "h": h.expand((spec.count,) + h.shape).contiguous(),
                "conv": conv.expand((spec.count,) + conv.shape).contiguous()})
        else:
            caches.append(KV.init_kv(
                spec.count, batch, _cache_len(cfg, spec.local, max_len),
                cfg.n_kv_heads, cfg.head_dim, dtype, device))
    return caches


def prefill(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the full prompt (B, S), build caches.  Returns (last-token
    logits (B, 1, V) fp32, caches).  On CUDA tensors, attention goes
    through the flash attention kernel and the SSM scan through the SSD
    scan kernel.  MoE layers take the drop-free dispatch, here and in
    :func:`decode_step`."""
    bsz, seq = tokens.shape
    positions = torch.arange(seq, device=tokens.device)[None].expand(
        bsz, seq)
    x = embed_tokens(cfg, params, tokens, positions)
    caches = init_cache(cfg, bsz, max_len, tokens.device)
    for spec, sp, cache in zip(build_stages(cfg), params["stages"], caches):
        if spec.kind == "ssm":
            for i in range(spec.count):
                x, (h, conv) = B.ssm_block_apply(layer(sp, i), x, cfg)
                cache["h"][i].copy_(h)
                cache["conv"][i].copy_(conv)
            continue
        window = B.attn_spec(cfg, spec.local).window
        for i in range(spec.count):
            x, _, kv = B.dense_block_apply(layer(sp, i), x, cfg, positions,
                                           local=spec.local, return_kv=True,
                                           dropless=True)
            KV.fill_kv_from_prefill(layer(cache, i), kv[0], kv[1],
                                    positions, window=window)
    logits = head_logits(cfg, params, x[:, -1:])
    return logits, caches


def decode_step(cfg: ArchConfig, params: Dict[str, Any], caches: List[Dict],
                tokens: torch.Tensor, positions: torch.Tensor,
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One serving step: ``tokens`` (B, 1) at absolute ``positions`` (B,).

    Writes this token's (k, v), or the new SSM and conv state, into
    ``caches`` in place and returns (logits (B, 1, V) fp32, caches).
    """
    x = embed_tokens(cfg, params, tokens, positions[:, None])
    for spec, sp, cache in zip(build_stages(cfg), params["stages"], caches):
        if spec.kind == "ssm":
            for i in range(spec.count):
                c = layer(cache, i)
                x, (h, conv) = B.ssm_block_apply(
                    layer(sp, i), x, cfg, state=(c["h"], c["conv"]),
                    decode=True)
                c["h"].copy_(h)
                c["conv"].copy_(conv)
            continue
        total = cache["k"].shape[-3]
        for i in range(spec.count):
            bp, c = layer(sp, i), layer(cache, i)
            k_new, v_new = B.decode_project_kv(bp, x, cfg, positions,
                                               local=spec.local)
            KV.write_kv(c["k"], c["v"], c["pos"], k_new, v_new, positions,
                        cache_total=total)
            x, _, _ = B.dense_block_apply(
                bp, x, cfg, positions, local=spec.local,
                kv_cache=(c["k"], c["v"], c["pos"]), dropless=True)
    logits = head_logits(cfg, params, x)
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
    """A decoder's parameters (dense, MoE or Mamba2) and its serving entry
    points.

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

    def prefill(self, tokens: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, List[Dict]]:
        return prefill(self.cfg, self.params, tokens, max_len)

    def decode_step(self, caches: List[Dict], tokens: torch.Tensor,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        return decode_step(self.cfg, self.params, caches, tokens, positions)
