"""Per-layer blocks: the dense transformer block.

A *block* is the unit the layer stack loops over.  ``dense_block_apply``
works in three modes:

* ``train``   — full sequence, no cache;
* ``prefill`` — full sequence, returns fresh KV for the cache;
* ``decode``  — one token against an existing cache.

MoE and Mamba2 blocks are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, AttnKind
from repro_torch.models.layers.attention import (AttnSpec, attention_apply,
                                                 attention_init,
                                                 decode_attend,
                                                 merge_decode_partials)
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.norms import (layernorm_apply, layernorm_init,
                                             rmsnorm_apply, rmsnorm_init)
from repro_torch.models.layers.rope import apply_rope


def _no_moe(cfg: ArchConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE: later slice")


def norm_init(cfg: ArchConfig, d: int,
              device: torch.device | str = "cuda") -> dict:
    return layernorm_init(d, device) if cfg.norm_kind == "layernorm" \
        else rmsnorm_init(d, device)


def norm_apply(cfg: ArchConfig, params: dict,
               x: torch.Tensor) -> torch.Tensor:
    fn = layernorm_apply if cfg.norm_kind == "layernorm" else rmsnorm_apply
    return fn(params, x, eps=cfg.norm_eps)


def attn_spec(cfg: ArchConfig, local: bool) -> AttnSpec:
    if cfg.attn_kind == AttnKind.SLIDING:
        window = cfg.window
    elif cfg.attn_kind == AttnKind.LOCAL_GLOBAL and local:
        window = cfg.window
    else:
        window = 0
    return AttnSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        causal=cfg.causal,
        window=window,
        softcap=cfg.logit_softcap,
        rope_theta=cfg.rope_theta,
        use_rope=not cfg.learned_pos,
    )


def dense_block_init(generator: torch.Generator, cfg: ArchConfig,
                     local: bool = False,
                     device: torch.device | str = "cuda") -> dict:
    _no_moe(cfg)
    p = {
        "ln_attn": norm_init(cfg, cfg.d_model, device),
        "attn": attention_init(generator, cfg.d_model, attn_spec(cfg, local),
                               device),
        "ln_mlp": norm_init(cfg, cfg.d_model, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                        device),
    }
    if cfg.post_norm:
        p["ln_attn_post"] = norm_init(cfg, cfg.d_model, device)
        p["ln_mlp_post"] = norm_init(cfg, cfg.d_model, device)
    return p


def dense_block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, *, local: bool = False,
                      kv_cache: Optional[Tuple] = None,
                      return_kv: bool = False):
    """Returns (y, new_kv_or_None).

    ``kv_cache = (k, v, kv_positions)`` → decode mode (x is one token at
    ``positions`` (B,)).  Otherwise ``positions`` is (B, S).
    """
    _no_moe(cfg)
    spec = attn_spec(cfg, local)
    h = norm_apply(cfg, params["ln_attn"], x)
    new_kv = None
    if kv_cache is not None:
        # decode: project q from h, attend over the cache
        dtype = h.dtype
        q = torch.einsum("bsd,dhk->bshk", h,
                         params["attn"]["wq"].to(dtype))
        if spec.use_rope:
            q = apply_rope(q, positions[:, None], spec.rope_theta)
        k_cache, v_cache, kv_pos = kv_cache
        wv, m, l = decode_attend(q, k_cache, v_cache, kv_pos, positions, spec)
        out = merge_decode_partials(wv, m, l)
        attn_out = torch.einsum("bshk,hkd->bsd", out.to(dtype),
                                params["attn"]["wo"].to(dtype))
    else:
        res = attention_apply(params["attn"], h, spec, positions,
                              return_kv=return_kv)
        if return_kv:
            attn_out, new_kv = res
        else:
            attn_out = res
    if cfg.post_norm:
        attn_out = norm_apply(cfg, params["ln_attn_post"], attn_out)
    x = x + attn_out
    h = norm_apply(cfg, params["ln_mlp"], x)
    ffn_out = mlp_apply(params["mlp"], h, cfg.mlp_kind)
    if cfg.post_norm:
        ffn_out = norm_apply(cfg, params["ln_mlp_post"], ffn_out)
    return x + ffn_out, new_kv


def decode_project_kv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, local: bool = False):
    """Project this token's (k, v) for the cache write (decode mode)."""
    spec = attn_spec(cfg, local)
    h = norm_apply(cfg, params["ln_attn"], x)
    dtype = h.dtype
    k = torch.einsum("bsd,dhk->bshk", h, params["attn"]["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", h, params["attn"]["wv"].to(dtype))
    if spec.use_rope:
        k = apply_rope(k, positions[:, None], spec.rope_theta)
    return k, v
