"""Per-layer blocks: the dense/MoE transformer block and the Mamba2 block.

A *block* is the unit the layer stack loops over.  Each block kind has an
``init`` and an ``apply`` that works in three modes:

* ``train``   — full sequence, no cache;
* ``prefill`` — full sequence, returns fresh KV / SSM state for the cache;
* ``decode``  — one token against an existing cache.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, AttnKind
from repro_torch.models.layers.attention import (AttnSpec, SeqShardAxis,
                                                 TensorAxis,
                                                 attention_apply,
                                                 attention_init,
                                                 decode_attend,
                                                 merge_decode_partials,
                                                 tp_kv, tp_output,
                                                 tp_query)
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.moe import moe_apply, moe_init
from repro_torch.models.layers.norms import (layernorm_apply, layernorm_init,
                                             rmsnorm_apply, rmsnorm_init)
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.layers.ssd import (SSMSpec, ssd_apply,
                                           ssd_decode_step, ssd_init)


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


def ssm_spec(cfg: ArchConfig) -> SSMSpec:
    return SSMSpec(d_model=cfg.d_model, d_inner=cfg.d_inner,
                   n_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                   chunk=cfg.ssm_chunk, conv_width=cfg.ssm_conv_width)


# ---------------------------------------------------------------------------
# Dense / MoE transformer block
# ---------------------------------------------------------------------------

def dense_block_init(generator: torch.Generator, cfg: ArchConfig,
                     local: bool = False,
                     device: torch.device | str = "cuda") -> dict:
    p = {
        "ln_attn": norm_init(cfg, cfg.d_model, device),
        "attn": attention_init(generator, cfg.d_model, attn_spec(cfg, local),
                               device),
        "ln_mlp": norm_init(cfg, cfg.d_model, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.d_ff,
                            cfg.n_experts, device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            device)
    if cfg.post_norm:
        p["ln_attn_post"] = norm_init(cfg, cfg.d_model, device)
        p["ln_mlp_post"] = norm_init(cfg, cfg.d_model, device)
    return p


def _ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
         dropless: bool = False, tp: Optional[TensorAxis] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.is_moe:
        return moe_apply(params["moe"], x, top_k=cfg.experts_per_token,
                         dropless=dropless, tp=tp, d_ff=cfg.d_ff)
    return (mlp_apply(params["mlp"], x, cfg.mlp_kind, tp=tp, d_ff=cfg.d_ff),
            torch.zeros((), dtype=torch.float32, device=x.device))


def dense_block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, *, local: bool = False,
                      kv_cache: Optional[Tuple] = None,
                      return_kv: bool = False,
                      seq_shard_axis: Optional[SeqShardAxis] = None,
                      dropless: bool = False,
                      tp: Optional[TensorAxis] = None,
                      q: Optional[torch.Tensor] = None):
    """Returns (y, aux_loss, new_kv_or_None).

    ``kv_cache = (k, v, kv_positions)`` → decode mode (x is one token at
    ``positions`` (B,)).  Otherwise ``positions`` is (B, S).  With
    ``seq_shard_axis`` the cache is this rank's sequence shard and the
    attention partials merge across the axis's ranks.
    ``dropless`` — MoE dispatch with no capacity dropping (the serving
    paths pass True so decode matches a drop-free full forward).
    ``tp`` — the weights are this rank's tensor-parallel shards (norms
    are whole): in decode ``q`` is the token's query of every head
    (:func:`decode_project_qkv`), every head attends over the rank's
    cache slots, and the rank's heads go into its ``wo`` shard
    (``attention.tp_output``).
    """
    spec = attn_spec(cfg, local)
    h = norm_apply(cfg, params["ln_attn"], x)
    new_kv = None
    if kv_cache is not None:
        # decode: project q from h, attend over the cache
        dtype = h.dtype
        if tp is not None and q is None:
            raise ValueError("tensor-parallel decode takes the query of "
                             "every head (decode_project_qkv)")
        if q is None:
            q = torch.einsum("bsd,dhk->bshk", h,
                             params["attn"]["wq"].to(dtype))
            if spec.use_rope:
                q = apply_rope(q, positions[:, None], spec.rope_theta)
        k_cache, v_cache, kv_pos = kv_cache
        wv, m, l = decode_attend(q, k_cache, v_cache, kv_pos, positions, spec)
        out = merge_decode_partials(wv, m, l, seq_shard_axis).to(dtype)
        if tp is None:
            attn_out = torch.einsum("bshk,hkd->bsd", out,
                                    params["attn"]["wo"].to(dtype))
        else:
            attn_out = tp_output(out, params["attn"]["wo"], spec, tp,
                                 cfg.d_model)
    else:
        res = attention_apply(params["attn"], h, spec, positions,
                              return_kv=return_kv, tp=tp)
        if return_kv:
            attn_out, new_kv = res
        else:
            attn_out = res
    if cfg.post_norm:
        attn_out = norm_apply(cfg, params["ln_attn_post"], attn_out)
    x = x + attn_out
    h = norm_apply(cfg, params["ln_mlp"], x)
    ffn_out, aux = _ffn(params, h, cfg, dropless=dropless, tp=tp)
    if cfg.post_norm:
        ffn_out = norm_apply(cfg, params["ln_mlp_post"], ffn_out)
    return x + ffn_out, aux, new_kv


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


def decode_project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                       positions: torch.Tensor, local: bool,
                       tp: TensorAxis):
    """This token's (q, k, v) of every head from this rank's
    tensor-parallel shards (decode mode): each projected over the rank's
    heads (every head, gathered weights, where the rule splits
    ``head_dim``), and the ones over some heads gathered in one
    all-gather, one token wide."""
    spec = attn_spec(cfg, local)
    h = norm_apply(cfg, params["ln_attn"], x)
    dtype = h.dtype
    (wq, _), (wk, wv, _) = tp_query(params["attn"], spec, tp), \
        tp_kv(params["attn"], spec, tp)
    q = torch.einsum("bsd,dhk->bshk", h, wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", h, wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", h, wv.to(dtype))
    if spec.use_rope:
        q = apply_rope(q, positions[:, None], spec.rope_theta)
        k = apply_rope(k, positions[:, None], spec.rope_theta)
    split = [(t, 2) for t, n in ((q, spec.n_heads), (k, spec.n_kv_heads),
                                 (v, spec.n_kv_heads)) if t.shape[2] < n]
    got = iter(tp.gathers(split))
    return tuple(next(got) if t.shape[2] < n else t
                 for t, n in ((q, spec.n_heads), (k, spec.n_kv_heads),
                              (v, spec.n_kv_heads)))


# ---------------------------------------------------------------------------
# Mamba2 (SSM) block
# ---------------------------------------------------------------------------

def ssm_block_init(generator: torch.Generator, cfg: ArchConfig,
                   device: torch.device | str = "cuda") -> dict:
    return {
        "ln": norm_init(cfg, cfg.d_model, device),
        "ssd": ssd_init(generator, ssm_spec(cfg), device),
    }


def ssm_block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    decode: bool = False, tp: Optional[TensorAxis] = None):
    """Returns (y, (ssm_state, conv_state)).  ``decode`` takes one token
    (B, 1, D) and needs ``state``; otherwise x is a whole sequence and
    ``state`` (or none) is the state before it.  With ``tp`` the weights
    and the states are this rank's shards (``ssd.ssd_apply``)."""
    spec = ssm_spec(cfg)
    h = norm_apply(cfg, params["ln"], x)
    if decode:
        if state is None:
            raise ValueError("decode needs the SSM state")
        out, new_state = ssd_decode_step(params["ssd"], h, spec,
                                         state[0], state[1], tp=tp)
    else:
        h0, conv0 = state if state is not None else (None, None)
        out, new_state = ssd_apply(params["ssd"], h, spec, h0=h0,
                                   conv0=conv0, tp=tp)
    return x + out, new_state


def init_ssm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device: torch.device | str = "cuda") -> Tuple:
    """Zero (ssm state (B, H, P, N) fp32, conv state (B, W-1, conv_dim))."""
    spec = ssm_spec(cfg)
    h = torch.zeros((batch, spec.heads, spec.head_dim, spec.n_state),
                    dtype=torch.float32, device=device)
    conv = torch.zeros((batch, spec.conv_width - 1, spec.conv_dim),
                       dtype=dtype, device=device)
    return h, conv
