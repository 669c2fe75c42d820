"""Extract :class:`~repro_torch.core.cost_model.ModelStats` from an
ArchConfig.

A copy of ``repro.core.model_stats`` (no JAX in it): the port keeps its
own, so that it imports nothing of the JAX package.

These are the napkin-math workload numbers the Cephalo planner and the
roofline analysis consume: parameters, FLOPs, and activation bytes per layer
type.  All FLOP counts use the 2·MACs convention; attention scores count
``2 * 2 * heads * head_dim * attended`` per token (QK^T and AV).
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import ArchConfig, AttnKind
from repro_torch.core.cost_model import LayerStats, ModelStats

_ACT_BYTES = 4   # fp32 boundary activations (paper trains full precision)


def _attn_params(cfg: ArchConfig) -> int:
    if not cfg.has_attention or cfg.n_heads == 0:
        return 0
    hd = cfg.head_dim
    return cfg.d_model * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    if d_ff == 0:
        return 0
    mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return mats * cfg.d_model * d_ff


def _ssm_params(cfg: ArchConfig) -> int:
    if cfg.ssm_state == 0:
        return 0
    d_in = cfg.d_inner
    n = cfg.ssm_state
    heads = cfg.ssm_heads
    in_proj = cfg.d_model * (2 * d_in + 2 * n + heads)
    conv = (d_in + 2 * n) * cfg.ssm_conv_width
    out_proj = d_in * cfg.d_model
    extras = 2 * heads + d_in   # A, D, gate norm
    return in_proj + conv + out_proj + extras


def _attended(cfg: ArchConfig, seq: int, layer_is_local: bool) -> float:
    """Mean attended context length per token."""
    if layer_is_local and cfg.attn_kind in (AttnKind.SLIDING,
                                            AttnKind.LOCAL_GLOBAL):
        w = min(cfg.window, seq)
        # causal within a window: ramps to w then stays
        return w * (1 - w / (2 * seq)) if seq > 0 else 0
    if cfg.causal:
        return seq / 2
    return seq


def _attn_flops_per_token(cfg: ArchConfig, seq: int,
                          layer_is_local: bool) -> float:
    if not cfg.has_attention or cfg.n_heads == 0:
        return 0.0
    att = _attended(cfg, seq, layer_is_local)
    return 2 * 2 * cfg.n_heads * cfg.head_dim * att


def _dense_layer(cfg: ArchConfig, seq: int, local: bool,
                 d_ff: int, active_d_ff: int) -> LayerStats:
    p_attn = _attn_params(cfg)
    p_mlp = _mlp_params(cfg, d_ff)
    p_router = cfg.d_model * cfg.n_experts if cfg.is_moe else 0
    params = p_attn + p_mlp + p_router + 2 * cfg.d_model
    active = p_attn + _mlp_params(cfg, active_d_ff) + p_router + 2 * cfg.d_model
    flops_tok = 2 * active + _attn_flops_per_token(cfg, seq, local)
    act = seq * cfg.d_model * _ACT_BYTES
    # transient workspace inside the remat block: widest intermediate
    wide = max(active_d_ff if active_d_ff else 0,
               cfg.n_heads * cfg.head_dim if cfg.n_heads else cfg.d_model)
    workspace = 2 * seq * wide * _ACT_BYTES
    return LayerStats(params=params, active_params=active,
                      flops_fwd=flops_tok * seq, act_bytes=act,
                      workspace_bytes=workspace)


def _ssm_layer(cfg: ArchConfig, seq: int) -> LayerStats:
    params = _ssm_params(cfg) + 2 * cfg.d_model
    # SSD scan: ~6 * d_inner * N per token on top of the projections
    flops_tok = 2 * params + 6 * cfg.d_inner * cfg.ssm_state
    act = seq * cfg.d_model * _ACT_BYTES
    workspace = 2 * seq * cfg.d_inner * _ACT_BYTES
    return LayerStats(params=params, active_params=params,
                      flops_fwd=flops_tok * seq, act_bytes=act,
                      workspace_bytes=workspace)


def build_model_stats(cfg: ArchConfig, seq_len: int) -> ModelStats:
    layers: List[Tuple[LayerStats, int]] = []
    if cfg.is_ssm:
        layers.append((_ssm_layer(cfg, seq_len), cfg.n_layers))
    elif cfg.is_hybrid:
        layers.append((_ssm_layer(cfg, seq_len), cfg.n_layers))
        n_apps = max(1, cfg.n_layers // cfg.hybrid_attn_every)
        shared = _dense_layer(cfg, seq_len, local=False,
                              d_ff=cfg.d_ff, active_d_ff=cfg.d_ff)
        # Shared weights: parameters are counted once (via embed_params
        # below); per-application FLOPs/activations recur n_apps times.
        layers.append((LayerStats(
            params=0, active_params=0, flops_fwd=shared.flops_fwd,
            act_bytes=shared.act_bytes,
            workspace_bytes=shared.workspace_bytes), n_apps))
        shared_params = shared.params
    elif cfg.is_moe:
        total_ff = cfg.d_ff * cfg.n_experts
        active_ff = cfg.d_ff * cfg.experts_per_token
        if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
            layers.append((_dense_layer(cfg, seq_len, True, total_ff,
                                        active_ff), cfg.n_layers // 2))
            layers.append((_dense_layer(cfg, seq_len, False, total_ff,
                                        active_ff),
                           cfg.n_layers - cfg.n_layers // 2))
        else:
            local = cfg.attn_kind == AttnKind.SLIDING
            layers.append((_dense_layer(cfg, seq_len, local, total_ff,
                                        active_ff), cfg.n_layers))
    else:
        if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
            layers.append((_dense_layer(cfg, seq_len, True, cfg.d_ff,
                                        cfg.d_ff), cfg.n_layers // 2))
            layers.append((_dense_layer(cfg, seq_len, False, cfg.d_ff,
                                        cfg.d_ff),
                           cfg.n_layers - cfg.n_layers // 2))
        else:
            local = cfg.attn_kind == AttnKind.SLIDING
            layers.append((_dense_layer(cfg, seq_len, local, cfg.d_ff,
                                        cfg.d_ff), cfg.n_layers))

    embed = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed *= 2
    embed += cfg.d_model   # final norm
    if cfg.frontend_dim:
        embed += cfg.frontend_dim * cfg.d_model   # frontend projector
    if cfg.is_hybrid:
        embed += shared_params
    return ModelStats(name=cfg.name, layers=layers, embed_params=embed,
                      seq_len=seq_len, d_model=cfg.d_model,
                      vocab_size=cfg.vocab_size)


def param_count(cfg: ArchConfig) -> int:
    return build_model_stats(cfg, 1).total_params
