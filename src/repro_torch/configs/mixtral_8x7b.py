"""Mixtral 8x7B — sparse MoE with sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
SWA window 4096.  [arXiv:2401.04088]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

MIXTRAL_8X7B = register_arch(ArchConfig(
    name="mixtral-8x7b",
    arch_type=ArchType.MOE,
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attn_kind=AttnKind.SLIDING,
    window=4096,
    rope_theta=1e6,
    mlp_kind="swiglu",
    n_experts=8,
    experts_per_token=2,
))
