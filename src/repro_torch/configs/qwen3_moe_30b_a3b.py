"""Qwen3-30B-A3B — fine-grained MoE: 128 experts, top-8, small expert d_ff.

48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

QWEN3_MOE_30B_A3B = register_arch(ArchConfig(
    name="qwen3-moe-30b-a3b",
    arch_type=ArchType.MOE,
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    attn_kind=AttnKind.FULL,
    rope_theta=1e6,
    mlp_kind="swiglu",
    n_experts=128,
    experts_per_token=8,
))
