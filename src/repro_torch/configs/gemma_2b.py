"""Gemma 2B — dense, GeGLU, MQA (kv=1), head_dim=256.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.  [arXiv:2403.08295]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

GEMMA_2B = register_arch(ArchConfig(
    name="gemma-2b",
    arch_type=ArchType.DENSE,
    source="arXiv:2403.08295",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    attn_kind=AttnKind.FULL,
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
))
