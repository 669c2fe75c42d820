"""Zamba2 7B — hybrid: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242]

A single *shared-weight* attention+MLP block is applied every
``hybrid_attn_every`` Mamba2 blocks (shared parameters, per-application KV
caches).  This breaks the paper's "all layers identical" profiling shortcut;
the cost model profiles block types separately (DESIGN.md §7.5).
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

ZAMBA2_7B = register_arch(ArchConfig(
    name="zamba2-7b",
    arch_type=ArchType.HYBRID,
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    attn_kind=AttnKind.FULL,   # the shared block's attention is full
    mlp_kind="geglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_attn_every=6,
))
