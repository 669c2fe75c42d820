"""Yi-34B — dense llama-architecture GQA model.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  [arXiv:2403.04652]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

YI_34B = register_arch(ArchConfig(
    name="yi-34b",
    arch_type=ArchType.DENSE,
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attn_kind=AttnKind.FULL,
    rope_theta=5e6,
    mlp_kind="swiglu",
))
