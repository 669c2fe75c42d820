"""StableLM 2 1.6B — dense decoder, MHA (kv=32).

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

STABLELM_1_6B = register_arch(ArchConfig(
    name="stablelm-1.6b",
    arch_type=ArchType.DENSE,
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    attn_kind=AttnKind.FULL,
    mlp_kind="swiglu",
))
