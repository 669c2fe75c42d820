"""Gemma 2 9B — local/global alternating attention + logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  [arXiv:2408.00118]
Local layers use a 4096-token sliding window; global layers attend fully.
Attention logits capped at 50, final logits at 30.
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

GEMMA2_9B = register_arch(ArchConfig(
    name="gemma2-9b",
    arch_type=ArchType.DENSE,
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_kind=AttnKind.LOCAL_GLOBAL,
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    mlp_kind="geglu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
))
