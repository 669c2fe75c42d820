"""Pixtral 12B — VLM decoder backbone (Mistral-NeMo-style) consuming
Pixtral-ViT patch embeddings.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409]

The vision frontend (Pixtral-ViT + projector) is a stub: the caller passes
precomputed patch embeddings at ``frontend_dim`` (``frontend_embed`` of
``prefill`` and of the loss batch).
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

PIXTRAL_12B = register_arch(ArchConfig(
    name="pixtral-12b",
    arch_type=ArchType.VLM,
    source="hf:mistralai/Pixtral-12B-2409",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    attn_kind=AttnKind.FULL,
    rope_theta=1e9,   # mistral-nemo long-context rope base
    mlp_kind="swiglu",
    frontend_dim=1024,   # pixtral-ViT hidden size delivered by the stub
))
