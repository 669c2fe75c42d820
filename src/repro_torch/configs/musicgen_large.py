"""MusicGen Large — decoder-only transformer over EnCodec audio tokens.

48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=2048.
[arXiv:2306.05284]

The EnCodec conv codec frontend is a stub: for conditioning, the caller
passes precomputed frame embeddings (``frontend_embed`` of ``prefill`` and
of the loss batch); the decoder itself consumes/predicts EnCodec codebook
tokens (vocab 2048).
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

MUSICGEN_LARGE = register_arch(ArchConfig(
    name="musicgen-large",
    arch_type=ArchType.AUDIO,
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    attn_kind=AttnKind.FULL,
    mlp_kind="gelu",
    frontend_dim=1536,   # conditioning embeddings from the stubbed codec/T5
))
