"""Mamba2 370M — attention-free state-space model (SSD).

48L d_model=1024, ssm_state=128, expand=2, head_dim=64.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

MAMBA2_370M = register_arch(ArchConfig(
    name="mamba2-370m",
    arch_type=ArchType.SSM,
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_kind=AttnKind.NONE,
    mlp_kind="swiglu",     # unused (no MLP blocks); SSD block carries gating
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    norm_eps=1e-5,
))
