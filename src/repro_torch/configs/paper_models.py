"""The paper's own evaluation models (Table 2), used by the benchmark
reproductions of Tables 4/5 and Figs 6-9.

Sequence length 512 for language models per the paper's setup (Sec. 4.1);
ViT models use 224px/16 patches → 197 tokens.
"""
from repro_torch.configs.base import (ArchConfig, ArchType, AttnKind,
                                      register_arch)

# ViTs are encoders over patch embeddings (IC task).
VIT_G = register_arch(ArchConfig(
    name="vit-g", arch_type=ArchType.ENCODER, source="Zhai et al. 2022",
    n_layers=48, d_model=1664, n_heads=16, head_dim=104, n_kv_heads=16,
    d_ff=8192, vocab_size=1000, attn_kind=AttnKind.FULL, causal=False,
    mlp_kind="gelu", norm_kind="layernorm", learned_pos=True, max_seq=256,
    frontend_dim=1664))

VIT_E = register_arch(ArchConfig(
    name="vit-e", arch_type=ArchType.ENCODER, source="Chen et al. 2022 (PaLI)",
    n_layers=56, d_model=1792, n_heads=16, head_dim=112, n_kv_heads=16,
    d_ff=15360, vocab_size=1000, attn_kind=AttnKind.FULL, causal=False,
    mlp_kind="gelu", norm_kind="layernorm", learned_pos=True, max_seq=256,
    frontend_dim=1792))

BERT_LARGE = register_arch(ArchConfig(
    name="bert-large", arch_type=ArchType.ENCODER, source="Devlin et al. 2018",
    n_layers=24, d_model=1024, n_heads=16, head_dim=64, n_kv_heads=16,
    d_ff=4096, vocab_size=30522, attn_kind=AttnKind.FULL, causal=False,
    mlp_kind="gelu", norm_kind="layernorm", learned_pos=True, max_seq=512))

BERT_XLARGE = register_arch(ArchConfig(
    name="bert-xlarge", arch_type=ArchType.ENCODER, source="Devlin et al. 2018",
    n_layers=36, d_model=1536, n_heads=24, head_dim=64, n_kv_heads=24,
    d_ff=6144, vocab_size=30522, attn_kind=AttnKind.FULL, causal=False,
    mlp_kind="gelu", norm_kind="layernorm", learned_pos=True, max_seq=512))

GPT_1_3B = register_arch(ArchConfig(
    name="gpt-1.3b", arch_type=ArchType.DENSE, source="Brown et al. 2020",
    n_layers=24, d_model=2048, n_heads=32, head_dim=64, n_kv_heads=32,
    d_ff=8192, vocab_size=50257, attn_kind=AttnKind.FULL, mlp_kind="gelu"))

GPT_2_7B = register_arch(ArchConfig(
    name="gpt-2.7b", arch_type=ArchType.DENSE, source="Brown et al. 2020",
    n_layers=32, d_model=2560, n_heads=80, head_dim=32, n_kv_heads=80,
    d_ff=10240, vocab_size=50257, attn_kind=AttnKind.FULL, mlp_kind="gelu"))

GPT_6_7B = register_arch(ArchConfig(
    name="gpt-6.7b", arch_type=ArchType.DENSE, source="Brown et al. 2020",
    n_layers=32, d_model=4096, n_heads=128, head_dim=32, n_kv_heads=128,
    d_ff=16384, vocab_size=50257, attn_kind=AttnKind.FULL, mlp_kind="gelu"))

TINY_LLAMA = register_arch(ArchConfig(
    name="tiny-llama", arch_type=ArchType.DENSE, source="Zhang et al. 2024a",
    n_layers=22, d_model=2048, n_heads=32, head_dim=64, n_kv_heads=4,
    d_ff=5632, vocab_size=32000, attn_kind=AttnKind.FULL, mlp_kind="swiglu"))

LLAMA_3B = register_arch(ArchConfig(
    name="llama-3b", arch_type=ArchType.DENSE, source="Geng & Liu 2023",
    n_layers=26, d_model=3200, n_heads=32, head_dim=100, n_kv_heads=32,
    d_ff=8640, vocab_size=32000, attn_kind=AttnKind.FULL, mlp_kind="swiglu"))

LLAMA_7B = register_arch(ArchConfig(
    name="llama-7b", arch_type=ArchType.DENSE, source="Touvron et al. 2023",
    n_layers=32, d_model=4096, n_heads=32, head_dim=128, n_kv_heads=32,
    d_ff=11008, vocab_size=32000, attn_kind=AttnKind.FULL, mlp_kind="swiglu"))

#: Paper Sec 4.1: sequence length 512 for language modeling; 197 for ViTs.
PAPER_SEQ_LEN = {
    "vit-g": 197, "vit-e": 197,
}


def paper_seq_len(name: str) -> int:
    return PAPER_SEQ_LEN.get(name, 512)
