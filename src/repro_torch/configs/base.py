"""Architecture configuration system (the port's own copy).

Every selectable architecture (``--arch <id>``) is one ``ArchConfig``
instance in its own module under ``repro_torch/configs/``.  Configs are
pure data: model construction happens in :mod:`repro_torch.models`.  The
fields, their defaults and :meth:`ArchConfig.reduced` are identical to the
JAX package's ``repro.configs.base``, so that the two packages build the
same shapes from the same name.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Sequence, Tuple

import torch


class ArchType(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"
    ENCODER = "encoder"   # paper models (BERT/ViT) — no decode step


class AttnKind(str, enum.Enum):
    FULL = "full"
    SLIDING = "sliding"               # all layers sliding-window
    LOCAL_GLOBAL = "local_global"     # gemma2-style alternating
    NONE = "none"                     # attention-free (SSM)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Complete, static description of one architecture."""

    name: str
    arch_type: ArchType
    source: str                       # citation: arXiv id or hf model card

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 → d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    # attention flavour
    attn_kind: AttnKind = AttnKind.FULL
    window: int = 4096                # sliding-window size when applicable
    logit_softcap: float = 0.0        # gemma2 attn softcap (0 = off)
    final_softcap: float = 0.0        # gemma2 final-logit softcap
    rope_theta: float = 10_000.0
    causal: bool = True

    # MLP flavour
    mlp_kind: str = "swiglu"          # swiglu | geglu | gelu (encoder)

    # MoE
    n_experts: int = 0                # 0 → dense MLP
    experts_per_token: int = 0
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0                # N (state size); 0 → no ssm layers
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # Hybrid (zamba2): one shared attention block applied every k ssm blocks
    hybrid_attn_every: int = 0        # 0 → not hybrid

    # Modality frontend stub (vlm / audio): inputs are precomputed embeddings
    frontend_dim: int = 0             # embedding dim delivered by the stub

    # norms / misc
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm (encoders)
    post_norm: bool = False           # gemma2-style post-sublayer norms
    embed_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    learned_pos: bool = False         # encoder absolute position embeddings
    max_seq: int = 8192               # only for learned_pos tables
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # --- derived ---------------------------------------------------------
    @property
    def has_attention(self) -> bool:
        return self.attn_kind != AttnKind.NONE

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.hybrid_attn_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.hybrid_attn_every > 0

    @property
    def has_decode(self) -> bool:
        return self.arch_type != ArchType.ENCODER

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def supports_long_context(self) -> bool:
        """True if the 524288-token decode shape is runnable: state/KV
        footprint must not be linear-in-context for *every* layer."""
        if not self.has_decode:
            return False
        if self.ssm_state > 0:
            return True                       # SSM / hybrid
        return self.attn_kind in (AttnKind.SLIDING, AttnKind.LOCAL_GLOBAL)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ArchConfig":
        """CPU-smoke-test variant of the same family (≤4 experts etc.)."""
        head_dim = 64
        n_heads = max(1, min(self.n_heads, d_model // head_dim)) \
            if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if self.n_heads else 0
        if self.n_kv_heads == 1:
            n_kv = 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim if n_heads else 0,
            d_ff=(4 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, vocab),
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            window=128 if self.attn_kind != AttnKind.FULL else self.window,
            hybrid_attn_every=min(self.hybrid_attn_every, 2)
            if self.hybrid_attn_every else 0,
            frontend_dim=d_model if self.frontend_dim else 0,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch, shape) pair per DESIGN.md §4."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention stack: 500k-token decode "
                       "requires sub-quadratic attention (DESIGN.md §4)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins: tensors on the ``meta`` device (a shape and
    a dtype, no storage) where the JAX package has ``ShapeDtypeStruct``.

    * train / prefill: token ids (+labels/weights for train).  VLM/audio
      archs also get precomputed frontend embeddings (the modality
      frontend is a stub).
    * decode: one new token per sequence + position index (KV cache /
      SSM state is threaded separately as carry state).

    Token ids and positions are int32, as in the JAX package (the port's
    own entry points take int64 ids; the stand-ins keep the reference's
    types).
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    i32 = torch.int32
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind == "train":
        specs = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32),
                 "weights": spec((b, s), torch.float32)}
        if cfg.frontend_dim:
            specs["frontend_embed"] = spec((b, s, cfg.frontend_dim), act)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": spec((b, s), i32)}
        if cfg.frontend_dim:
            specs["frontend_embed"] = spec((b, s, cfg.frontend_dim), act)
        return specs
    return {"tokens": spec((b, 1), i32), "positions": spec((b,), i32)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCHS: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCHS)}") from None


def list_archs(assigned_only: bool = False) -> Sequence[str]:
    _ensure_loaded()
    names = sorted(_ARCHS)
    if assigned_only:
        names = [n for n in names if _ARCHS[n].arch_type != ArchType.ENCODER
                 and not n.endswith("-smoke") and n in ASSIGNED]
    return names


#: The 10 assigned architectures (public-pool assignment for this paper).
ASSIGNED = (
    "mixtral-8x7b", "pixtral-12b", "mamba2-370m", "yi-34b", "gemma-2b",
    "gemma2-9b", "musicgen-large", "stablelm-1.6b", "qwen3-moe-30b-a3b",
    "zamba2-7b",
)

_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every config module the port has once so registrations run
    from repro_torch.configs import (gemma2_9b, gemma_2b,  # noqa: F401
                                     mamba2_370m, mixtral_8x7b,
                                     musicgen_large, paper_models,
                                     pixtral_12b, qwen3_moe_30b_a3b,
                                     stablelm_1_6b, yi_34b, zamba2_7b)
