"""Model FLOPs of a training step: the work the model's forward and
backward need, recomputation not counted.

Per token: 6 times the weights the token multiplies (every projection,
the depthwise conv and the output head; the embedding lookup is no
product), plus the mixer's own work forward and backward (three times
the forward): causal attention, 4 d operations a kept (query, key) pair
and head; or the SSD scan in its chunked form at the model's chunk ``Q``,
``2 pairs (N + P) + 4 Q P N`` a chunk and head.
"""

from __future__ import annotations

from typing import Any, Dict


def weights_multiplied(model: Dict[str, Any], family: str) -> int:
    """The weights one token multiplies, over all layers and the head."""
    d, L, V = model["d_model"], model["n_layers"], model["vocab_size"]
    if family == "dense":
        H, KV, D, F = (model["n_heads"], model["n_kv_heads"],
                       model["head_dim"], model["d_ff"])
        mlp = (3 if model["mlp_kind"] in ("swiglu", "geglu") else 2) * d * F
        per_layer = d * D * (2 * H + 2 * KV) + mlp
    elif family == "mamba2":
        di = model["ssm_expand"] * d
        P, N = model["ssm_head_dim"], model["ssm_state"]
        H = di // P
        conv = di + 2 * N
        per_layer = (d * (2 * di + 2 * N + H) + di * d
                     + model["ssm_conv_width"] * conv)
    else:
        raise KeyError(f"no model FLOPs for family {family!r}")
    return L * per_layer + d * V


def mixer_per_token(model: Dict[str, Any], family: str, seq: int) -> float:
    """The mixer's FLOPs a token, forward and backward."""
    L = model["n_layers"]
    if family == "dense":
        # causal pairs / seq = (seq + 1) / 2 a token
        return 3 * 4.0 * L * model["n_heads"] * model["head_dim"] \
            * (seq + 1) / 2
    if family == "mamba2":
        di = model["ssm_expand"] * model["d_model"]
        P, N, Q = model["ssm_head_dim"], model["ssm_state"], \
            model["ssm_chunk"]
        per_chunk = 2 * (Q * (Q + 1) // 2) * (N + P) + 4 * Q * P * N
        return 3.0 * L * (di // P) * per_chunk / Q
    raise KeyError(f"no model FLOPs for family {family!r}")


def per_token(config: Dict[str, Any], seq: int) -> float:
    model, family = config["model"], config["family"]
    return 6.0 * weights_multiplied(model, family) \
        + mixer_per_token(model, family, seq)
