"""Feed-forward blocks: SwiGLU, GeGLU, and classic GELU MLP.

Both GELUs are the tanh approximation, as in ``repro.models.layers.mlp``.
Under tensor-parallel serving (a ``TensorAxis``) ``w_gate``, ``w_up`` and
``b_up`` are split by ``d_ff`` and ``w_down`` by rows: each rank's
partial product, then one sum over the ranks; ``b_down`` is whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.init_utils import dense_init


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             device: torch.device | str = "cuda") -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, (d_model, d_ff), device=device),
            "w_up": dense_init(generator, (d_model, d_ff), device=device),
            "w_down": dense_init(generator, (d_ff, d_model), device=device),
        }
    if kind == "gelu":
        return {
            "w_up": dense_init(generator, (d_model, d_ff), device=device),
            "b_up": torch.zeros((d_ff,), dtype=torch.float32, device=device),
            "w_down": dense_init(generator, (d_ff, d_model), device=device),
            "b_down": torch.zeros((d_model,), dtype=torch.float32,
                                  device=device),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_apply(params: dict, x: torch.Tensor, kind: str, tp=None,
              d_ff: int = 0) -> torch.Tensor:
    """The block over ``x``; with ``tp`` (a ``TensorAxis``) ``params`` are
    this rank's shards of a block of ``d_ff``, summed over the ranks where
    the rule splits ``d_ff``."""
    dtype = x.dtype
    split = tp is not None and params["w_down"].shape[-2] < d_ff
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w_gate"].to(dtype)
        up = x @ params["w_up"].to(dtype)
        act = F.silu(gate) if kind == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        y = (act * up) @ params["w_down"].to(dtype)
        return tp.sum_partials(y) if split else y
    h = x @ params["w_up"].to(dtype) + params["b_up"].to(dtype)
    h = F.gelu(h, approximate="tanh")
    y = h @ params["w_down"].to(dtype)
    if split:
        y = tp.sum_partials(y)
    return y + params["b_down"].to(dtype)
