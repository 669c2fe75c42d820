"""Plain reference of the Mamba-2 model (family ``mamba2``,
arXiv:2405.21060), written from its equations.

Per layer, on the residual stream ``x`` (tokens x d_model), with
``d_inner = ssm_expand d_model``, ``H = d_inner / ssm_head_dim`` heads of
``P = ssm_head_dim`` and state size ``N = ssm_state`` (one group)::

    h = rmsnorm(x) (1 + ln)                            eps: norm_eps
    [z | xBC | dt] = h in_proj
    xBC = silu(causal depthwise conv of width ssm_conv_width + conv_b)
    [x | B | C] = xBC
    dt = softplus(dt + dt_bias);  A = -exp(a_log)
    state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T     (per head, P x N)
    y_t = state_t C_t + d_skip x_t
    x = x + rmsnorm(y silu(z)) (1 + gate_norm) out_proj    eps: gate_norm_eps

then ``logits = rmsnorm(x) (1 + final_norm) head`` (the embedding's
transpose where the model ties them) and the cross-entropy
of the next token.  The recurrence is computed exactly in its chunked
form (chunks of ``ssm_chunk``): within a chunk as the masked product of
``C B^T`` with the decays, across chunks through each chunk's state.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import leaves as LV
from perfbench.reference import common as C
from perfbench.weights import Spec, fan_in_std


def _dims(model: Dict[str, Any]):
    d = model["d_model"]
    di = model["ssm_expand"] * d
    P, N = model["ssm_head_dim"], model["ssm_state"]
    return d, di, di // P, P, N, di + 2 * N


def param_specs(model: Dict[str, Any]) -> List[Spec]:
    """The tree the port trains, with its initial distributions."""
    L = model["n_layers"]
    d, di, H, P, N, conv = _dims(model)
    W = model["ssm_conv_width"]
    s = ("stages", "0")
    return C.token_specs(model, fan_in_std(d)) + [
        (s + ("ln", "scale"), (L, d), ("zeros",)),
        (s + ("ssd", "in_proj"), (L, d, 2 * di + 2 * N + H),
         ("trunc", fan_in_std(d))),
        (s + ("ssd", "conv_w"), (L, W, conv), ("trunc", fan_in_std(W))),
        (s + ("ssd", "conv_b"), (L, conv), ("zeros",)),
        (s + ("ssd", "dt_bias"), (L, H), ("uniform", -4.0, -1.0)),
        (s + ("ssd", "a_log"), (L, H), ("log_linspace", 1.0, 16.0)),
        (s + ("ssd", "d_skip"), (L, H), ("ones",)),
        (s + ("ssd", "gate_norm", "scale"), (L, di), ("zeros",)),
        (s + ("ssd", "out_proj"), (L, di, d), ("trunc", fan_in_std(di))),
    ]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """y of the recurrence above from a zero state.  x (b, L, H, P), dt
    (b, L, H), A (H,), B and C (b, L, N); L a multiple of ``chunk``."""
    b, L, H, P = x.shape
    c, Q = L // chunk, chunk
    xd = (x * dt[..., None]).view(b, c, Q, H, P)
    a = (dt * A).view(b, c, Q, H).permute(0, 3, 1, 2)      # (b, H, c, Q)
    acs = torch.cumsum(a, dim=-1)
    Bc, Cc = B.view(b, c, Q, -1), Cm.view(b, c, Q, -1)
    # within a chunk: y_i += sum_{j<=i} exp(acs_i - acs_j) (C_i . B_j) xd_j
    seg = acs[..., :, None] - acs[..., None, :]             # (b, H, c, Q, Q)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep, float("-inf")))
    cb = Cc @ Bc.transpose(-1, -2)                          # (b, c, Q, Q)
    m = decay * cb[:, None]                                 # (b, H, c, Q, Q)
    y = torch.einsum("bhcij,bcjhp->bcihp", m, xd)
    # each chunk's own state: sum_j exp(acs_last - acs_j) xd_j B_j^T
    tail = torch.exp(acs[..., -1:] - acs)                   # (b, H, c, Q)
    own = torch.einsum("bhcj,bcjhp,bcjn->bchpn", tail, xd, Bc)
    # the state entering each chunk, and its share of the chunk's y
    whole = torch.exp(acs[..., -1])                         # (b, H, c)
    state = torch.zeros_like(own[:, 0])
    entering = []
    for k in range(c):
        entering.append(state)
        state = whole[:, :, k, None, None] * state + own[:, k]
    ent = torch.stack(entering, dim=1)                      # (b, c, H, P, N)
    y = y + torch.einsum("bcin,bchpn,bhci->bcihp", Cc, ent, torch.exp(acs))
    return y.reshape(b, L, H, P)


def _conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
          ) -> torch.Tensor:
    """Causal depthwise conv along positions: out_t = sum_i w_i u_{t-W+1+i}
    + bias, zero before position 0.  u (b, L, ch), w (W, ch)."""
    W, L = w.shape[0], u.shape[1]
    full = F.pad(u, (0, 0, W - 1, 0))
    out = bias + sum(full[:, i:i + L] * w[i] for i in range(W))
    return F.silu(out)


def _layer(x: torch.Tensor, lp: Dict[str, Any], model: Dict[str, Any],
           precision: str) -> torch.Tensor:
    b, L, _ = x.shape
    d, di, H, P, N, conv = _dims(model)
    p = lp["ssd"]
    h = C.rmsnorm(x, lp["ln"]["scale"], model["norm_eps"])
    proj = C.linear(h, p["in_proj"], precision)
    z, xbc, dt = proj.split([di, conv, H], dim=-1)
    xbc = _conv(xbc, p["conv_w"], p["conv_b"])
    xs, B, Cm = xbc.split([di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xh = xs.reshape(b, L, H, P)
    y = ssd(xh, dt, A, B, Cm, model["ssm_chunk"])
    y = (y + p["d_skip"][:, None] * xh).reshape(b, L, di)
    g = C.rmsnorm(y * F.silu(z), p["gate_norm"]["scale"],
                  model["gate_norm_eps"])
    return x + C.linear(g, p["out_proj"], precision)


def loss_sum(params: Dict[str, Any], tokens: torch.Tensor,
             labels: torch.Tensor, model: Dict[str, Any],
             precision: str) -> torch.Tensor:
    """Sum over ``tokens`` (b, s) of the cross-entropy of ``labels``."""
    x = params["embed"][tokens]
    st = params["stages"][0]
    for i in range(model["n_layers"]):
        x = checkpoint(_layer, x, LV.layer(st, i), model, precision,
                       use_reentrant=False)
    h = C.rmsnorm(x, params["final_norm"]["scale"], model["norm_eps"])
    logits = C.linear(h.reshape(-1, h.shape[-1]), C.head(params),
                      precision)
    return C.ce_sum(logits, labels.reshape(-1))
