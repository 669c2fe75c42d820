"""Mamba2 block — State Space Duality (SSD), chunked parallel form.

The port of ``repro.models.layers.ssd``: the Mamba2 (arXiv:2405.21060)
block

    in_proj → [z | x | B | C | dt] → causal depthwise conv (x,B,C) → SSD →
    gated RMSNorm → out_proj

with the SSD recurrence per head (state ``h ∈ R^{P×N}``)

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = h_t · C_t + D · x_t

:func:`ssd_apply` runs the scan, from zero or from a given state, through
``kernels.ssd_scan.ops.ssd_scan`` (the CUDA kernel on CUDA tensors, its
plain version on the CPU) and keeps the scan's real final state for the
cache.  :func:`ssd_decode_step` is the one-token recurrence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers.init_utils import dense_init
from repro_torch.models.layers.norms import rmsnorm_apply, rmsnorm_init


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_inner: int
    n_state: int          # N
    head_dim: int         # P
    chunk: int = 256      # the config's; the CUDA kernel tiles at 64
    conv_width: int = 4

    @property
    def heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_state


def ssd_init(generator: torch.Generator, spec: SSMSpec,
             device: torch.device | str = "cuda") -> dict:
    """Random fp32 parameters with the JAX package's names, shapes and
    distributions."""
    h = spec.heads
    proj_out = 2 * spec.d_inner + 2 * spec.n_state + h
    f32 = dict(dtype=torch.float32, device=device)
    dt_bias = torch.empty((h,), **f32).uniform_(-4.0, -1.0,
                                                generator=generator)
    return {
        "in_proj": dense_init(generator, (spec.d_model, proj_out),
                              device=device),
        "conv_w": dense_init(generator, (spec.conv_width, spec.conv_dim),
                             fan_in=spec.conv_width, device=device),
        "conv_b": torch.zeros((spec.conv_dim,), **f32),
        "dt_bias": dt_bias,
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "gate_norm": rmsnorm_init(spec.d_inner, device),
        "out_proj": dense_init(generator, (spec.d_inner, spec.d_model),
                               device=device),
    }


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------

def _split_proj(proj: torch.Tensor, spec: SSMSpec):
    di = spec.d_inner
    z = proj[..., :di]
    xbc = proj[..., di: di + spec.conv_dim]
    dt = proj[..., di + spec.conv_dim:]
    assert dt.shape[-1] == spec.heads
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq.  xbc: (B,L,Cd); w: (W,Cd).
    Returns (silu(out), new_state), the state being the last W-1 inputs.

    A sum of W shifted products, as the JAX package writes it, and not
    ``F.conv1d``: on the card a float32 convolution goes through cuDNN in
    TF32 by default."""
    width = w.shape[0]
    seq = xbc.shape[1]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
    full = torch.cat([state, xbc], dim=1)
    out = full[:, 0:seq] * w[0]
    for i in range(1, width):
        out = out + full[:, i: i + seq] * w[i]
    out = out + bias.to(out.dtype)
    new_state = full[:, -(width - 1):]
    return F.silu(out), new_state


def ssd_apply(params: dict, x: torch.Tensor, spec: SSMSpec,
              h0: Optional[torch.Tensor] = None,
              conv0: Optional[torch.Tensor] = None):
    """Full Mamba2 block over a sequence.  x: (B, L, D).
    Returns (y, (ssm_state, conv_state))."""
    dtype = x.dtype
    proj = x @ params["in_proj"].to(dtype)
    z, xbc, dt_raw = _split_proj(proj, spec)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"].to(dtype),
                                   params["conv_b"], conv0)
    xs = xbc[..., : spec.d_inner]
    b = xbc[..., spec.d_inner: spec.d_inner + spec.n_state]
    c = xbc[..., spec.d_inner + spec.n_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xh = xs.unflatten(-1, (spec.heads, spec.head_dim))   # (B,L,H,P) view
    # kernel layout: x (B,H,L,P), dt (B,H,L), views of the same storage
    y, hT = ssd_ops.ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), a, b,
                             c, h0)
    y = y.transpose(1, 2)                                # (B,L,H,P)
    y = y + params["d_skip"][:, None] * xh.float()
    y = y.reshape(*xs.shape[:-1], spec.d_inner).to(dtype)
    y = rmsnorm_apply(params["gate_norm"], y * F.silu(z))
    out = y @ params["out_proj"].to(dtype)
    return out, (hT, conv_state)


def ssd_decode_step(params: dict, x: torch.Tensor, spec: SSMSpec,
                    h: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrent step.  x: (B, 1, D);
    h: (B,H,P,N); conv_state: (B, W-1, conv_dim)."""
    dtype = x.dtype
    proj = x @ params["in_proj"].to(dtype)
    z, xbc, dt_raw = _split_proj(proj, spec)
    w = params["conv_w"].to(dtype)
    full = torch.cat([conv_state, xbc], dim=1)             # (B, W, Cd)
    conv_out = torch.einsum("bwc,wc->bc", full, w) + \
        params["conv_b"].to(dtype)
    conv_out = F.silu(conv_out)[:, None]
    new_conv = full[:, 1:]
    xs = conv_out[..., : spec.d_inner]
    b = conv_out[..., spec.d_inner: spec.d_inner + spec.n_state]
    c = conv_out[..., spec.d_inner + spec.n_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xh = xs.reshape(xs.shape[0], spec.heads, spec.head_dim)
    dt1 = dt[:, 0]                                         # (B,H)
    decay = torch.exp(dt1 * a)[..., None, None]
    upd = dt1[..., None, None] * xh.float()[..., :, None] \
        * b[:, 0][:, None, None, :].float()
    h_new = h * decay + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c[:, 0].float())
    y = y + params["d_skip"][:, None] * xh.float()
    y = y.reshape(x.shape[0], 1, spec.d_inner).to(dtype)
    y = rmsnorm_apply(params["gate_norm"], y * F.silu(z))
    out = y @ params["out_proj"].to(dtype)
    return out, (h_new, new_conv)
