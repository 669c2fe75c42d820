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

Under tensor-parallel serving (a ``TensorAxis``, the serving rules of
``launch.serving``) the state ``h`` is split by heads, so a rank scans its
heads (the kernel at H/n); ``in_proj``, ``conv_w`` and ``conv_b`` are
split by their last dim, which lines up neither with the ``[z, x, B, C,
dt]`` segments nor with the heads, so the layer gathers them for its
duration, or for a few tokens (a decode step) the projection's columns
instead (:func:`_proj_conv`); the conv cache is split by channels,
gathered for the layer and the rank's channels kept; ``out_proj`` is
split by ``d_inner`` rows, which match the heads: a partial product, then
a sum over the ranks; the gated norm over ``d_inner`` sums its squares
over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers.init_utils import dense_init
from repro_torch.models.layers.norms import rmsnorm_apply, rmsnorm_init

#: the gated norm's epsilon (``rmsnorm_apply``'s default, as the JAX
#: package's)
_NORM_EPS = 1e-6


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


def _heads(spec: SSMSpec, tp) -> slice:
    """The heads a rank scans: its block where the rule splits them, else
    every head."""
    if tp is not None and tp.splits(spec.heads):
        return tp.block(spec.heads)
    return slice(0, spec.heads)


def _step_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               state: torch.Tensor):
    """The causal conv's step for one token: xbc (B, 1, C), state (B,
    W-1, C).  Returns (silu(out) (B, 1, C), new state)."""
    full = torch.cat([state, xbc], dim=1)                  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", full, w) + bias.to(w.dtype)
    return F.silu(out)[:, None], full[:, 1:]


def _proj_conv(params: dict, x: torch.Tensor, spec: SSMSpec, tp,
               conv0: Optional[torch.Tensor], step: bool):
    """``in_proj`` and the causal conv (``_step_conv`` for one token, else
    ``_causal_conv`` from ``conv0`` or zero): (z, xbc after the conv, dt,
    the new conv state), each whole but the conv state, which is the
    rank's channels where ``tp`` splits them (``conv0`` too).

    With ``tp`` the layer makes the projection and the conv whole in one
    all-gather a dtype: ``conv_w``, ``conv_b`` and ``conv0``, beside
    whichever moves fewer bytes, ``in_proj`` (at least ``d_model``
    tokens: a prefill) or the rank's columns of the projection (fewer: a
    decode step)."""
    dtype = x.dtype
    conv = _step_conv if step else _causal_conv
    proj_out = 2 * spec.d_inner + 2 * spec.n_state + spec.heads
    few = tp is not None and x.shape[0] * x.shape[1] < x.shape[-1]
    in_proj, w, bias = params["in_proj"], params["conv_w"], params["conv_b"]
    items = [(x @ in_proj.to(dtype) if few else in_proj, -1, proj_out),
             (w, -1, spec.conv_dim), (bias, -1, spec.conv_dim)]
    if conv0 is not None:
        items.append((conv0, -1, spec.conv_dim))
    got = tp.wholes(items) if tp is not None else [t for t, _, _ in items]
    proj = got[0] if few else x @ got[0].to(dtype)
    z, xbc, dt_raw = _split_proj(proj, spec)
    out, state = conv(xbc, got[1].to(dtype), got[2],
                      got[3] if conv0 is not None else None)
    if tp is not None and tp.splits(spec.conv_dim):
        state = state[..., tp.block(spec.conv_dim)]
    return z, out, dt_raw, state


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor,
               spec: SSMSpec, tp, heads: slice) -> torch.Tensor:
    """Gated RMSNorm of ``y`` (..., heads x P) against the whole gate ``z``,
    then ``out_proj``.  Where ``y`` holds some of the heads, the norm's
    sum of squares is summed over the ranks; where ``out_proj`` is split
    by rows, the rank's rows of the normed ``y`` give a partial product,
    summed over the ranks."""
    dtype = y.dtype
    cols = slice(heads.start * spec.head_dim, heads.stop * spec.head_dim)
    g = y * F.silu(z[..., cols])
    if cols.stop - cols.start < spec.d_inner:
        g32 = g.float()
        var = tp.sum(g32.square().sum(dim=-1, keepdim=True)) / spec.d_inner
        scale = params["gate_norm"]["scale"][cols]
        g = (g32 * torch.rsqrt(var + _NORM_EPS) * (1.0 + scale)).to(dtype)
    else:
        g = rmsnorm_apply(params["gate_norm"], g, eps=_NORM_EPS)
    w = params["out_proj"]
    if w.shape[0] == spec.d_inner:
        return g @ w.to(dtype)
    rows = tp.block(spec.d_inner)
    g = g[..., rows.start - cols.start: rows.stop - cols.start]
    return tp.sum_partials(g @ w.to(dtype))


def ssd_apply(params: dict, x: torch.Tensor, spec: SSMSpec,
              h0: Optional[torch.Tensor] = None,
              conv0: Optional[torch.Tensor] = None, tp=None):
    """Full Mamba2 block over a sequence.  x: (B, L, D).
    Returns (y, (ssm_state, conv_state)).  With ``tp`` (a ``TensorAxis``)
    ``params`` are this rank's shards: it scans its heads (``h0`` and the
    returned state over them) from the whole projection
    (:func:`_proj_conv`); ``conv0`` and the returned conv state are the
    conv state's channels the rule gives it."""
    dtype = x.dtype
    z, xbc, dt_raw, conv_state = _proj_conv(params, x, spec, tp, conv0,
                                            step=False)
    xs = xbc[..., : spec.d_inner]
    b = xbc[..., spec.d_inner: spec.d_inner + spec.n_state]
    c = xbc[..., spec.d_inner + spec.n_state:]
    heads = _heads(spec, tp)
    dt = F.softplus(dt_raw[..., heads].float()
                    + params["dt_bias"][heads].float())
    a = -torch.exp(params["a_log"][heads].float())
    xh = xs.unflatten(-1, (spec.heads, spec.head_dim))[:, :, heads]
    # kernel layout: x (B,H,L,P), dt (B,H,L), views of the same storage
    y, hT = ssd_ops.ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), a, b,
                             c, h0)
    y = y.transpose(1, 2)                                # (B,L,H,P)
    y = y + params["d_skip"][heads, None] * xh.float()
    y = y.flatten(-2).to(dtype)
    out = _gated_out(params, y, z, spec, tp, heads)
    return out, (hT, conv_state)


def ssd_decode_step(params: dict, x: torch.Tensor, spec: SSMSpec,
                    h: torch.Tensor, conv_state: torch.Tensor, tp=None):
    """One-token recurrent step.  x: (B, 1, D);
    h: (B,H,P,N); conv_state: (B, W-1, conv_dim).  With ``tp`` (a
    ``TensorAxis``) the params, ``h`` and ``conv_state`` are this rank's
    shards (:func:`_proj_conv`), and its heads' new ``h`` and its
    channels of the new conv state are returned."""
    dtype = x.dtype
    z, conv_out, dt_raw, new_conv = _proj_conv(params, x, spec, tp,
                                               conv_state, step=True)
    xs = conv_out[..., : spec.d_inner]
    b = conv_out[..., spec.d_inner: spec.d_inner + spec.n_state]
    c = conv_out[..., spec.d_inner + spec.n_state:]
    heads = _heads(spec, tp)
    dt = F.softplus(dt_raw[..., heads].float()
                    + params["dt_bias"][heads].float())
    a = -torch.exp(params["a_log"][heads].float())
    xh = xs.reshape(xs.shape[0], spec.heads, spec.head_dim)[:, heads]
    dt1 = dt[:, 0]                                         # (B,H)
    decay = torch.exp(dt1 * a)[..., None, None]
    upd = dt1[..., None, None] * xh.float()[..., :, None] \
        * b[:, 0][:, None, None, :].float()
    h_new = h * decay + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c[:, 0].float())
    y = y + params["d_skip"][heads, None] * xh.float()
    y = y.reshape(x.shape[0], 1, -1).to(dtype)
    out = _gated_out(params, y, z, spec, tp, heads)
    return out, (h_new, new_conv)
