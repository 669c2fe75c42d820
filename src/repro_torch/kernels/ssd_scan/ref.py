"""Plain PyTorch version of the SSD scan kernel.

The sequential state-space recurrence, one step at a time, as
``repro.kernels.ssd_scan.ref.ssd_reference``, in the kernel's layout:
x (B, H, L, P), dt (B, H, L), a (H,) negative, b/c (B, L, N).  Unlike that
oracle it also returns the final state and takes an initial one, as
``repro.models.layers.ssd.ssd_reference`` does, because serving needs them.
:func:`ssd_scan_backward_reference` is the plain version of the backward
kernel: autograd through :func:`ssd_scan_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor,
                       h0: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns y (B, H, L, P) in x's dtype and the state after the last
    step, (B, H, P, N) fp32, starting from ``h0`` (B, H, P, N) or zero.
    All arithmetic is fp32."""
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = b.float(), c.float(), a.float()
    hs = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = torch.empty((bsz, h, l, p), dtype=torch.float32, device=x.device)
    for t in range(l):
        dtt = dtf[:, :, t]                                   # (B, H)
        decay = torch.exp(dtt * af)[..., None, None]
        upd = (dtt[..., None, None] * xf[:, :, t, :, None]
               * bf[:, None, None, t, :])                    # (B, H, P, N)
        hs = hs * decay + upd
        ys[:, :, t] = torch.einsum("bhpn,bn->bhp", hs, cf[:, t])
    return ys.to(x.dtype), hs


def ssd_scan_backward_reference(x: torch.Tensor, dt: torch.Tensor,
                                a: torch.Tensor, b: torch.Tensor,
                                c: torch.Tensor, h0: Optional[torch.Tensor],
                                dy: torch.Tensor,
                                dh_final: Optional[torch.Tensor] = None,
                                ) -> Tuple[Optional[torch.Tensor], ...]:
    """The grads (dx, ddt, da, db, dc, dh0) of :func:`ssd_scan_reference`'s
    inputs for the cotangents ``dy`` of y and ``dh_final`` of the final
    state (None for zero), by autograd through it; dh0 is None without
    ``h0``.  Each grad has its input's dtype.

    For tests and for holding the kernel against it, never a main path:
    autograd keeps the step's products, about one (B, H, P, N) fp32 state
    per position, about 21 GB at B 10, H 32, L 2048, P 64, N 128."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_()
               for t in (x, dt, a, b, c, h0)]
        y, h_final = ssd_scan_reference(*ins)
        outs, cots = [y], [dy]
        if dh_final is not None:
            outs.append(h_final)
            cots.append(dh_final)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(outs, live, cots))
    return tuple(None if t is None else next(grads) for t in ins)
