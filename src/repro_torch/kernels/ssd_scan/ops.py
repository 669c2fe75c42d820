"""Public wrapper around the CUDA SSD scan kernel.

The device of the tensors picks the path, with no option: CPU tensors go
to the plain PyTorch version (:mod:`.ref`), CUDA tensors launch a kernel
of ``csrc/ssd_scan.cu`` or raise on what it does not take.  There is no
fallback from a kernel to the plain version.  The dtype picks the kernel:
bf16 runs on tensor cores (``bf16-mma``), fp32 on scalar FMAs
(``fp32-fma``); both take the same shapes and strides.  The kernels mask
a ragged L themselves, so unlike the TPU wrapper nothing is padded; they
read through the strides they are given, so the column slices and
transposed views that ``models.layers.ssd.ssd_apply`` passes are not
copied.

Where grad mode is on and an input requires grad, CUDA tensors go through
:class:`SSDScan`, a ``torch.autograd.Function``: its forward launches the
forward kernel, and its backward a kernel of ``csrc/ssd_scan_bwd.cu``, or
raises; it never takes the plain version.  The dtype picks the backward
kernel as it picks the forward's: bf16 runs ``ssd_scan_bwd_kernel_mma``
on tensor cores (``bf16-mma``; its fp32 operands split into bf16 hi + lo),
fp32 the scalar ``ssd_scan_bwd_kernel`` (``fp32-fma``).  CPU tensors take
the plain version through plain autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_reference

#: Launches of the CUDA kernels (not of the plain version) since import or
#: since a caller last reset it.
LAUNCHES = 0
#: The same launches by kernel variant.
VARIANT_LAUNCHES = {"fp32-fma": 0, "bf16-mma": 0}
#: The same launches by their head count H.
HEAD_LAUNCHES: dict = {}
#: Launches of the backward kernel, apart from the forward ones above.
BWD_LAUNCHES = 0
#: The backward's launches by kernel variant.
BWD_VARIANT_LAUNCHES = {"fp32-fma": 0, "bf16-mma": 0}

HEAD_DIMS = (32, 64)               # P instantiated in the kernel
STATE_DIMS = (16, 32, 64, 128)     # N instantiated in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}
BWD_VARIANTS = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}
CHUNK = 64                         # positions per chunk of both kernels
_FN = None
_BWD_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("ssd_scan").ssd_scan_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 13
                       + [ctypes.c_int, ctypes.c_void_p])
        _FN = fn
    return _FN


def _bwd_kernel_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = build.load("ssd_scan_bwd").ssd_scan_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
        _BWD_FN = fn
    return _BWD_FN


def _copy_width(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> int:
    """Elements per copy of the bf16 kernel's staging: the largest of 8
    (16 B), 4, 2 that divides the data pointers of x, b, c and their
    B/H/L strides, else 1 (plain loads).  The model's views (column slices
    of one (B, L, d_inner + 2N) tensor) take 8."""
    bits = 0
    for t, strides in ((x, x.stride()[:3]), (b, b.stride()[:2]),
                       (c, c.stride()[:2])):
        bits |= t.data_ptr() // t.element_size()
        for s in strides:
            bits |= s
    for vec in (8, 4, 2):
        if bits % vec == 0:
            return vec
    return 1


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor,
           h0: Optional[torch.Tensor] = None) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 \
            or c.dim() != 3:
        raise ValueError("ssd_scan wants x (B, H, L, P), dt (B, H, L), "
                         "a (H,), b and c (B, L, N)")
    bsz, h, l, p = x.shape
    n = b.shape[2]
    if tuple(dt.shape) != (bsz, h, l) or tuple(a.shape) != (h,) \
            or tuple(b.shape) != (bsz, l, n) or c.shape != b.shape:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, b, c in float32 or "
                        f"bfloat16, one dtype for all: {x.dtype}, {b.dtype},"
                        f" {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes dt and a in float32: "
                        f"{dt.dtype}, {a.dtype}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan kernel takes head dims {HEAD_DIMS}, "
                         f"not {p}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel takes state dims {STATE_DIMS}, "
                         f"not {n}")
    if l == 0:
        raise ValueError("ssd_scan needs at least one position")
    if bsz > 65535:
        raise ValueError(f"ssd_scan kernel takes batch <= 65535, not {bsz}")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("x, dt, a, b, c on different devices")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must have stride 1, strides "
                             f"{t.stride()}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if h0 is not None:
        if tuple(h0.shape) != (bsz, h, p, n):
            raise ValueError(f"h0 must be {(bsz, h, p, n)}, not "
                             f"{tuple(h0.shape)}")
        if h0.dtype != torch.float32:
            raise TypeError(f"ssd_scan kernel takes h0 in float32: "
                            f"{h0.dtype}")
        if h0.device != x.device or not h0.is_contiguous():
            raise ValueError("h0 must be contiguous, on x's device")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x: (B, H, L, P); dt: (B, H, L) fp32; a: (H,) fp32;
    b, c: (B, L, N); h0: the state before position 0, (B, H, P, N) fp32
    and contiguous, or None for zero.

    Returns ``(y, h_final)``: y (B, H, L, P) in x's dtype and the state
    after position L - 1, (B, H, P, N) fp32.  Unlike the JAX wrapper
    ``repro.kernels.ssd_scan.ops.ssd_scan``, which returns y alone, this
    also returns the final state, which serving keeps as the SSM cache,
    and it takes an initial state, which the TPU kernel does not.
    It has no ``chunk`` argument: the kernel tiles at 64 positions, and
    the result depends on the tiling only through the order of fp32 sums.
    On CUDA, y is stored as (B, L, H, P) and returned as its
    (B, H, L, P) view, so the model's transpose back is free.
    """
    if x.device.type == "cpu":
        return ssd_scan_reference(x, dt, a, b, c, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, b, c, h0)):
        return SSDScan.apply(x, dt, a, b, c, h0)
    return _forward(x, dt, a, b, c, h0)


def _forward(x, dt, a, b, c, h0):
    """Launch the forward kernel; returns (y, h_final)."""
    global LAUNCHES
    _check(x, dt, a, b, c, h0)
    bsz, h, l, p = x.shape
    n = b.shape[2]
    y = torch.empty((bsz, l, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
    vec = _copy_width(x, b, c) if x.dtype == torch.bfloat16 else 1
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), h_final.data_ptr(),
                _DTYPES[x.dtype], bsz, h, l, p, n,
                *x.stride()[:3], *dt.stride(), b.stride(0), b.stride(1),
                c.stride(0), c.stride(1), *y.stride()[:3], vec, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[VARIANTS[x.dtype]] += 1
    HEAD_LAUNCHES[h] = HEAD_LAUNCHES.get(h, 0) + 1
    return y, h_final


def _backward(x, dt, a, b, c, h0, dy, dh_final):
    """Launch the backward kernel: the grads of ``ssd_scan``'s inputs
    (dx, ddt, da, db, dc, dh0; dh0 is None without h0) for the cotangents
    ``dy`` of y and ``dh_final`` of the final state (None for zero).

    bf16 inputs launch ``ssd_scan_bwd_kernel_mma`` (tensor cores), fp32
    ones ``ssd_scan_bwd_kernel`` (scalar FMAs).  Either kernel writes da
    per (batch, head) and db, dc per head, fp32; they are summed here over
    batch and heads by ``torch.sum``, in a fixed order, so a rerun gives
    the same bits.  dx and ddt are stored as (B, L, H, P) and (B, L, H)
    and returned as their (B, H, L, ·) views, the layout of the model's x
    and dt.  Scratch: the state at the start of each chunk, P N fp32 per
    chunk and (batch, head), in a layout of the kernel's own."""
    global BWD_LAUNCHES
    _check(x, dt, a, b, c, h0)
    bsz, h, l, p = x.shape
    n = b.shape[2]
    if dy is None:
        dy = torch.zeros_like(x)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}, not "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dh_final is not None:
        if tuple(dh_final.shape) != (bsz, h, p, n):
            raise ValueError(f"dh_final must be {(bsz, h, p, n)}, not "
                             f"{tuple(dh_final.shape)}")
        dh_final = dh_final.float().contiguous()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_chunks = -(-l // CHUNK)
    states = torch.empty((bsz, h, n_chunks, p, n), **f32)
    dx = torch.empty((bsz, l, h, p), dtype=x.dtype,
                     device=dev).transpose(1, 2)
    ddt = torch.empty((bsz, l, h), **f32).transpose(1, 2)
    da = torch.empty((bsz, h), **f32)
    db = torch.empty((bsz, h, l, n), **f32)
    dc = torch.empty((bsz, h, l, n), **f32)
    dh0 = None if h0 is None else torch.empty((bsz, h, p, n), **f32)
    fn = _bwd_kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if h0 is None else h0.data_ptr(),
                dy.data_ptr(),
                None if dh_final is None else dh_final.data_ptr(),
                states.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                None if dh0 is None else dh0.data_ptr(),
                _DTYPES[x.dtype], bsz, h, l, p, n,
                *x.stride()[:3], *dt.stride(), b.stride(0), b.stride(1),
                c.stride(0), c.stride(1), *dy.stride()[:3],
                *dx.stride()[:3], *ddt.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {rc}")
    BWD_LAUNCHES += 1
    BWD_VARIANT_LAUNCHES[BWD_VARIANTS[x.dtype]] += 1
    return (dx, ddt, da.sum(0), db.sum(1).to(b.dtype),
            dc.sum(1).to(c.dtype), dh0)


class SSDScan(torch.autograd.Function):
    """The CUDA kernels as an autograd function: the forward kernel, and
    its hand-written backward.  It saves the inputs, not the outputs (a
    checkpointed layer recomputes the forward anyway), and takes an unused
    final state's cotangent as zero without building it."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        return _forward(x, dt, a, b, c, h0)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        return _backward(*ctx.saved_tensors, dy, dh_final)
