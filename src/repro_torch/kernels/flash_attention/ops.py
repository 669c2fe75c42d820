"""Public wrapper around the CUDA flash attention kernels.

The device of the tensors picks the path, with no option: CPU tensors go
to the plain PyTorch version (:mod:`.ref`), CUDA tensors launch a kernel
of ``csrc/flash_attention.cu`` or raise on what it does not take.  There
is no fallback from a kernel to the plain version.  The dtype picks the
kernel: bf16 runs on tensor cores (``bf16-mma``), fp32 on scalar FMAs
(``fp32-fma``, since TF32 cannot meet fp32's tolerance).  The kernels mask
ragged edges themselves, so unlike the TPU wrapper nothing is padded; they
read through the strides they are given, so transposed views are not
copied.

Where grad mode is on and q, k or v requires grad, CUDA tensors go
through :class:`FlashAttention`, a ``torch.autograd.Function``: its
forward launches the forward kernel, which then also writes each row's
log-sum-exp, and its backward launches the two backward kernels of
``csrc/flash_attention_bwd.cu`` (dQ, then dK and dV), picked by dtype as
the forward's: bf16 on tensor cores (``bf16-mma``), fp32 on scalar FMAs
(``fp32-fma``).  CPU tensors take the plain version through plain
autograd.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_reference

#: Launches of the CUDA kernels (not of the plain version) since import or
#: since a caller last reset it.
LAUNCHES = 0
#: The same launches by kernel variant.
VARIANT_LAUNCHES = {"fp32-fma": 0, "bf16-mma": 0}
#: The same launches by their (query heads, KV heads).
HEAD_LAUNCHES: dict = {}
#: Launches of the backward kernels (both dtypes), apart from the forward
#: ones above.
BWD_LAUNCHES = {"flash_bwd_dq": 0, "flash_bwd_dkdv": 0}
#: The backward kernels' launches (each of the two counts) by variant.
BWD_VARIANT_LAUNCHES = {"fp32-fma": 0, "bf16-mma": 0}

#: Head dims both kernels take: multiples of 4 from 8 to 256 (the bf16
#: kernel pads to a multiple of 16, the fp32 one to 32, with zeros).
HEAD_DIMS = tuple(range(8, 257, 4))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}
_FN = None
_BWD_FNS = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _FN = fn
    return _FN


def _bwd_fns():
    """The dq and the dkdv entry points of the backward library, which
    share one argument list."""
    global _BWD_FNS
    if _BWD_FNS is None:
        lib = build.load("flash_attention_bwd")
        fns = {}
        for name in BWD_LAUNCHES:
            fn = getattr(lib, "flash_attention_" + name[len("flash_"):])
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p])
            fns[name] = fn
        _BWD_FNS = fns
    return _BWD_FNS


def _copy_width(tensors, ptrs) -> int:
    """Elements per copy of the bf16 kernel: 8 (16 B) where the head dim,
    the base pointers and the B/H/S strides all allow it, else 4 (8 B).
    At 8 the kernel loads K and V by TMA, whose copies need the same 16 B
    alignment; at 4 (llama-3b's D 100: 200 B rows) by 8 B cp.async."""
    bits = tensors[0].shape[3]
    for t, ptr in zip(tensors, ptrs):
        bits |= ptr // t.element_size()
        for s in t.stride()[:3]:
            bits |= s
    for vec in (8, 4):
        if bits % vec == 0:
            return vec
    raise ValueError("flash_attention bf16 kernel copies 8 B at least: "
                     "base pointers and B/H/S strides must be multiples of "
                     "4 elements, strides " +
                     ", ".join(str(t.stride()) for t in tensors))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on what neither kernel takes; return the data pointers of q,
    k, v and the copy width (elements) of the bf16 kernel."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants 4-d (B, H, S, D) tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"one dtype for all: {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims that are "
                         f"multiples of 4 from 8 to 256, not {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head dim must have stride 1, strides "
                             f"{t.stride()}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    vec = _copy_width((q, k, v), ptrs) if q.dtype == torch.bfloat16 else 1
    return ptrs, vec


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention on (B, H, Sq, D) queries / (B, KV, Sk, D) keys.

    GQA when H > KV (H must be a multiple of KV).  ``window > 0`` enables
    sliding-window masking; ``softcap`` the gemma2-style logit cap.
    Returns (B, H, Sq, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, with_lse=False)[0]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(q, k, v, causal, window, softcap, with_lse):
    """Launch the forward kernel; returns (out, lse or None)."""
    global LAUNCHES
    ptrs, vec = _check(q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, out.data_ptr(), None if lse is None else lse.data_ptr(),
                _DTYPES[q.dtype], b, h, kvh, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window), float(softcap),
                float(d ** -0.5), vec, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[VARIANTS[q.dtype]] += 1
    HEAD_LAUNCHES[h, kvh] = HEAD_LAUNCHES.get((h, kvh), 0) + 1
    return out, lse


def _backward(q, k, v, lse, dout, causal, window, softcap):
    """Launch the dq kernel, then the dkdv kernel; returns (dq, dk, dv) in
    q's dtype, each laid out as its input (``empty_like``).  dO is made
    contiguous here.  The bf16 kernels copy by the forward's rule
    (:func:`_copy_width`), which the library applies to the same
    pointers and strides."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: grad {tuple(dout.shape)}"
                         f" {dout.dtype}, output {tuple(q.shape)} {q.dtype}")
    dout = dout.contiguous()
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, dout, dq, dk, dv)
    for name, t in zip(("q", "k", "v", "dout", "dq", "dk", "dv"), tensors):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head dim must have stride 1, strides "
                             f"{t.stride()}")
    strides = (ctypes.c_longlong * 21)(*(s for t in tensors
                                         for s in t.stride()[:3]))
    ptrs = [t.data_ptr() for t in (q, k, v, dout)] + [
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr()]
    if q.dtype == torch.bfloat16:
        _copy_width(tensors[:4], ptrs[:4])
    variant = VARIANTS[q.dtype]
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        for name, fn in _bwd_fns().items():     # dq first: it writes delta
            rc = fn(*ptrs, _DTYPES[q.dtype], b, h, kvh, sq, sk, d, strides,
                    int(causal), int(window), float(softcap),
                    float(d ** -0.5), stream)
            if rc != 0:
                raise RuntimeError(f"flash_attention backward kernel {name} "
                                   f"launch failed: CUDA error {rc}")
            BWD_LAUNCHES[name] += 1
            BWD_VARIANT_LAUNCHES[variant] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels as an autograd function: the forward kernel with
    the row log-sum-exp, and its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, lse, dout, *ctx.mask)
        return dq, dk, dv, None, None, None
