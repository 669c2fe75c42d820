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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_reference

#: Launches of the CUDA kernels (not of the plain version) since import or
#: since a caller last reset it.
LAUNCHES = 0
#: The same launches by kernel variant.
VARIANT_LAUNCHES = {"fp32-fma": 0, "bf16-mma": 0}

#: Head dims both kernels take: multiples of 4 from 8 to 256 (the bf16
#: kernel pads to a multiple of 16, the fp32 one to 32, with zeros).
HEAD_DIMS = tuple(range(8, 257, 4))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _FN = fn
    return _FN


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
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    ptrs, vec = _check(q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, out.data_ptr(),
                _DTYPES[q.dtype], b, h, kvh, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window), float(softcap),
                float(d ** -0.5), vec, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[VARIANTS[q.dtype]] += 1
    return out
