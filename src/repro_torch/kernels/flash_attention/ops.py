"""Public wrapper around the CUDA flash attention kernel.

The device of the tensors picks the path, with no option: CPU tensors go
to the plain PyTorch version (:mod:`.ref`), CUDA tensors launch the kernel
in ``csrc/flash_attention.cu`` or raise on what it does not take.  There
is no fallback from the kernel to the plain version.  The kernel masks
ragged edges itself, so unlike the TPU wrapper nothing is padded; it reads
through the strides it is given, so transposed views are not copied.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_reference

#: Launches of the CUDA kernel (not of the plain version) since import or
#: since a caller last reset it.
LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
        _FN = fn
    return _FN


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, not {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head dim must have stride 1, strides "
                             f"{t.stride()}")


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
    _check(q, k, v)
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
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, h, kvh, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window), float(softcap),
                float(d ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
