"""Operations and bytes of causal (or windowed) attention at a shape, the
least work the flash attention kernels must do.

Each input is read once and each output written once; the products count
only the (query, key) pairs the mask keeps.  ``case`` is ``(b, h, kvh,
sq, sk, d, causal, window)``, ``esize`` the bytes of an element.
"""

from __future__ import annotations

from typing import Tuple


def pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs kept, queries and keys both at positions 0..;
    a window of w keeps the keys with q - k < w."""
    total = 0
    for q in range(sq):
        hi = min(q, sk - 1) if causal else sk - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def forward(case: Tuple, esize: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the forward: q, k, v read, the output written;
    Q K^T and P V, 2 d operations each a kept pair and head."""
    b, h, kvh, sq, sk, d, causal, window = case
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kvh * sk)
    flops = 4.0 * b * h * d * pairs(sq, sk, causal, window)
    return nbytes, flops


def backward(case: Tuple, esize: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the backward as one function: q, k, v, dO and the
    rows' log-sum-exp (fp32) read, dq, dk, dv written; S once, dP, dQ, dK
    and dV, 10 d operations a kept pair and head."""
    b, h, kvh, sq, sk, d, causal, window = case
    qo, kv, rows = b * h * sq * d, b * kvh * sk * d, b * h * sq
    nbytes = esize * (3 * qo + 4 * kv) + 4 * rows
    flops = 10.0 * b * h * d * pairs(sq, sk, causal, window)
    return nbytes, flops
