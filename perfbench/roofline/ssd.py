"""Operations and bytes of the SSD scan (Mamba-2's state-space dual) at a
shape ``(b, h, l, p, n)``, the least work its kernels must do.

Inputs read once and outputs written once (x, y, dy, dx in the element
size; dt, A, the state and their gradients in fp32); the FLOPs of the
chunked form at the kernel's tile of ``TILE`` positions over the causal
pairs of each tile.
"""

from __future__ import annotations

from typing import Tuple

TILE = 64


def _tiles(l: int):
    for l0 in range(0, l, TILE):
        q = min(TILE, l - l0)
        yield q, q * (q + 1) // 2


def forward(shape: Tuple[int, ...], esize: int) -> Tuple[float, float]:
    """x, dt, B, C read, y and the final state written; C B^T and its
    product with x dt over causal pairs, C h^T and the state update."""
    b, h, l, p, n = shape
    nbytes = (esize * (2 * b * h * l * p + 2 * b * l * n)
              + 4 * (b * h * l + h + b * h * p * n))
    flops = sum(2 * pr * (n + p) + 4 * q * p * n for q, pr in _tiles(l))
    return nbytes, float(flops * b * h)


def backward(shape: Tuple[int, ...], esize: int) -> Tuple[float, float]:
    """x, dy, dt, A, B, C read, dx, ddt, dA, dB, dC written; C B^T, dy
    u^T, M^T dy, dS B and dS^T C over causal pairs, the chunk states, B
    g^T, dy h_prev, x g and the adjoint update over tile x P x N."""
    b, h, l, p, n = shape
    nbytes = (esize * (3 * b * h * l * p + 4 * b * l * n)
              + 4 * (2 * b * h * l + 2 * h))
    flops = sum(2 * pr * (3 * n + 2 * p) + 10 * q * p * n
                for q, pr in _tiles(l))
    return nbytes, float(flops * b * h)
