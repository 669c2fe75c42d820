"""Published peaks of the cards a run may be on, by a part of the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 (the vendor's H100 Tensor Core GPU datasheet, SXM5
column, dense rates, at its 700 W limit): bf16 tensor cores 989.4
TFLOP/s (the sheet's 1,979 is with sparsity), 80 GB of HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flop_s": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def of(device_kind: str) -> Dict[str, float]:
    """The peaks of the card named ``device_kind``; an unknown card is an
    error, so that no share is taken against another card's peak."""
    for key, peaks in PEAKS.items():
        if key in device_kind:
            return peaks
    raise KeyError(f"no published peaks for {device_kind!r}")


def least_seconds(nbytes: float, flops: float, peaks: Dict[str, float]
                  ) -> float:
    """The larger of ``nbytes`` at the memory rate and ``flops`` at the
    bf16 peak."""
    return max(nbytes / peaks["hbm_bytes_s"], flops / peaks["bf16_flop_s"])
