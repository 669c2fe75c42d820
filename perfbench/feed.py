"""The one general generator of traffic: token blocks from a mix's file
and the seed.

A training mix names its global batch and sequence length; each step
``i`` gets its own block of ``(global_batch, seq_len + 1)`` token ids
from ``(seed, i)``, so the same seed gives the same blocks, every step
and every row differ, and every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from perfbench.weights import seed63


class Feed:
    def __init__(self, traffic: Dict[str, Any], vocab: int, seed: int):
        self.batch = int(traffic["global_batch"])
        self.seq = int(traffic["seq_len"])
        self.vocab = int(vocab)
        self.seed = seed63(seed)

    def block(self, i: int) -> np.ndarray:
        """Step ``i``'s block: ids drawn uniformly from the vocabulary."""
        rng = np.random.default_rng([self.seed, int(i)])
        return rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int64)
