"""Load the JAX package's parameters into the port.

The JAX package and the port draw different random numbers from the same
seed, so a parity check initialises with ``repro.models.model.init_params``,
brings the tree to the host (``jax.device_get``) and hands the resulting
nested dicts and lists of ``np.ndarray`` to :func:`params_from_numpy`.
This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model import (resolve_device, storage_dtype,
                                      tree_map)


def params_from_numpy(tree: Dict[str, Any], device: torch.device | str,
                      dtype: torch.dtype | None = None) -> Dict[str, Any]:
    """The same tree, leaf for leaf, as tensors on ``device``.

    With ``dtype`` every leaf but the fp32 ones is stored in it (as
    :func:`repro_torch.models.model.init_params` stores them); without it
    the leaves keep their numpy dtype.
    """
    device = resolve_device(device)

    def leaf(path, a):
        t = torch.from_numpy(np.array(a))   # a writable copy
        if dtype is not None:
            t = t.to(storage_dtype(path, dtype))
        return t.to(device)

    return tree_map(tree, leaf)
