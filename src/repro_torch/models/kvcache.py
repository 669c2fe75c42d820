"""KV cache structures and update helpers.

Caches are plain dicts of tensors: ``k``/``v`` of shape
``(L, B, S_max, KV, hd)`` and ``pos`` of shape ``(L, B, S_max)``.  Windowed
caches are ring buffers: ``slot = position % cache_len``; ``pos`` records
which absolute position each slot currently holds (−1 = empty), which is
all the attention mask needs.

Unlike the JAX package, whose caches are immutable and rebuilt by every
update, these helpers write into the cache **in place** (``index_put_`` /
slice assignment): a functional update would copy the whole cache of a
layer on every decoded token.  Callers pass views of one layer
(``cache["k"][i]``) and the stacked tensors change with them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def init_kv(n_layers: int, batch: int, cache_len: int, n_kv: int,
            head_dim: int, dtype: torch.dtype,
            device: torch.device | str = "cuda") -> dict:
    shape = (n_layers, batch, cache_len, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_layers, batch, cache_len), -1,
                          dtype=torch.int32, device=device),
    }


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
             pos_arr: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
             positions: torch.Tensor, cache_total: int,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one token's (k, v) into a layer cache, in place.

    k_cache/v_cache: (B, cache_total, KV, hd); pos_arr: (B, cache_total);
    k_new/v_new: (B, 1, KV, hd); positions: (B,) absolute positions.
    ``cache_total`` is the cache length (= window for ring buffers).
    Returns the updated tensors, which are the ones passed in.  (The JAX
    package's ``shard_start`` belongs to sequence-sharded decode, ROADMAP
    queue 1 item 11.)
    """
    idx = positions % cache_total
    b_idx = torch.arange(pos_arr.shape[0], device=pos_arr.device)
    k_cache.index_put_((b_idx, idx), k_new[:, 0])
    v_cache.index_put_((b_idx, idx), v_new[:, 0])
    pos_arr.index_put_((b_idx, idx), positions.to(pos_arr.dtype))
    return k_cache, v_cache, pos_arr


def fill_kv_from_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, window: int = 0) -> dict:
    """Fill an empty single-layer cache from prefill-fresh (k, v), in place.

    ``cache`` holds ``k``/``v`` (B, cache_len, KV, hd) and ``pos``
    (B, cache_len), as made by :func:`init_kv` (zeros, −1).  k, v:
    (B, S, KV, hd); the last ``cache_len`` positions are kept (ring layout
    for windowed caches so decode can continue seamlessly).
    """
    b, s = k.shape[:2]
    cache_len = cache["k"].shape[1]
    take = min(s, cache_len)
    src = slice(s - take, s)
    if window > 0:
        slots = positions[:, src] % cache_len
        b_idx = torch.arange(b, device=k.device)[:, None]
        cache["k"].index_put_((b_idx, slots), k[:, src])
        cache["v"].index_put_((b_idx, slots), v[:, src])
        cache["pos"].index_put_((b_idx, slots),
                                positions[:, src].to(cache["pos"].dtype))
    else:
        cache["k"][:, :take] = k[:, src]
        cache["v"][:, :take] = v[:, src]
        cache["pos"][:, :take] = positions[:, src]
    return cache
