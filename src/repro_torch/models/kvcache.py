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
             positions: torch.Tensor, cache_total: int, shard_start: int = 0,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one token's (k, v) into (a shard of) a layer cache, in place.

    k_cache/v_cache: (B, S_loc, KV, hd); pos_arr: (B, S_loc);
    k_new/v_new: (B, 1, KV, hd); positions: (B,) absolute positions.
    ``cache_total`` is the *global* cache length (= window for ring
    buffers); ``shard_start`` → this rank owns global slots
    [shard_start, shard_start + S_loc) and writes only a token whose slot
    it owns (a row it does not own is written back as it was).  Returns
    the updated tensors, which are the ones passed in.
    """
    b, s_loc = pos_arr.shape
    b_idx = torch.arange(b, device=pos_arr.device)
    slot = positions % cache_total - shard_start
    pos_new = positions.to(pos_arr.dtype)
    if shard_start == 0 and s_loc == cache_total:
        idx, k_w, v_w = slot, k_new[:, 0], v_new[:, 0]
    else:
        own = (slot >= 0) & (slot < s_loc)
        idx = slot.clamp(0, s_loc - 1)
        k_w = torch.where(own[:, None, None], k_new[:, 0],
                          k_cache[b_idx, idx])
        v_w = torch.where(own[:, None, None], v_new[:, 0],
                          v_cache[b_idx, idx])
        pos_new = torch.where(own, pos_new, pos_arr[b_idx, idx])
    k_cache.index_put_((b_idx, idx), k_w)
    v_cache.index_put_((b_idx, idx), v_w)
    pos_arr.index_put_((b_idx, idx), pos_new)
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


def fill_kv_shard(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, window: int, total: int,
                  start: int) -> dict:
    """Fill a rank's empty shard of a layer cache — global slots [start,
    start + S_loc) of ``total`` — from prefill-fresh (k, v) of every
    position, in place: the whole layer cache is filled as
    :func:`fill_kv_from_prefill` fills it, for the duration of the call,
    and the shard's slots are copied out of it."""
    b, _, kvh, hd = k.shape
    whole = init_kv(1, b, total, kvh, hd, k.dtype, k.device)
    whole = {n: t[0] for n, t in whole.items()}
    fill_kv_from_prefill(whole, k, v, positions, window=window)
    s_loc = cache["k"].shape[1]
    for name in ("k", "v", "pos"):
        cache[name].copy_(whole[name].narrow(1, start, s_loc))
    return cache
