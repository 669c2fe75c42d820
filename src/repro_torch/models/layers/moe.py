"""Mixture-of-Experts feed-forward (the port of ``repro.models.layers.moe``).

Top-k routing with the chosen gates renormalised (mixtral-style), then one
of two dispatches, as in the JAX package:

* capacity (training, :func:`_moe_dense`): each expert takes at most
  ``C = max(min(int(T k cf / E) + 1, T), 1)`` assignments of the ``T``
  tokens of one dispatch, in token-major, k-minor order; the overflow is
  dropped (its residual passes through).  The JAX package builds the
  ``(T, E, C)`` dispatch and combine one-hots; here the kept tokens are
  gathered by index into an ``(E, C, D)`` buffer, the experts run as
  ``bmm`` against their stacked weights, and each token gathers its
  experts' outputs back with its gates.  Same function, same expert
  FLOPs, no host synchronise.
* drop-free (serving, :func:`_moe_dropless`): every expert runs over every
  token and the combine is masked by the ``(T, E)`` gate matrix, so a
  1-token decode step and a full forward compute the same per-token
  outputs.  This costs ``E / k`` times the expert FLOPs of a top-k
  dispatch (16x for qwen3-moe-30b-a3b) and reads every expert's weights
  every step; it is the JAX package's form, kept for exactness.

Under tensor-parallel serving (a ``TensorAxis``) the drop-free dispatch
runs on each rank's experts (``w_gate``/``w_up``/``w_down`` split at dim
-3; where the experts do not split, by ``d_ff``) over every token, the
router whole, the combine weighted by the router's gates for those
experts: each rank's partial sum, then one sum over the ranks.  Still
exact, with no capacity and no host synchronise.

Router load-balance loss per Switch Transformers: ``aux = E Σ_e f_e P_e``
(fraction of tokens whose top-1 is ``e`` times the mean router prob).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
from torch.nn import functional as F

from repro_torch.models.layers.init_utils import dense_init


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, device: torch.device | str = "cuda") -> dict:
    return {
        "router": dense_init(generator, (d_model, n_experts), device=device),
        "w_gate": dense_init(generator, (n_experts, d_model, d_ff),
                             fan_in=d_model, device=device),
        "w_up": dense_init(generator, (n_experts, d_model, d_ff),
                           fan_in=d_model, device=device),
        "w_down": dense_init(generator, (n_experts, d_ff, d_model),
                             fan_in=d_ff, device=device),
    }


def _capacity(tokens: int, n_experts: int, k: int,
              capacity_factor: float) -> int:
    c = int(tokens * k * capacity_factor / n_experts) + 1
    return max(min(c, tokens), 1)


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              chunk_tokens: int = 4096,
              dropless: bool = False,
              tp=None, d_ff: int = 0,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss).

    ``dropless=True`` selects the drop-free dispatch; ``tp`` (a
    ``TensorAxis``, drop-free only) runs it on this rank's shards of
    experts of ``d_ff`` (:func:`_moe_dropless`).  When ``S >
    chunk_tokens`` and divides by it, each sequence's chunk of
    ``chunk_tokens`` is its own dispatch (its own capacity), and aux is
    the mean over chunks and sequences, as the JAX package's ``vmap`` over
    the batch inside a ``scan`` over chunks; otherwise the ``B S`` tokens
    are one dispatch.
    """
    b, s, d = x.shape
    if s > chunk_tokens and s % chunk_tokens == 0:
        groups = x.reshape(b * (s // chunk_tokens), chunk_tokens, d)
    else:
        groups = x.reshape(1, b * s, d)
    if dropless:
        y, aux = _moe_dropless(params, groups, top_k=top_k, tp=tp,
                               d_ff=d_ff)
    elif tp is not None:
        raise ValueError("tensor-parallel MoE runs the drop-free dispatch")
    else:
        y, aux = _moe_dense(params, groups, top_k=top_k,
                            capacity_factor=capacity_factor)
    return y.reshape(b, s, d), aux.mean()


def _route(params: dict, xt: torch.Tensor, top_k: int):
    """Shared router: (..., T, D) tokens → (probs, normalised gates,
    expert ids).  The router matmul runs in the tokens' dtype and is cast
    to fp32, then softmax, top-k and the chosen gates renormalised (floor
    1e-9), in the JAX package's order."""
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                       # (.., T, E)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # (.., T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss on the top-1 routing fraction; over the
    last two dims (T, E) and (T, K), one value per leading index."""
    e = probs.shape[-1]
    frac_routed = F.one_hot(expert_idx[..., 0], e).float().mean(dim=-2)
    mean_prob = probs.mean(dim=-2)
    return e * (frac_routed * mean_prob).sum(dim=-1)


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert over its rows: xe (E, N, D) → (E, N, D)."""
    dtype = xe.dtype
    gate = torch.bmm(xe, params["w_gate"].to(dtype))
    up = torch.bmm(xe, params["w_up"].to(dtype))
    return torch.bmm(F.silu(gate) * up, params["w_down"].to(dtype))


_ROUTE_LOGS: List[list] = []    # the lists of open recording_routes() blocks


@contextlib.contextmanager
def recording_routes():
    """Yields a list that gets the expert ids (G, T, K), sorted along K,
    of each drop-free dispatch run while the block is open: the experts
    each token was routed to, in the order the layers ran."""
    log: list = []
    _ROUTE_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTE_LOGS.remove(log)


def _moe_dropless(params: dict, x: torch.Tensor, *, top_k: int, tp=None,
                  d_ff: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-free dispatch of each group of x (G, T, D): every expert over
    every token, the combine masked by the gates.  Returns y (G, T, D) and
    each group's aux (G,).  With ``tp`` the experts are this rank's shards:
    its block of the experts (every expert, of its block of ``d_ff``,
    where the experts do not split), its partial combine summed over the
    ranks."""
    g, t, d = x.shape
    e = params["router"].shape[1]
    probs, gate_vals, expert_idx = _route(params, x, top_k)
    comb = torch.zeros((g, t, e), dtype=torch.float32, device=x.device
                       ).scatter_(-1, expert_idx, gate_vals)    # (G, T, E)
    for log in _ROUTE_LOGS:
        log.append(expert_idx.sort(dim=-1).values)
    comb = comb.reshape(g * t, e)
    e_loc = params["w_gate"].shape[0]
    split = tp is not None and (e_loc < e or
                                params["w_gate"].shape[-1] < d_ff)
    if tp is not None and e_loc < e:
        comb = comb[:, tp.block(e)]
    xt = x.reshape(1, g * t, d).expand(e_loc, g * t, d)
    out = _experts(params, xt)                              # (E_loc, GT, D)
    y = torch.einsum("te,etd->td", comb.to(x.dtype), out)
    if split:
        y = tp.sum_partials(y)
    return y.reshape(g, t, d), _aux_loss(probs, expert_idx)


def _kept(expert_idx: torch.Tensor, n_experts: int,
          cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(queue position, kept) of each assignment, (G, T, K): the position
    is the exclusive cumsum of the (T K, E) one-hot in token-major,
    k-minor order within each group; an assignment is kept while its
    position is below the capacity ``cap``."""
    g, t, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, n_experts).to(torch.int32).reshape(
        g, t * k, n_experts)
    before = onehot.cumsum(dim=1) - onehot
    pos = (before * onehot).sum(dim=-1).reshape(g, t, k)
    return pos, pos < cap


_DROP_LOGS: List[list] = []     # the lists of open counting_drops() blocks


@contextlib.contextmanager
def counting_drops():
    """Yields a list that gets one ``(T, dropped)`` pair for each capacity
    dispatch run while the block is open (checkpointed recomputes
    included): its tokens a group and the assignments it dropped, a 0-d
    tensor on the tokens' device."""
    log: list = []
    _DROP_LOGS.append(log)
    try:
        yield log
    finally:
        _DROP_LOGS.remove(log)


def _moe_dense(params: dict, x: torch.Tensor, *, top_k: int,
               capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch of each group of x (G, T, D), with capacity ``C``
    an expert.  Returns y (G, T, D) and each group's aux (G,)."""
    g, t, d = x.shape
    e = params["router"].shape[1]
    probs, gate_vals, expert_idx = _route(params, x, top_k)
    cap = _capacity(t, e, top_k, capacity_factor)
    pos, keep = _kept(expert_idx, e, cap)
    for log in _DROP_LOGS:
        log.append((t, (~keep).sum()))
    gate_vals = gate_vals * keep
    # each kept assignment's slot in the (E, G, C) buffer; the dropped
    # ones all go to one spare slot past its end, which no token reads
    n_slots = e * g * cap
    group = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(keep, (expert_idx * g + group) * cap + pos, n_slots)
    # the token in each slot; empty slots point at a zero row
    token = torch.arange(g * t, device=x.device).repeat_interleave(top_k)
    slot_token = torch.full((n_slots + 1,), g * t, dtype=torch.long,
                            device=x.device).scatter_(0, slot.reshape(-1),
                                                      token)
    rows = torch.cat([x.reshape(g * t, d), x.new_zeros(1, d)])
    expert_in = rows[slot_token[:n_slots]].reshape(e, g * cap, d)
    out = _experts(params, expert_in).reshape(n_slots, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    y = torch.einsum("gtk,gtkd->gtd", gate_vals.to(x.dtype), out[slot])
    return y, _aux_loss(probs, expert_idx)
