"""The port's MoE layer (``models/layers/moe.py``) against the JAX
package's, on the CPU.

Inputs and parameters come from numpy seeds and go through both functions
in fp32.  Routing is held first and exactly: the expert ids must be equal
and the probabilities and gates within 1e-6, so that a flipped choice
shows as itself.  Outputs and aux losses must agree within 1e-5 of the
reference's largest magnitude (the two frameworks sum in different
orders), gradients within 1e-4 of each leaf's largest magnitude.  The
capacity dispatch must keep exactly the assignments the reference keeps,
at a capacity factor low enough that some are dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import moe as JM
from repro_torch.models.layers import moe as PM

import torch_threads  # noqa: F401,E402  (caps torch's threads)

RTOL = 1e-5
D, F = 32, 48
# (experts, top_k): mixtral's 8 / 2 and qwen3's fine-grained ratio, cut
SHAPES = [(8, 2), (16, 4)]


def _params(rng, e):
    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return {"router": w(D, e, fan_in=D), "w_gate": w(e, D, F, fan_in=D),
            "w_up": w(e, D, F, fan_in=D), "w_down": w(e, F, D, fan_in=F)}


def _x(rng, *shape):
    return rng.standard_normal(shape + (D,)).astype(np.float32)


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _one_group(fn, params, x, **kw):
    """``fn`` (a dispatch over groups (G, T, D)) on the ``B S`` tokens of
    x (B, S, D) as one group, as the reference's functions take them."""
    b, s, d = x.shape
    y, aux = fn(params, torch.from_numpy(x).reshape(1, b * s, d), **kw)
    return y.reshape(b, s, d), aux[0]


def _ref_keep(jparams, x, top_k, capacity_factor):
    """The reference's kept assignments (T, K), by its own lines
    (``repro/models/layers/moe.py:151-159``)."""
    b, s, d = x.shape
    e = jparams["router"].shape[1]
    t = b * s
    _, _, idx = JM._route(jparams, jnp.asarray(x).reshape(t, d), top_k)
    cap = JM._capacity(t, e, top_k, capacity_factor)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(t * top_k, e)
    pos = ((jnp.cumsum(flat, axis=0) - flat).reshape(t, top_k, e)
           * onehot).sum(-1)
    return np.asarray(pos < cap)


@pytest.mark.parametrize("e,k", SHAPES)
def test_route_matches(e, k):
    rng = np.random.default_rng(0)
    jp, pp = _both(_params(rng, e))
    x = _x(rng, 96)
    jprobs, jgates, jidx = JM._route(jp, jnp.asarray(x), k)
    probs, gates, idx = PM._route(pp, torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0,
                               atol=1e-6)
    assert gates.dtype == torch.float32
    _close(PM._aux_loss(probs, idx), JM._aux_loss(jprobs, jidx))


@pytest.mark.parametrize("e,k", SHAPES)
def test_aux_loss_matches(e, k):
    """On skewed probabilities, where the top-1 fractions are uneven."""
    rng = np.random.default_rng(1)
    logits = 3.0 * rng.standard_normal((80, e)).astype(np.float32)
    logits[:, 0] += 2.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :k]
    got = PM._aux_loss(torch.from_numpy(probs), torch.from_numpy(idx))
    ref = JM._aux_loss(jnp.asarray(probs), jnp.asarray(idx))
    _close(got, ref)


@pytest.mark.parametrize("e,k", SHAPES)
def test_moe_dropless_matches(e, k):
    rng = np.random.default_rng(2)
    jp, pp = _both(_params(rng, e))
    x = _x(rng, 3, 20)
    jy, jaux = JM._moe_dropless(jp, jnp.asarray(x), top_k=k)
    y, aux = _one_group(PM._moe_dropless, pp, x, top_k=k)
    _close(y, jy)
    _close(aux, jaux)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("e,k", SHAPES)
def test_moe_dense_drops_the_same_tokens(e, k, cf):
    """The capacity dispatch keeps exactly the reference's assignments.
    At capacity factor 0.5 some are dropped (asserted), and y still
    matches; at 1.25 the training default."""
    rng = np.random.default_rng(3)
    jp, pp = _both(_params(rng, e))
    x = _x(rng, 2, 40)
    want = _ref_keep(jp, x, k, cf)
    _, _, idx = PM._route(pp, torch.from_numpy(x).reshape(1, 80, D), k)
    cap = PM._capacity(80, e, k, cf)
    assert cap == JM._capacity(80, e, k, cf)
    _, keep = PM._kept(idx, e, cap)
    np.testing.assert_array_equal(keep[0].numpy(), want)
    if cf < 1:
        assert not want.all()
    jy, jaux = JM._moe_dense(jp, jnp.asarray(x), top_k=k,
                             capacity_factor=cf)
    y, aux = _one_group(PM._moe_dense, pp, x, top_k=k, capacity_factor=cf)
    _close(y, jy)
    _close(aux, jaux)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_chunked_moe_apply_matches(dropless):
    """S 64 in chunks of 16: each sequence's chunk is its own dispatch
    (capacity 0.5 drops within chunks) and aux is the mean over chunks
    and sequences."""
    rng = np.random.default_rng(4)
    e, k = SHAPES[0]
    jp, pp = _both(_params(rng, e))
    x = _x(rng, 2, 64)
    kw = dict(top_k=k, capacity_factor=0.5, chunk_tokens=16,
              dropless=dropless)
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), **kw)
    y, aux = PM.moe_apply(pp, torch.from_numpy(x), **kw)
    _close(y, jy)
    _close(aux, jaux)
    if not dropless:   # chunking changes which tokens drop
        whole, _ = _one_group(PM._moe_dense, pp, x, top_k=k,
                              capacity_factor=0.5)
        assert not torch.allclose(whole, y)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_apply_grads_match(dropless):
    """d(Σ y ∘ r + aux)/d(params, x) against ``jax.grad`` of the same."""
    rng = np.random.default_rng(5)
    e, k = SHAPES[1]
    params = _params(rng, e)
    x = _x(rng, 2, 24)
    r = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=0.75, dropless=dropless)

    def jloss(p, xx):
        y, aux = JM.moe_apply(p, xx, **kw)
        return jnp.sum(y * r) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))
    pp = {n: torch.from_numpy(v).requires_grad_() for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = PM.moe_apply(pp, tx, **kw)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    for name in params:
        _close(pp[name].grad, jgp[name], rtol=1e-4)
    _close(tx.grad, jgx, rtol=1e-4)


def test_capacity_matches():
    for t in (1, 7, 80, 4096):
        for e, k in SHAPES + [(128, 8)]:
            for cf in (0.5, 1.0, 1.25, 8.0):
                assert PM._capacity(t, e, k, cf) == JM._capacity(t, e, k, cf)
