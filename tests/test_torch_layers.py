"""The PyTorch port's layers against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both functions; fp32
results must agree within 1e-5 of the reference's largest magnitude
(the two frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as JKV
from repro.models.layers import attention as JA
from repro.models.layers import init_utils as JI
from repro.models.layers import mlp as JMLP
from repro.models.layers import norms as JN
from repro.models.layers import rope as JR
from repro_torch.models import kvcache as PKV
from repro_torch.models.layers import attention as PA
from repro_torch.models.layers import init_utils as PI
from repro_torch.models.layers import mlp as PMLP
from repro_torch.models.layers import norms as PN
from repro_torch.models.layers import rope as PR

import torch_threads  # noqa: F401,E402  (caps torch's threads)

RTOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = _rng(0)
    x = _f32(rng, 3, 5, 64, scale=4.0) + 1.0
    params = {"scale": _f32(rng, 64, scale=0.3)}
    if kind == "layernorm":
        params["bias"] = _f32(rng, 64, scale=0.3)
    jfn = JN.rmsnorm_apply if kind == "rmsnorm" else JN.layernorm_apply
    pfn = PN.rmsnorm_apply if kind == "rmsnorm" else PN.layernorm_apply
    eps = 1e-5                      # cfg.norm_eps, as blocks.norm_apply
    ref = jfn({k: jnp.asarray(v) for k, v in params.items()},
              jnp.asarray(x), eps=eps)
    got = pfn({k: _t(v) for k, v in params.items()}, _t(x), eps=eps)
    _close(got, ref)


def test_rope_matches():
    rng = _rng(1)
    x = _f32(rng, 2, 7, 3, 64)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    ref = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = PR.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(got, ref, rtol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    rng = _rng(2)
    d, f = 32, 96
    x = _f32(rng, 2, 5, d)
    if kind == "gelu":
        params = {"w_up": _f32(rng, d, f, scale=d ** -0.5),
                  "b_up": _f32(rng, f, scale=0.1),
                  "w_down": _f32(rng, f, d, scale=f ** -0.5),
                  "b_down": _f32(rng, d, scale=0.1)}
    else:
        params = {"w_gate": _f32(rng, d, f, scale=d ** -0.5),
                  "w_up": _f32(rng, d, f, scale=d ** -0.5),
                  "w_down": _f32(rng, f, d, scale=f ** -0.5)}
    ref = JMLP.mlp_apply({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), kind)
    got = PMLP.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x), kind)
    _close(got, ref)


ATTN_CASES = [
    # n_heads, n_kv, hd, causal, window, softcap
    (4, 4, 32, True, 0, 0.0),
    (4, 2, 32, True, 0, 0.0),      # GQA
    (4, 1, 64, True, 5, 0.0),      # MQA + window
    (2, 2, 32, False, 0, 20.0),    # non-causal + softcap
]


def _specs(h, kv, hd, causal, window, softcap):
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, causal=causal,
              window=window, softcap=softcap)
    return JA.AttnSpec(**kw), PA.AttnSpec(**kw)


@pytest.mark.parametrize("h,kv,hd,causal,window,softcap", ATTN_CASES)
def test_dense_attention_matches(h, kv, hd, causal, window, softcap):
    rng = _rng(3)
    b, sq, sk = 2, 9, 13
    js, ps = _specs(h, kv, hd, causal, window, softcap)
    q = _f32(rng, b, sq, h, hd)
    k = _f32(rng, b, sk, kv, hd)
    v = _f32(rng, b, sk, kv, hd)
    qpos = np.tile(np.arange(4, 4 + sq, dtype=np.int32), (b, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    kpos[1, -3:] = -1                       # empty cache slots
    ref = JA.dense_attention(*(jnp.asarray(a) for a in (q, k, v)), js,
                             jnp.asarray(qpos), jnp.asarray(kpos))
    got = PA.dense_attention(*(_t(a) for a in (q, k, v)), ps, _t(qpos),
                             _t(kpos))
    _close(got, ref)


@pytest.mark.parametrize("h,kv,hd,causal,window,softcap", ATTN_CASES)
def test_decode_attend_matches(h, kv, hd, causal, window, softcap):
    rng = _rng(4)
    b, s = 3, 11
    js, ps = _specs(h, kv, hd, causal, window, softcap)
    q = _f32(rng, b, 1, h, hd)
    ck = _f32(rng, b, s, kv, hd)
    cv = _f32(rng, b, s, kv, hd)
    cpos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    cpos[0, 7:] = -1
    qpos = np.array([6, 10, 8], np.int32)
    jref = JA.decode_attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(cpos), jnp.asarray(qpos), js)
    pgot = PA.decode_attend(_t(q), _t(ck), _t(cv), _t(cpos), _t(qpos), ps)
    for g, r in zip(pgot, jref):
        _close(g, r)
    _close(PA.merge_decode_partials(*pgot), JA.merge_decode_partials(*jref))


@pytest.mark.parametrize("h,kv,hd,causal,window,softcap", ATTN_CASES)
def test_attention_apply_matches(h, kv, hd, causal, window, softcap):
    """Self-attention layer: the port's kernel seam (plain version on the
    CPU) against the JAX dense path, with the fresh (k, v)."""
    rng = _rng(5)
    b, s, d = 2, 12, 48
    js, ps = _specs(h, kv, hd, causal, window, softcap)
    params = {"wq": _f32(rng, d, h, hd, scale=d ** -0.5),
              "wk": _f32(rng, d, kv, hd, scale=d ** -0.5),
              "wv": _f32(rng, d, kv, hd, scale=d ** -0.5),
              "wo": _f32(rng, h, hd, d, scale=(h * hd) ** -0.5)}
    x = _f32(rng, b, s, d)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jy, (jk, jv) = JA.attention_apply(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x), js,
        jnp.asarray(pos), return_kv=True)
    py, (pk, pv) = PA.attention_apply(
        {k: _t(a) for k, a in params.items()}, _t(x), ps, _t(pos),
        return_kv=True)
    _close(py, jy)
    _close(pk, jk)
    _close(pv, jv)


@pytest.mark.parametrize("cache_total", [8, 4])
def test_write_kv_matches(cache_total):
    """In-place write (plain and ring slots), against the functional one."""
    rng = _rng(6)
    b, kv, hd = 3, 2, 8
    kc = _f32(rng, b, cache_total, kv, hd)
    vc = _f32(rng, b, cache_total, kv, hd)
    pc = rng.integers(-1, 20, (b, cache_total)).astype(np.int32)
    kn, vn = _f32(rng, b, 1, kv, hd), _f32(rng, b, 1, kv, hd)
    positions = np.array([9, 13, 6], np.int32)
    ref = JKV.write_kv(*(jnp.asarray(a) for a in (kc, vc, pc, kn, vn,
                                                   positions)),
                       cache_total=cache_total)
    pt = [_t(a) for a in (kc, vc, pc)]
    got = PKV.write_kv(*pt, _t(kn), _t(vn), _t(positions).long(),
                       cache_total=cache_total)
    for g, t, r in zip(got, pt, ref):
        assert g is t                             # updated in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("window,cache_len", [(0, 12), (6, 6)])
def test_fill_kv_from_prefill_matches(window, cache_len):
    rng = _rng(7)
    b, s, kv, hd = 2, 9, 2, 4
    k, v = _f32(rng, b, s, kv, hd), _f32(rng, b, s, kv, hd)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    ref = JKV.fill_kv_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), cache_len, window=window)
    cache = {name: t[0] for name, t in PKV.init_kv(
        1, b, cache_len, kv, hd, torch.float32, "cpu").items()}
    got = PKV.fill_kv_from_prefill(cache, _t(k), _t(v), _t(pos).long(),
                                   window=window)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))


def test_init_distributions_match():
    """Same distributions as the JAX initialisers: truncated normal at
    ±2 std with std 1/sqrt(fan_in), and a unit normal embedding."""
    shape, fan_in = (256, 384), 256
    gen = torch.Generator().manual_seed(0)
    got = PI.dense_init(gen, shape, device="cpu").numpy()
    ref = np.asarray(JI.dense_init(jax.random.PRNGKey(0), shape))
    bound = 2.0 / np.sqrt(fan_in)
    for a in (got, ref):
        assert a.dtype == np.float32 and a.shape == shape
        assert np.abs(a).max() <= bound * (1 + 1e-6)
        # std of a standard normal truncated at ±2: 0.8796
        assert abs(a.std() * np.sqrt(fan_in) - 0.8796) < 0.01
    emb = PI.embed_init(gen, 512, 64, device="cpu").numpy()
    jemb = np.asarray(JI.embed_init(jax.random.PRNGKey(1), 512, 64))
    for a in (emb, jemb):
        assert abs(a.std() - 1.0) < 0.02 and abs(a.mean()) < 0.02


@pytest.mark.parametrize("rep", [1, 3])
def test_gqa_layout_helpers_match(rep):
    rng = _rng(8)
    x = _f32(rng, 2, 5, 2, 8)
    _close(PA._expand_kv(_t(x), rep), JA._expand_kv(jnp.asarray(x), rep))
    q = _f32(rng, 2, 5, 6, 8)
    _close(PA._group_q(_t(q), 3), JA._group_q(jnp.asarray(q), 3))


@pytest.mark.parametrize("arch", ["llama-7b", "bert-large"])
def test_norm_apply_uses_cfg_eps(arch):
    """Block norms take ``cfg.norm_eps``, not the 1e-6 default: inputs
    whose mean square is near eps tell the two apart."""
    from repro.configs.base import get_arch as jget
    from repro.models import blocks as JB
    from repro_torch.configs.base import get_arch as pget
    from repro_torch.models import blocks as PB
    jcfg, pcfg = jget(arch).reduced(), pget(arch).reduced()
    rng = _rng(9)
    x = _f32(rng, 2, 3, 256, scale=3e-3)
    params = {"scale": _f32(rng, 256, scale=0.3),
              "bias": _f32(rng, 256, scale=0.3)}
    if pcfg.norm_kind == "rmsnorm":
        del params["bias"]
    ref = JB.norm_apply(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    got = PB.norm_apply(pcfg, {k: _t(v) for k, v in params.items()}, _t(x))
    _close(got, ref)


# (window, softcap, causal): the cases of tests/test_layers.py's blockwise
# property (windowed non-causal is not a supported combination)
BLOCKWISE_CASES = [(w, c, causal) for w in (0, 8, 32) for c in (0.0, 25.0)
                   for causal in (True, False) if causal or not w]


@pytest.mark.parametrize("window,softcap,causal", BLOCKWISE_CASES)
def test_blockwise_attention_matches(window, softcap, causal):
    """The port's blockwise attention (KV blocks of 16, Q blocks of 32 at
    S 64, GQA 4/2) against the JAX package's blockwise and dense paths."""
    rng = _rng(10)
    b, s, h, kv, hd = 2, 64, 4, 2, 16
    js, ps = _specs(h, kv, hd, causal, window, softcap)
    q, k, v = _f32(rng, b, s, h, hd), _f32(rng, b, s, kv, hd), \
        _f32(rng, b, s, kv, hd)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    got = PA.blockwise_attention(_t(q), _t(k), _t(v), ps, _t(pos), _t(pos),
                                 block_kv=16, block_q=32)
    _close(got, JA.blockwise_attention(*jargs, js, jnp.asarray(pos),
                                       jnp.asarray(pos), block_kv=16,
                                       block_q=32))
    _close(got, JA.dense_attention(*jargs, js, jnp.asarray(pos),
                                   jnp.asarray(pos)))


def test_blockwise_ragged_kv_and_empty_slots():
    """Sk 45 padded to the block of 16 with position -1, cache slots
    already at -1, Sq != Sk: against both JAX paths."""
    rng = _rng(11)
    js, ps = _specs(4, 1, 32, True, 0, 0.0)
    q, k, v = _f32(rng, 2, 9, 4, 32), _f32(rng, 2, 45, 1, 32), \
        _f32(rng, 2, 45, 1, 32)
    qpos = np.tile(np.arange(36, 45, dtype=np.int32), (2, 1))
    kpos = np.tile(np.arange(45, dtype=np.int32), (2, 1))
    kpos[1, 30:] = -1
    got = PA.blockwise_attention(_t(q), _t(k), _t(v), ps, _t(qpos),
                                 _t(kpos), block_kv=16)
    jargs = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    _close(got, JA.blockwise_attention(*jargs[:3], js, *jargs[3:],
                                       block_kv=16))
    _close(got, JA.dense_attention(*jargs[:3], js, *jargs[3:]))


def test_blockwise_rows_are_convex_combinations():
    """All-ones V gives all-ones rows (``tests/test_layers.py``'s check of
    the online softmax's normalisation), at KV blocks of 8; and the same
    rows as the JAX blockwise on a random V."""
    rng = _rng(12)
    js, ps = _specs(2, 2, 8, True, 0, 0.0)
    q, k = _f32(rng, 1, 32, 2, 8), _f32(rng, 1, 32, 2, 8)
    pos = np.arange(32, dtype=np.int32)[None]
    out = PA.blockwise_attention(_t(q), _t(k), torch.ones(1, 32, 2, 8), ps,
                                 _t(pos), _t(pos), block_kv=8)
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6)
    v = _f32(rng, 1, 32, 2, 8)
    got = PA.blockwise_attention(_t(q), _t(k), _t(v), ps, _t(pos), _t(pos),
                                 block_kv=8)
    _close(got, JA.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), js, jnp.asarray(pos),
        jnp.asarray(pos), block_kv=8))


def test_attention_apply_past_threshold_is_blockwise(monkeypatch):
    """One sequence of 2100 tokens (past the 2048 threshold) through the
    port's attention layer on the CPU, against the JAX layer (which is
    blockwise there too); the port must not build the full logits through
    the flash kernel's plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    def refuse(*a, **kw):
        raise AssertionError("flash path taken past the threshold")
    monkeypatch.setattr(flash_ops, "flash_attention", refuse)
    rng = _rng(13)
    b, s, d, h, kv, hd = 1, 2100, 32, 4, 2, 16
    js, ps = _specs(h, kv, hd, True, 0, 0.0)
    params = {"wq": _f32(rng, d, h, hd, scale=d ** -0.5),
              "wk": _f32(rng, d, kv, hd, scale=d ** -0.5),
              "wv": _f32(rng, d, kv, hd, scale=d ** -0.5),
              "wo": _f32(rng, h, hd, d, scale=(h * hd) ** -0.5)}
    x = _f32(rng, b, s, d)
    pos = np.arange(s, dtype=np.int32)[None]
    jy = JA.attention_apply({k: jnp.asarray(a) for k, a in params.items()},
                            jnp.asarray(x), js, jnp.asarray(pos))
    py = PA.attention_apply({k: _t(a) for k, a in params.items()}, _t(x),
                            ps, _t(pos))
    _close(py, jy)
