"""The port's Mamba2 layer (``models/layers/ssd.py``) and SSM block against
the JAX package's, on the CPU.

Inputs and parameters come from numpy seeds (parameters from the JAX
init, perturbed where they are constant at init) and go through both
functions; fp32 results must agree within 1e-5 of the reference's
largest magnitude, except where a chunked form meets a sequential one
(1e-4, the bound of ``tests/test_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import blocks as JB
from repro.models.layers import ssd as JS
from repro_torch.configs import base as pt_base
from repro_torch.models import blocks as PB
from repro_torch.models.layers import ssd as PS

import torch_threads  # noqa: F401,E402  (caps torch's threads)

SPEC = dict(d_model=64, d_inner=128, n_state=16, head_dim=32, chunk=16,
            conv_width=4)
SEQ = 40                     # ragged against the chunk of 16


def _close(got, ref, rtol=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _t(a):
    return torch.from_numpy(np.array(a))


def _core_inputs(seed, bsz=2, l=SEQ, h=4, p=32, n=16):
    """x (B,L,H,P), dt (B,L,H), a (H,), b, c (B,L,N), h0 (B,H,P,N), fp32,
    with slow decay so that the state carries across chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, l, h)) - 3.0))
    a = -np.exp(np.linspace(-2.0, 0.5, h))
    b = rng.standard_normal((bsz, l, n)).astype(np.float32)
    c = rng.standard_normal((bsz, l, n)).astype(np.float32)
    h0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return (x, dt.astype(np.float32), a.astype(np.float32), b, c, h0)


def _params(seed):
    """JAX ``ssd_init``, with conv_b, d_skip and the gate norm (constant at
    init) made random."""
    spec = JS.SSMSpec(**SPEC)
    tree = jax.device_get(JS.ssd_init(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v) for k, v in tree.items() if k != "gate_norm"}
    for k in ("conv_b", "d_skip"):
        out[k] = out[k] + 0.1 * rng.standard_normal(out[k].shape).astype(
            np.float32)
    out["gate_norm"] = {"scale": 0.1 * rng.standard_normal(
        (spec.d_inner,)).astype(np.float32)}
    return out


def _jparams(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pparams(tree):
    return {k: ({"scale": _t(v["scale"])} if isinstance(v, dict) else _t(v))
            for k, v in tree.items()}


def test_ssd_init_matches_tree():
    """Same names, shapes, dtypes and constants as the JAX init."""
    spec = JS.SSMSpec(**SPEC)
    ref = jax.device_get(JS.ssd_init(jax.random.PRNGKey(0), spec))
    got = PS.ssd_init(torch.Generator().manual_seed(0), PS.SSMSpec(**SPEC),
                      device="cpu")
    assert set(got) == set(ref)
    flat_ref = {k: np.asarray(v["scale"] if isinstance(v, dict) else v)
                for k, v in ref.items()}
    flat_got = {k: (v["scale"] if isinstance(v, dict) else v).numpy()
                for k, v in got.items()}
    for k in flat_ref:
        assert flat_got[k].shape == flat_ref[k].shape, k
        assert flat_got[k].dtype == flat_ref[k].dtype == np.float32, k
    for k in ("conv_b", "a_log", "d_skip", "gate_norm"):
        _close(flat_got[k], flat_ref[k], rtol=1e-6)
    assert (-4.0 <= flat_got["dt_bias"]).all()
    assert (flat_got["dt_bias"] <= -1.0).all()


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero", "state"])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    ro, rs = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                             jnp.asarray(bias),
                             None if state is None else jnp.asarray(state))
    go, gs = PS._causal_conv(_t(xbc), _t(w), _t(bias),
                             None if state is None else _t(state))
    _close(go, ro)
    _close(gs, rs)


@pytest.mark.parametrize("given", [False, True], ids=["prefill", "h0-conv0"])
def test_ssd_apply_matches(monkeypatch, given):
    """The port scans through ``ssd_ops.ssd_scan`` (its plain version on
    the CPU), from zero or from h0; the JAX package through
    ``ssd_chunked``."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    tree = _params(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, SEQ, SPEC["d_model"])).astype(np.float32)
    kw_j, kw_p = {}, {}
    if given:
        _, _, _, _, _, h0 = _core_inputs(4)
        conv0 = rng.standard_normal(
            (2, SPEC["conv_width"] - 1,
             SPEC["d_inner"] + 2 * SPEC["n_state"])).astype(np.float32)
        kw_j = dict(h0=jnp.asarray(h0), conv0=jnp.asarray(conv0))
        kw_p = dict(h0=_t(h0), conv0=_t(conv0))
    ro, (rh, rc) = JS.ssd_apply(_jparams(tree), jnp.asarray(x),
                                JS.SSMSpec(**SPEC), **kw_j)
    go, (gh, gc) = PS.ssd_apply(_pparams(tree), _t(x), PS.SSMSpec(**SPEC),
                                **kw_p)
    rtol = 1e-5 if given else 1e-4
    _close(go, ro, rtol)
    _close(gh, rh, rtol)
    _close(gc, rc)


def test_ssd_decode_step_matches():
    tree = _params(5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, SPEC["d_model"])).astype(np.float32)
    _, _, _, _, _, h = _core_inputs(6)
    conv = rng.standard_normal(
        (2, SPEC["conv_width"] - 1,
         SPEC["d_inner"] + 2 * SPEC["n_state"])).astype(np.float32)
    ro, (rh, rc) = JS.ssd_decode_step(_jparams(tree), jnp.asarray(x),
                                      JS.SSMSpec(**SPEC), jnp.asarray(h),
                                      jnp.asarray(conv))
    go, (gh, gc) = PS.ssd_decode_step(_pparams(tree), _t(x),
                                      PS.SSMSpec(**SPEC), _t(h), _t(conv))
    _close(go, ro)
    _close(gh, rh)
    _close(gc, rc)


@pytest.mark.parametrize("mode", ["prefill", "decode", "prefill-state"])
def test_ssm_block_matches(monkeypatch, mode):
    """The block: pre-norm, the layer, the residual; the spec from the
    reduced mamba2-370m config.  A prefill with a state continues it."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    jcfg = jax_base.get_arch("mamba2-370m").reduced()
    pcfg = pt_base.get_arch("mamba2-370m").reduced()
    assert dataclasses.asdict(PB.ssm_spec(pcfg)) == \
        dataclasses.asdict(JB.ssm_spec(jcfg))
    tree = jax.device_get(JB.ssm_block_init(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(7)
    tree["ln"]["scale"] = 0.1 * rng.standard_normal(
        tree["ln"]["scale"].shape).astype(np.float32)
    decode = mode == "decode"
    seq = 1 if decode else SEQ
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    state_j = state_p = None
    if mode != "prefill":
        h, conv = PB.init_ssm_state(pcfg, 2, torch.float32, "cpu")
        h = rng.standard_normal(tuple(h.shape)).astype(np.float32)
        conv = rng.standard_normal(tuple(conv.shape)).astype(np.float32)
        state_j = (jnp.asarray(h), jnp.asarray(conv))
        state_p = (_t(h), _t(conv))
    ro, (rh, rc) = JB.ssm_block_apply(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), jcfg, state=state_j,
                                      decode=decode)
    ptree = jax.tree.map(lambda v: _t(v), tree)
    go, (gh, gc) = PB.ssm_block_apply(ptree, _t(x), pcfg, state=state_p,
                                      decode=decode)
    _close(go, ro, 1e-5 if decode else 1e-4)
    _close(gh, rh, 1e-5 if decode else 1e-4)
    _close(gc, rc)
