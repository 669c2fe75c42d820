"""The port's frontend models (musicgen-large, pixtral-12b) against the
JAX package's, on the CPU.

* The port's two config copies equal the JAX package's, field for field,
  at full size and reduced, and the full-size parameter counts are the
  reference's (2,428,143,616 and 12,253,025,280).
* Reduced, with the JAX init (norms and biases perturbed, as in
  ``tests/test_torch_serve.py``) carried over through numpy and the same
  precomputed frontend embeddings ``(B, S, frontend_dim)`` and prompts
  from a numpy seed: ``prefill`` with ``frontend_embed`` gives the
  reference's logits and every cache leaf within 1e-4 of their max, the
  embeddings change the logits, and 8 greedy decode steps (which take no
  frontend) give the reference's logits and tokens; ``launch.serve.serve``
  with the embeddings gives the same tokens.
* ``python -m repro_torch.examples.serve_batched --device cpu`` runs, and
  its tokens are ``serve``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import model as JM
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.examples import serve_batched
from repro_torch.launch import serve as pt_serve
from repro_torch.models import model as PM

import torch_threads  # noqa: F401,E402  (caps torch's threads)

ARCHS = {"musicgen-large": 2_428_143_616, "pixtral-12b": 12_253_025_280}
BATCH, PROMPT, STEPS = 2, 24, 8
#: leaves the JAX init leaves constant (zero or one), made random here
_PERTURBED = ("scale", "bias", "b_up", "b_down")


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["arch_type"] = d["arch_type"].value
    d["attn_kind"] = d["attn_kind"].value
    return d


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_reference(arch):
    for size in ("full", "reduced"):
        jc, pc = jax_base.get_arch(arch), pt_base.get_arch(arch)
        if size == "reduced":
            jc, pc = jc.reduced(), pc.reduced()
        assert _as_dict(jc) == _as_dict(pc), (arch, size)
        assert pc.frontend_dim > 0
    meta = PM.init_params(pt_base.get_arch(arch), torch.Generator(),
                          device="meta")
    assert PM.param_count(meta) == ARCHS[arch]


def _perturbed_params(cfg, seed):
    tree = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path) for v in t]
        a = np.asarray(t)
        if path[-1] in _PERTURBED:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return walk(tree)


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= rtol * scale, f"{what}: err {err} > {rtol} * {scale}"


def _close_caches(pc, jc, what):
    assert len(pc) == len(jc)
    for i, (p, j) in enumerate(zip(pc, jc)):
        assert set(p) == set(j), (what, i)
        for key in j:
            ref = np.asarray(j[key])
            assert tuple(p[key].shape) == ref.shape, (what, i, key)
            if np.issubdtype(ref.dtype, np.integer):
                np.testing.assert_array_equal(p[key].numpy(), ref)
            else:
                _close(p[key], ref, 1e-4, f"{what} cache {i}.{key}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_frontend_prefill_and_decode_match_jax(monkeypatch, arch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    jcfg = jax_base.get_arch(arch).reduced()
    pcfg = pt_base.get_arch(arch).reduced()
    tree = _perturbed_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size,
                           (BATCH, PROMPT)).astype(np.int32)
    fe = rng.standard_normal(
        (BATCH, PROMPT, jcfg.frontend_dim)).astype(np.float32)
    max_len = PROMPT + STEPS + 1
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    j_decode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t,
                                                           pos))
    with torch.inference_mode():
        jl, jc = JM.prefill(jcfg, jparams, jnp.asarray(prompts), max_len,
                            jnp.asarray(fe))
        pl, pc = PM.prefill(pcfg, params, torch.from_numpy(prompts).long(),
                            max_len, torch.from_numpy(fe))
        _close(pl, jl, 1e-4, "prefill logits")
        _close_caches(pc, jc, "prefill")
        # the embeddings take part: without them the logits move
        bare, _ = PM.prefill(pcfg, params, torch.from_numpy(prompts).long(),
                             max_len)
        assert float((bare - pl).abs().max()) > 1e-3 * float(
            pl.abs().max())
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ptok = pl[:, -1].argmax(-1)[:, None]
        greedy = [np.asarray(jtok)[:, 0]]
        for i in range(STEPS):
            np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
            pos = PROMPT + i
            jl, jc = j_decode(jparams, jc, jtok,
                              jnp.full((BATCH,), pos, jnp.int32))
            pl, pc = PM.decode_step(pcfg, params, pc, ptok,
                                    torch.full((BATCH,), pos))
            _close(pl, jl, 1e-4, f"decode step {i} logits")
            jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            ptok = pl[:, -1].argmax(-1)[:, None]
            greedy.append(np.asarray(jtok)[:, 0])
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        _close_caches(pc, jc, "decode")
    res = pt_serve.serve(pcfg, PM.DecoderLM(pcfg, params), prompts,
                         STEPS + 1, device="cpu", frontend_embed=fe)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.stack(greedy, axis=1))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_batched_example_runs(arch, capsys):
    toks = serve_batched.main(["--arch", arch, "--batch", "2",
                               "--prompt-len", "12", "--gen", "4",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"[{arch}-smoke] prefill 2x12")
    assert tuple(toks.shape) == (2, 4)
    cfg = pt_base.get_arch(arch).reduced()
    model = PM.DecoderLM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int64)
    want = pt_serve.serve(cfg, model, prompts, 4, "cpu")["tokens"]
    assert torch.equal(toks, want)
