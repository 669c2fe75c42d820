"""Tensor-parallel serving (``launch.serving``: the reference's
``build_prefill`` / ``build_decode``) on worlds of gloo rank processes.

Each rank holds only its shard of every weight (``shard_params``, the
rules of ``param_shardings``) and of every cache leaf (``rank_caches``,
the rules of ``cache_shardings``), prefills its rows of the batch
(``batch_rows``) and decodes them teacher-forced on the port's unsharded
greedy tokens, issuing the collectives of ``TensorAxis``.  One world a
mesh, every case inside it:

* meshes (1, 2), (2, 2) (the batch over "data") and (1, 4), each with the
  reduced stablelm-1.6b (dense), qwen3-moe-30b-a3b (the experts split),
  mamba2-370m (the SSM heads split, ``in_proj``/conv gathered),
  gemma2-9b with window 8 < max_len (a pair's local ring and global
  cache, each with its own start) and zamba2-7b (SSM groups and the
  shared block); on (1, 4) a prompt of 140 tokens, more than d_model,
  so the prefill gathers weights (``wk``/``wv``, ``in_proj``, conv) where
  the shorter prompts gather its tokens' activations;
* mesh (2, 4) with stablelm-1.6b at B 4, S 64: the reference's own test
  (``tests/integration/test_spmd_cephalo.py::
  test_sharded_decode_matches_unsharded``), ported;
* mesh (1, 8): the reduced models' 4 heads fall back to the ``head_dim``
  split (``wq``/``wk``/``wv`` gathered for the layer, ``wo`` by
  ``d_model``), qwen3's 4 experts to the ``d_ff`` split.

The prefill's logits and every decode step's must be within 1e-5 of
max|logits| of the port's unsharded ``prefill`` / ``decode_step`` (fp32)
and within 1e-4 of the JAX package's on the same numpy-carried params,
with the same greedy tokens; every leaf a rank holds has the shard shape
of its rule.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import model as JM
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import world as W
from repro_torch.launch import dryrun, serving
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as PM

import torch_threads  # noqa: F401,E402  (caps torch's threads)
from test_torch_serve import _perturbed_params  # noqa: E402

ARCHS = {"stablelm-1.6b": {}, "qwen3-moe-30b-a3b": {}, "mamba2-370m": {},
         "gemma2-9b": {"window": 8}, "zamba2-7b": {}}
#: (prompt, decode steps, cache slots, batch): fewer tokens a rank than
#: d_model (the layers gather the K/V, projections and conv outputs of
#: their tokens), or more (LONG: they gather wk/wv, in_proj, conv_w)
SMALL = (13, 8, 24, 2)
LONG = (140, 8, 148, 2)
#: mesh → {arch: (prompt, steps, max_len, batch)}
WORLDS = {
    (1, 2): {a: SMALL for a in ARCHS},
    (2, 2): {a: SMALL for a in ARCHS},
    (1, 4): {a: LONG for a in ARCHS},
    (2, 4): {"stablelm-1.6b": (64, 4, 68, 4)},
    (1, 8): {"stablelm-1.6b": SMALL, "qwen3-moe-30b-a3b": SMALL},
}
CASES = [(m, a) for m, archs in WORLDS.items() for a in archs]


def _cfgs(arch):
    return [dataclasses.replace(base.get_arch(arch).reduced(), **ARCHS[arch])
            for base in (jax_base, pt_base)]


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _shapes_follow(mesh, tree, shapes, specs) -> bool:
    """Whether every leaf of ``tree`` has its rule's shard shape (the
    trees walked key by key)."""
    if isinstance(tree, dict):
        return tree.keys() == shapes.keys() and all(
            _shapes_follow(mesh, tree[k], shapes[k], specs[k]) for k in tree)
    if isinstance(tree, list):
        return len(tree) == len(shapes) and all(
            _shapes_follow(mesh, *x) for x in zip(tree, shapes, specs))
    return tuple(tree.shape) == mesh.shard_shape(shapes.shape, specs)


def _rank_tp(ctx, arch, tree, prompts, tokens, max_len):
    """This rank's tensor-parallel prefill and teacher-forced decode of its
    rows: the logits of each, and whether its weights and caches at rest
    have their rules' shard shapes."""
    cfg = _cfgs(arch)[1]
    mesh = ctx.mesh
    batch, plen = prompts.shape
    rows = serving.batch_rows(mesh, ctx.rank, batch)
    with torch.inference_mode():
        params = serving.shard_params(cfg, params_from_numpy(tree, "cpu"),
                                      mesh, ctx.rank)
        caches = serving.rank_caches(cfg, mesh, batch, max_len, "cpu")
        at_rest = (
            _shapes_follow(mesh, params, serving.param_shapes(cfg),
                           serving.param_shardings(cfg, mesh)),
            _shapes_follow(mesh, caches, serving.cache_shapes(
                cfg, batch, max_len), serving.cache_shardings(
                cfg, mesh, batch, max_len)))
        tp = serving.tensor_axis(ctx)
        axis = serving.seq_shard_axis(ctx, batch)
        totals = serving.cache_totals(cfg, batch, max_len)
        logits, caches = PM.prefill(
            cfg, params, torch.from_numpy(prompts[rows]), max_len, tp=tp,
            seq_shard_axis=axis, caches=caches)
        out = [logits.numpy()]
        for i, tok in enumerate(tokens):
            logits, caches = PM.decode_step(
                cfg, params, caches, torch.from_numpy(tok[rows])[:, None],
                torch.full((rows.stop - rows.start,), plen + i),
                seq_shard_axis=axis, cache_total=totals, tp=tp)
            out.append(logits.numpy())
    return {"logits": out, "rows": rows, "at_rest": at_rest,
            "calls": dict(ctx.comm.calls)}


def _unsharded(arch, tree, prompts, steps, max_len):
    """The port's and the JAX package's unsharded logits (prefill, then
    each greedy decode step) and the greedy tokens fed."""
    jcfg, pcfg = _cfgs(arch)
    batch, plen = prompts.shape
    params = params_from_numpy(tree, "cpu")
    with torch.inference_mode():
        logits, caches = PM.prefill(pcfg, params, torch.from_numpy(prompts),
                                    max_len)
        port, tokens = [logits.numpy()], []
        tok = logits[:, -1].argmax(-1)
        for i in range(steps):
            tokens.append(tok.numpy())
            logits, caches = PM.decode_step(pcfg, params, caches,
                                            tok[:, None],
                                            torch.full((batch,), plen + i))
            port.append(logits.numpy())
            tok = logits[:, -1].argmax(-1)
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, max_len=max_len))(
        jparams, jnp.asarray(prompts, jnp.int32))
    ref = [np.asarray(jl)]
    j_decode = jax.jit(lambda p, c, t, q: JM.decode_step(jcfg, p, c, t, q))
    for i, t in enumerate(tokens):
        jl, jc = j_decode(jparams, jc, jnp.asarray(t, jnp.int32)[:, None],
                          jnp.full((batch,), plen + i, jnp.int32))
        ref.append(np.asarray(jl))
    return port, ref, tokens


@pytest.fixture(scope="module")
def results():
    trees = {a: _perturbed_params(_cfgs(a)[0], seed=4) for a in ARCHS}
    out, unsharded = {}, {}
    for shape, archs in WORLDS.items():
        cases = {}
        for arch, (plen, steps, max_len, batch) in archs.items():
            prompts = np.random.default_rng(7).integers(
                0, _cfgs(arch)[1].vocab_size, (batch, plen)).astype(np.int64)
            key = (arch, plen, steps, max_len, batch)
            if key not in unsharded:
                unsharded[key] = _unsharded(arch, trees[arch], prompts,
                                            steps, max_len)
            port, ref, tokens = unsharded[key]
            cases[arch] = {"port": port, "jax": ref, "tokens": tokens,
                           "prompts": prompts, "max_len": max_len}
        with W.World(make_test_mesh(*shape), "cpu") as world:
            for arch, c in cases.items():
                c["ranks"] = world.call(_rank_tp, (
                    arch, trees[arch], c["prompts"], c["tokens"],
                    c["max_len"]))
                out[shape, arch] = c
    return out


def _ids(cases):
    return [f"{a}-{m[0]}x{m[1]}" for m, a in cases]


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_tp_serving_matches_unsharded(results, mesh, arch):
    """Prefill and every decode step within 1e-5 of max|logits| of the
    port's unsharded path, the same greedy tokens, on every rank."""
    c = results[mesh, arch]
    for i, want in enumerate(c["port"]):
        scale = float(np.abs(want).max())
        for r in c["ranks"]:
            got = r["logits"][i]
            ref = want[r["rows"]]
            err = float(np.abs(got - ref).max())
            assert err <= 1e-5 * scale, (mesh, arch, i, err, scale)
            np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                          ref[:, -1].argmax(-1))


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_tp_serving_matches_jax(results, mesh, arch):
    """Within 1e-4 of max|logits| of the JAX package's unsharded
    ``prefill`` / ``decode_step`` on the same params."""
    c = results[mesh, arch]
    for i, want in enumerate(c["jax"]):
        scale = float(np.abs(want).max())
        for r in c["ranks"]:
            err = float(np.abs(r["logits"][i] - want[r["rows"]]).max())
            assert err <= 1e-4 * scale, (mesh, arch, i, err, scale)


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_leaves_at_rest_are_shards(results, mesh, arch):
    """Every weight and cache leaf a rank holds has the shard shape of its
    rule, and the collectives ran (the ranks did not each compute the
    whole model)."""
    for r in results[mesh, arch]["ranks"]:
        assert r["at_rest"] == (True, True)
        assert r["calls"]["all_reduce"] > 0 and r["calls"]["all_gather"] > 0


def test_head_dim_fallback_splits_no_heads():
    """On mesh (1, 8) the reduced stablelm's 4 heads do not split: its
    ``wq``/``wk``/``wv`` are split by ``head_dim`` and ``wo`` by
    ``d_model``, qwen3's experts by ``d_ff`` (the rules' fallbacks the
    cases above ran)."""
    mesh = make_test_mesh(1, 8)
    specs = serving.param_shardings(_cfgs("stablelm-1.6b")[1], mesh)
    attn = specs["stages"][0]["attn"]
    assert attn["wq"] == (None, None, None, "model")
    assert attn["wk"] == attn["wv"] == (None, None, None, "model")
    assert attn["wo"] == (None, None, None, "model")
    moe = serving.param_shardings(_cfgs("qwen3-moe-30b-a3b")[1],
                                  mesh)["stages"][0]["moe"]
    assert moe["w_gate"] == (None, None, None, "model")
    assert moe["w_down"] == (None, None, "model", None)


@pytest.mark.parametrize("arch", pt_base.ASSIGNED)
def test_shard_params_bytes_are_the_dry_runs(arch):
    """``shard_params`` on the bf16 serving shapes (meta tensors) gives
    each rank of mesh (1, 2) the dry-run's per-rank weight bytes."""
    cfg = pt_base.get_arch(arch)
    mesh = make_test_mesh(1, 2)
    want = dryrun.serving_bytes(cfg, mesh, 1, 16)["weights"]
    shapes = serving.serving_param_shapes(cfg)
    for rank in range(mesh.size):
        got = sum(math.prod(t.shape) * t.element_size() for t in _leaves(
            serving.shard_params(cfg, shapes, mesh, rank)))
        assert got == want, (arch, rank, got, want)


#: arch → the mesh its ``--check`` run is on: (2, 2) splits the batch, so
#: rank 0's prefill check takes its rows of the gathered caches
CHECK_MESHES = {"qwen3-moe-30b-a3b": (1, 2), "mamba2-370m": (1, 2),
                "gemma2-9b": (2, 2)}
CHECK_ARCHS = tuple(CHECK_MESHES)


@pytest.fixture(scope="module")
def checked():
    """``serve_sharded(..., check=True)`` of each of CHECK_ARCHS (reduced,
    fp32) on a world of its mesh: a batch of 2, 24 prompt tokens (past
    gemma2's window of 8), 5 generated."""
    out = {}
    for shape in sorted(set(CHECK_MESHES.values())):
        mesh = make_test_mesh(*shape)
        with W.World(mesh, "cpu") as world:
            for arch in (a for a, m in CHECK_MESHES.items() if m == shape):
                cfg = _cfgs(arch)[1]
                prompts = np.random.default_rng(3).integers(
                    0, cfg.vocab_size, (2, 24))
                out[arch] = serving.serve_sharded(
                    cfg, prompts, 5, mesh, "cpu", check=True, world=world)
    return out


@pytest.mark.parametrize("arch", CHECK_ARCHS)
def test_check_holds_the_prefill_to_the_unsharded_one(checked, arch):
    """The check's prefill, block by block: rank 0's unsharded blocks,
    each fed the tensor-parallel prefill's input to it, give its
    embedding, every block's output and its last-position logits within
    1e-5 of max|value|, and every leaf of the caches gathered from the
    ranks' shards (layer by layer) within 1e-5 (``pos`` equal)."""
    cfg = _cfgs(arch)[1]
    pre = checked[arch][0].meta["prefill_check"]
    assert len(pre["blocks"]) == sum(
        1 for _ in PM._sub_blocks(cfg, PM.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"),
            PM.init_cache(cfg, 1, 4, "cpu")))
    assert max(pre["embed"], pre["logits"], *pre["blocks"]) <= 1e-5, pre
    assert pre["caches"] and max(pre["caches"].values()) <= 1e-5, pre


@pytest.mark.parametrize("arch", CHECK_ARCHS)
def test_routes_are_the_experts_each_decode_chose(checked, arch):
    """``routes``: the experts each MoE layer of each decode step chose
    (steps, layers, rows, K), sorted; in fp32 the tensor-parallel decode
    chooses the unsharded decode's (``whole_routes``); a model without
    MoE has none."""
    cfg = _cfgs(arch)[1]
    out = checked[arch]
    whole = out[0].arrays["whole_routes"]
    layers, k = ((cfg.n_layers, cfg.experts_per_token) if cfg.is_moe
                 else (0, 0))
    assert whole.shape == (4, layers, 2, k)
    if cfg.is_moe:
        assert (np.diff(whole, axis=-1) > 0).all()
    for p in out:
        np.testing.assert_array_equal(p.arrays["routes"],
                                      whole[:, :, slice(*p.meta["rows"])])


def test_cache_errs_see_one_moved_slot():
    """``_cache_errs``: one KV slot moved in one layer reads as an error
    of the size of the slot's values (a norm over the leaf would dilute
    it); a changed ``pos`` reads inf."""
    gen = torch.Generator().manual_seed(0)
    want = [{"k": torch.randn(3, 2, 64, 2, 8, generator=gen),
             "pos": torch.arange(64).expand(3, 2, 64).clone()}]
    got = [{"k": want[0]["k"].clone(), "pos": want[0]["pos"].clone()}]
    assert serving._cache_errs(got, want) == {"[0].k": 0.0, "[0].pos": 0.0}
    got[0]["k"][1, 0, 40] = want[0]["k"][1, 0, 41]
    got[0]["pos"][2, 1, 5] = -1
    errs = serving._cache_errs(got, want)
    assert errs["[0].k"] > 0.3 and errs["[0].pos"] == math.inf
