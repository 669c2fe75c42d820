"""Sequence-sharded decode and the serving rules' cache split, on the CPU.

Worlds of gloo rank processes (``repro_torch.core.engine.world``): mesh
(1, 2) with a batch of 2 (the caches' sequence over "model"), mesh (2, 2)
with a batch of 1 (the batch does not divide over "data", so the sequence
splits over every axis, the reference's long_500k rule), and mesh (2, 2)
with a batch of 2 (the batch over "data", a row a rank pair, the sequence
over "model").  Each rank runs the full prefill, keeps its rows and slots
of every cache (``launch.serving.shard_cache``), and decodes its rows
(``launch.serving.batch_rows``) teacher-forced on the port's unsharded
greedy tokens, merging attention partials across its group
(``decode_step(..., seq_shard_axis, cache_total)``).  Cases, reduced:

* stablelm-1.6b (dense stages);
* gemma2-9b with window 8 < max_len 24 (a pair's local ring and global
  cache split with a start each): the 13-token prompt leaves the ring at
  slot 5, so decode wraps it past its end, across ranks;
* zamba2-7b (SSM groups and the shared block: the shared block's KV
  cache split, the SSM state whole on every rank of a row).

Every rank's logits of every step must equal the port's unsharded
``decode_step`` within 1e-5 of max|logits| (fp32) and the JAX package's
unsharded ``prefill``/``decode_step`` on the same numpy-carried params
within 1e-4 of max|logits| (``tests/test_torch_serve.py``'s tolerance);
the ranks' KV cache bytes sum to the world's, each rank's equal to the
dry-run's serving bytes, and a rank whose shard is still empty merges
without NaN.
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
from repro_torch.core.engine import world as W
from repro_torch.launch import dryrun, serving
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as PM

import torch_threads  # noqa: F401,E402  (caps torch's threads)
from test_torch_serve import _perturbed_params  # noqa: E402

PROMPT, STEPS, MAX_LEN = 13, 8, 24
CASES = {"stablelm-1.6b": {}, "gemma2-9b": {"window": 8}, "zamba2-7b": {}}
#: world → (mesh shape, batch)
WORLDS = {"2": ((1, 2), 2), "4": ((2, 2), 1), "4b2": ((2, 2), 2)}


def _cfgs(arch):
    return [dataclasses.replace(base.get_arch(arch).reduced(), **CASES[arch])
            for base in (jax_base, pt_base)]


def _prompts(cfg, batch):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (batch, PROMPT)).astype(np.int64)


def _kv_bytes(caches):
    total = 0

    def walk(t, name=""):
        nonlocal total
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif name in ("k", "v", "pos"):
            total += t.numel() * t.element_size()
    walk(caches)
    return total


def _first_pos(cfg, caches):
    """The ``pos`` of the first full-length KV cache layer on this rank."""
    c = caches[0]
    c = {"dense": c, "pair": c.get("global"), "zamba": c.get("attn")}[
        PM.build_stages(cfg)[0].kind]
    return c["pos"][0]


def _rank_decode(ctx, arch, tree, prompts, tokens, batch):
    """This rank's logits of every teacher-forced decode step of its rows
    on its sequence shard, its rows, KV cache bytes and group index."""
    cfg = _cfgs(arch)[1]
    params = params_from_numpy(tree, "cpu")
    axis = serving.seq_shard_axis(ctx, batch)
    totals = serving.cache_totals(cfg, batch, MAX_LEN)
    rows = serving.batch_rows(ctx.mesh, ctx.rank, batch)
    out = []
    with torch.inference_mode():
        _, full = PM.prefill(cfg, params, torch.from_numpy(prompts), MAX_LEN)
        caches = serving.shard_cache(cfg, full, ctx.mesh, ctx.rank, batch,
                                     MAX_LEN)
        del full
        kv = _kv_bytes(caches)
        empty = 0
        for i, tok in enumerate(tokens):
            empty += int(bool((_first_pos(cfg, caches) < 0).all()))
            logits, caches = PM.decode_step(
                cfg, params, caches, torch.from_numpy(tok[rows])[:, None],
                torch.full((rows.stop - rows.start,), PROMPT + i),
                seq_shard_axis=axis, cache_total=totals)
            assert torch.isfinite(logits).all()
            out.append(logits.numpy())
    return {"logits": out, "kv_bytes": kv, "index": axis.index,
            "rows": rows, "empty_steps": empty}


@pytest.fixture(scope="module")
def cases():
    """Per arch: the reference's and the port's unsharded logits, the
    greedy tokens, and every world's ranks' results."""
    out = {}
    for arch in CASES:
        jcfg, pcfg = _cfgs(arch)
        tree = _perturbed_params(jcfg, seed=4)
        out[arch] = {"tree": tree}
        for n, (_, batch) in WORLDS.items():
            prompts = _prompts(pcfg, batch)
            params = params_from_numpy(tree, "cpu")
            with torch.inference_mode():
                logits, caches = PM.prefill(pcfg, params,
                                            torch.from_numpy(prompts),
                                            MAX_LEN)
                tok = logits[:, -1].argmax(-1)
                tokens, port = [], []
                for i in range(STEPS):
                    tokens.append(tok.numpy())
                    logits, caches = PM.decode_step(
                        pcfg, params, caches, tok[:, None],
                        torch.full((batch,), PROMPT + i))
                    port.append(logits.numpy())
                    tok = logits[:, -1].argmax(-1)
            jparams = jax.tree.map(jnp.asarray, tree)
            jl, jc = jax.jit(lambda p, t, c=jcfg: JM.prefill(
                c, p, t, max_len=MAX_LEN))(jparams,
                                           jnp.asarray(prompts, jnp.int32))
            j_decode = jax.jit(lambda p, cache, t, pos, c=jcfg:
                               JM.decode_step(c, p, cache, t, pos))
            ref = []
            for i, t in enumerate(tokens):
                jl, jc = j_decode(jparams, jc,
                                  jnp.asarray(t, jnp.int32)[:, None],
                                  jnp.full((batch,), PROMPT + i, jnp.int32))
                ref.append(np.asarray(jl))
            out[arch][n] = {"prompts": prompts, "tokens": tokens,
                            "port": port, "jax": ref, "batch": batch}
    for n, (shape, batch) in WORLDS.items():
        with W.World(make_test_mesh(*shape), "cpu") as world:
            for arch in CASES:
                c = out[arch][n]
                c["ranks"] = world.call(_rank_decode, (
                    arch, out[arch]["tree"], c["prompts"], c["tokens"],
                    batch))
    return out


IDS = [(a, n) for a in CASES for n in WORLDS]


@pytest.mark.parametrize("arch,n", IDS, ids=[f"{a}-{n}" for a, n in IDS])
def test_sharded_decode_matches_unsharded(cases, arch, n):
    c = cases[arch][n]
    shape, batch = WORLDS[n]
    mesh = make_test_mesh(*shape)
    group = mesh.axis_size(serving.seq_axes(mesh, batch))
    assert sorted(r["index"] for r in c["ranks"]) == \
        sorted(list(range(group)) * (mesh.size // group))
    assert sorted((r["rows"].start, r["rows"].stop) for r in c["ranks"]) \
        == sorted([(i * batch // (mesh.size // group),
                    (i + 1) * batch // (mesh.size // group))
                   for i in range(mesh.size // group)] * group)
    for i, want in enumerate(c["port"]):
        scale = float(np.abs(want).max())
        for r in c["ranks"]:
            err = float(np.abs(r["logits"][i] - want[r["rows"]]).max())
            assert err <= 1e-5 * scale, (arch, n, i, err, scale)


@pytest.mark.parametrize("arch,n", IDS, ids=[f"{a}-{n}" for a, n in IDS])
def test_sharded_decode_matches_jax(cases, arch, n):
    c = cases[arch][n]
    for i, want in enumerate(c["jax"]):
        scale = float(np.abs(want).max())
        for r in c["ranks"]:
            err = float(np.abs(r["logits"][i] - want[r["rows"]]).max())
            assert err <= 1e-4 * scale, (arch, n, i, err, scale)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_rank_cache_bytes_are_the_dry_runs(cases, n):
    """stablelm's KV caches split evenly: each rank holds the dry-run's
    per-rank cache bytes, and the ranks together hold the whole cache."""
    c = cases["stablelm-1.6b"][n]
    shape, batch = WORLDS[n]
    cfg = _cfgs("stablelm-1.6b")[1]
    mesh = make_test_mesh(*shape)
    want = dryrun.serving_bytes(cfg, mesh, batch, MAX_LEN)["cache"]
    full = _kv_bytes(serving.cache_shapes(cfg, batch, MAX_LEN))
    assert [r["kv_bytes"] for r in c["ranks"]] == [want] * mesh.size
    assert want * mesh.size == full


@pytest.mark.parametrize("arch", list(CASES))
def test_an_empty_shard_merges_without_nan(cases, arch):
    """In the world of 4 the 13-token prompt leaves the last rank's slots
    of the 24-slot cache empty for the first decode steps: its partials
    hold m = -1e30, and the merged logits stay finite (checked on the
    rank) and equal the unsharded ones (the tests above)."""
    ranks = cases[arch]["4"]["ranks"]
    assert max(r["empty_steps"] for r in ranks) > 0


@pytest.mark.parametrize("mesh", ["1,2", "2,2"])
def test_serve_sharded_entry_point(mesh):
    """``python -m repro_torch.launch.serving`` (``serve_sharded``,
    reduced stablelm-1.6b, a batch of 2, ``--check``) on a world of 2
    (the sequence split) and of 4 (a row over each "data" index, its
    sequence split over "model"): every rank's bf16 greedy tokens are
    those of the other ranks of its rows, its fp32 check logits within
    1e-5 of max|logits| of rank 0's whole-cache decode of its rows, its
    KV shard the dry-run's bytes."""
    out = serving.main(["--arch", "stablelm-1.6b", "--reduced", "--batch",
                        "2", "--prompt-len", "20", "--gen", "5", "--mesh",
                        mesh, "--check", "--device", "cpu"])
    whole = out[0].arrays["whole_logits"]
    cfg = _cfgs("stablelm-1.6b")[1]
    shape = tuple(int(x) for x in mesh.split(","))
    want = dryrun.serving_bytes(cfg, make_test_mesh(*shape), 2, 25)["cache"]
    seen = {}
    for p in out:
        rows = slice(*p.meta["rows"])
        toks = p.arrays["tokens"]
        assert toks.shape == (rows.stop - rows.start, 5)
        np.testing.assert_array_equal(toks, seen.setdefault(p.meta["rows"],
                                                            toks))
        err = np.abs(p.arrays["check_logits"] - whole[:, rows]).max()
        assert err <= 1e-5 * np.abs(whole).max()
        assert p.meta["kv_bytes"] == want
        assert p.meta["collectives"]["all_reduce"] == 3 * cfg.n_layers * 4
    assert sorted(seen) == ([(0, 2)] if shape[0] == 1 else [(0, 1), (1, 2)])
