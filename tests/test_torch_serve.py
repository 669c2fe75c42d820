"""The PyTorch port's serving path against the JAX package, on the CPU.

Both packages get the same parameters (the JAX init, perturbed where it
is constant so norms, biases and skips matter, handed over as numpy) and
the same prompts; prefill logits, every leaf of every cache and four
greedy decode steps must agree within 1e-4 of max|logits| (of max|leaf|
for caches), with identical greedy tokens.  Also:
the port imports neither JAX nor the JAX package, and its entry points
refuse to fall back to the CPU when CUDA is asked for and absent.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import model as JM
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core.fsdp import tree_flatten
from repro_torch.launch import serve as pt_serve
from repro_torch.models import model as PM

import torch_threads  # noqa: F401,E402  (caps torch's threads)

REPO = Path(__file__).resolve().parents[1]

# (arch, overrides applied to the reduced config on both sides, prompt)
SERVE_CASES = [
    ("llama-7b", {}, 16),                        # SwiGLU, MHA
    ("gemma-2b", {}, 16),                        # MQA, tied, GeGLU, scale
    ("gpt-1.3b", {}, 16),                        # GELU with biases
    ("llama-7b", {"n_kv_heads": 2}, 16),         # GQA
    ("llama-7b", {"attn_kind": "sliding", "window": 8}, 16),  # ring buffer
    ("mamba2-370m", {}, 40),                     # SSM; ragged vs chunk 32
    ("mixtral-8x7b", {}, 16),                    # MoE 4/2 (reduced), SWA
    ("qwen3-moe-30b-a3b", {}, 16),               # MoE 4/2 (reduced), GQA
    ("gemma2-9b", {}, 16),                       # local/global pair, caps
    ("gemma2-9b", {"n_layers": 3}, 16),          # a pair, then one global
    ("zamba2-7b", {}, 40),                       # SSM group + shared block
    ("zamba2-7b", {"n_layers": 5}, 40),          # 2 groups, then 1 SSM
    ("yi-34b", {}, 16),                          # dense, rope theta 5e6
]
SERVE_IDS = [f"{a}-{'-'.join(o) or 'base'}" for a, o, _ in SERVE_CASES]
BATCH, STEPS = 2, 4
#: leaves the JAX init leaves constant (zero or one), made random here
_PERTURBED = ("scale", "bias", "b_up", "b_down", "conv_b", "d_skip")


def _cfgs(arch, overrides):
    out = []
    for base in (jax_base, pt_base):
        cfg = base.get_arch(arch).reduced()
        kw = dict(overrides)
        if "attn_kind" in kw:
            kw["attn_kind"] = base.AttnKind(kw["attn_kind"])
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _perturbed_params(cfg, seed):
    """JAX init on the host, with norms, biases and skips (constant at
    init) made random so that they take part in the comparison."""
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


def _close(got, ref, scale, rtol, what):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(ref, np.float64)).max())
    assert err <= rtol * scale, f"{what}: err {err} > {rtol} * {scale}"


def _close_caches(pc, jc, what):
    """Every leaf of every stage's cache, down the nested dicts of pair
    (``local``, ``global``) and zamba (``h``, ``conv``, ``attn``) stages:
    integer leaves (positions) exactly, float leaves within 1e-4 of the
    leaf's max magnitude."""
    assert len(pc) == len(jc)

    def walk(p, j, where):
        if isinstance(j, dict):
            assert set(p) == set(j), (where, set(p), set(j))
            for key in j:
                walk(p[key], j[key], f"{where}.{key}")
            return
        ref = np.asarray(j)
        assert tuple(p.shape) == ref.shape, (where, p.shape, ref.shape)
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(p.numpy(), ref, err_msg=where)
        else:
            _close(p, ref, float(np.abs(ref).max()), 1e-4, where)

    for i, (p_stage, j_stage) in enumerate(zip(pc, jc)):
        walk(p_stage, j_stage, f"{what} cache {i}")


def _prompts(cfg, prompt):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)


@pytest.mark.parametrize("arch,overrides,prompt", SERVE_CASES, ids=SERVE_IDS)
def test_prefill_decode_match_jax(monkeypatch, arch, overrides, prompt):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    jcfg, pcfg = _cfgs(arch, overrides)
    tree = _perturbed_params(jcfg, seed=0)
    prompts = _prompts(jcfg, prompt)
    max_len = prompt + STEPS + 1

    jparams = jax.tree.map(jnp.asarray, tree)
    j_prefill = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, max_len=max_len))
    j_decode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t,
                                                           pos))
    params = params_from_numpy(tree, "cpu")

    with torch.inference_mode():
        jl, jc = j_prefill(jparams, jnp.asarray(prompts))
        pl, pc = PM.prefill(pcfg, params, torch.from_numpy(prompts).long(),
                            max_len)
        scale = float(jnp.abs(jl).max())
        _close(pl, jl, scale, 1e-4, "prefill logits")
        _close_caches(pc, jc, "prefill")

        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ptok = pl[:, -1].argmax(-1)[:, None]
        greedy = [np.asarray(jtok)[:, 0]]
        for i in range(STEPS):
            np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
            pos = prompt + i
            jl, jc = j_decode(jparams, jc, jtok,
                              jnp.full((BATCH,), pos, jnp.int32))
            pl, pc = PM.decode_step(pcfg, params, pc, ptok,
                                    torch.full((BATCH,), pos))
            _close(pl, jl, float(jnp.abs(jl).max()), 1e-4,
                   f"decode step {i} logits")
            jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            ptok = pl[:, -1].argmax(-1)[:, None]
            greedy.append(np.asarray(jtok)[:, 0])
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        _close_caches(pc, jc, "decode")

    # the entry point a user calls gives the same greedy tokens
    res = pt_serve.serve(pcfg, PM.DecoderLM(pcfg, params), prompts,
                         STEPS + 1, device="cpu")
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.stack(greedy, axis=1))


@pytest.mark.parametrize("arch", ["mamba2-370m", "llama-7b"])
def test_prefill_matches_jax_pallas_interpret(monkeypatch, arch):
    """The port's prefill logits against the JAX package running its
    Pallas kernels in interpret mode (the SSD scan for mamba2, flash
    attention for llama).  Caches are not compared: that path of the JAX
    package leaves the SSM state zero (ROADMAP, reference quirks)."""
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    jcfg, pcfg = _cfgs(arch, {})
    tree = _perturbed_params(jcfg, seed=3)
    prompts = _prompts(jcfg, 40)
    jl, _ = JM.prefill(jcfg, jax.tree.map(jnp.asarray, tree),
                       jnp.asarray(prompts), max_len=41)
    with torch.inference_mode():
        pl, _ = PM.prefill(pcfg, params_from_numpy(tree, "cpu"),
                           torch.from_numpy(prompts).long(), 41)
    _close(pl, jl, float(jnp.abs(jl).max()), 1e-4, "prefill logits")


@pytest.mark.parametrize("arch", ["llama-7b", "gemma-2b"])
def test_embed_and_head_match(arch):
    """Embedding (with gemma's sqrt(d) scale) and the fp32 head (tied for
    gemma), outside the norms that would hide a scale error."""
    jcfg, pcfg = _cfgs(arch, {})
    tree = _perturbed_params(jcfg, seed=2)
    params = params_from_numpy(tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 5))
    pos = np.tile(np.arange(5), (2, 1))
    ref = JM.embed_tokens(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos))
    got = PM.embed_tokens(pcfg, params, torch.from_numpy(toks),
                          torch.from_numpy(pos))
    _close(got, ref, float(jnp.abs(ref).max()), 1e-6, "embed")
    h = np.random.default_rng(4).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    ref = JM.head_logits(jcfg, jparams, jnp.asarray(h))
    got = PM.head_logits(pcfg, params, torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close(got, ref, float(jnp.abs(ref).max()), 1e-5, "head")


def test_reduced_configs_identical():
    """The port's config copies equal the JAX package's, at full size and
    reduced."""
    for name in ("llama-7b", "gemma-2b", "gpt-1.3b", "stablelm-1.6b",
                 "tiny-llama", "bert-large", "mamba2-370m", "mixtral-8x7b",
                 "qwen3-moe-30b-a3b", "gemma2-9b", "zamba2-7b", "yi-34b"):
        for size in ("full", "reduced"):
            jc, pc = jax_base.get_arch(name), pt_base.get_arch(name)
            if size == "reduced":
                jc, pc = jc.reduced(), pc.reduced()
            j, p = dataclasses.asdict(jc), dataclasses.asdict(pc)
            for d in (j, p):
                d["arch_type"] = d["arch_type"].value
                d["attn_kind"] = d["attn_kind"].value
            assert j == p, (name, size)


def test_model_holds_bf16_weights_fp32_norms():
    cfg = pt_base.get_arch("llama-7b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    model = PM.DecoderLM.init(cfg, gen, device="cpu")
    p = model.params
    assert p["stages"][0]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert p["stages"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert p["embed"].dtype == torch.bfloat16
    assert p["stages"][0]["ln_attn"]["scale"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    names = dict(model.named_parameters())
    assert "tree.stages.0.mlp.w_gate" in names
    # the dict is built once and its leaves are the registered parameters
    assert model.params is p
    assert p["stages"][0]["mlp"]["w_gate"] is names["tree.stages.0.mlp.w_gate"]
    assert not any(t.requires_grad for t in names.values())


_SSM_FP32 = (("ln", "scale"), ("ssd", "gate_norm", "scale"), ("ssd", "a_log"),
             ("ssd", "dt_bias"), ("ssd", "d_skip"), ("ssd", "conv_b"))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_ssm_model_stores_fp32_leaves():
    """A bf16 mamba2 keeps in fp32 every leaf the JAX package keeps and
    uses in fp32, from ``init_params`` and from ``params_from_numpy``;
    the matmul weights and the conv weight are bf16."""
    cfg = dataclasses.replace(pt_base.get_arch("mamba2-370m").reduced(),
                              dtype="bfloat16")
    model = PM.DecoderLM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jax_base.get_arch("mamba2-370m").reduced()
    loaded = params_from_numpy(_perturbed_params(jcfg, seed=0), "cpu",
                               dtype=torch.bfloat16)
    for params in (model.params, loaded):
        stage = params["stages"][0]
        assert stage["ssd"]["in_proj"].shape == (2, 256, 2 * 512 + 2 * 16
                                                 + 512 // 32)
        for path in _SSM_FP32:
            assert _leaf(stage, path).dtype == torch.float32, path
        for path in (("ssd", "in_proj"), ("ssd", "out_proj"),
                     ("ssd", "conv_w")):
            assert _leaf(stage, path).dtype == torch.bfloat16, path
        assert params["final_norm"]["scale"].dtype == torch.float32
        assert params["embed"].dtype == torch.bfloat16
    caches = PM.init_cache(cfg, 3, 10, "cpu")
    assert caches[0]["h"].shape == (2, 3, 16, 32, 16)
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].shape == (2, 3, 3, 512 + 2 * 16)
    assert caches[0]["conv"].dtype == torch.bfloat16


def test_hybrid_model_stores_fp32_leaves():
    """A bf16 zamba2 keeps in fp32 the leaves the JAX package keeps in
    fp32, in the twice-stacked SSM blocks and in the ``shared`` block,
    from ``init_params`` and from ``params_from_numpy``; the rest is bf16,
    and the loaded tree keeps the JAX package's values leaf for leaf."""
    cfg = dataclasses.replace(pt_base.get_arch("zamba2-7b").reduced(),
                              dtype="bfloat16")
    model = PM.DecoderLM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    jtree = _perturbed_params(jax_base.get_arch("zamba2-7b").reduced(), 0)
    loaded = params_from_numpy(jtree, "cpu", dtype=torch.bfloat16)
    for params in (model.params, loaded):
        mamba = params["stages"][0]["mamba"]
        assert mamba["ssd"]["in_proj"].shape[:2] == (1, 2)
        for path in _SSM_FP32:
            assert _leaf(mamba, path).dtype == torch.float32, path
        assert mamba["ssd"]["out_proj"].dtype == torch.bfloat16
        shared = params["shared"]
        assert shared["ln_attn"]["scale"].dtype == torch.float32
        assert shared["attn"]["wq"].dtype == torch.bfloat16
        assert shared["mlp"]["w_up"].dtype == torch.bfloat16
    for t, x in zip(tree_flatten(loaded)[0], jax.tree.leaves(jtree)):
        assert tuple(t.shape) == x.shape
        if t.dtype == torch.float32:
            np.testing.assert_array_equal(t.numpy(), x)
    caches = PM.init_cache(cfg, 3, 10, "cpu")
    assert set(caches[0]) == {"h", "conv", "attn"}
    assert caches[0]["h"].shape == (1, 2, 3, 16, 32, 16)
    assert caches[0]["attn"]["k"].shape == (1, 3, 10, 4, 64)


def test_full_width_mamba2_tree():
    """mamba2-370m at full width keeps the JAX tree and its 419,825,152
    parameters (built on the meta device: shapes only, nothing drawn)."""
    cfg = pt_base.get_arch("mamba2-370m")
    assert [(s.kind, s.count) for s in PM.build_stages(cfg)] == [("ssm", 48)]
    params = PM.init_params(cfg, None, "meta")
    assert params["stages"][0]["ssd"]["in_proj"].shape == (48, 1024, 4384)
    assert params["stages"][0]["ssd"]["out_proj"].shape == (48, 2048, 1024)
    assert params["stages"][0]["ssd"]["conv_w"].shape == (48, 4, 2304)
    assert PM.param_count(params) == 419_825_152


@pytest.mark.parametrize("arch,count,layers", [
    ("qwen3-moe-30b-a3b", 30_532_110_336, 48),
    ("mixtral-8x7b", 46_702_792_704, 32)])
def test_full_width_moe_tree(arch, count, layers):
    """The MoE models at full width keep the JAX tree (``moe`` in place
    of ``mlp``, experts stacked (L, E, ...)) and its parameter count
    (meta device: shapes only); bf16 storage but for the norms."""
    cfg = pt_base.get_arch(arch)
    params = PM.init_params(cfg, None, "meta")
    assert [(s.kind, s.count) for s in PM.build_stages(cfg)] == \
        [("dense", layers)]
    stage = params["stages"][0]
    assert "mlp" not in stage
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(t.shape) for k, t in stage["moe"].items()} == {
        "router": (layers, d, e), "w_gate": (layers, e, d, f),
        "w_up": (layers, e, d, f), "w_down": (layers, e, f, d)}
    assert stage["moe"]["w_up"].dtype == torch.bfloat16
    assert stage["ln_mlp"]["scale"].dtype == torch.float32
    assert PM.param_count(params) == count
    jcfg, pcfg = _cfgs(arch, {})
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    small, _ = tree_flatten(PM.init_params(pcfg, None, "meta"))
    assert [tuple(t.shape) for t in small] == \
        [x.shape for x in jax.tree.leaves(jshapes)]


def test_sliding_window_ring_buffer_wraparound():
    """``tests/test_elastic_and_cache.py``'s wrap check on the port, held
    against the JAX package: reduced mixtral (window 128), a prefill of
    64 tokens, then decode to 200, past the ring's wrap at 128.  At
    positions 64, 130, 160 and 199 the port's decode logits must match
    the JAX package's full drop-free forward over the prefix within 1e-4
    of max|logits| (fp32; the reference's own test allows 2e-3)."""
    jcfg, pcfg = _cfgs("mixtral-8x7b", {})
    assert pcfg.window == 128
    tree = _perturbed_params(jcfg, seed=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    total, prefix = 200, 64
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (1, total)).astype(np.int32)
    ptoks = torch.from_numpy(toks).long()
    with torch.inference_mode():
        _, caches = PM.prefill(pcfg, params, ptoks[:, :prefix], total)
        assert caches[0]["k"].shape[-3] == 128        # the ring buffer
        for pos in range(prefix, total):
            logits, caches = PM.decode_step(pcfg, params, caches,
                                            ptoks[:, pos:pos + 1],
                                            torch.full((1,), pos))
            if pos in (prefix, 130, 160, total - 1):
                h, _ = JM.forward_hidden(jcfg, jparams,
                                         jnp.asarray(toks[:, :pos + 1]),
                                         remat="none", dropless=True)
                ref = JM.head_logits(jcfg, jparams, h[:, -1:])
                _close(logits, ref, float(jnp.abs(ref).max()), 1e-4,
                       f"decode at {pos}")


def test_pair_ring_buffer_wraps_as_the_reference():
    """gemma2's local cache is a ring past its window: reduced gemma2-9b
    (window 128, one local/global pair), a prompt of 200 (the prefill's
    window masks, and the ring holds positions 72..199), then 16 greedy
    decode steps.  Tokens, logits and every cache leaf against the JAX
    package's ``prefill``/``decode_step`` at each step (1e-4)."""
    jcfg, pcfg = _cfgs("gemma2-9b", {})
    assert pcfg.window == 128
    tree = _perturbed_params(jcfg, seed=7)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    prompt, steps = 200, 16
    max_len = prompt + steps
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    j_decode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t,
                                                           pos))
    with torch.inference_mode():
        jl, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks), max_len)
        pl, pc = PM.prefill(pcfg, params, torch.from_numpy(toks).long(),
                            max_len)
        assert tuple(pc[0]["local"]["k"].shape[1:3]) == (BATCH, 128)
        assert tuple(pc[0]["global"]["k"].shape[1:3]) == (BATCH, max_len)
        assert sorted(pc[0]["local"]["pos"][0, 0].tolist()) == \
            list(range(prompt - 128, prompt))
        _close(pl, jl, float(jnp.abs(jl).max()), 1e-4, "prefill logits")
        _close_caches(pc, jc, "prefill")
        for i in range(steps):
            jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            ptok = pl[:, -1].argmax(-1)[:, None]
            np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
            pos = prompt + i
            jl, jc = j_decode(jparams, jc, jtok,
                              jnp.full((BATCH,), pos, jnp.int32))
            pl, pc = PM.decode_step(pcfg, params, pc, ptok,
                                    torch.full((BATCH,), pos))
            _close(pl, jl, float(jnp.abs(jl).max()), 1e-4,
                   f"decode step {i} logits")
            _close_caches(pc, jc, f"decode step {i}")


@pytest.mark.parametrize("arch,count,stages", [
    ("gemma2-9b", 9_241_705_984, [("pair", 21, 0)]),
    ("zamba2-7b", 6_751_130_832, [("zamba", 13, 6), ("ssm", 3, 0)]),
    ("yi-34b", 34_388_917_248, [("dense", 60, 0)])])
def test_full_width_pair_hybrid_trees(arch, count, stages):
    """gemma2-9b, zamba2-7b and yi-34b at full width keep the JAX package's
    parameter count, stages and (reduced) leaf shapes, on the meta device;
    a zamba stage is stacked twice, its ``shared`` block once, and the SSM
    blocks' fp32 leaves stay fp32 in a bf16 model."""
    cfg = pt_base.get_arch(arch)
    assert [(s.kind, s.count, s.inner) for s in PM.build_stages(cfg)] == \
        stages
    params = PM.init_params(cfg, None, "meta")
    assert PM.param_count(params) == count
    if arch == "zamba2-7b":
        ssd = params["stages"][0]["mamba"]["ssd"]
        assert tuple(ssd["out_proj"].shape) == (13, 6, 7168, 3584)
        assert ssd["out_proj"].dtype == torch.bfloat16
        assert ssd["a_log"].dtype == torch.float32
        assert tuple(params["shared"]["attn"]["wq"].shape) == \
            (3584, 32, 112)
    if arch == "gemma2-9b":
        pair = params["stages"][0]
        assert set(pair) == {"local", "global"}
        assert tuple(pair["local"]["attn"]["wq"].shape) == (21, 3584, 16, 256)
        assert pair["global"]["ln_mlp_post"]["scale"].dtype == torch.float32
    jcfg, pcfg = _cfgs(arch, {})
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    small, _ = tree_flatten(PM.init_params(pcfg, None, "meta"))
    assert [tuple(t.shape) for t in small] == \
        [x.shape for x in jax.tree.leaves(jshapes)]


# ---------------------------------------------------------------------------
# isolation and device rules
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_repro():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(REPO)} imports {m}"

    mods = []
    for path in _port_files()[:-1]:
        rel = path.relative_to(REPO / "src").with_suffix("")
        mods.append(".".join(rel.parts))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_serve_main_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_serve.main(["--arch", "llama-7b", "--reduced", "--batch", "1",
                       "--prompt-len", "4", "--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.init_params(pt_base.get_arch("llama-7b").reduced(),
                       torch.Generator(), device="cuda")


def test_serve_main_cpu_runs():
    res = pt_serve.main(["--arch", "gpt-1.3b", "--reduced", "--batch", "2",
                         "--prompt-len", "8", "--gen", "3",
                         "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
