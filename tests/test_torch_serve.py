"""The PyTorch port's serving path against the JAX package, on the CPU.

Both packages get the same parameters (the JAX init, perturbed where it
is zero so norms and biases matter, handed over as numpy) and the same
prompts; prefill logits and caches and four greedy decode steps must
agree within 1e-4 of max|logits|, with identical greedy tokens.  Also:
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
from repro_torch.launch import serve as pt_serve
from repro_torch.models import model as PM

REPO = Path(__file__).resolve().parents[1]

# (arch, overrides applied to the reduced config on both sides)
SERVE_CASES = [
    ("llama-7b", {}),                            # SwiGLU, MHA
    ("gemma-2b", {}),                            # MQA, tied, GeGLU, scale
    ("gpt-1.3b", {}),                            # GELU with biases
    ("llama-7b", {"n_kv_heads": 2}),             # GQA
    ("llama-7b", {"attn_kind": "sliding", "window": 8}),  # ring-buffer cache
]
BATCH, PROMPT, STEPS = 2, 16, 4


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
    """JAX init on the host, with norms and biases (zero at init) made
    random so that they take part in the comparison."""
    tree = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path) for v in t]
        a = np.asarray(t)
        if path[-1] in ("scale", "bias", "b_up", "b_down"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return walk(tree)


def _close(got, ref, scale, rtol, what):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(ref, np.float64)).max())
    assert err <= rtol * scale, f"{what}: err {err} > {rtol} * {scale}"


@pytest.mark.parametrize("arch,overrides", SERVE_CASES,
                         ids=[f"{a}-{'-'.join(o) or 'base'}"
                              for a, o in SERVE_CASES])
def test_prefill_decode_match_jax(arch, overrides):
    jcfg, pcfg = _cfgs(arch, overrides)
    tree = _perturbed_params(jcfg, seed=0)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS + 1

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
        for key in ("k", "v"):
            ref = np.asarray(jc[0][key])
            _close(pc[0][key], ref, float(np.abs(ref).max()), 1e-4,
                   f"cache {key}")
        np.testing.assert_array_equal(pc[0]["pos"].numpy(),
                                      np.asarray(jc[0]["pos"]))

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
            _close(pl, jl, float(jnp.abs(jl).max()), 1e-4,
                   f"decode step {i} logits")
            jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            ptok = pl[:, -1].argmax(-1)[:, None]
            greedy.append(np.asarray(jtok)[:, 0])
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(pc[0]["pos"].numpy(),
                                      np.asarray(jc[0]["pos"]))

    # the entry point a user calls gives the same greedy tokens
    res = pt_serve.serve(pcfg, PM.DecoderLM(pcfg, params), prompts,
                         STEPS + 1, device="cpu")
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.stack(greedy, axis=1))


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
    got = PM.embed_tokens(pcfg, params, torch.from_numpy(toks))
    _close(got, ref, float(jnp.abs(ref).max()), 1e-6, "embed")
    h = np.random.default_rng(4).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    ref = JM.head_logits(jcfg, jparams, jnp.asarray(h))
    got = PM.head_logits(pcfg, params, torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close(got, ref, float(jnp.abs(ref).max()), 1e-5, "head")


def test_reduced_configs_identical():
    """The port's config copy reduces exactly as the JAX package's."""
    for name in ("llama-7b", "gemma-2b", "gpt-1.3b", "stablelm-1.6b",
                 "tiny-llama", "bert-large"):
        j = dataclasses.asdict(jax_base.get_arch(name).reduced())
        p = dataclasses.asdict(pt_base.get_arch(name).reduced())
        for d in (j, p):
            d["arch_type"] = d["arch_type"].value
            d["attn_kind"] = d["attn_kind"].value
        assert j == p, name


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
