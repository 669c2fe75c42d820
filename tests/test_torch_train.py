"""The port's training loss and gradients against the JAX package's, on the
CPU at reduced sizes (2 layers, d 256, seq <= 32, fp32): ``loss_fn`` and
every param grad against ``jax.value_and_grad(repro.models.model.loss_fn)``
on the same params (loaded from the JAX init through numpy), the same
tokens and weights.  Tolerances: the loss within 1e-5 relative, each grad
leaf within 1e-4 of its max|grad| (fp32 sums in another order).  Also
Adam element by element against ``repro.optim.adam`` over 3 steps.
mamba2-370m's training state: fp32, its leaves carried from the JAX
package leaf for leaf.  For the MoE models the reference's capacity
dispatch drops tokens on these batches (asserted), so the loss and grads
show the same drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_arch
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.hetero_trainer import trainable
from repro_torch.models import model as M
from repro_torch.optim import adam as tadam

import torch_threads  # noqa: F401,E402  (caps torch's threads)

#: tiny-llama: GQA, swiglu, RoPE; gpt-1.3b: gelu MLP with biases;
#: bert-large: non-causal, layernorm, learned positions; mamba2-370m: SSM
#: stages (conv, SSD scan, gated norm), no attention; mixtral-8x7b and
#: qwen3-moe-30b-a3b: MoE (4 experts, top-2 reduced) through the capacity
#: dispatch with the router aux in the loss, mixtral with its window;
#: gemma2-9b: a local/global pair (window 128 reduced), softcaps, post-norms,
#: tied and scaled embedding; zamba2-7b: an SSM group of 2 and the shared
#: block, each SSM block checkpointed inside the group's checkpoint
ARCHS = ["tiny-llama", "gpt-1.3b", "bert-large", "mamba2-370m",
         "mixtral-8x7b", "qwen3-moe-30b-a3b", "gemma2-9b", "zamba2-7b"]


def _batch(cfg, bsz=2, seq=24, seed=0):
    """Tokens, labels and Eq. 1 weights; an MoE model's tokens come from 8
    ids only, so that routing is skewed and the capacity dispatch drops
    (a batch of random ids routes too evenly to overflow)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 8 if cfg.is_moe else cfg.vocab_size,
                        (bsz, seq + 1))
    w = rng.uniform(0.5, 1.5, (bsz, seq)).astype(np.float32) / (bsz * seq)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "weights": w}


def _jax_reference(name, batch, ce_chunk):
    cfg = jax_arch(name).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return JM.loss_fn(cfg, p, jbatch, ce_chunk=ce_chunk)[0]
    value, grads = jax.value_and_grad(loss)(params)
    return (jax.device_get(params), float(value),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _torch_loss_and_grads(cfg, params, batch, remat, ce_chunk):
    leaves, _ = fsdp.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    loss, aux = M.loss_fn(cfg, params, tb, remat=remat, ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, leaves)
    return loss, aux, [g.numpy() for g in grads]


@pytest.mark.parametrize("ce_chunk", [512, 10], ids=["one-chunk",
                                                    "padded-chunks"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, ce_chunk):
    cfg = get_arch(arch).reduced()
    batch = _batch(cfg)
    jparams, jloss, jgrads = _jax_reference(arch, batch, ce_chunk)
    params = params_from_numpy(jparams, "cpu")
    loss, aux, grads = _torch_loss_and_grads(cfg, params, batch, "full",
                                             ce_chunk)
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    assert float(aux["weight_sum"]) == pytest.approx(
        float(batch["weights"].sum()), rel=1e-6)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert g.shape == jg.shape
        scale = np.abs(jg).max()
        assert scale > 0
        assert np.abs(g - jg).max() <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_batches_drop_tokens(arch):
    """The params and batch of ``test_loss_and_grads_match_jax`` make the
    capacity dispatch drop assignments in the MoE layers (counted in the
    port's loss, which that test holds to the reference's; the kept set
    is held to the reference's in ``tests/test_torch_moe.py``), so that
    test's loss and grads cover drops."""
    from repro_torch.models.layers import moe
    cfg = get_arch(arch).reduced()
    params = params_from_numpy(jax.device_get(JM.init_params(
        jax_arch(arch).reduced(), jax.random.PRNGKey(0))), "cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(cfg).items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    with moe.counting_drops() as log:
        M.loss_fn(cfg, params, tb, remat="none")
    drops = [int(d) for _, d in log]
    assert len(drops) == cfg.n_layers and sum(drops) > 0, drops


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_matches_none(arch):
    """Checkpointing each layer changes memory, not the gradients."""
    cfg = get_arch(arch).reduced()
    batch = _batch(cfg, seq=16, seed=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for remat in ("full", "none"):
        p = M.tree_map(params, lambda _, t: t.detach().clone())
        loss, _, grads = _torch_loss_and_grads(cfg, p, batch, remat, 512)
        out[remat] = (float(loss.detach()), grads)
    assert out["full"][0] == out["none"][0]
    for a, b in zip(out["full"][1], out["none"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_per_layer_leaves_give_the_stacked_grads():
    """The trainer's tree (one autograd leaf per layer and leaf, stages as
    lists of per-layer trees) gives the grads of the stacked tree."""
    cfg = get_arch("gpt-1.3b").reduced()
    batch = _batch(cfg, seq=16, seed=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                           all_fp32=True)
    stacked = M.tree_map(params, lambda _, t: t.detach().clone())
    _, _, want = _torch_loss_and_grads(cfg, stacked, batch, "full", 512)
    want = fsdp.tree_unflatten(fsdp.tree_flatten(stacked)[1], want)
    tree, leaves = trainable(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    loss, _ = M.loss_fn(cfg, tree, tb)
    got = fsdp.tree_unflatten(fsdp.tree_flatten(tree)[1], [
        g.numpy() for g in torch.autograd.grad(loss, leaves)])
    pairs = [(got[k], want[k]) for k in got if k != "stages"]
    pairs += [(layer_tree, M.layer(want["stages"][0], i))
              for i, layer_tree in enumerate(got["stages"][0])]
    for a, b in pairs:
        for x, y in zip(fsdp.tree_flatten(a)[0], fsdp.tree_flatten(b)[0]):
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-7 * np.abs(y).max())


#: (arch, seq): gemma2's pair past its reduced window of 128, so that the
#: local layer masks; zamba2's group of SSM blocks and the shared block
ELEMENT_CASES = [("gemma2-9b", 160), ("zamba2-7b", 40)]


@pytest.mark.parametrize("arch,seq", ELEMENT_CASES)
def test_element_apply_matches_jax(arch, seq):
    """One stage element (a pair; a zamba group with ``shared``) against
    the reference's ``element_apply``: y within 1e-4 of max|y|, and the
    grads of sum(y * w) for a seeded w, by ``jax.vjp``, for x, every leaf
    of the element and of the shared block, within 1e-4 of each max."""
    jcfg = jax_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    spec = M.build_stages(cfg)[0]
    jspec = JM.build_stages(jcfg)[0]
    assert (spec.kind, spec.inner) == (jspec.kind, jspec.inner)
    tree = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(4)))
    jbp = jax.tree.map(lambda a: a[0], tree["stages"][0])
    jshared = tree.get("shared")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (2, 1))

    def jfn(bp, sh, xx):
        return JM.element_apply(jcfg, jspec, bp, xx, jnp.asarray(pos), sh)[0]
    jy, vjp = jax.vjp(jfn, jbp, jshared, jnp.asarray(x))
    jgrads = vjp(jnp.asarray(w))

    bp = params_from_numpy(jbp, "cpu")
    shared = None if jshared is None else params_from_numpy(jshared, "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = fsdp.tree_flatten([bp] + ([shared] if shared else []))[0]
    for t in leaves:
        t.requires_grad_(True)
    y, _ = M.element_apply(cfg, spec, bp, tx, torch.from_numpy(pos).long(),
                           shared)
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(y.detach().numpy() - np.asarray(jy)).max() <= 1e-4 * scale
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                                leaves + [tx])
    want = jax.tree.leaves(jgrads[:2]) + [jgrads[2]]
    assert len(grads) == len(want)
    for g, jg in zip(grads, want):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


def test_learned_positions_and_fp32_storage():
    cfg = get_arch("bert-large").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           all_fp32=True)
    assert tuple(params["pos_embed"].shape) == (cfg.max_seq, cfg.d_model)
    full = get_arch("gpt-1.3b")
    shapes = M.init_params(full, torch.Generator(), "meta", all_fp32=True)
    leaves, _ = fsdp.tree_flatten(shapes)
    assert {t.dtype for t in leaves} == {torch.float32}
    assert sum(t.numel() for t in leaves) == 1_414_158_336
    served = M.init_params(full.reduced(), torch.Generator(), "cpu")
    assert served["embed"].dtype == torch.float32   # reduced: fp32 config
    vit = get_arch("vit-g").reduced()
    stub = M.init_params(vit, torch.Generator(), "cpu")["frontend_proj"]
    assert tuple(stub.shape) == (vit.frontend_dim, vit.d_model)


def test_mamba2_training_state_and_conversion():
    """mamba2-370m's training state is fp32 throughout (419,825,152
    parameters at full width, 48 SSM layers); the JAX package's params
    carry across leaf for leaf, and stored in bf16 the SSM block's decay,
    step, skip and conv-bias leaves and the norms stay fp32 and exact."""
    full = get_arch("mamba2-370m")
    assert [(s.kind, s.count) for s in M.build_stages(full)] == [("ssm", 48)]
    shapes = M.init_params(full, torch.Generator(), "meta", all_fp32=True)
    leaves, _ = fsdp.tree_flatten(shapes)
    assert {t.dtype for t in leaves} == {torch.float32}
    assert sum(t.numel() for t in leaves) == 419_825_152
    cfg = jax_arch("mamba2-370m").reduced()
    tree = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(2)))
    jleaves = jax.tree.leaves(tree)
    for dtype in (None, torch.bfloat16):
        params = params_from_numpy(tree, "cpu", dtype)
        got, _ = fsdp.tree_flatten(params)
        assert [tuple(t.shape) for t in got] == [x.shape for x in jleaves]
        ssd = params["stages"][0]["ssd"]
        for key in ("a_log", "dt_bias", "d_skip", "conv_b"):
            assert ssd[key].dtype == torch.float32
        assert ssd["in_proj"].dtype == (dtype or torch.float32)
        for t, x in zip(got, jleaves):
            if t.dtype == torch.float32:
                np.testing.assert_array_equal(t.numpy(), x)


def test_adam_matches_reference_over_three_steps():
    """adam_update (in place, on flat fp32 tensors) against the reference's
    functional update, element by element (1e-6 relative: the same fp32
    arithmetic in the same order, bc_t's power may differ by an ulp)."""
    rng = np.random.default_rng(0)
    n = 4096
    cfg_kw = dict(lr=1e-3, weight_decay=0.01)
    p0 = rng.standard_normal(n).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    tp = torch.from_numpy(p0.copy())
    tm, tv = tadam.adam_init(tp)
    for step in range(1, 4):
        g = rng.standard_normal(n).astype(np.float32)
        jp, jm, jv = jadam.adam_update(jadam.AdamConfig(**cfg_kw), jp,
                                       jnp.asarray(g), jm, jv,
                                       jnp.int32(step))
        out = tadam.adam_update(tadam.AdamConfig(**cfg_kw), tp,
                                torch.from_numpy(g), tm, tv, step)
        assert out[0] is tp and out[1] is tm and out[2] is tv
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_adam_helpers_match_reference():
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32) for s in (7, 130)]
    want = float(jadam.global_norm([jnp.asarray(g) for g in gs]))
    got = tadam.global_norm([torch.from_numpy(g) for g in gs])
    assert float(got) == pytest.approx(want, rel=1e-6)
    clipped = tadam.clip_by_global_norm([torch.from_numpy(g) for g in gs],
                                        1.0)
    jclipped = jadam.clip_by_global_norm([jnp.asarray(g) for g in gs], 1.0)
    for a, b in zip(clipped, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    sched, jsched = (mod.cosine_schedule(1e-3, 10, 100)
                     for mod in (tadam, jadam))
    for step in (0, 5, 10, 50, 100, 150):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6,
                                            abs=1e-12)
