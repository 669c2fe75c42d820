"""The port's SPMD wire format, collectives and program, on the CPU.

Rank processes run in gloo worlds (``repro_torch.core.engine.world``);
the JAX oracles run in a subprocess with fake host devices and hand their
numpy results back through a file.

* ``gather_unit`` / ``scatter_grad`` on even and uneven layouts (and a
  stacked ``(count, P_max)`` shard) in worlds of 2 and 3, against numpy:
  the gather exact, the ReduceScatter within 1e-6 of numpy's sum.
* ``make_mixed_gather``: forward exact in its dtype; the gradient is the
  ReduceScatter of every rank's cotangent in the backward dtype, in fp32
  (1e-6) and bf16 (one bf16 rounding of the sum: 1e-2 of max|sum|), and
  with the HSDP replica all-reduce in a world of 4 (mesh 2 x 2, state
  over "model").
* ``sharded_embed_lookup`` and ``sharded_ce`` (softcap 0 and 30), values
  and grads, against the JAX functions under ``shard_map`` on 2 devices,
  within 1e-5 of max|value|: grads through the sums follow JAX's
  transpose of ``psum`` (a sum of the cotangents).  ``sharded_ce``'s
  reference max (``pmax``) has no differentiation rule in JAX, so its
  grads come from the same function with the max under
  ``stop_gradient`` (exact: the logsumexp does not depend on it).
* The mesh's groups against the order of ``jax.make_mesh``'s collectives.
* HSDP: the port's ``CephaloProgram`` on mesh (2, 2) with
  ``state_axes=("model",)`` and uneven ratios against the JAX program,
  from the same params and batch: loss within 1e-4, params after the
  step within 2e-4 (the reference's own shard_map gate) wherever the Adam
  step was well conditioned, and within lr everywhere (:func:`p_close`);
  Adam's m after the step, ``(1 - b1) g``, within 1e-4 relative
  (:func:`m_close`), which holds the gradients' scale.
* ``has_frontend_batch`` (reduced musicgen-large, two uneven ranks):
  loss and gradient against the plain model's on the whole batch.
* A rank's exception and a rank's death come back to the controller as
  errors; the placement rule.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.engine import world as W
from repro_torch.core.layered_ga import CephaloProgram
from repro_torch.optim.adam import AdamConfig

import torch_threads  # noqa: F401,E402  (caps torch's threads)

V, D = 64, 8                 # vocab rows and width of the sharded tables
SOFTCAPS = (0.0, 30.0)
HSDP_RATIOS = [0.7, 0.3]
HSDP = dict(ell=1, m=2, seq=16)
#: Adam's first moment after a step against the reference's, relative
#: (``m_close``): fp32 gradients summed in another order
M_TOL = 1e-4


def p_close(got, want, v_want, lr=1e-3, b2=AdamConfig().b2):
    """max |got - want| over the params after one Adam step where that
    step was well conditioned — the reference's sqrt(v_hat) >= 1e-6, 100x
    Adam's eps — after checking that no element is more than ``lr``
    apart.  Adam divides m by sqrt(v) + 1e-8, so where a grad is near
    1e-8 an fp32-level difference of the grad moves p by a fraction of lr
    (a few elements of reduced tiny-llama have grads of ~1e-9)."""
    worst = 0.0
    for a, b, v in zip(got, want, v_want):
        e = np.abs(np.asarray(a) - np.asarray(b))
        assert e.max() <= lr, e.max()
        well = np.sqrt(np.asarray(v) / (1 - b2)) >= 1e-6
        worst = max(worst, float(e[well].max(initial=0.0)))
    return worst


def m_close(got, want):
    """max over the leaves of ``|got - want| / |want|`` (2-norms).  After
    one step Adam's first moment is ``(1 - b1) g``: this holds the
    gradient itself, its scale included, which p after a first step
    (``lr · sign(g)`` where well conditioned) cannot show."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d, nb = np.linalg.norm(a - b), np.linalg.norm(b)
        worst = max(worst, d / nb if nb else d)
    return worst


def _layout(size, ratios, name="u"):
    return fsdp.make_layout(name, {"w": torch.empty(size, device="meta")},
                            ratios)


# ---------------------------------------------------------------------------
# Rank functions (module level: pickled by name into the rank processes)
# ---------------------------------------------------------------------------

def _rank_collectives(ctx, cases):
    """For each (size, ratios, lead): the gathered flat of a common full
    buffer and this rank's ReduceScattered share of every rank's grad."""
    group, idx = ctx.axis_group(ctx.mesh.axis_names)
    out = []
    for k, (size, ratios, lead) in enumerate(cases):
        layout = _layout(size, ratios)
        full = torch.from_numpy(np.random.default_rng(k).standard_normal(
            lead + (layout.padded,)).astype(np.float32))
        gathered = fsdp.gather_unit(layout,
                                    fsdp.padded_shard(layout, full, idx),
                                    group, ctx.comm)
        grad = torch.from_numpy(np.random.default_rng((k, ctx.rank))
                                .standard_normal(layout.padded)
                                .astype(np.float32))
        scattered = fsdp.scatter_grad(layout, grad, group, ctx.comm)
        out.append((idx, gathered.numpy(), scattered.numpy()))
    return out


def _rank_mixed(ctx, size, ratios, fwd, bwd, state_axes):
    """A mixed gather's output and its shard's gradient for a cotangent
    drawn per rank; HSDP when ``state_axes`` leaves a replica axis."""
    group, idx = ctx.axis_group(state_axes)
    rest = tuple(a for a in ctx.mesh.axis_names if a not in state_axes)
    replica = ctx.axis_group(rest)[0] if rest else None
    layout = _layout(size, ratios)
    full = torch.from_numpy(np.random.default_rng(0).standard_normal(
        layout.padded).astype(np.float32))
    shard = fsdp.padded_shard(layout, full, idx).requires_grad_(True)
    gather = fsdp.make_mixed_gather(layout, group, ctx.comm, fwd, bwd,
                                    replica_group=replica)
    out = gather(shard)
    ct = torch.from_numpy(np.random.default_rng(ctx.rank).standard_normal(
        layout.padded).astype(np.float32))
    (out.float() * ct).sum().backward()
    return {"idx": idx, "dtype": str(out.dtype),
            "out": out.detach().float().numpy(),
            "grad": shard.grad.numpy(), "grad_dtype": str(shard.grad.dtype),
            "stats": dict(gather.stats)}


def _rank_vocab(ctx, data):
    """sharded_embed_lookup and sharded_ce on this rank's rows: values and
    grads (embedding rows, and h for the CE)."""
    group, idx = ctx.axis_group(ctx.mesh.axis_names)
    lo, hi = fsdp.embed_rows_for_rank(V, ctx.world_size)[idx]
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    es = t["embed"][lo:hi].clone().requires_grad_(True)
    x = fsdp.sharded_embed_lookup(es, t["tokens"], lo, group, ctx.comm)
    (g_es,) = torch.autograd.grad((x * t["coef"]).sum(), [es])
    out = {"lookup": (x.detach().numpy(), g_es.numpy())}
    for cap in SOFTCAPS:
        es = t["embed"][lo:hi].clone().requires_grad_(True)
        h = t["h"].clone().requires_grad_(True)
        ce = fsdp.sharded_ce(h, es, t["labels"], t["weights"], lo, group,
                             ctx.comm, final_softcap=cap)
        g_es, g_h = torch.autograd.grad(ce, [es, h])
        out[f"ce{cap:g}"] = (float(ce), g_es.numpy(), g_h.numpy())
    return out


def _rank_hsdp(ctx, cfg, params, batch):
    """The HSDP program's step from ``params`` on this rank's row of
    ``batch``; rank 0 returns the loss, the params after the step and
    the collectives, the others None."""
    prog = CephaloProgram(cfg, ctx, ratios=HSDP_RATIOS,
                          adam=AdamConfig(lr=1e-3), state_axes=("model",),
                          **HSDP)
    state = prog.state_from_trees(params_from_numpy(params, "cpu"))
    shapes = {k: tuple(s) for k, (s, _) in prog.state_shapes().items()}
    mine = {k: tuple(v.shape) for k, v in state.items() if k != "step"}
    _, loss = prog.step(state, {k: torch.from_numpy(v[ctx.rank])
                                for k, v in batch.items()})
    p1 = prog.gather_params(state)
    m1 = prog.gather_part(state, "m")
    if ctx.rank:
        return None
    return {"loss": loss, "replica_axes": prog.replica_axes,
            "n_state": prog.n_state, "state_index": prog.state_index,
            "stats": dict(prog.substrate.stats), "shapes": shapes,
            "local_shapes": mine,
            "p1": [t.numpy() for t in fsdp.tree_flatten(p1)[0]],
            "m1": [t.numpy() for t in fsdp.tree_flatten(m1)[0]]}


def _rank_remat(ctx, cfg, params, batch):
    """One step of the program under each remat policy and gather dtype
    from the same params; rank 0 returns each one's loss, params after
    the step and collectives."""
    out = {}
    for remat, gdt in (("full", "float32"), ("none", "float32"),
                       ("offload", "float32"), ("full", "bfloat16")):
        prog = CephaloProgram(cfg, ctx, ratios=[0.6, 0.4],
                              adam=AdamConfig(lr=1e-3), remat=remat,
                              gather_dtype=gdt, ell=2, m=1, seq=16,
                              unroll=True)
        state = prog.state_from_trees(params_from_numpy(params, "cpu"))
        _, loss = prog.step(state, {k: torch.from_numpy(v[ctx.rank])
                                    for k, v in batch.items()})
        p1 = [t.numpy() for t in fsdp.tree_flatten(
            prog.gather_params(state))[0]]
        out[(remat, gdt)] = (loss, p1, dict(prog.substrate.stats))
    return out if ctx.rank == 0 else None


def _rank_fail(ctx, mode):
    if ctx.rank == 1 and mode == "raise":
        raise ValueError("rank one refuses")
    if ctx.rank == 1 and mode == "die":
        os._exit(3)
    return ctx.rank


# ---------------------------------------------------------------------------
# The JAX oracles
# ---------------------------------------------------------------------------

ORACLE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import get_arch
from repro.core import fsdp
from repro.core.engine.substrate import shard_map_call
from repro.core.layered_ga import CephaloProgram
from repro.data.pipeline import DataConfig, SyntheticStream, make_homogeneous_batch
from repro.optim.adam import AdamConfig

data = pickle.load(open(sys.argv[1], "rb"))
out = {}
V, per = data["embed"].shape[0], data["embed"].shape[0] // 2
mesh2 = Mesh(np.array(jax.devices()[:2]), ("data",))

def lookup(es, toks, coef):
    v0 = jax.lax.axis_index("data") * per
    def loss(e):
        x = fsdp.sharded_embed_lookup(e, toks, v0, "data")
        return jnp.sum(x * coef), x
    (_, x), g = jax.value_and_grad(loss, has_aux=True)(es)
    return x[None], g
x, g = shard_map_call(lookup, mesh2, (P("data"), P(), P()),
                      (P("data"), P("data")))(
    data["embed"], data["tokens"], data["coef"])
out["lookup"] = (np.asarray(x), np.asarray(g))

def ce_sg(h, es, labels, weights, v_start, cap):
    # fsdp.sharded_ce with its max under stop_gradient (pmax has no
    # differentiation rule); the same value
    z = h.astype(jnp.float32) @ es.astype(jnp.float32).T
    if cap > 0:
        z = cap * jnp.tanh(z / cap)
    m_glob = jax.lax.pmax(jax.lax.stop_gradient(z.max(axis=-1)), "data")
    sumexp = jax.lax.psum(jnp.sum(jnp.exp(z - m_glob[..., None]), -1), "data")
    lse = m_glob + jnp.log(sumexp)
    local = labels - v_start
    valid = (local >= 0) & (local < es.shape[0])
    idx = jnp.clip(local, 0, es.shape[0] - 1)
    picked = jnp.take_along_axis(z, idx[..., None], axis=-1)[..., 0]
    picked = jax.lax.psum(picked * valid.astype(jnp.float32), "data")
    return jnp.sum(weights * (lse - picked))

for cap in (0.0, 30.0):
    def ce(es, h, labels, weights, cap=cap):
        v0 = jax.lax.axis_index("data") * per
        val = fsdp.sharded_ce(h, es, labels, weights, v0, "data", cap)
        val2, (ges, gh) = jax.value_and_grad(ce_sg, argnums=(1, 0))(
            h, es, labels, weights, v0, cap)
        return val[None], val2[None], ges, gh[None]
    v, v2, ges, gh = shard_map_call(
        ce, mesh2, (P("data"), P(), P(), P()),
        (P("data"), P("data"), P("data"), P("data")))(
        data["embed"], data["h"], data["labels"], data["weights"])
    out[f"ce{cap:g}"] = tuple(np.asarray(a) for a in (v, v2, ges, gh))

# the mesh's device order: each device's all_gather of linear ids
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
ids = {d.id: i for i, d in enumerate(mesh.devices.flat)}
lin = jnp.asarray([ids[d.id] for d in mesh.devices.flat],
                  jnp.int32).reshape(2, 2)
for axes in (("model",), ("data",), ("data", "model"), ("model", "data")):
    f = lambda x, axes=axes: jax.lax.all_gather(x.reshape(()), axes)[None, None]
    got = shard_map_call(f, mesh, (P("data", "model"),),
                         P("data", "model"))(lin)
    out[("groups",) + axes] = np.asarray(got).reshape(4, -1)

# HSDP: mesh (2, 2), state over "model", uneven ratios
cfg = get_arch("tiny-llama").reduced()
n, ell, m, seq = 4, data["hsdp"]["ell"], data["hsdp"]["m"], data["hsdp"]["seq"]
prog = CephaloProgram(cfg, mesh, ratios=data["hsdp_ratios"], ell=ell, m=m,
                      seq=seq, adam=AdamConfig(lr=1e-3),
                      state_axes=("model",))
state = prog.init_state(jax.random.PRNGKey(0))
stream = SyntheticStream(DataConfig(cfg.vocab_size, seq, seed=0))
hb = make_homogeneous_batch(stream, 0, n * ell * m)
batch = {k: hb[k].reshape(n, ell, m, seq) for k in ("tokens", "labels", "weights")}
params0 = jax.device_get(prog.gather_params(state))
ns, loss = prog.jit_step()(state, {k: jnp.asarray(v) for k, v in batch.items()})
out["hsdp"] = {"params0": params0, "batch": batch, "loss": float(loss),
               "p1": [np.asarray(a) for a in jax.tree.leaves(
                   jax.device_get(prog.gather_params(ns)))],
               "m1": [np.asarray(a) for a in jax.tree.leaves(
                   jax.device_get(prog.gather_part(ns, "m")))],
               "v1": [np.asarray(a) for a in jax.tree.leaves(
                   jax.device_get(prog.gather_part(ns, "v")))],
               "shapes": {k: tuple(v.shape) for k, v in prog.state_shapes().items()},
               "replica_axes": prog.replica_axes}
pickle.dump(out, open(sys.argv[2], "wb"))
print("ORACLE-OK")
"""


def _rank_frontend(ctx, cfg, params, batch):
    """One step of the program with a frontend batch
    (``has_frontend_batch``) from ``params``; rank 0 returns the loss and
    Adam's m after the step, ``(1 - b1) g``."""
    prog = CephaloProgram(cfg, ctx, ratios=[0.6, 0.4],
                          adam=AdamConfig(lr=1e-3), ell=1, m=2, seq=16,
                          has_frontend_batch=True)
    assert "frontend_embed" in prog.batch_shapes()
    state = prog.state_from_trees(params_from_numpy(params, "cpu"))
    _, loss = prog.step(state, {k: torch.from_numpy(v[ctx.rank])
                                for k, v in batch.items()})
    m1 = prog.gather_part(state, "m")
    if ctx.rank:
        return None
    return loss, [t.numpy() for t in fsdp.tree_flatten(m1)[0]]


def _frontend_inputs():
    """Reduced musicgen-large (a frontend stub), its fp32 params from a
    seeded generator as numpy, and a batch of 2 ranks x (1, 2, 16) with
    frontend embeddings."""
    from repro_torch.models import model as M
    cfg = get_arch("musicgen-large").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                           all_fp32=True)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 1, 2, 17))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "weights": np.full((2, 1, 2, 16), 1 / 64, np.float32),
             "frontend_embed": rng.standard_normal(
                 (2, 1, 2, 16, cfg.frontend_dim)).astype(np.float32)}
    return cfg, M.tree_map(params, lambda _, t: t.numpy()), batch


def _host_params():
    """Reduced tiny-llama's fp32 params from a seeded generator, as numpy."""
    from repro_torch.models import model as M
    cfg = get_arch("tiny-llama").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                           all_fp32=True)
    return M.tree_map(params, lambda _, t: t.numpy())


def _vocab_data():
    rng = np.random.default_rng(7)
    return {"embed": rng.standard_normal((V, D)).astype(np.float32),
            "tokens": rng.integers(0, V, (3, 5)).astype(np.int32),
            "coef": rng.standard_normal((3, 5, D)).astype(np.float32),
            "h": rng.standard_normal((3, 5, D)).astype(np.float32),
            "labels": rng.integers(0, V, (3, 5)).astype(np.int32),
            "weights": rng.random((3, 5)).astype(np.float32)}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("spmd_oracle")
    data = {**_vocab_data(), "hsdp": HSDP, "hsdp_ratios": HSDP_RATIOS}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    code = ORACLE.replace("sys.argv[1]", repr(str(d / "in.pkl"))) \
        .replace("sys.argv[2]", repr(str(d / "out.pkl")))
    assert "ORACLE-OK" in subproc(code, n_devices=4, timeout=600)
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------

CASES = {2: [(1000, [0.5, 0.5], ()), (1000, [0.7, 0.3], ()),
             (300, [0.6, 0.4], (3,)), (5000, [0.0, 1.0], ())],
         3: [(3000, [1 / 3] * 3, ()), (1000, [0.2, 0.3, 0.5], ()),
             (777, [0.5, 0.1, 0.4], (2,))]}
MIXED = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module")
def world2():
    with W.World(W.Mesh((2,), ("data",)), "cpu") as world:
        res = {"collectives": world.call(_rank_collectives, (CASES[2],)),
               "mixed": {(str(f), str(b)): world.call(
                   _rank_mixed, (1000, [0.7, 0.3], f, b, ("data",)))
                   for f, b in MIXED},
               "vocab": world.call(_rank_vocab, (_vocab_data(),))}
        with pytest.raises(RuntimeError, match="rank one refuses"):
            world.call(_rank_fail, ("raise",))
        res["after_raise"] = world.call(_rank_fail, ("ok",))
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 512, (2, 2, 1, 17))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                 "weights": np.full((2, 2, 1, 16), 1 / 64, np.float32)}
        res["remat"] = world.call(_rank_remat, (
            get_arch("tiny-llama").reduced(), _host_params(), batch))[0]
        res["frontend"] = world.call(_rank_frontend, _frontend_inputs())[0]
        with pytest.raises(RuntimeError, match="spmd rank 1 died"):
            world.call(_rank_fail, ("die",))
        procs = list(world.procs)
    res["alive_after_close"] = [p.is_alive() for p in procs]
    return res


@pytest.fixture(scope="module")
def world3():
    with W.World(W.Mesh((3,), ("data",)), "cpu") as world:
        return {"collectives": world.call(_rank_collectives, (CASES[3],))}


@pytest.fixture(scope="module")
def world4(oracle):
    cfg = get_arch("tiny-llama").reduced()
    ref = oracle["hsdp"]
    with W.World(W.Mesh((2, 2), ("data", "model")), "cpu") as world:
        return {"mixed": world.call(_rank_mixed, (
                    1000, [0.6, 0.4], torch.float32, torch.float32,
                    ("model",))),
                "hsdp": world.call(_rank_hsdp, (cfg, ref["params0"],
                                                ref["batch"]))[0]}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(2, k) for k in range(len(CASES[2]))] +
                         [(3, k) for k in range(len(CASES[3]))])
def test_gather_and_scatter_against_numpy(n, k, world2, world3):
    """gather_unit returns the full flat bit for bit; scatter_grad the sum
    over ranks of each rank's grad at this rank's slice, zero-padded."""
    res = (world2 if n == 2 else world3)["collectives"]
    size, ratios, lead = CASES[n][k]
    layout = _layout(size, ratios)
    full = np.random.default_rng(k).standard_normal(
        lead + (layout.padded,)).astype(np.float32)
    total = sum(np.random.default_rng((k, r)).standard_normal(
        layout.padded).astype(np.float32) for r in range(n))
    assert layout.even == (len(set(layout.shard_sizes)) == 1)
    for r in range(n):
        idx, gathered, scattered = res[r][k]
        assert idx == r
        np.testing.assert_array_equal(gathered, full)
        off, s = layout.offsets()[idx], layout.shard_sizes[idx]
        want = np.zeros(layout.p_max, np.float32)
        want[:s] = total[off: off + s]
        np.testing.assert_allclose(scattered, want, rtol=0, atol=1e-6)


def test_shard_unit_matches_the_reference_wire_format():
    """shard_unit's padded shards and unshard's reassembly on the
    layouts of the gather tests."""
    for cases in CASES.values():
        for size, ratios, lead in cases:
            layout = _layout(size, ratios)
            flat = torch.arange(layout.padded, dtype=torch.float32)
            shards = fsdp.shard_unit(layout, flat)
            assert [s.shape[-1] for s in shards] == [layout.p_max] * layout.n
            for s, n_valid in zip(shards, layout.shard_sizes):
                assert not s[n_valid:].any()
            torch.testing.assert_close(
                fsdp.unshard(layout, torch.stack(shards)), flat, rtol=0,
                atol=0)


@pytest.mark.parametrize("fwd,bwd", MIXED, ids=lambda d: str(d)[6:])
def test_mixed_gather_forward_and_gradient(fwd, bwd, world2):
    """Forward: the full flat in ``fwd``.  Backward: the ReduceScatter of
    both ranks' cotangents (as the forward dtype carries them) in ``bwd``,
    then fp32; one AllGather and one ReduceScatter each."""
    res = world2["mixed"][(str(fwd), str(bwd))]
    layout = _layout(1000, [0.7, 0.3])
    full = torch.from_numpy(np.random.default_rng(0).standard_normal(
        layout.padded).astype(np.float32))
    cts = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        layout.padded).astype(np.float32)).to(fwd).to(bwd) for r in range(2)]
    total = (cts[0].float() + cts[1].float()).to(bwd).float()
    for r in range(2):
        out = res[r]
        assert out["dtype"] == str(fwd) and out["grad_dtype"] == "torch.float32"
        np.testing.assert_array_equal(out["out"], full.to(fwd).float())
        off, s = layout.offsets()[out["idx"]], layout.shard_sizes[out["idx"]]
        want = np.zeros(layout.p_max, np.float32)
        want[:s] = total[off: off + s].numpy()
        tol = 1e-6 if bwd == torch.float32 else 1e-2 * np.abs(want).max()
        np.testing.assert_allclose(out["grad"], want, rtol=0, atol=tol)
        assert out["stats"] == {"all_gather": 1, "reduce_scatter": 1,
                                "all_reduce": 0}


def test_hsdp_replica_all_reduce(world4):
    """Mesh (2, 2), state over "model": each shard's gradient is the sum of
    all four ranks' cotangents at its slice — the ReduceScatter over its
    state group, then the all-reduce over its replica group."""
    layout = _layout(1000, [0.6, 0.4])
    total = sum(np.random.default_rng(r).standard_normal(
        layout.padded).astype(np.float32) for r in range(4))
    assert [out["idx"] for out in world4["mixed"]] == [0, 1, 0, 1]
    for out in world4["mixed"]:
        off, s = layout.offsets()[out["idx"]], layout.shard_sizes[out["idx"]]
        want = np.zeros(layout.p_max, np.float32)
        want[:s] = total[off: off + s]
        np.testing.assert_allclose(out["grad"], want, rtol=0, atol=1e-5)
        assert out["stats"] == {"all_gather": 1, "reduce_scatter": 1,
                                "all_reduce": 1}


def test_sharded_embed_lookup_against_jax(world2, oracle):
    """Values and the embedding rows' grads on both ranks."""
    x_ref, g_ref = oracle["lookup"]
    per = V // 2
    for r, out in enumerate(world2["vocab"]):
        x, g = out["lookup"]
        tol = 1e-5 * np.abs(x_ref).max()
        np.testing.assert_allclose(x, x_ref[r], rtol=0, atol=tol)
        np.testing.assert_allclose(g, g_ref[r * per: (r + 1) * per], rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("cap", SOFTCAPS)
def test_sharded_ce_against_jax(cap, world2, oracle):
    """Σ w·CE and its grads for the embedding rows and h on both ranks."""
    v, v2, ges_ref, gh_ref = oracle[f"ce{cap:g}"]
    np.testing.assert_allclose(v, v2, rtol=1e-6)
    per = V // 2
    for r, out in enumerate(world2["vocab"]):
        val, ges, gh = out[f"ce{cap:g}"]
        assert abs(val - v[r]) <= 1e-5 * abs(v[r])
        np.testing.assert_allclose(ges, ges_ref[r * per: (r + 1) * per],
                                   rtol=0, atol=1e-5 * np.abs(ges_ref).max())
        np.testing.assert_allclose(gh, gh_ref[r], rtol=0,
                                   atol=1e-5 * np.abs(gh_ref).max())


def test_sharded_ce_value_is_the_full_vocab_ce(world2):
    """The summed sharded CE equals the plain CE over the whole table."""
    data = _vocab_data()
    z = torch.from_numpy(data["h"]) @ torch.from_numpy(data["embed"]).T
    for cap in SOFTCAPS:
        zc = cap * torch.tanh(z / cap) if cap else z
        lse = torch.logsumexp(zc, -1)
        picked = zc.gather(-1, torch.from_numpy(data["labels"]).long()[..., None])[..., 0]
        want = float((torch.from_numpy(data["weights"]) * (lse - picked)).sum())
        for out in world2["vocab"]:
            assert abs(out[f"ce{cap:g}"][0] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model"),
                                  ("model", "data")])
def test_mesh_groups_follow_jax_device_order(axes, oracle):
    """Each rank's group over ``axes`` lists the ranks in the order in
    which ``lax.all_gather`` over those axes stacks the devices of
    ``jax.make_mesh``."""
    mesh = W.Mesh((2, 2), ("data", "model"))
    got = oracle[("groups",) + axes]
    for ranks in mesh.groups(axes):
        for r in ranks:
            assert list(got[r]) == ranks


def test_hsdp_program_against_jax(world4, oracle):
    """Mesh (2, 2), state over "model" with ratios 0.7 / 0.3, replicated
    over "data": one step from the JAX program's params on its batch."""
    ref, got = oracle["hsdp"], world4["hsdp"]
    assert got["replica_axes"] == tuple(ref["replica_axes"]) == ("data",)
    assert got["n_state"] == 2 and got["state_index"] == 0
    assert abs(got["loss"] - ref["loss"]) <= 1e-4, (got["loss"], ref["loss"])
    assert len(got["p1"]) == len(ref["p1"])
    assert p_close(got["p1"], ref["p1"], ref["v1"]) <= 2e-4
    assert m_close(got["m1"], ref["m1"]) <= M_TOL
    # the reference's global state shapes (a stage keeps its count dim);
    # each rank holds P_max of the n_state · P_max columns
    assert sorted(got["shapes"]) == sorted(ref["shapes"])
    for k, shape in ref["shapes"].items():
        if k != "step":
            assert got["shapes"][k][-1] == shape[-1], k
            assert got["local_shapes"][k][-1] * 2 == shape[-1], k
    # one round: each unit gathered in the forward and again in the
    # backward's recompute, each gather's backward one ReduceScatter
    # and one replica all-reduce
    stats = got["stats"]
    assert stats["all_gather"] == 2 * stats["reduce_scatter"]
    assert stats["reduce_scatter"] == stats["all_reduce"] > 0


def test_remat_policies_and_gather_dtype(world2):
    """remat "none" and "offload" (on the CPU it keeps the boundary
    activations in place) take the same step as "full", bit for bit;
    without recompute the backward re-gathers nothing.  bf16 gathers
    (beyond-paper) move the loss by about a bf16 rounding of the weights;
    Adam's first step moves each param by at most lr either way, so the
    params stay within 2 lr of the fp32 gathers'."""
    res = world2["remat"]
    loss, p1, stats = res[("full", "float32")]
    assert stats["all_gather"] == 2 * stats["reduce_scatter"] > 0
    for key in (("none", "float32"), ("offload", "float32")):
        l2, p2, st2 = res[key]
        assert l2 == loss
        for a, b in zip(p1, p2):
            np.testing.assert_array_equal(a, b)
    assert res[("none", "float32")][2]["all_gather"] == \
        stats["reduce_scatter"]
    assert res[("offload", "float32")][2] == stats
    lb, pb, stb = res[("full", "bfloat16")]
    assert stb == stats
    assert 0 < abs(lb - loss) <= 1e-2 * abs(loss)
    assert max(float(np.abs(a - b).max()) for a, b in zip(pb, p1)) <= \
        2e-3 * (1 + 1e-5)


def test_frontend_batch_against_the_plain_loss(world2):
    """``has_frontend_batch``: the program's loss and gradient (Adam's m
    after one step is ``(1 - b1) g``) over two uneven ranks equal the
    plain model's on the whole batch with its frontend embeddings (the
    loss within 1e-5 relative, m within ``M_TOL``), and the embeddings
    reach the loss (the frontend projection has a gradient)."""
    from repro_torch.models import model as M
    cfg, params, batch = _frontend_inputs()
    loss, m1 = world2["frontend"]
    tree = M.tree_map(params_from_numpy(params, "cpu"),
                      lambda _, t: t.requires_grad_(True))
    ref, _ = M.loss_fn(cfg, tree, {
        k: torch.from_numpy(np.ascontiguousarray(
            v.reshape((-1,) + v.shape[3:]))) for k, v in batch.items()})
    ref.backward()
    assert abs(loss - ref.item()) <= 1e-5 * abs(ref.item()), (loss, ref)
    want = [(1 - AdamConfig().b1) * t.grad.numpy()
            for t in fsdp.tree_flatten(tree)[0]]
    assert len(m1) == len(want)
    assert m_close(m1, want) <= M_TOL
    assert np.abs(tree["frontend_proj"].grad.numpy()).max() > 0


def test_rank_errors_reach_the_controller(world2):
    """A rank's exception raises in the controller with its traceback and
    leaves the world usable; a rank's death raises at once; close()
    leaves no rank process alive."""
    assert world2["after_raise"] == [0, 1]
    assert world2["alive_after_close"] == [False, False]


def test_placement_rule(monkeypatch):
    """CPU ranks: gloo.  A card per rank: NCCL.  Ranks sharing a card:
    gloo through pinned host copies.  CUDA asked for and absent raises."""
    cpu = W.placement("cpu", 3)
    assert (cpu.backend, cpu.staged, cpu.devices) == ("gloo", False,
                                                      ("cpu",) * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            W.placement("cuda", 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    own = W.placement("cuda", 4)
    assert (own.backend, own.staged) == ("nccl", False)
    assert own.devices == ("cuda:0", "cuda:1", "cuda:2", "cuda:3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    shared = W.placement("cuda", 2)
    assert (shared.backend, shared.staged) == ("gloo", True)
    assert shared.devices == ("cuda:0", "cuda:0")
    assert W.device_count("cpu") == 1
