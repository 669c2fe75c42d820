"""The port's checkpointing (``repro_torch.checkpoint.checkpointing``)
against the JAX package's, on the CPU.

* The same on disk: a loopback engine's state shards saved by either
  package load in the other with equal keys, shapes and values, and the
  two manifests list the same keys and shapes for the same files.
* Atomic saves and manifest validation, as the reference's own tests check
  them (``tests/test_substrates.py``): a crash at any point of a save
  leaves the previous checkpoint loadable; a shard whose keys or shapes
  disagree with the manifest is refused.
* ``reshard`` equal to the reference's.
* Resume: 2 steps, save, load, import into a fresh engine (or put the
  saved shards back on the device), one more step: the loss of 3 steps
  straight, exactly.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as JCK
from repro.configs.base import get_arch as jax_arch
from repro.core.engine import build_train_step as jax_build
from repro.core.partition import Plan as JaxPlan
from repro.core.partition import RankPlan as JaxRankPlan
from repro.models import model as JM
from repro_torch.checkpoint import checkpointing as CK
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import fsdp
from repro_torch.core.engine import build_train_step
from repro_torch.core.partition import Plan, RankPlan
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.models import model as M

import torch_threads  # noqa: F401,E402  (caps torch's threads)

RANKS = [("A", 2, 2, 0.5), ("B", 1, 1, 0.3), ("C", 3, 1, 0.2)]
SEQ = 16


def _plan(R, P):
    return P(model="toy", cluster="toy",
             global_batch=sum(m * ell for _, m, ell, _ in RANKS),
             ranks=[R(i, d, m=m, ell=ell, state_ratio=r)
                    for i, (d, m, ell, r) in enumerate(RANKS)])


@pytest.fixture(scope="module")
def states():
    """(port state, reference state): the same params, reduced
    tiny-llama, one step of the same plan on the same block."""
    jcfg, cfg = jax_arch("tiny-llama").reduced(), \
        get_arch("tiny-llama").reduced()
    init = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jeng = jax_build(jcfg, _plan(JaxRankPlan, JaxPlan),
                     substrate="loopback", seq_len=SEQ)
    eng = build_train_step(cfg, _plan(RankPlan, Plan), seq_len=SEQ,
                           device="cpu")
    jstate = jeng.import_state({"step": 0, "p": init})
    state = eng.import_state({"step": 0,
                              "p": params_from_numpy(init, "cpu")})
    big = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=1)).sample(
        0, eng.plan.global_batch)
    jstate, _ = jeng.step(jstate, big)
    state, _ = eng.step(state, big)
    return state, jstate


def _manifest_layout(d, module):
    man = module._read_manifest(d)
    return ([(e["rank"], e["keys"], e["shapes"], e["size"])
             for e in man["shards"]],
            man["replicated"]["keys"], man["replicated"]["shapes"],
            man["step"], man["n_ranks"], man["meta"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_load_in_either_package(writer, states):
    state, jstate = states
    shards = state if writer == "port" else jstate
    save = CK.save if writer == "port" else JCK.save
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as e:
        save(d, 1, shards, {"step": 1}, meta={"plan": "toy"})
        (JCK.save if writer == "port" else CK.save)(
            e, 1, jstate if writer == "port" else state, {"step": 1},
            meta={"plan": "toy"})
        assert _manifest_layout(d, CK) == _manifest_layout(e, JCK)
        for load in (CK.load, JCK.load):
            step, loaded, rep, meta = load(d, jstate[0], {"step": None})
            assert (step, int(rep["step"]), meta) == (1, 1, {"plan": "toy"})
            assert len(loaded) == len(shards)
            for got, want in zip(loaded, shards):
                got, want = CK._flatten_dict(got), CK._flatten_dict(want)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fail_at", [0, 1, 2])
def test_crash_mid_save_leaves_previous_loadable(fail_at, monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        shards = [{"u": {"p": torch.arange(4, dtype=torch.float32)}}]
        CK.save(d, 1, shards, {"norm": np.ones(2, np.float32)})
        new = [{"u": {"p": torch.full((4,), 9.0)}}]
        calls = {"n": 0}
        real = CK._write_npz

        def boom(directory, name, flat):
            if calls["n"] == fail_at:
                raise OSError("disk full (simulated crash)")
            calls["n"] += 1
            return real(directory, name, flat)

        if fail_at < 2:
            monkeypatch.setattr(CK, "_write_npz", boom)
        else:   # every npz lands, the manifest flip crashes
            monkeypatch.setattr(CK.json, "dump", lambda *a, **k: (
                _ for _ in ()).throw(OSError("crash")))
        with pytest.raises(OSError):
            CK.save(d, 2, new, {"norm": np.zeros(2, np.float32)})
        monkeypatch.undo()
        for load in (CK.load, JCK.load):
            step, loaded, rep, _ = load(d, {"u": {"p": None}},
                                        {"norm": None})
            assert step == 1
            np.testing.assert_array_equal(loaded[0]["u"]["p"],
                                          np.arange(4, dtype=np.float32))
            np.testing.assert_array_equal(rep["norm"], np.ones(2))
        # the next good save collects the crashed save's files
        CK.save(d, 3, new, {"norm": np.zeros(2, np.float32)})
        assert sorted(n.split(".")[0] for n in os.listdir(d)) == \
            ["manifest", "rank_0", "replicated"]


@pytest.mark.parametrize("damage", ["keys", "shape"])
def test_load_validates_the_manifest(damage):
    with tempfile.TemporaryDirectory() as d:
        shards = [{"u": {"p": torch.arange(4, dtype=torch.float32),
                         "m": torch.zeros(4)}}]
        CK.save(d, 3, shards, {"norm": np.ones(2, np.float32)})
        entry = CK._read_manifest(d)["shards"][0]
        assert entry["keys"] == ["u/m", "u/p"]
        assert entry["shapes"]["u/p"] == [4]
        bad = {"u/p": np.arange(4, dtype=np.float32)} if damage == "keys" \
            else {"u/p": np.arange(3, dtype=np.float32),
                  "u/m": np.zeros(4, np.float32)}
        np.savez(os.path.join(d, entry["file"]), **bad)
        with pytest.raises(ValueError, match=damage):
            CK.load(d, shards[0], {"norm": None})


@pytest.mark.parametrize("old,new", [([6, 6], [4, 4, 4]), ([7, 5], [12]),
                                     ([3, 0, 9], [5, 7]),
                                     ([4, 4, 4], [2, 2, 2, 6])])
def test_reshard_matches_reference(old, new):
    full = np.arange(sum(old), dtype=np.float32)
    pmax = max(old)
    flat, off = [], 0
    for n in old:
        buf = np.zeros(pmax, np.float32)
        buf[:n] = full[off: off + n]
        flat.append(buf)
        off += n
    got, want = CK.reshard(flat, old, new), JCK.reshard(flat, old, new)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mismatch"):
        CK.reshard(flat, old, new[:-1] + [new[-1] + 1])


def _to_device(shard, device):
    """A loaded loopback shard back as the engine's state: tensors, and
    the step as an int."""
    return {k: int(v) if k == "step" else
            M.tree_map(v, lambda _, a: torch.from_numpy(a).to(device))
            for k, v in shard.items()}


@pytest.mark.parametrize("fmt", ["exported", "shards"])
def test_resume_from_a_checkpoint_gives_the_straight_loss(fmt):
    cfg = get_arch("gpt-1.3b").reduced()
    plan = _plan(RankPlan, Plan)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, SEQ, seed=3))
    blocks = [stream.sample(i, plan.global_batch) for i in range(3)]

    def fresh():
        return build_train_step(cfg, plan, seq_len=SEQ, device="cpu")

    def init(eng):
        return eng.init_state(torch.Generator().manual_seed(5))

    eng = fresh()
    state = init(eng)
    straight = [eng.step(state, b)[1] for b in blocks]

    eng = fresh()
    state = init(eng)
    for b in blocks[:2]:
        state, _ = eng.step(state, b)
    saved = eng.export_state(state)
    with tempfile.TemporaryDirectory() as d:
        if fmt == "exported":
            ex = eng.export_state(state)
            CK.save(d, ex["step"], [{k: ex[k] for k in "pmv"}],
                    {"step": ex["step"]}, meta={"format": "exported"})
            step, shards, rep, _ = CK.load(d, {k: ex[k] for k in "pmv"},
                                           {"step": None})
            eng = fresh()
            state = eng.import_state({"step": int(rep["step"]), **{
                k: params_from_numpy(shards[0][k], "cpu") for k in "pmv"}})
        else:
            CK.save(d, 2, state, {})
            step, shards, _, _ = CK.load(d, state[0], {})
            eng = fresh()
            state = [_to_device(s, "cpu") for s in shards]
    assert step == 2
    restored = eng.export_state(state)
    assert restored["step"] == saved["step"] == 2
    for k in "pmv":
        for a, b in zip(fsdp.tree_flatten(restored[k])[0],
                        fsdp.tree_flatten(saved[k])[0]):
            assert torch.equal(a, b)
    _, loss = eng.step(state, blocks[2])
    assert loss == straight[2]
