"""The port's input shapes, meshes, placements, serving rules and memory
dry-run against the JAX package, on the CPU.

* ``shape_applicable`` (status and reason) and ``input_specs`` (every
  stand-in's shape and dtype) equal the reference's for every assigned
  arch × every ``INPUT_SHAPES`` entry.
* On the production meshes (16, 16) and (2, 16, 16), the train program
  the dry-run builds (``ell`` 1, ``m`` the batch over the chips, fp32
  gathers): each rank's state shape under ``state_shardings()`` equals
  ``NamedSharding.shard_shape`` of the reference's ``state_shapes()``
  under its ``state_shardings()``, for every assigned arch (a stage of
  one element keeps the port's count dim of 1: compared by element
  count there), and likewise the batch under ``batch_shardings()``.
* The serving rules: every param leaf's spec (``param_shardings``, the
  reference's ``_leaf_spec``) and every cache leaf's
  (``cache_shardings`` at decode_32k and long_500k) equal the
  reference's on both meshes, for every assigned arch.
* The reference's specs come from one subprocess with 512 fake host
  devices.
* ``python -m repro_torch.launch.dryrun`` writes a record per
  combination: skips with the reference's reason, per-rank bytes that
  follow from those shapes, the H100's roofline terms.
"""

import json
import math
import pickle

import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jax_base
from repro_torch.configs import base as pt_base
from repro_torch.launch import dryrun, serving
from repro_torch.launch.mesh import (all_axes, axis_size, data_axes,
                                     make_production_mesh, make_test_mesh)
from repro_torch.roofline import analysis as R

import torch_threads  # noqa: F401,E402  (caps torch's threads)

ARCHS = pt_base.ASSIGNED
SHAPES = list(pt_base.INPUT_SHAPES)
CACHE_SHAPES = ("decode_32k", "long_500k")

ORACLE = r'''
import pickle
import jax
from repro.configs.base import ASSIGNED, INPUT_SHAPES, get_arch
from repro.core.engine import CephaloProgram
from repro.launch import serving
from repro.launch.mesh import make_production_mesh


def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(serving._path_names(p)): tuple(s.spec) for p, s in leaves}


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    chips = mesh.devices.size
    shape = INPUT_SHAPES["train_4k"]
    for arch in ASSIGNED:
        cfg = get_arch(arch)
        m = max(shape.global_batch // chips, 1)
        prog = CephaloProgram(cfg, mesh, ell=1, m=m, seq=shape.seq_len,
                              gather_dtype="float32")
        st, bt = prog.state_shardings(), prog.batch_shardings()
        rec = {"state": {k: tuple(st[k].shard_shape(v.shape))
                         for k, v in prog.state_shapes().items()},
               "batch": {k: tuple(bt[k].shard_shape(v.shape))
                         for k, v in prog.batch_shapes().items()},
               "params": flat(serving.param_shardings(cfg, mesh))}
        for name in ("decode_32k", "long_500k"):
            sp = INPUT_SHAPES[name]
            rec[name] = flat(serving.cache_shardings(
                cfg, mesh, sp.global_batch, sp.seq_len))
        out[(arch, multi)] = rec
with open(PATH_, "wb") as f:
    pickle.dump(out, f)
print("ORACLE-OK")
'''


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, subproc):
    path = tmp_path_factory.mktemp("dryrun") / "out.pkl"
    code = ORACLE.replace("PATH_", repr(str(path)))
    assert "ORACLE-OK" in subproc(code, n_devices=512, timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


def _specs(tree):
    """{names: spec} of a port spec tree, a one-axis tuple written as its
    axis (``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    out = {}
    serving._tree_map_with_path(
        lambda names, s: out.__setitem__(tuple(names), tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in s)), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_and_input_specs_match_reference(arch):
    jcfg, pcfg = jax_base.get_arch(arch), pt_base.get_arch(arch)
    for name in SHAPES:
        jshape, shape = jax_base.INPUT_SHAPES[name], pt_base.INPUT_SHAPES[name]
        assert pt_base.shape_applicable(pcfg, shape) == \
            jax_base.shape_applicable(jcfg, jshape)
        want = jax_base.input_specs(jcfg, jshape)
        got = pt_base.input_specs(pcfg, shape)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == \
                jnp.dtype(spec.dtype).name, (name, k)


def test_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.axis_names) == \
        ((2, 16, 16), ("pod", "data", "model"))
    assert data_axes(two) == ("pod", "data") and all_axes(one) == \
        ("data", "model")
    assert axis_size(two, "model") == 16
    assert axis_size(two, ("pod", "data")) == 32 and two.size == 512
    test = make_test_mesh()
    assert (test.shape, test.size) == ((2, 4), 8)
    # a rank's block along some axes: row-major over them, as the mesh
    assert [two.coord(r, ("pod", "model")) for r in (0, 1, 16, 256, 511)] \
        == [0, 1, 0, 16, 31]


@pytest.mark.parametrize("multi", [False, True], ids=["pod16x16",
                                                      "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_placement_matches_reference(oracle, arch, multi):
    ref = oracle[(arch, multi)]
    cfg, shape = pt_base.get_arch(arch), pt_base.INPUT_SHAPES["train_4k"]
    prog = dryrun.train_program(cfg, shape, make_production_mesh(
        multi_pod=multi))
    assert prog.jit_step() is None
    local = prog.local_shapes()
    assert set(local) == set(ref["state"]) | set(ref["batch"])
    for k, want in ref["state"].items():
        got = local[k]
        if got != want:     # a one-element stage: (1, P_max) vs (P_max,)
            assert len(got) == len(want) + 1 and got[0] == 1, (k, got, want)
            assert math.prod(got) == math.prod(want)
    for k, want in ref["batch"].items():
        assert local[k] == want, (k, local[k], want)
    st = dryrun.state_bytes(prog)
    for part in ("p", "m", "v"):
        assert st[part] == 4 * sum(math.prod(v) for k, v in
                                   ref["state"].items()
                                   if k.endswith("/" + part))


@pytest.mark.parametrize("multi", [False, True], ids=["pod16x16",
                                                      "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_specs_match_reference(oracle, arch, multi):
    ref = oracle[(arch, multi)]
    cfg = pt_base.get_arch(arch)
    mesh = make_production_mesh(multi_pod=multi)
    assert _specs(serving.param_shardings(cfg, mesh)) == ref["params"]
    for name in CACHE_SHAPES:
        sp = pt_base.INPUT_SHAPES[name]
        got = _specs(serving.cache_shardings(cfg, mesh, sp.global_batch,
                                             sp.seq_len))
        assert got == ref[name], name


def test_dryrun_cli_records(tmp_path):
    """Two records through the module's entry point: a skip with the
    reference's reason, and a train record whose per-rank state is the
    program's shards and whose roofline is the H100's."""
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "long_500k",
                 "--multi-pod", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "stablelm-1.6b__train_4k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["geometry"] == {"ell": 1, "m": 1, "per_device_batch": 1}
    cfg = pt_base.get_arch("stablelm-1.6b")
    shape = pt_base.INPUT_SHAPES["train_4k"]
    prog = dryrun.train_program(cfg, shape, make_production_mesh())
    per = rec["per_rank_bytes"]
    assert per["state"] == dryrun.state_bytes(prog)
    assert per["total"] == sum(per["state"].values()) + per["batch"]
    assert rec["roofline_analytic"] == json.loads(json.dumps(
        R.terms_for(cfg, shape, 256).row()))
    assert rec["hardware"] == "H100"
    assert rec["collectives_analytic"]["counts"] == \
        R.program_collectives(prog).counts
    skip = json.loads((tmp_path / "qwen3-moe-30b-a3b__long_500k__pod2x16x16"
                       ".json").read_text())
    assert skip["status"] == "skipped"
    assert (False, skip["reason"]) == jax_base.shape_applicable(
        jax_base.get_arch("qwen3-moe-30b-a3b"),
        jax_base.INPUT_SHAPES["long_500k"])


def test_serving_bytes_follow_the_specs():
    """decode_32k on (16, 16): the cache shard of a dense model is its
    cache over 16 batch groups and 16 sequence blocks; the weights' bytes
    are bf16 over the split dims."""
    cfg = pt_base.get_arch("stablelm-1.6b")
    mesh = make_production_mesh()
    sp = pt_base.INPUT_SHAPES["decode_32k"]
    got = dryrun.serving_bytes(cfg, mesh, sp.global_batch, sp.seq_len)
    whole = sum(t.numel() * t.element_size() for t in
                _leaves(serving.cache_shapes(cfg, sp.global_batch,
                                             sp.seq_len)))
    assert got["cache"] * 256 == whole
    params = _leaves(serving.serving_param_shapes(cfg))
    assert all(t.dtype == torch.bfloat16 for t in params)
    assert got["weights"] <= sum(t.numel() * 2 for t in params)


def _leaves(tree):
    out = []
    serving._tree_map_with_path(lambda _, t: out.append(t), tree)
    return out
