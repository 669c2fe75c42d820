"""Memory dry-run with no card: every (architecture × input shape × mesh).

The port of ``repro.launch.dryrun``.  For each combination it writes one
JSON record with the reference's keys where they apply — ``status``, a
skip ``reason``, ``geometry`` (train), ``roofline_analytic`` (the H100's
terms, :mod:`repro_torch.roofline.analysis`) and ``bottleneck_hint`` —
and ``per_rank_bytes``, what one rank of the mesh holds:

* ``train``: the state of a ``CephaloProgram``
  (:mod:`repro_torch.core.layered_ga`) on the mesh alone (p, m and v of
  every padded ``UnitLayout`` shard, the step) and its batch arguments,
  as the reference's ``dryrun_one`` builds them (``ell`` 1, ``m`` the
  batch over the chips, fp32 gathers), with the collectives a step
  issues (``collectives_analytic``);
* ``prefill`` / ``decode``: the bf16 weights under the serving rules
  (``repro_torch.launch.serving``), the KV / SSM cache shard and the
  token arguments.

Nothing is traced or compiled, so the reference's XLA temporaries and
cost analysis (``_mem_dict``, ``_cost_dict``), its HLO collective parse
and its ``--unroll`` have no analogue here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records land in ``--out`` (default ``build/dryrun/``, not committed) as
``<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs.base import (ASSIGNED, INPUT_SHAPES, ArchConfig,
                                      InputShape, get_arch, input_specs,
                                      shape_applicable)
from repro_torch.core.engine.world import Mesh
from repro_torch.core.layered_ga import CephaloProgram
from repro_torch.launch import serving
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as R

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def train_program(cfg: ArchConfig, shape: InputShape,
                  mesh: Mesh) -> CephaloProgram:
    """The reference dry-run's train program: every chip a ZeRO-3 worker,
    ``ell`` 1, ``m`` the batch over the chips (at least 1: with B < chips
    the surplus ranks hold state and idle), fp32 gathers."""
    m = max(shape.global_batch // mesh.size, 1)
    return CephaloProgram(cfg, mesh, ell=1, m=m, seq=shape.seq_len,
                          gather_dtype="float32")


def state_bytes(prog: CephaloProgram) -> Dict[str, int]:
    """One rank's bytes of each state part (``p``, ``m``, ``v``: its
    padded shards of every unit, fp32) and of the step counter."""
    local = prog.local_shapes()
    out: Dict[str, int] = {}
    for key, (_, dtype) in prog.state_shapes().items():
        part = key.split("/")[-1]
        out[part] = out.get(part, 0) + math.prod(local[key]) * dtype.itemsize
    return out


def batch_bytes(prog: CephaloProgram) -> int:
    """One rank's bytes of a step's batch arguments."""
    local = prog.local_shapes()
    return sum(math.prod(local[k]) * dtype.itemsize
               for k, (_, dtype) in prog.batch_shapes().items())


def serving_bytes(cfg: ArchConfig, mesh: Mesh, batch: int, max_len: int
                  ) -> Dict[str, int]:
    """One rank's bytes of the bf16 weights under the serving rules and of
    its cache shard for ``batch`` sequences of ``max_len`` slots."""
    return {
        "weights": serving.tree_bytes(
            mesh, serving.serving_param_shapes(cfg),
            serving.param_shardings(cfg, mesh)),
        "cache": serving.tree_bytes(
            mesh, serving.cache_shapes(cfg, batch, max_len),
            serving.cache_shardings(cfg, mesh, batch, max_len))}


def _serving_args_bytes(cfg: ArchConfig, shape: InputShape,
                        mesh: Mesh) -> int:
    bspec = serving.batch_sharding(mesh, shape.global_batch)[1][0]
    return sum(math.prod(mesh.shard_shape(t.shape, (bspec,))) *
               t.element_size()
               for t in input_specs(cfg, shape).values())


def record_for(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> Dict:
    """The dry-run's fields for one (arch, shape, mesh): geometry, each
    rank's bytes and the roofline terms."""
    rec: Dict = {}
    if shape.kind == "train":
        prog = train_program(cfg, shape, mesh)
        rec["geometry"] = {"ell": 1, "m": prog.m, "per_device_batch": prog.m}
        st = state_bytes(prog)
        per = {"state": st, "batch": batch_bytes(prog)}
        per["total"] = sum(st.values()) + per["batch"]
        coll = R.program_collectives(prog)
        rec["collectives_analytic"] = {
            "counts": coll.counts, "bytes_by_op": coll.bytes_by_op,
            "total_bytes": coll.total_bytes}
    else:
        per = serving_bytes(cfg, mesh, shape.global_batch, shape.seq_len)
        per["args"] = _serving_args_bytes(cfg, shape, mesh)
        per["total"] = per["weights"] + per["cache"] + per["args"]
    rec["per_rank_bytes"] = per
    terms = R.terms_for(cfg, shape, mesh.size)
    rec["hardware"] = terms.hw.name
    rec["roofline_analytic"] = terms.row()
    rec["bottleneck_hint"] = R.what_would_move_it(terms, shape.kind)
    return rec


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True, out_dir: Optional[str] = None) -> Dict:
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    record: Dict = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "chips": mesh.size, "kind": shape.kind,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        _save(record, out_dir)
        if verbose:
            print(f"[skip] {arch} × {shape_name} × {record['mesh']}: "
                  f"{reason}")
        return record
    t0 = time.perf_counter()
    try:
        record.update(record_for(cfg, shape, mesh))
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["seconds"] = round(time.perf_counter() - t0, 3)
    _save(record, out_dir)
    if verbose:
        mark = "ok  " if record["status"] == "ok" else "FAIL"
        if record["status"] == "ok":
            gib = record["per_rank_bytes"]["total"] / 2**30
            extra = (f" per-rank={gib:.2f}GiB dominant="
                     f"{record['roofline_analytic']['dominant']}")
        else:
            extra = " " + record.get("error", "")[:160]
        print(f"[{mark}] {arch} × {shape_name} × {record['mesh']}{extra}",
              flush=True)
    return record


def _save(record: Dict, out_dir: Optional[str]) -> None:
    d = out_dir or OUT_DIR
    os.makedirs(d, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(d, name), "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs × all shapes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]
    results = [dryrun_one(arch, shape, args.multi_pod, out_dir=args.out)
               for arch, shape in combos]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
