"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

Nothing here knows a particular cell, configuration, mix or metric: a
new one is a new file beside the others and an entry in
``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

#: the root of the checkout: ``BENCHMARK.json`` and ``perfbench/``
ROOT = Path(__file__).resolve().parents[1]

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, or a file it names, is missing or malformed."""


@dataclasses.dataclass
class Cell:
    """One workload: its configuration, traffic mix and check, the
    end-to-end metrics it reports and the per-layer metrics its traced
    run reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def _named(kind: str, name: str) -> str:
    if not _NAME.match(name):
        raise SpecError(f"{kind} name {name!r} is not a plain name")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    root = Path(root)
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; known: "
                        f"{sorted(w['name'] for w in bench['workloads'])}")
    conf = {c["name"]: c for c in bench["configs"]}.get(work["config"])
    if conf is None:
        raise SpecError(f"workload {name!r} names config "
                        f"{work['config']!r}, which BENCHMARK.json lacks")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    pkg = root / "perfbench"
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_load_json(root / conf["file"]),
        traffic=_load_json(pkg / "traffic" /
                           f"{_named('traffic', work['traffic'])}.json"),
        checks=_load_json(pkg / "checks" / f"{_named('workload', name)}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root)


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``perfbench/<kind>/<name>.py`` under ``root``, loaded
    from its file (a name may hold dots and dashes)."""
    path = Path(root) / "perfbench" / kind / f"{_named(kind, name)}.py"
    if not path.exists():
        raise SpecError(f"missing file {path}")
    key = "perfbench_file_" + re.sub(r"\W", "_", str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def readers(kind: str, metrics: List[dict], root: Path = ROOT
            ) -> Dict[str, ModuleType]:
    """Each metric's reader, ``perfbench/<kind>/<metric>.py``."""
    return {m["name"]: module(kind, m["name"], root) for m in metrics}


def read_all(mods: Dict[str, ModuleType], metrics: List[dict], ctx
             ) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read; a reader that found nothing returns None and its
    metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = mods[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
