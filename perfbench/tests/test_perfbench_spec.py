"""BENCHMARK.json keeps to its format, the harness finds a new
configuration, mix or metric by its file alone, and nothing the benchmark
runs loads JAX or the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.tests import tiny
from perfbench import checks, spec

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_every_name_is_plain(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_is_well_formed(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if "bound" in metric:
        allowed |= {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert (ROOT / "perfbench/metrics" / f"{metric['name']}.py").exists()
    assert set(metric) <= allowed
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = spec.cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.checks["limits"]) == set(checks.NUMBERS)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a check and a per-layer metric added as new
    files, and entries added to BENCHMARK.json, are found with no file
    already there edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    cfg = tiny.config("dense")
    cfg["name"] = "gpt-tiny"
    (tmp_path / "perfbench/configs/gpt-tiny.json").write_text(
        json.dumps(cfg))
    (tmp_path / "perfbench/traffic/mini.b8.s16.json").write_text(
        json.dumps({"runner": "train_mpmd", "cluster": "mini",
                    "global_batch": 8, "seq_len": 16}))
    (tmp_path / "perfbench/checks/gpt-tiny.mini.json").write_text(
        json.dumps({"steps": 2, "tokens_per_block": 64,
                    "limits": tiny.LIMITS}))
    (tmp_path / "perfbench/metrics/steps_traced.py").write_text(
        "def read(ctx):\n    return ctx.window.steps\n")
    bench["configs"].append({"name": "gpt-tiny", "source": "test",
                             "file": "perfbench/configs/gpt-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gpt-tiny.mini", "config": "gpt-tiny",
                               "traffic": "mini.b8.s16", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_tokens_per_s",
                               "workloads": ["gpt-tiny.mini"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("gpt-tiny.mini", root=tmp_path)
    assert cell.config["model"]["d_model"] == 64
    assert cell.traffic["global_batch"] == 8
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    mods = spec.readers("metrics", cell.per_layer, root=tmp_path)

    class Ctx:
        class window:
            steps = 3
    assert mods["steps_traced"].read(Ctx) == 3
    assert spec.module("runners", cell.traffic["runner"], root=tmp_path)
    # the new cell's metric is not reported by the cells already there
    old = spec.cell(BENCH["workloads"][0]["name"], root=tmp_path)
    assert "steps_traced" not in [m["name"] for m in old.per_layer]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "perfbench").rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cell at a test's size, traced, in a fresh process:
    no module with a forbidden top-level name is loaded after it; the
    comparison is by whole top-level names (``repro_torch`` is the
    port)."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.runners import train_mpmd as R\n"
        "from perfbench.roofline import peaks\n"
        "from perfbench import run\n"
        "out = R.run(tiny.cell('dense'), 3, 0.2, True, time.perf_counter(),"
        " device='cpu', peaks=peaks.PEAKS['H100'])\n"
        "assert out['correct'], out['checks']\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    found, tops = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "repro_torch" in tops and "'repro'" not in tops
