"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit; the same numbers are the last lines of
standard error.  The run exits non-zero and prints no result where the
card is missing or has fewer chips than the cell asks for, where a file
the cell names is missing, and where the process holds JAX or the JAX
package once the window has closed.

Every build and kernel cache lies under ``build/`` in the checkout, at a
fixed path: Python's bytecode of every module the run imports too
(``build/pycache``), written even where the environment says not to, so
that only the first run of a checkout compiles the sources of PyTorch
and the port.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import traceback  # noqa: E402
#: top-level module names that may not be loaded in the process that
#: prints the result (whole names: ``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: ``time.perf_counter()`` at the process's start
PROCESS_START = _T_IMPORT - _process_age()


def _environment() -> None:
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the script's own directory would shadow modules of the same name
    # (``trace``) for every import
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from perfbench import spec
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = spec.module("runners", cell.traffic["runner"])
    try:
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                            PROCESS_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad}; the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    result = _finite(result)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
