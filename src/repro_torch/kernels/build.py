"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled on its own
into a shared library with a plain C interface, under ``build/kernels/``
at the repository root.  The library's file name carries a hash of its
source, so a changed source is rebuilt at its next use and an unchanged
one is loaded as it is.  All sources that need building are compiled in
parallel, one ``nvcc`` each.  Nothing is built when this module is
imported: the first call of :func:`load` (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) → source path."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns kernel name → ``nvcc`` output (register and shared-memory use
    from ``-Xptxas -v``) for the sources it compiled.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: src for name, src in sources().items()
            if not _lib_path(src).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc={proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(todo[name]))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            src = sources()[name]
            if not _lib_path(src).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(src)))
            _LOADED[name] = lib
        return lib
