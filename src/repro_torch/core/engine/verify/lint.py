"""Determinism lint: every gradient reduction flows through
``combine_fixed_order``.

The port's copy of ``repro.core.engine.verify.lint``: it reads the
port's own data plane (the modules beside this package, under
``repro_torch/core/engine``), not the reference's.

The bitwise cross-substrate parity contract (paper Sec. 2 / App. C)
holds only because every multi-contributor float reduction in the data
plane happens in one fixed rank order — the hub coordinator, the
loopback tree sum, and each ring destination all call
:func:`repro_torch.core.engine.ring.combine_fixed_order`.  A pipelined
partial-sum ring (accumulating in *ring* order) or a reduction iterating
a dict would produce a different float-add order per topology or per
hash seed and silently break parity.  This AST lint makes the property
checkable:

* **DET-1** — a loop-carried accumulation (``acc = acc + x`` /
  ``acc += x``) inside a ``for`` over ``.items()`` / ``.values()`` is a
  dict-iteration reduction; it must live in an allowlisted function
  (each allowlist entry documents why its order is deterministic or
  order-free).  Element-wise pairwise adds (dict comprehensions — no
  loop-carried state) are inherently two-operand and exempt.
* **DET-2** — every ``accum_grads(x)`` call site must pass a value
  bound from ``combine_fixed_order`` in the same scope (or be
  allowlisted: the hub worker's ``grad_accum`` handler receives slices
  the coordinator already combined).

Scope: the data-plane modules (ring, transport, substrate, multiproc) —
the code between a gradient and its Adam update.  The mutation harness
feeds this lint a ring-order-accumulation mutant via ``extra_sources``
and expects a finding.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

#: modules between a gradient and its optimizer update
DATA_PLANE_MODULES = ("ring.py", "transport.py", "substrate.py",
                      "multiproc.py")

#: (file basename, qualified function name) -> why the dict-iteration
#: accumulation there is deterministic anyway.  (``combine_fixed_order``
#: itself needs no entry: its outer loop is a fixed rank-order *list*,
#: and its inner ``out[u] = out[u] + a32`` is per-key independent —
#: each dict iteration touches its own accumulator slot, a shape DET-1
#: recognizes and exempts.)
DICT_REDUCTION_ALLOWLIST: Dict[Tuple[str, str], str] = {
    ("transport.py", "ShmArena.write"):
        "integer byte offsets (arena layout), not a float reduction; "
        "iteration order IS the wire manifest order by construction",
    ("multiproc.py", "MultiProcessSubstrate.coordinator_bytes"):
        "integer byte accounting; int addition is exact and order-free",
}

#: (file basename, qualified function name) -> why accum_grads may be
#: fed something other than a local combine_fixed_order result.
ACCUM_CALL_ALLOWLIST: Dict[Tuple[str, str], str] = {
    ("multiproc.py", "_worker_main"):
        "hub grad_accum handler: the arrays arrive over the wire "
        "already rank-order-combined by the coordinator "
        "(_hub_collective_round calls combine_fixed_order)",
}


@dataclasses.dataclass
class Finding:
    path: str
    qualname: str
    lineno: int
    rule: str
    detail: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.lineno}: [{self.rule}] "
                f"{self.qualname}: {self.detail}")


def _target_root(node: ast.AST) -> Optional[str]:
    """Root name of an assignment target (``out`` for ``out[u]``)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_dict_iteration(iter_node: ast.AST) -> bool:
    return (isinstance(iter_node, ast.Call)
            and isinstance(iter_node.func, ast.Attribute)
            and iter_node.func.attr in ("items", "values"))


def _per_key_independent(target: ast.AST, loop_targets: set) -> bool:
    """True for ``acc[k] = ...`` / ``acc[k] += ...`` where ``k`` is the
    iterating loop's own key: each iteration writes a distinct slot, so
    the float-add order across the dict iteration cannot matter."""
    if not isinstance(target, ast.Subscript):
        return False
    sl = target.slice
    if isinstance(sl, ast.Index):   # pragma: no cover - py<3.9 AST shape
        sl = sl.value
    return isinstance(sl, ast.Name) and sl.id in loop_targets


def _loop_carried_accums(loop: ast.For) -> List[ast.AST]:
    """Statements in ``loop`` that accumulate into loop-carried state:
    ``x += ...`` or ``x = <expr mentioning x>`` under an Add —
    excluding per-key-independent slot updates keyed by this loop's own
    target."""
    loop_targets = _names_in(loop.target)
    hits: List[ast.AST] = []
    for stmt in ast.walk(loop):
        if isinstance(stmt, ast.AugAssign) and \
                isinstance(stmt.op, ast.Add):
            if not _per_key_independent(stmt.target, loop_targets):
                hits.append(stmt)
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            root = _target_root(stmt.targets[0])
            if root is None:
                continue
            has_add = any(isinstance(n, ast.BinOp)
                          and isinstance(n.op, ast.Add)
                          for n in ast.walk(stmt.value))
            if has_add and root in _names_in(stmt.value) and \
                    not _per_key_independent(stmt.targets[0],
                                             loop_targets):
                hits.append(stmt)
    return hits


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.base = os.path.basename(path)
        self.stack: List[str] = []
        #: per-scope names bound from combine_fixed_order
        self.combined: List[set] = [set()]
        self.findings: List[Finding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    # --- scope tracking --------------------------------------------------
    def _enter(self, node):
        self.stack.append(node.name)
        self.combined.append(set())
        self.generic_visit(node)
        self.combined.pop()
        self.stack.pop()

    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter
    visit_ClassDef = _enter

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Call):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name == "combine_fixed_order":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.combined[-1].add(t.id)
        self.generic_visit(node)

    # --- DET-1: dict-iteration reductions --------------------------------
    def visit_For(self, node: ast.For):
        if _is_dict_iteration(node.iter):
            for stmt in _loop_carried_accums(node):
                key = (self.base, self.qualname)
                if key not in DICT_REDUCTION_ALLOWLIST:
                    self.findings.append(Finding(
                        self.path, self.qualname, stmt.lineno, "DET-1",
                        "loop-carried accumulation while iterating a "
                        "dict: float-add order depends on dict order; "
                        "route reductions through combine_fixed_order "
                        "or add a justified allowlist entry"))
                break   # one finding per loop
        self.generic_visit(node)

    # --- DET-2: accum_grads call sites -----------------------------------
    def visit_Call(self, node: ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        if name == "accum_grads" and node.args:
            arg = node.args[0]
            ok = isinstance(arg, ast.Name) and \
                any(arg.id in scope for scope in self.combined)
            key = (self.base, self.qualname)
            if not ok and key not in ACCUM_CALL_ALLOWLIST:
                self.findings.append(Finding(
                    self.path, self.qualname, node.lineno, "DET-2",
                    "accum_grads() fed something other than a "
                    "combine_fixed_order result bound in this scope — "
                    "the reduction order is unproven (ring-order "
                    "accumulation breaks bitwise parity)"))
        self.generic_visit(node)


def _engine_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_determinism(paths: Optional[Sequence[str]] = None,
                     extra_sources: Optional[Sequence[Tuple[str, str]]]
                     = None) -> List[Finding]:
    """Run the determinism lint over the data-plane modules (or
    ``paths``); ``extra_sources`` is ``[(virtual_path, source), ...]``
    for the mutation harness."""
    findings: List[Finding] = []
    if paths is None:
        paths = [os.path.join(_engine_dir(), m)
                 for m in DATA_PLANE_MODULES]
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        findings.extend(_lint_source(path, source))
    for vpath, source in (extra_sources or ()):
        findings.extend(_lint_source(vpath, source))
    return findings


def _lint_source(path: str, source: str) -> List[Finding]:
    visitor = _Visitor(path)
    visitor.visit(ast.parse(source, filename=path))
    return visitor.findings
