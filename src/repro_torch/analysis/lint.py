"""AST contract linter: the rule engine behind ``python -m
repro_torch.analysis``, the counterpart of the JAX package's
``analysis/lint.py`` (the same engine, copied; it is stdlib ``ast``).

Layer 1 of the port's static-analysis gate.  Each rule is a small class
over the stdlib ``ast`` module encoding ONE contract of the port — the
RNG plan/draw determinism contract (R2), the pipelined dispatch's no
host sync contract (R3), the ``torch_cost`` counter lock discipline
(R4).  Registry conformance (R5) is runtime reflection and lives in
:mod:`repro_torch.analysis.rules.r5_registry`; the traced-graph layer,
the counterpart of the reference's R1 and jaxpr audit, is
:mod:`repro_torch.analysis.graph_audit`.

Suppression: a violation whose source line carries
``# repro: noqa-contract(RULE)`` (or ``(RULE1,RULE2)``) is dropped —
the escape hatch for a reviewed, intentional exception.  There is no
``--fix``; violations are fixed by hand or suppressed explicitly.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract violation: rule id, location, human message."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Rule:
    """Base class for AST contract rules.  ``applies`` selects files by
    path (repo-relative, '/'-separated); ``check`` returns raw
    violations (suppressions are handled by the engine)."""

    rule_id = "R?"
    title = ""

    def applies(self, path: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.AST, src: str, path: str) -> List[Violation]:
        raise NotImplementedError


# ------------------------------------------------------------ AST helpers


def dotted_name(node: ast.AST) -> Optional[str]:
    """'np.random.rand' for nested Attribute/Name chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def names_in(node: ast.AST) -> Set[str]:
    """All bare identifier names referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def assign_target_names(node: ast.AST) -> Set[str]:
    """Plain names bound by an assignment target (tuple unpack included;
    subscript/attribute stores bind no new name)."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


_NOQA_RE = re.compile(r"#\s*repro:\s*noqa-contract\(([^)]*)\)")


def suppressions(src: str) -> Dict[int, Set[str]]:
    """line number -> set of suppressed rule ids (from
    ``# repro: noqa-contract(R1)`` / ``(R1,R2)`` comments)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


# ---------------------------------------------------------------- engine


def default_rules() -> List[Rule]:
    from .rules import ALL_RULES
    return [cls() for cls in ALL_RULES]


def lint_source(src: str, path: str, rules: Sequence[Rule],
                force: bool = False) -> List[Violation]:
    """Run ``rules`` over one file's source.  ``force=True`` skips the
    per-rule path filter (fixture tests)."""
    norm = path.replace(os.sep, "/")
    active = [r for r in rules if force or r.applies(norm)]
    if not active:
        return []
    tree = ast.parse(src, filename=path)
    sup = suppressions(src)
    out: List[Violation] = []
    for rule in active:
        for v in rule.check(tree, src, norm):
            if rule.rule_id in sup.get(v.line, ()):
                continue
            out.append(v)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_file(path: str, rules: Optional[Sequence[Rule]] = None,
              force: bool = False) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path, rules or default_rules(), force=force)


def iter_py_files(roots: Iterable[str]) -> List[str]:
    out: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git",
                                        "bench_out", ".ruff_cache")]
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(".py"))
    return sorted(out)


def lint_paths(roots: Iterable[str],
               rules: Optional[Sequence[Rule]] = None
               ) -> List[Violation]:
    """Lint every .py file under ``roots`` with the applicable rules."""
    rules = list(rules or default_rules())
    out: List[Violation] = []
    for path in iter_py_files(roots):
        out.extend(lint_file(path, rules))
    return out
