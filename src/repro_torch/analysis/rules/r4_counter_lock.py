"""R4 — ``torch_cost``'s module counters and caches mutate only under
``_LOCK``.

Callers may dispatch from worker threads (the sweep server's epoch
worker beside its admission thread; ``torch_cost``'s header comment), so
every mutation of a module-level counter or cache — assignment,
augmented increment, subscript store, or mutating method call — must sit
lexically inside a ``with _LOCK:`` block.  Module-level initializers
(outside any function) are exempt; reads are not restricted.
"""
from __future__ import annotations

import ast
import re
from typing import List

from ..lint import Rule, Violation, names_in

#: the lock-guarded module globals of ``torch_cost``
COUNTER_RE = re.compile(
    r"^_(DISPATCHES|HOST_BLOCKED_S|STACK_PREP_HITS|STACK_PREP_MISSES|"
    r"STACK_CONSTS)$")

MUTATORS = {"clear", "update", "pop", "popitem", "setdefault", "add",
            "append", "extend", "remove", "discard", "insert"}

FILES = ("repro_torch/core/torch_cost.py",)


def _is_counter(name: str) -> bool:
    return bool(COUNTER_RE.match(name))


class CounterLockRule(Rule):
    rule_id = "R4"
    title = "torch_cost counter/cache mutations must hold _LOCK"

    def applies(self, path: str) -> bool:
        return any(path.endswith(f) for f in FILES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Violation]:
        out: List[Violation] = []
        self._visit(tree, path, fn_depth=0, lock_depth=0, out=out)
        return out

    def _visit(self, node: ast.AST, path: str, fn_depth: int,
               lock_depth: int, out: List[Violation]) -> None:
        for child in ast.iter_child_nodes(node):
            c_fn, c_lock = fn_depth, lock_depth
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                c_fn += 1
            elif isinstance(child, ast.With):
                if any("_LOCK" in names_in(item.context_expr)
                       for item in child.items):
                    c_lock += 1
            if fn_depth > 0 and lock_depth == 0:
                self._flag(child, path, out)
            self._visit(child, path, c_fn, c_lock, out)

    def _flag(self, node: ast.AST, path: str,
              out: List[Violation]) -> None:
        hits: List[str] = []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and _is_counter(t.id):
                    hits.append(t.id)
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        _is_counter(t.value.id):
                    hits.append(t.value.id)
                elif isinstance(t, ast.Tuple):
                    for el in t.elts:
                        if isinstance(el, ast.Name) and \
                                _is_counter(el.id):
                            hits.append(el.id)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS and \
                isinstance(node.func.value, ast.Name) and \
                _is_counter(node.func.value.id):
            hits.append(f"{node.func.value.id}.{node.func.attr}()")
        for h in hits:
            out.append(Violation(
                self.rule_id, path, node.lineno,
                f"mutation of {h} outside `with _LOCK:` races a "
                f"dispatching worker thread — guard every module "
                f"counter/cache mutation with the lock"))
