"""R3 — no host materialization of deferred handles in the pipelined
dispatch path.

The pipelined dispatch contract: ``run_segments`` / ``eval_stacked``
with ``defer=True`` return handles (``SegmentResult`` with an unresolved
``harvest`` thunk, ``StackedPending``) whose device work and copies are
still queued; the ONLY sanctioned host conversions are the nested
harvest/materialize/finalize thunks, which run one round late and charge
their wall clock through ``_time_block``.  An eager ``np.asarray`` /
``float()`` / ``.item()`` / ``.cpu()`` / ``.synchronize()`` on a
dispatch output in the *immediate* body of a dispatch-path function
re-inserts the per-round host sync the pipeline removed.

Mechanics: names bound from a dispatch call (``eval_stacked``,
``run_segments`` — tuple unpack included) are *deferred*; materializing
ops on expressions referencing a deferred name flag, and so does a
``torch.cuda.synchronize()`` anywhere in a function that holds one,
except inside nested functions/lambdas (those are the sanctioned late
thunks).  The on-card half of the contract (a sync the AST cannot see)
is ``chip_smoke.py``'s ``analysis`` line, under
``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import ast
from typing import List, Set

from ..lint import Rule, Violation, assign_target_names, dotted_name, names_in

#: calls whose results are in-flight device handles
DISPATCH_FNS = {"eval_stacked", "run_segments"}

#: eager materializers
SYNC_CALLS = {"float", "int", "list"}
SYNC_DOTTED = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "np.stack", "np.concatenate"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: device-wide syncs: flag wherever a deferred handle is held
DEVICE_SYNCS = {"torch.cuda.synchronize"}

FILES = ("repro_torch/core/torch_cost.py", "repro_torch/core/search.py")


def _immediate_nodes(fn: ast.AST):
    """Every node in the function's own body, descending into control
    flow and expressions but NOT into nested function/lambda bodies
    (those are the sanctioned deferred thunks)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class DeferredSyncRule(Rule):
    rule_id = "R3"
    title = "no host sync on deferred dispatch handles (pipeline path)"

    def applies(self, path: str) -> bool:
        return any(path.endswith(f) for f in FILES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_fn(node, path))
        return out

    def _check_fn(self, fn: ast.AST, path: str) -> List[Violation]:
        nodes = list(_immediate_nodes(fn))
        deferred: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                d = dotted_name(node.value.func)
                leaf = d.rsplit(".", 1)[-1] if d else None
                if leaf in DISPATCH_FNS:
                    for tgt in node.targets:
                        deferred |= assign_target_names(tgt)
        if not deferred:
            return []
        # propagate through plain reassignments in the immediate body
        for _ in range(4):
            grew = False
            for node in nodes:
                if isinstance(node, ast.Assign) and \
                        names_in(node.value) & deferred:
                    tgts: Set[str] = set()
                    for t in node.targets:
                        tgts |= assign_target_names(t)
                    if not tgts <= deferred:
                        deferred |= tgts
                        grew = True
            if not grew:
                break

        out: List[Violation] = []
        for call in nodes:
            if not isinstance(call, ast.Call):
                continue
            sync = None
            target = None
            d = dotted_name(call.func)
            if d in DEVICE_SYNCS:
                out.append(Violation(
                    self.rule_id, path, call.lineno,
                    f"{d}() waits for the whole device while this "
                    f"function holds deferred dispatch handles "
                    f"({', '.join(sorted(deferred))}) — wait only inside "
                    f"the harvest/finalize thunks via _time_block"))
                continue
            if d in SYNC_CALLS or d in SYNC_DOTTED:
                if call.args:
                    sync, target = d, call.args[0]
            elif isinstance(call.func, ast.Attribute) and \
                    call.func.attr in SYNC_METHODS:
                sync = f".{call.func.attr}()"
                target = call.func.value
            if sync is None or target is None:
                continue
            hit = names_in(target) & deferred
            if hit:
                out.append(Violation(
                    self.rule_id, path, call.lineno,
                    f"{sync} blocks on deferred dispatch handle "
                    f"({', '.join(sorted(hit))}) in the immediate "
                    f"dispatch path — materialize only inside the "
                    f"harvest/finalize thunks via _time_block "
                    f"(the pipelined dispatch contract)"))
        return out
