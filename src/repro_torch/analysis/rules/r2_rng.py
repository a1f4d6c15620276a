"""R2 — RNG determinism in ``repro_torch/core/``: no global-state or
time-seeded RNG.

The device<->host replay contract: every random draw a search consumes
is pre-planned through the ``es_ops`` plan/draw split from an explicitly
seeded ``np.random.Generator`` or a keyed ``torch.Generator``, so a
device segment replays bit-identically on the host.  Bare
``np.random.*`` calls (module-global state), stdlib ``random``,
unseeded or time-seeded ``default_rng()``, and torch's sampling
functions drawing from torch's global generator (no ``generator=``) all
break that bit parity.  ``es_ops.py`` itself is the sanctioned plan/draw
module and is exempt.

Allowed: ``np.random.default_rng(<explicit seed>)``,
``np.random.SeedSequence(...)``, ``np.random.Generator``, and any torch
sampler given ``generator=`` (annotations are not calls and never
flag).
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Rule, Violation, dotted_name

#: np.random attributes that are fine to CALL
_ALLOWED = {"default_rng", "Generator", "SeedSequence", "PCG64",
            "Philox", "SFC64", "MT19937", "BitGenerator"}

#: torch functions that draw from torch's global generator unless given
#: ``generator=``
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
                  "bernoulli", "normal", "rand_like", "randn_like",
                  "randint_like", "poisson"}

#: in-place tensor samplers, the same unless given ``generator=``
TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                          "exponential_", "geometric_", "cauchy_",
                          "log_normal_"}

_STDLIB_MSG = ("stdlib `random` (global hidden state) breaks "
               "device<->host replay bit-parity; draw from a seeded "
               "np.random.Generator via the es_ops plan/draw split instead")


def _mentions_time(node: ast.AST) -> bool:
    for n in ast.walk(node):
        d = dotted_name(n)
        if d in ("time.time", "time.time_ns", "time.perf_counter",
                 "time.monotonic"):
            return True
    return False


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


class RngDeterminismRule(Rule):
    rule_id = "R2"
    title = ("no bare np.random.* / random.* / time-seeded RNG / global "
             "torch generator in core/")

    def applies(self, path: str) -> bool:
        return "repro_torch/core/" in path and \
            not path.endswith("core/es_ops.py")

    def check(self, tree: ast.AST, src: str, path: str) -> List[Violation]:
        out: List[Violation] = []
        imports_random = False
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                if any(a.name == "random" for a in node.names):
                    imports_random = True
                    out.append(Violation(self.rule_id, path, node.lineno,
                                         _STDLIB_MSG))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    out.append(Violation(self.rule_id, path, node.lineno,
                                         _STDLIB_MSG))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in TORCH_INPLACE_SAMPLERS and \
                    not _has_generator(node):
                out.append(Violation(
                    self.rule_id, path, node.lineno,
                    f"`.{node.func.attr}(...)` without generator= draws "
                    f"from torch's global generator in core/; pass a "
                    f"keyed torch.Generator (es_ops plan/draw split)"))
                continue
            if d is None:
                continue
            if d.startswith(("np.random.", "numpy.random.")):
                attr = d.rsplit(".", 1)[1]
                if attr not in _ALLOWED:
                    out.append(Violation(
                        self.rule_id, path, node.lineno,
                        f"bare global-state RNG `{d}(...)` in core/ "
                        f"breaks replay determinism; use an explicitly "
                        f"seeded np.random.default_rng through the "
                        f"es_ops plan/draw split"))
                elif attr == "default_rng" and (
                        not node.args or
                        isinstance(node.args[0], ast.Constant)
                        and node.args[0].value is None or
                        _mentions_time(node)):
                    out.append(Violation(
                        self.rule_id, path, node.lineno,
                        "unseeded/time-seeded default_rng() in core/ is "
                        "non-replayable; pass an explicit seed"))
            elif d.startswith("torch.") and \
                    d.rsplit(".", 1)[1] in TORCH_SAMPLERS and \
                    d.count(".") == 1 and not _has_generator(node):
                out.append(Violation(
                    self.rule_id, path, node.lineno,
                    f"`{d}(...)` without generator= draws from torch's "
                    f"global generator in core/; pass a keyed "
                    f"torch.Generator (es_ops plan/draw split)"))
            elif imports_random and d.startswith("random."):
                out.append(Violation(
                    self.rule_id, path, node.lineno,
                    f"stdlib `{d}(...)` uses hidden global state; use a "
                    f"seeded np.random.Generator via the es_ops "
                    f"plan/draw split"))
        return out
