"""The port's contract linter and graph auditor (``repro_torch.analysis``),
the counterpart of ``tests/test_analysis.py`` (without its compile-ahead
tests: the port compiles nothing ahead of a dispatch).

Layer 1: every rule R2-R4 fires on a violating snippet and stays silent
on a conforming twin; suppression; the port's files are lint-clean; R5
over the live registries and over deliberately broken fakes.  Layer 2:
the graph audit passes and hashes a live family, fails on a deliberately
baked constant, and flags an ``.item()``, a ``.cpu()`` and a stray
float64.  The ``python -m repro_torch.analysis`` gate exits 0 on the
repo (lint layer; the whole audit runs in ``chip_smoke.py``'s
``analysis`` line).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import default_roots, lint_source, run_report
from repro_torch.analysis import graph_audit
from repro_torch.analysis.lint import Violation, suppressions
from repro_torch.analysis.rules import ALL_RULES
from repro_torch.analysis.rules.r2_rng import RngDeterminismRule
from repro_torch.analysis.rules.r3_deferred_sync import DeferredSyncRule
from repro_torch.analysis.rules.r4_counter_lock import CounterLockRule
from repro_torch.analysis.rules.r5_registry import (check_archs,
                                                    check_density_families,
                                                    check_registries,
                                                    check_request_methods)
from repro_torch.core import torch_cost
from repro_torch.core.arch import ARCH_SPARSEMAP, as_arch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPETS = {
    "R2": ("""
        import random

        import numpy as np
        import torch


        def draw(n, x):
            vals = np.random.rand(n)          # module-global numpy RNG
            gen = np.random.default_rng()     # unseeded generator
            y = random.random()               # stdlib global RNG
            z = torch.rand(n)                 # torch's global generator
            w = torch.randint(0, 5, (n,))
            x.uniform_()
            return vals, gen, y, z, w
        """, 7, """
        import numpy as np
        import torch


        def draw(n, seed, x):
            rng = np.random.default_rng(seed)
            ss = np.random.SeedSequence([seed, n])
            g = torch.Generator().manual_seed(seed)
            z = torch.rand(n, generator=g)
            x.uniform_(generator=g)
            return rng.random(n), ss, z
        """),
    "R3": ("""
        import numpy as np
        import torch


        def dispatch(models, segs, rows):
            res = run_segments(models, segs, defer=True)
            ys = np.asarray(res)
            handle = eval_stacked(models, rows, defer=True)
            v = handle.item()
            c = res[0].carry[0].cpu()
            torch.cuda.synchronize()
            return ys, float(res), v, c
        """, 5, """
        import numpy as np


        def dispatch(models, segs, _time_block):
            res = run_segments(models, segs, defer=True)

            def harvest():
                return np.asarray(res), res.cpu()

            out = _time_block(lambda: float(res))
            return harvest, out
        """),
    "R4": ("""
        _DISPATCHES = 0
        _STACK_CONSTS = {}


        def record(key, val):
            global _DISPATCHES
            _DISPATCHES += 1
            _STACK_CONSTS[key] = val
            _STACK_CONSTS.clear()
        """, 3, """
        import threading

        _LOCK = threading.Lock()
        _DISPATCHES = 0
        _STACK_CONSTS = {}


        def record(key, val):
            global _DISPATCHES
            with _LOCK:
                _DISPATCHES += 1
                _STACK_CONSTS[key] = val


        def snapshot():
            return dict(_STACK_CONSTS), _DISPATCHES
        """),
}
RULES = {"R2": RngDeterminismRule, "R3": DeferredSyncRule,
         "R4": CounterLockRule}


def _lint(src, rule):
    # force=True: snippets live outside the rules' real target paths
    return lint_source(textwrap.dedent(src), "snippet.py", [rule()],
                       force=True)


# ------------------------------------------------------------ rules R2-R4


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_rule_fires_on_bad_and_not_on_ok(rule_id):
    bad, n_bad, ok = SNIPPETS[rule_id]
    vs = _lint(bad, RULES[rule_id])
    assert len(vs) == n_bad, [str(v) for v in vs]
    assert all(v.rule == rule_id for v in vs)
    assert [v.line for v in vs] == sorted(v.line for v in vs)
    assert all(f"[{rule_id}]" in str(v) for v in vs)
    assert _lint(ok, RULES[rule_id]) == []


def test_rules_apply_to_the_ports_files_only():
    assert RngDeterminismRule().applies("src/repro_torch/core/search.py")
    assert not RngDeterminismRule().applies(
        "src/repro_torch/core/es_ops.py")
    assert not RngDeterminismRule().applies("src/repro/core/search.py")
    assert DeferredSyncRule().applies("src/repro_torch/core/torch_cost.py")
    assert CounterLockRule().applies("src/repro_torch/core/torch_cost.py")
    assert not CounterLockRule().applies("src/repro/core/jax_cost.py")


def test_noqa_contract_suppression():
    src = textwrap.dedent("""
        import torch


        def jitter(n):
            return torch.rand(n)  # repro: noqa-contract(R2)


        def still_bad(n):
            return torch.rand(n)
        """)
    sup = suppressions(src)
    assert any("R2" in rules for rules in sup.values())
    vs = lint_source(src, "snippet.py", [RngDeterminismRule()], force=True)
    assert len(vs) == 1
    assert vs[0].line > min(sup)


def test_the_port_is_lint_clean():
    roots = default_roots(ROOT)
    assert any(r.endswith("chip_smoke.py") for r in roots)
    assert any(r.endswith("run_torch.py") for r in roots)
    rep = run_report(roots=roots, include_graph=False)
    assert rep["lint"]["violations"] == [], rep["lint"]["violations"]
    assert rep["ok"] and "graph" not in rep


def test_all_rules_registered():
    assert [r.rule_id for r in ALL_RULES] == ["R2", "R3", "R4"]
    assert Violation("R9", "x.py", 3, "m").rule == "R9"


# ------------------------------------------------------------------- R5


def test_live_registries_conform():
    assert check_registries() == []


def test_r5_flags_bad_factory_and_orphan_segment_method():
    vs = check_request_methods(
        {"bad": (lambda spec: None), "notcallable": 3},
        segment_methods={"ghost", "bad"})
    msgs = "\n".join(str(v) for v in vs)
    assert "positional" in msgs
    assert "**kw" in msgs
    assert "not callable" in msgs
    assert "ghost" in msgs


def test_r5_flags_nonconforming_density_family():
    from repro_torch.core.density import DensityModel

    @dataclasses.dataclass(frozen=True)
    class Mystery(DensityModel):
        family = "other_name"

    vs = check_density_families(
        {"mystery": (7, Mystery), "notamodel": (8, int)},
        torch_occ={}, base_cls=DensityModel)
    msgs = "\n".join(str(v) for v in vs)
    assert "does not match its registry key" in msgs
    assert "not overridden" in msgs
    assert "torch occupancy function" in msgs
    assert "not a DensityModel subclass" in msgs


def test_r5_flags_param_vector_length_mismatch():
    class Truncated:
        topology = ARCH_SPARSEMAP.topology

        def param_vector(self):
            return ARCH_SPARSEMAP.param_vector()[:-1]

    vs = check_archs({"trunc": Truncated()})
    assert any("evaluator layout" in v.message for v in vs)
    assert check_archs({"sparsemap": ARCH_SPARSEMAP}) == []


# ------------------------------------------------------- graph audit


def test_graph_audit_one_family_clean_and_hashed():
    findings, hashes = graph_audit.audit_families(
        archs={"cloud": as_arch("cloud")}, include_scan=False)
    assert findings == [], [str(v) for v in findings]
    assert set(hashes) == {"cloud/u/eval", "cloud/s/eval"}
    assert all(len(h) == 16 for h in hashes.values())


def test_baked_constant_fails_family_sharing(monkeypatch):
    """An evaluator that reads an arch number as a Python float (the bug
    class the audit exists to catch) traces a different graph per
    arch; the conforming twin, the number as an input, does not."""
    x = torch.zeros(4)

    def make_baked(scale):
        const = torch.full((4,), scale)           # a closure constant

        def f(x):
            return x * const + float(scale)       # and a baked literal
        return f

    h1 = graph_audit.canonical_hash(graph_audit.trace(make_baked(1.5), (x,)))
    h2 = graph_audit.canonical_hash(graph_audit.trace(make_baked(2.5), (x,)))
    assert h1 != h2

    def traced(x, s):
        return x * s

    g1 = graph_audit.trace(traced, (x, torch.tensor(1.5)))
    g2 = graph_audit.trace(traced, (x, torch.tensor(2.5)))
    assert graph_audit.canonical_hash(g1) == graph_audit.canonical_hash(g2)

    eval_device = torch_cost.TorchCostModel.eval_device

    def baked(self, rows, consts=None):
        valid, energy, cycles = eval_device(self, rows, consts)
        return valid, energy * float(self.arch.e_mac), cycles

    monkeypatch.setattr(torch_cost.TorchCostModel, "eval_device", baked)
    findings, _ = graph_audit.audit_families(
        archs={"cloud": as_arch("cloud")}, include_scan=False)
    assert len(findings) == 2
    assert all("family sharing violated" in v.message for v in findings)


@pytest.mark.parametrize("case", ["item", "cpu", "numpy", "mask",
                                  "float64"])
def test_audit_flags_host_syncs_and_float64(case):
    def f(x):
        if case == "item":
            return x * x.sum().item()
        if case == "cpu":
            return x.cpu() + 1
        if case == "numpy":
            return torch.from_numpy(x.numpy() * 2)
        if case == "mask":
            return x[x > 0]
        return x.double() * 2

    vs = graph_audit.audit_run(f, (torch.ones(3, device="meta"),), "fx")
    assert vs and all(v.rule == "GRAPH" for v in vs)
    want = "float64" if case == "float64" else "host sync"
    assert any(want in v.message for v in vs), [str(v) for v in vs]


def test_audit_allows_float64_inside_pow_only():
    x = torch.ones(3, device="meta")
    assert graph_audit.audit_run(lambda a: torch_cost._pow(a, a), (x,),
                                 "pow") == []
    assert graph_audit.audit_run(lambda a: torch_cost._occ_uniform(
        (a, a, a), a), (x,), "occ") == []


def test_segment_program_runs_on_meta_and_traces():
    model = graph_audit._model_for(as_arch("cloud"), False)
    meta = graph_audit.segment_program(model.twin(torch.device("meta")))
    assert graph_audit.audit_run(*meta, "scan") == []
    code = "\n".join(graph_audit.trace(*graph_audit.segment_program(model)))
    # selection, then the children through the row evaluator
    assert "aten.sort" in code and "aten.frexp" in code


# ----------------------------------------------------------- module gate


def test_module_gate_exits_zero():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--skip-graph"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint 0 violation(s)" in proc.stderr
