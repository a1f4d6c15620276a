"""The paper's tables and the LLM-GEMM scenario on the PyTorch port
(``benchmarks/paper_tables_torch.py``, ``examples/
search_accelerator_torch.py``, ``repro_torch.configs.arch_gemms``)
against the JAX package's twins, on the CPU at small budgets.

Tolerances: the numpy parts (``arch_gemms``, Fig. 2) are equal exactly;
every search makes the reference's choices (the same evaluation count and
best genome), and a best ``log10 EDP`` is held to the evaluators'
tolerance ``|Δ| <= 2e-3·max(|lg|, 1)`` (``tests/_torch_port_util.py``),
as Fig. 7's random designs are, whose validity may differ only within the
capacity margin.
"""
import ast
import csv
import importlib.util
import math
import os
import re

import numpy as np
import pytest

from _torch_port_util import lg_close
from benchmarks import paper_tables as ref_tables
from benchmarks import paper_tables_torch as tables
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.paper_workloads import arch_gemms as ref_arch_gemms
from repro.core import search as ref_search
from repro_torch.configs import arch_gemms
from repro_torch.core import search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BUDGET = 600


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_example = _load(os.path.join(ROOT, "examples", "search_accelerator.py"),
                    "ref_search_accelerator")
example = _load(os.path.join(ROOT, "examples",
                             "search_accelerator_torch.py"),
                "search_accelerator_torch")


@pytest.fixture(autouse=True)
def out_dirs(tmp_path, monkeypatch):
    """Both modules write their CSVs under ``tmp_path``."""
    monkeypatch.setattr(ref_tables, "OUT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(tables, "OUT_DIR", str(tmp_path / "torch"))
    return tmp_path


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _same_edp(a, b):
    if not (np.isfinite(a) and np.isfinite(b)):
        return a == b
    return bool(lg_close(np.log10(a), np.log10(b)))


class _Record:
    """Wraps a search module's ``run`` and ``run_method_sweep`` and keeps
    every result in call order."""

    def __init__(self, module, monkeypatch):
        self.results = []
        run, sweep = module.run, module.run_method_sweep

        def rec_run(method, wl, *a, **kw):
            res = run(method, wl, *a, **kw)
            self.results.append((method, wl.name, res))
            return res

        def rec_sweep(methods, wls, *a, **kw):
            grid = sweep(methods, wls, *a, **kw)
            self.results += [(m, w.name, grid[m][w.name])
                             for m in methods for w in wls]
            return grid

        monkeypatch.setattr(module, "run", rec_run)
        monkeypatch.setattr(module, "run_method_sweep", rec_sweep)


def _same_searches(got, ref):
    assert [(m, w) for m, w, _ in got.results] == \
        [(m, w) for m, w, _ in ref.results]
    for (m, w, a), (_, _, b) in zip(got.results, ref.results):
        assert a.evals == b.evals, (m, w)
        assert (a.best_genome is None) == (b.best_genome is None), (m, w)
        if b.best_genome is not None:
            np.testing.assert_array_equal(a.best_genome, b.best_genome,
                                          err_msg=f"{m}/{w}")
        assert _same_edp(a.best_edp, b.best_edp), (m, w)


# ---------------------------------------------------------------- arch_gemms

@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_arch_gemms_are_the_references(arch):
    """Equal ``cache_key`` (by ``repr``: the density objects are each
    package's own classes)."""
    got, ref = arch_gemms(arch), ref_arch_gemms(arch)
    assert [w.name for w in got] == [w.name for w in ref]
    assert [repr(w.cache_key()) for w in got] == \
        [repr(w.cache_key()) for w in ref]
    kw = dict(weight_density=0.3, act_density=0.9, tokens=128)
    assert [repr(w.cache_key()) for w in arch_gemms(arch, **kw)] == \
        [repr(w.cache_key()) for w in ref_arch_gemms(arch, **kw)]


# ---------------------------------------------------------------- figures

@pytest.mark.parametrize("platform", ["mobile", "edge"])
def test_fig2_interaction_is_the_references(platform, out_dirs):
    got = tables.fig2_interaction(platform, device=CPU)
    ref = ref_tables.fig2_interaction(platform)
    assert got == ref
    assert _csv(out_dirs / "torch" / "fig2.csv") == \
        _csv(out_dirs / "ref" / "fig2.csv")


def test_fig7_space_agrees(out_dirs):
    got = tables.fig7_space(n_samples=200, device=CPU)
    ref = ref_tables.fig7_space(n_samples=200)
    assert got == ref
    a = _csv(out_dirs / "torch" / "fig7.csv")
    b = _csv(out_dirs / "ref" / "fig7.csv")
    assert a[0] == b[0] == ["pca_mapping", "pca_sparse", "valid", "edp"]
    for ra, rb in zip(a[1:], b[1:]):
        np.testing.assert_allclose(float(ra[0]), float(rb[0]), rtol=1e-9)
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), rtol=1e-9)
        assert ra[2] == rb[2]
        if ra[2] == "True":
            assert _same_edp(float(ra[3]), float(rb[3]))


def test_table_iv_agrees(out_dirs, monkeypatch):
    got_rec = _Record(search, monkeypatch)
    ref_rec = _Record(ref_search, monkeypatch)
    kw = dict(budget=BUDGET, platforms=("cloud",),
              workload_names=["mm1", "mm3"])
    got = tables.table_iv(device=CPU, **kw)
    ref = ref_tables.table_iv(**kw)
    _same_searches(got_rec, ref_rec)
    assert len(got_rec.results) == 6
    assert [(r["workload"], r["platform"]) for r in got] == \
        [(r["workload"], r["platform"]) for r in ref]
    for a, b in zip(got, ref):
        assert list(a) == list(b)
        for m in tables.TABLE_IV_METHODS:
            assert _same_edp(a[m], b[m])
    assert _csv(out_dirs / "torch" / "table_iv.csv")[0] == \
        _csv(out_dirs / "ref" / "table_iv.csv")[0]


@pytest.mark.parametrize("concurrent", [True, False])
def test_fig17_baselines_agree(concurrent, out_dirs, monkeypatch):
    got_rec = _Record(search, monkeypatch)
    ref_rec = _Record(ref_search, monkeypatch)
    kw = dict(budget=BUDGET, workload_names=("mm1",), concurrent=concurrent)
    got = tables.fig17_baselines(device=CPU, **kw)
    ref = ref_tables.fig17_baselines(**kw)
    _same_searches(got_rec, ref_rec)
    assert len(got_rec.results) == 6
    for a, b in zip(got, ref):
        assert (a["workload"], a["method"]) == (b["workload"], b["method"])
        assert _same_edp(a["edp"], b["edp"])
        assert a["valid_frac"] == b["valid_frac"]
    assert _csv(out_dirs / "torch" / "fig17.csv")[0] == \
        _csv(out_dirs / "ref" / "fig17.csv")[0]


def test_fig18_ablation_agrees(out_dirs, monkeypatch):
    got_rec = _Record(search, monkeypatch)
    ref_rec = _Record(ref_search, monkeypatch)
    kw = dict(budget=BUDGET, workload_names=("mm3", "mm1"))
    got = tables.fig18_ablation(device=CPU, **kw)
    ref = ref_tables.fig18_ablation(**kw)
    _same_searches(got_rec, ref_rec)
    for a, b in zip(got, ref):
        assert (a["workload"], a["method"]) == (b["workload"], b["method"])
        assert _same_edp(a["best_edp"], b["best_edp"])
    a = _csv(out_dirs / "torch" / "fig18.csv")
    b = _csv(out_dirs / "ref" / "fig18.csv")
    assert a[0] == b[0] and len(a) == len(b) == 1 + 2 * 3 * 100


def test_table_iv_fleet_rows_equal_one_search_at_a_time():
    """The Table IV grid as one ``run_method_sweep`` fleet a platform, one
    generation a round (what ``chip_smoke.py`` runs at the paper's
    budget), gives ``table_iv``'s rows bit for bit."""
    from repro_torch.configs.paper_workloads import by_name
    names = ["mm1", "mm3"]
    wls = [by_name(n) for n in names]
    methods = list(tables.TABLE_IV_METHODS)
    for plat in ("edge", "cloud"):
        grid = search.run_method_sweep(methods, wls, plat, budget=BUDGET,
                                       seed=0, device=CPU, device_rounds=1)
        rows = [tables.table_iv_row(w.name, plat, {
            m: grid[m][w.name].best_edp for m in methods}) for w in wls]
        seq = tables.table_iv(budget=BUDGET, platforms=(plat,),
                              workload_names=names, device=CPU)
        for a, b in zip(rows, seq):
            assert list(a) == list(b)
            for k in a:
                assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


def test_device_segments_take_another_trajectory_in_both_packages():
    """``device_rounds=4`` (the GPU's fleet default) is not the
    one-generation-a-round search: the reference's own SparseMap history
    leaves k = 1's at the same evaluation as the port's, and both land on
    the same best EDP at each k."""
    from repro.configs.paper_workloads import by_name as ref_by_name
    from repro_torch.configs.paper_workloads import by_name
    first = {}
    for pkg, mod, bn, kw in (("torch", search, by_name, dict(device=CPU)),
                             ("ref", ref_search, ref_by_name, {})):
        k1 = mod.run("sparsemap", bn("mm1"), "edge", budget=BUDGET, seed=0,
                     **kw)
        k4 = mod.run("sparsemap", bn("mm1"), "edge", budget=BUDGET, seed=0,
                     device_rounds=4, **kw)
        diff = np.nonzero(k1.history != k4.history)[0]
        assert len(diff) > 0
        first[pkg] = (int(diff[0]), k1.best_edp, k4.best_edp)
    assert first["torch"][0] == first["ref"][0]
    assert _same_edp(first["torch"][1], first["ref"][1])
    assert _same_edp(first["torch"][2], first["ref"][2])


def test_table_iv_row_is_what_table_iv_builds():
    row = tables.table_iv_row("mm1", "edge", dict(
        random_mapper=8.0, sage_like=4.0, sparsemap=2.0))
    assert row == dict(workload="mm1", platform="edge", random_mapper=8.0,
                       sage_like=4.0, sparsemap=2.0,
                       speedup_vs_sparseloop=4.0, speedup_vs_sage=2.0)
    inf = tables.table_iv_row("mm1", "edge", dict(
        random_mapper=8.0, sage_like=4.0, sparsemap=math.inf))
    assert math.isnan(inf["speedup_vs_sage"])


def test_tables_need_a_device_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tables.table_iv, tables.fig17_baselines,
               tables.fig18_ablation, tables.fig2_interaction,
               tables.fig7_space):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_out_dir_is_a_torch_subdirectory_of_the_references():
    assert tables.OUT_DIR != ref_tables.OUT_DIR
    assert os.path.basename(tables.OUT_DIR) == "torch"


# ---------------------------------------------------------------- scenario

_ROW = re.compile(r"^\s*(\S+): ours\s+(\S+)\s+SAGE-like\s+(\S+)x\s+"
                  r"Sparseloop-like\s+(\S+)x$")


def test_search_accelerator_runs_on_the_cpu(capsys):
    args = ["--model", "mistral-nemo-12b", "--budget", str(BUDGET),
            "--platforms", "cloud"]
    grids = example.main(args + ["--device", CPU])
    ours = capsys.readouterr().out.splitlines()
    ref_example.main(args)
    ref = capsys.readouterr().out.splitlines()
    assert ours[0] == ref[0] == ("extracted 4 GEMMs from mistral-nemo-12b "
                                 "(50% pruned weights, 60% dense "
                                 "activations)")
    rows = [_ROW.match(x) for x in ours]
    ref_rows = [_ROW.match(x) for x in ref]
    rows = [m.groups() for m in rows if m]
    ref_rows = [m.groups() for m in ref_rows if m]
    assert len(rows) == len(ref_rows) == 4
    for a, b in zip(rows, ref_rows):
        assert a[0] == b[0]
        assert _same_edp(float(a[1]), float(b[1]))
    stats = [x for x in ours if x.strip().startswith("[")]
    assert len(stats) == 1 and "compile-ahead" not in stats[0]
    assert re.match(r"\s*\[12 searches, \d+ rounds, \d+ device dispatches, "
                    r"host-blocked \d+\.\d{3}s, \d+\.\ds\]$", stats[0])
    assert ours[-1] == ref[-1]
    assert set(grids) == {"cloud"}
    assert all(r.evals == BUDGET for g in grids["cloud"].values()
               for r in g.values())


def test_search_accelerator_lists_the_references_archs(capsys):
    assert example.main(["--list-archs"]) is None
    ours = capsys.readouterr().out.splitlines()
    ref_example.main(["--list-archs"])
    ref = capsys.readouterr().out.splitlines()
    assert [x.replace("repro_torch.", "repro.") for x in ours] == ref


def test_search_accelerator_writes_a_chrome_trace(tmp_path, capsys):
    example.main(["--model", "starcoder2-7b", "--budget", "400",
                  "--platforms", "edge", "--device", CPU,
                  "--profile", str(tmp_path / "prof")])
    assert "profiler trace written to" in capsys.readouterr().out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------- imports

@pytest.mark.parametrize("rel", ["benchmarks/paper_tables_torch.py",
                                 "examples/search_accelerator_torch.py",
                                 "chip_smoke.py"])
def test_twins_import_neither_jax_nor_the_reference(rel):
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "repro")]
    assert not bad, f"{rel} imports {bad}"
