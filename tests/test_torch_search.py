"""The first slice of the PyTorch port as a whole: the SparseMap search
(``repro_torch.core.search.run``) against the JAX package's, held two
ways, plus the port's import hygiene and its device contract."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from _torch_port_util import Recorder, lg_close
from repro.configs.paper_workloads import by_name as ref_by_name
from repro.core import baselines as ref_baselines
from repro.core import search as ref_search
from repro_torch.configs.paper_workloads import by_name as port_by_name
from repro_torch.core import baselines as port_baselines
from repro_torch.core import search as port_search
from repro_torch.core import torch_cost
from repro_torch.kernels import ops as port_ops

REPO = pathlib.Path(__file__).resolve().parents[1]
BUDGET, SEED, PLATFORM = 2000, 0, "cloud"


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's ``search.run("sparsemap", wl, "cloud", 2000, 0)``
    with every request batch and its outputs recorded (the body of
    ``search.run`` with the cached evaluator wrapped in a recorder)."""
    runs = {}
    for name in ("conv4", "mm1"):
        plat = ref_search._platform(PLATFORM)
        spec, ev = ref_search.get_evaluator(ref_by_name(name), plat)
        rec = Recorder(ev)
        res = ref_baselines.METHODS["sparsemap"](spec, rec, BUDGET, SEED,
                                                 plat)
        runs[name] = (res, rec.batches)
    return runs


@pytest.mark.parametrize("name", ["conv4", "mm1"])
def test_lockstep_with_the_reference(reference_runs, name):
    """Drive the port's request generator; every request must equal the
    reference's integer for integer.  The port's evaluator is checked on
    each request at tolerance, and the REFERENCE's outputs are sent back,
    so a float32 near-tie cannot fork the trajectory."""
    ref_res, batches = reference_runs[name]
    plat = port_search._platform(PLATFORM)
    spec, ev = port_search.get_evaluator(port_by_name(name), plat,
                                         device="cpu")
    gen, tracker = port_baselines.make_requests("sparsemap", spec, plat,
                                                BUDGET, SEED)
    req = next(gen)
    n_checked = 0
    for i, (ref_req, ref_out) in enumerate(batches):
        np.testing.assert_array_equal(
            np.asarray(req), ref_req, err_msg=f"request {i} differs")
        out = ev(req)
        np.testing.assert_array_equal(out["valid"], ref_out["valid"])
        v = ref_out["valid"]
        assert np.all(lg_close(out["log10_edp"][v], ref_out["log10_edp"][v]))
        n_checked += int(v.sum())
        try:
            req = gen.send(ref_out)
        except StopIteration:
            assert i == len(batches) - 1, "the port stopped early"
            break
    else:
        pytest.fail("the port asked for more batches than the reference")
    assert n_checked > 100
    assert tracker.evals == ref_res.evals == BUDGET
    assert tracker.best == ref_res.best_edp
    np.testing.assert_array_equal(tracker.best_genome, ref_res.best_genome)
    np.testing.assert_array_equal(np.asarray(tracker.hist), ref_res.history)


@pytest.mark.parametrize("name", ["conv4", "mm1"])
def test_free_running_search_lands_on_the_reference(reference_runs, name):
    """The port alone, on its own evaluator: identical eval count and
    history length, best log10-EDP within tolerance of the reference's,
    and the numpy oracle agrees with what the search reports.  (Seed 0
    does not fork on a near-tie for either workload: the best genomes are
    identical.)"""
    ref_res, _ = reference_runs[name]
    wl = port_by_name(name)
    torch_cost.reset_dispatch_count()
    res = port_search.run("sparsemap", wl, PLATFORM, budget=BUDGET,
                          seed=SEED, device="cpu")
    assert torch_cost.dispatch_count() > 0
    assert res.evals == ref_res.evals == BUDGET
    assert len(res.history) == len(ref_res.history)
    assert res.valid_evals > 0
    lg, ref_lg = np.log10(res.best_edp), np.log10(ref_res.best_edp)
    assert lg_close(lg, ref_lg)
    np.testing.assert_array_equal(res.best_genome, ref_res.best_genome)
    rep = port_search.report_best(wl, PLATFORM, res)
    assert rep.valid and lg_close(lg, np.log10(rep.edp))
    design = port_search.decode_best(wl, res)
    ref_design = ref_search.decode_best(ref_by_name(name), ref_res)
    assert design.mapping.describe() == ref_design.mapping.describe()


@pytest.mark.parametrize("method", sorted(ref_baselines.METHODS))
def test_random_mapper_matches_the_reference(method):
    """Every registered method (the quickstart's ``random_mapper`` among
    them) runs the same request stream in both packages: the same number
    of evaluations and of valid ones, the same best genome, the same best
    log10 EDP."""
    assert sorted(port_baselines.METHODS) == sorted(ref_baselines.METHODS)
    a = ref_search.run(method, ref_by_name("mm1"), PLATFORM, budget=600,
                       seed=0)
    b = port_search.run(method, port_by_name("mm1"), PLATFORM, budget=600,
                        seed=0, device="cpu")
    assert a.evals == b.evals
    assert a.valid_evals == b.valid_evals
    if a.valid_evals == 0:     # standard_es finds no valid design at 600
        assert a.best_genome is None and b.best_genome is None
        assert np.isinf(a.best_edp) and np.isinf(b.best_edp)
        return
    np.testing.assert_array_equal(a.best_genome, b.best_genome)
    assert lg_close(np.log10(b.best_edp), np.log10(a.best_edp))


def test_evaluator_cache_is_keyed_by_content_and_device():
    port_search.clear_cache()
    wl = port_by_name("mm1")
    a = port_search.get_evaluator(wl, "cloud", device="cpu")
    b = port_search.get_evaluator(port_by_name("mm1"), "cloud", device="cpu")
    c = port_search.get_evaluator(wl, "edge", device="cpu")
    assert a[1] is b[1] and a[1] is not c[1]
    assert a[1].device == torch.device("cpu")
    with pytest.raises(KeyError):
        port_search.run("no_such_method", wl, "cloud", device="cpu")


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    """``device=None`` means the GPU: where there is none every entry
    point raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    wl = port_by_name("mm1")
    port_search.clear_cache()
    with pytest.raises(RuntimeError):
        port_search.get_evaluator(wl, "cloud")
    with pytest.raises(RuntimeError):
        port_search.run("sparsemap", wl, "cloud", budget=400)
    q = np.zeros((1, 1, 64, 64), np.float32)
    with pytest.raises(RuntimeError):
        port_ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError):
        port_ops.bsr_spmm(np.zeros((1, 8, 32), np.float32),
                          np.zeros(1, np.int32), np.zeros(2, np.int32),
                          np.zeros((32, 32), np.float32), m_blocks=1, bn=32)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_the_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py",
              REPO / "examples" / "sweep_client_torch.py"]
    assert len(files) > 25
    for sub in ("checkpoint", "runtime", "launch"):
        assert REPO / "src" / "repro_torch" / sub / "__init__.py" in files
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax",
                                       "optax"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax_module():
    """In a fresh interpreter, importing every module of the port pulls
    in neither jax nor repro."""
    import subprocess
    import sys
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted((REPO / "src" / "repro_torch").rglob("*.py"))
            if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_quickstart_runs_on_the_cpu(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", REPO / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--budget", "1200"])
    out = capsys.readouterr().out
    assert "SparseMap" in out and "oracle check" in out
