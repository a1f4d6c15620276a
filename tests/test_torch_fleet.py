"""The fleet engine of the PyTorch port (``repro_torch.core.search``
``MultiSearch`` / ``run_sweep`` / ``run_method_sweep`` over
``torch_cost.eval_stacked``) against itself and against the JAX package,
all with ``device="cpu"``:

* ``eval_stacked`` is bit-exact against per-model calls (mixed platforms,
  a uniform + structured group) and within the reference's tolerance of
  the reference's stacked evaluator;
* the stacked-constants cache, signature checks, names, grid checks;
* a mixed-method fleet equals the sequential runs, stacked equals
  unstacked, one dispatch per round;
* ``FleetConfig`` / ``SearchTask`` JSON is byte-equal to the reference's
  and round-trips across the two packages;
* the same grid in both packages gives the same counts and best genomes.
"""
import numpy as np
import pytest
import torch

from _torch_port_util import Recorder, lg_close, within_capacity_margin
from repro.configs.paper_workloads import by_name as ref_by_name
from repro.core import jax_cost
from repro.core import search as ref_search
from repro.core.workload import spmm as ref_spmm
from repro_torch.configs.paper_workloads import by_name
from repro_torch.core import search, torch_cost
from repro_torch.core.arch import as_arch
from repro_torch.core.baselines import METHODS as PORT_METHODS
from repro_torch.core.cost_model import evaluate
from repro_torch.core.density import BlockNM
from repro_torch.core.search import FleetConfig, MultiSearch, SearchTask
from repro_torch.core.workload import spmm

CPU = "cpu"
METHODS = ["sparsemap", "pso", "random_mapper"]
WLS = ("mm1", "mm3")        # same (3, 16) natural signature
BUDGET = 600


def _ev(wl, platform, **kw):
    return search.get_evaluator(wl, platform, device=CPU, **kw)


def _same(a, b):
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ------------------------------------------------- stacked evaluator


def _mixed_group():
    """Three workloads on three same-topology platforms, one of them
    structured (N:M): all promoted onto one structured signature."""
    wls = [spmm("stk_a", 32, 64, 48, 0.2, 0.5),
           spmm("stk_b", 48, 32, 64, 0.4, 0.3),
           spmm("stk_c", 64, 48, 32, BlockNM(2, 4), 0.5)]
    plats = ["cloud", "edge", "mobile"]
    evs = [_ev(w, p, structured=True) for w, p in zip(wls, plats)]
    return wls, plats, evs


def test_eval_stacked_bitexact_vs_per_model_calls():
    _, _, evs = _mixed_group()
    assert len({ev.signature for _, ev in evs}) == 1
    rng = np.random.default_rng(0)
    for sizes in ((37, 50, 3), (1, 130, 64), (200, 2, 9)):
        batches = [s.random_genomes(rng, n) for (s, _), n in
                   zip(evs, sizes)]
        outs = torch_cost.eval_stacked([ev for _, ev in evs], batches)
        for (_, ev), g, o in zip(evs, batches, outs):
            _same(ev(g), o)
    # pad_floor (the sticky mega-batch shape) must not change results
    (o,) = torch_cost.eval_stacked([evs[0][1]], [batches[0]], pad_floor=512)
    _same(evs[0][1](batches[0]), o)
    # the uniform members on their own (natural, uniform) evaluator
    s, ev = _ev(spmm("stk_a", 32, 64, 48, 0.2, 0.5), "cloud")
    g = s.random_genomes(rng, 70)
    (o,) = torch_cost.eval_stacked([ev, ev], [g, g])[:1]
    _same(ev(g), o)


def test_eval_stacked_agrees_with_the_reference_stacked_evaluator():
    """The port's mega-batch against the JAX package's on the same
    genomes: log10 EDP within the reference's tolerance, validity equal
    except within the capacity margin."""
    wls, plats, evs = _mixed_group()
    ref_wls = [ref_spmm("stk_a", 32, 64, 48, 0.2, 0.5),
               ref_spmm("stk_b", 48, 32, 64, 0.4, 0.3)]
    from repro.core.density import BlockNM as RefBlockNM
    ref_wls.append(ref_spmm("stk_c", 64, 48, 32, RefBlockNM(2, 4), 0.5))
    refs = [ref_search.get_evaluator(w, p, structured=True)
            for w, p in zip(ref_wls, plats)]
    # random genomes are almost all invalid: take the tail of a short
    # search's request stream, mostly valid designs
    batches = []
    for (spec, ev), p, n in zip(evs, plats, (300, 250, 280)):
        rec = Recorder(ev)
        PORT_METHODS["sparsemap"](spec, rec, 400, 0, as_arch(p))
        batches.append(np.concatenate([g for g, _ in rec.batches])[-n:])
    mine = torch_cost.eval_stacked([ev for _, ev in evs], batches)
    theirs = jax_cost.eval_stacked([ev for _, ev in refs], batches)
    n_both = 0
    for (spec, _), p, g, a, b in zip(evs, plats, batches, mine, theirs):
        arch = as_arch(p)
        both = a["valid"] & np.asarray(b["valid"])
        n_both += int(both.sum())
        assert np.all(lg_close(a["log10_edp"][both],
                               np.asarray(b["log10_edp"])[both]))
        for i in np.flatnonzero(a["valid"] != np.asarray(b["valid"])):
            rep = evaluate(spec.decode(g[i]), arch)
            assert within_capacity_margin(rep, arch), i
    assert n_both > 20


def test_eval_stacked_caches_constants_per_fleet_epoch():
    """The per-row constants are rebuilt only when the (models, row
    counts, padded shape) fleet epoch changes."""
    _, _, evs = _mixed_group()
    (sa, eva), (sb, evb) = evs[:2]
    rng = np.random.default_rng(2)
    ga, gb = sa.random_genomes(rng, 37), sb.random_genomes(rng, 50)
    torch_cost.clear_stack_cache()
    first = torch_cost.eval_stacked([eva, evb], [ga, gb])
    again = torch_cost.eval_stacked([eva, evb], [ga, gb])
    assert torch_cost.stack_prep_counts() == (1, 1)
    for x, y in zip(first, again):
        _same(x, y)
    # a different fleet composition is a new epoch: rebuild, then warm
    torch_cost.eval_stacked([eva], [ga])
    torch_cost.eval_stacked([eva], [ga])
    assert torch_cost.stack_prep_counts() == (2, 2)
    # content, not identity: a content-equal workload hits
    _, eva2 = search.get_evaluator(spmm("stk_a", 32, 64, 48, 0.2, 0.5),
                                   "cloud", structured=True, device=CPU,
                                   n_pad=eva.n_pad)
    torch_cost.eval_stacked([eva2], [ga])
    assert torch_cost.stack_prep_counts() == (3, 2)


def test_eval_stacked_rejects_mixed_signatures():
    sa, eva = _ev(spmm("sig_a", 32, 64, 48, 0.2, 0.5), "cloud")
    sc, evc = _ev(spmm("sig_c", 128, 256, 512, 0.1, 0.9), "cloud")
    assert eva.signature != evc.signature
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError):
        torch_cost.eval_stacked([eva, evc], [sa.random_genomes(rng, 8),
                                             sc.random_genomes(rng, 8)])


# ------------------------------------------------- mixed-method fleet


@pytest.fixture(scope="module")
def sweep_runs():
    """Sequential ``search.run`` per (method, workload), then the same
    grid as one fleet with and without mega-batch stacking."""
    wls = [by_name(n) for n in WLS]
    torch_cost.reset_dispatch_count()
    seq = {m: {w.name: search.run(m, w, "cloud", budget=BUDGET, seed=0,
                                  device=CPU)
               for w in wls} for m in METHODS}
    seq_dispatches = torch_cost.dispatch_count()
    stacked_stats, unstacked_stats = {}, {}
    stacked = search.run_method_sweep(METHODS, wls, "cloud", budget=BUDGET,
                                      seed=0, stack_batches=True,
                                      stats_out=stacked_stats, device=CPU)
    unstacked = search.run_method_sweep(METHODS, wls, "cloud",
                                        budget=BUDGET, seed=0,
                                        stack_batches=False,
                                        stats_out=unstacked_stats,
                                        device=CPU)
    return dict(seq=seq, stacked=stacked, unstacked=unstacked,
                seq_dispatches=seq_dispatches,
                stacked_stats=stacked_stats,
                unstacked_stats=unstacked_stats)


def _results_equal(a, b, key):
    assert a.best_edp == b.best_edp, key
    assert a.evals == b.evals and a.valid_evals == b.valid_evals, key
    np.testing.assert_array_equal(a.history, b.history, err_msg=str(key))
    if a.best_genome is not None:
        np.testing.assert_array_equal(a.best_genome, b.best_genome)


def test_mixed_method_fleet_matches_sequential_exactly(sweep_runs):
    for m in METHODS:
        for w in WLS:
            assert sweep_runs["seq"][m][w].evals == BUDGET
            _results_equal(sweep_runs["seq"][m][w],
                           sweep_runs["stacked"][m][w], (m, w))


def test_stacked_matches_unstacked_bit_for_bit(sweep_runs):
    for m in METHODS:
        for w in WLS:
            _results_equal(sweep_runs["unstacked"][m][w],
                           sweep_runs["stacked"][m][w], (m, w))


def test_stacked_fleet_is_one_dispatch_per_round(sweep_runs):
    from repro_torch.core.arch import ARCH_SPARSEMAP
    stats = sweep_runs["stacked_stats"]
    assert stats["signatures"] == \
        [(3, 16, ARCH_SPARSEMAP.topology.fingerprint, "u")]
    assert stats["dispatches"] == stats["rounds"]
    assert stats["device_rounds"] == 1 and \
        stats["device_rounds_source"] == "default:cpu"
    assert stats["compile_ahead_hits"] == stats["compile_ahead_misses"] == 0
    # per-task dispatch pays one dispatch per alive task per round, the
    # sequential runs one per request
    assert stats["dispatches"] < sweep_runs["unstacked_stats"]["dispatches"]
    assert stats["dispatches"] < sweep_runs["seq_dispatches"]


def test_run_method_sweep_grid_shape(sweep_runs):
    grid = sweep_runs["stacked"]
    assert sorted(grid) == sorted(METHODS)
    for m in METHODS:
        assert sorted(grid[m]) == sorted(WLS)
        for w in WLS:
            assert grid[m][w].extras["method"] == m


def test_run_method_sweep_rejects_grid_collisions():
    a = spmm("twin", 16, 16, 16, 0.5, 0.5)
    b = spmm("twin", 32, 16, 16, 0.5, 0.5)
    with pytest.raises(ValueError):
        search.run_method_sweep(["pso"], [a, b], budget=50, device=CPU)
    with pytest.raises(ValueError):
        search.run_method_sweep(["pso", "pso"], [a], budget=50, device=CPU)


# ------------------------------------------------- names


def test_multisearch_duplicate_names_all_suffixed():
    wl = by_name("mm1")
    ms = MultiSearch([SearchTask(wl, "cloud", budget=50, name="dup"),
                      SearchTask(wl, "cloud", budget=50, name="dup"),
                      SearchTask(wl, "cloud", budget=50, name="solo"),
                      SearchTask(wl, "cloud", budget=50, name="dup")],
                     device=CPU)
    assert ms.final_names == ["dup#0", "dup#1", "solo", "dup#2"]
    assert set(ms.run()) == {"dup#0", "dup#1", "solo", "dup#2"}


def test_multisearch_suffixes_avoid_explicit_names():
    wl = by_name("mm1")
    ms = MultiSearch([SearchTask(wl, "cloud", budget=50, name="dup"),
                      SearchTask(wl, "cloud", budget=50, name="dup"),
                      SearchTask(wl, "cloud", budget=50, name="dup#0")],
                     device=CPU)
    assert ms.final_names == ["dup#1", "dup#2", "dup#0"]


def test_multisearch_default_names_include_method():
    wl = by_name("mm1")
    ms = MultiSearch([SearchTask(wl, "cloud", budget=50),
                      SearchTask(wl, "cloud", budget=50, method="pso")],
                     device=CPU)
    assert ms.final_names == ["mm1@cloud", "pso:mm1@cloud"]
    with pytest.raises(KeyError):
        SearchTask(wl, method="no_such_method")


def test_admitted_task_equals_its_solo_run():
    """The incremental API: a task admitted into a running fleet joins
    its signature group's mega-batch and still searches exactly as it
    would alone; ``pop_done`` drains every retirement once."""
    cfg = FleetConfig(stack_batches=True)
    ms = MultiSearch([SearchTask(by_name("mm1"), "cloud", budget=BUDGET)],
                     cfg, device=CPU)
    ms.start()
    ms.step()
    late = SearchTask(by_name("mm3"), "edge", budget=BUDGET, seed=4)
    name = ms.admit(late)
    done = []
    while ms.step():
        done += ms.pop_done()
    done += ms.pop_done()
    assert sorted(n for n, _ in done) == sorted(["mm1@cloud", name])
    assert ms.done and ms.stats_snapshot()["dispatches"] > 0
    res = ms.finish()
    solo = MultiSearch([late], cfg, device=CPU).run()
    _results_equal(res[name], solo[name], name)


def test_multisearch_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError):
        MultiSearch([by_name("mm1")])
    with pytest.raises(RuntimeError):
        search.run_sweep([by_name("mm1")], "cloud", budget=100)


# ------------------------------------------------- wire schema


def _ref_cfg(**kw):
    from repro.core.search import FleetConfig as RefFleetConfig
    return RefFleetConfig(**kw)


CONFIGS = [dict(),
           dict(align_signatures=False, stack_batches=True, device_rounds=4,
                pipeline=False, compile_ahead=False),
           dict(device_execute=False, pad_policies={
               "abc": dict(decay_rounds=2, decay_ratio=0.25,
                           source="measured")})]


@pytest.mark.parametrize("kw", CONFIGS)
def test_fleet_config_json_is_the_references(kw):
    mine, theirs = FleetConfig(**kw), _ref_cfg(**kw)
    assert mine.to_json() == theirs.to_json()
    assert FleetConfig.from_json(theirs.to_json()) == mine
    assert _ref_cfg().from_json(mine.to_json()) == theirs


def test_fleet_config_validation():
    with pytest.raises(ValueError, match="None or a SearchMesh"):
        FleetConfig(mesh=object())
    with pytest.raises(ValueError):
        FleetConfig(device_rounds=0)
    d = FleetConfig().to_json_dict()
    d["warp_factor"] = 9
    with pytest.raises(ValueError, match="warp_factor"):
        FleetConfig.from_json(d)
    assert FleetConfig(device_rounds=3).resolved_device_rounds(CPU) == \
        (3, "explicit")
    assert FleetConfig().resolved_device_rounds(CPU) == (1, "default:cpu")


def test_search_task_json_is_the_references():
    from repro.core.density import Banded as RefBanded
    from repro.core.search import SearchTask as RefSearchTask
    from repro_torch.core.density import Banded
    mine = SearchTask(spmm("wire", 100, 64, 48, Banded(0.2, 0.5), 0.6),
                      "edge", budget=1234, seed=9, method="pso",
                      method_kw={"n_particles": 16})
    theirs = RefSearchTask(ref_spmm("wire", 100, 64, 48,
                                    RefBanded(0.2, 0.5), 0.6),
                           "edge", budget=1234, seed=9, method="pso",
                           method_kw={"n_particles": 16})
    assert mine.to_json() == theirs.to_json()
    back = SearchTask.from_json(theirs.to_json())
    assert back.workload.cache_key() == mine.workload.cache_key()
    assert back.to_json() == mine.to_json()
    assert RefSearchTask.from_json(mine.to_json()).to_json() == \
        theirs.to_json()
    mine.runtime_kw["state_out"] = {}
    assert "runtime_kw" not in mine.to_json_dict()


@pytest.mark.parametrize("traj", [[], [64, 64], [65536, 65536, 4096, 4096],
                                  [4096, 512, 4096], [1024, 256, 128, 128]])
def test_derive_pad_policy_is_the_references(traj):
    import dataclasses
    from repro.core.search import derive_pad_policy as ref_derive
    assert dataclasses.asdict(search.derive_pad_policy(traj)) == \
        dataclasses.asdict(ref_derive(traj))


def test_pad_policy_registry_starts_empty_and_overrides_apply():
    fp = "not-a-topology"
    assert search.pad_policy_for(fp) is search.DEFAULT_PAD_POLICY
    pol = search.PadPolicy(decay_rounds=2, decay_ratio=0.25, source="seed")
    search.set_pad_policy(fp, pol)
    try:
        assert search.pad_policy_for(fp) == pol
    finally:
        search._PAD_POLICIES.pop(fp)
    ms = MultiSearch([SearchTask(by_name("mm1"), "cloud", budget=300)],
                     FleetConfig(stack_batches=True, pad_policies={
                         as_arch("cloud").topology.fingerprint: pol}),
                     device=CPU)
    ms.run()
    assert list(ms.stats["pad_policies"].values()) == \
        [dict(decay_rounds=2, decay_ratio=0.25, source="seed")]


# ------------------------------------------------- across the packages


GRID = ["sparsemap", "pso", "random_mapper", "standard_es"]


@pytest.fixture(scope="module")
def both_grids():
    ref = ref_search.run_method_sweep(
        GRID, [ref_by_name(n) for n in WLS], "cloud", budget=BUDGET,
        seed=0, stack_batches=True)
    mine = search.run_method_sweep(
        GRID, [by_name(n) for n in WLS], "cloud", budget=BUDGET, seed=0,
        stack_batches=True, device=CPU)
    return ref, mine


@pytest.mark.parametrize("method", GRID)
def test_cross_package_fleet_lands_on_the_reference(both_grids, method):
    ref, mine = both_grids
    for w in WLS:
        a, b = ref[method][w], mine[method][w]
        assert a.evals == b.evals == BUDGET
        assert a.valid_evals == b.valid_evals
        if a.best_genome is None:    # standard_es: nothing valid at 600
            assert b.best_genome is None and np.isinf(b.best_edp)
            continue
        np.testing.assert_array_equal(a.best_genome, b.best_genome)
        assert lg_close(np.log10(b.best_edp), np.log10(a.best_edp))
