"""Device-resident ES rounds in the PyTorch port
(``repro_torch.core.torch_cost.run_segments``), all with ``device="cpu"``:

* **device**: k generations of every same-shape task advanced in one
  dispatch, the population kept on the device between segments;
* **host replay**: the same generator answered with ``None``, replaying
  the identical pre-drawn plan one generation at a time on the host.

Both consume the same ``DeviceSegment.draws``, so they must agree bit for
bit (best EDP, history, counts) for the plain ES, the stagnation-restart
variant, ``standard_es``'s direct segments and a mixed-density fleet, with
and without pipelining.  The port's host replay is also held against the
JAX package's host replay of the same fleet (no XLA scan is compiled for
it), on the shared numpy plan stream.
"""
import threading

import numpy as np
import pytest
import torch

from _torch_port_util import Recorder, lg_close
from repro.configs.paper_workloads import by_name as ref_by_name
from repro.core import search as ref_search
from repro_torch.configs.paper_workloads import by_name, structured_workloads
from repro_torch.core import es_ops, search, torch_cost
from repro_torch.core.arch import as_arch
from repro_torch.core.baselines import METHODS
from repro_torch.core.direct_encoding import DirectValueSpec
from repro_torch.core.es_ops import DeviceSegment
from repro_torch.core.workload import spmm

CPU = "cpu"
BUDGET = 700
SEED = 3
K = 4


def _grid_equal(a, b):
    """Bit-exact best EDP, history and counts over two result grids."""
    assert set(a) == set(b)
    for m in a:
        assert set(a[m]) == set(b[m])
        for w in a[m]:
            ra, rb = a[m][w], b[m][w]
            assert ra.best_edp == rb.best_edp, (m, w)
            assert np.array_equal(ra.history, rb.history), (m, w)
            assert ra.evals == rb.evals and \
                ra.valid_evals == rb.valid_evals, (m, w)
            if ra.best_genome is not None:
                assert np.array_equal(ra.best_genome, rb.best_genome), (m, w)


def _sweep(methods, wls, arch="cloud", device_execute=True, stats=None,
           **kw):
    return search.run_method_sweep(
        methods, [by_name(w) if isinstance(w, str) else w for w in wls],
        arch, budget=BUDGET, seed=SEED, stack_batches=True,
        device_rounds=kw.pop("device_rounds", K),
        device_execute=device_execute,
        stats_out=stats if stats is not None else {}, device=CPU, **kw)


# ------------------------------------------------ device == host replay


@pytest.mark.parametrize("arch", ["cloud", "maple_edge"])
def test_device_segments_match_host_replay_bitwise(arch):
    stats_dev, stats_host = {}, {}
    dev = _sweep(["sparsemap"], ["mm1", "mm3"], arch, True, stats_dev)
    host = _sweep(["sparsemap"], ["mm1", "mm3"], arch, False, stats_host)
    _grid_equal(dev, host)
    # the device fleet folded k generations per host sync; host replay
    # paid one per generation
    assert stats_dev["host_syncs_per_round"] <= 1 / K
    assert stats_host["host_syncs_per_round"] >= 1.0
    assert stats_dev["host_syncs"] < stats_host["host_syncs"]


def test_restart_segments_match_host_replay():
    kw = {"sparsemap": dict(stagnation_restart=2)}
    sa, sb = {}, {}
    dev = _sweep(["sparsemap"], ["mm1"], "cloud", True, sa, method_kw=kw)
    host = _sweep(["sparsemap"], ["mm1"], "cloud", False, sb, method_kw=kw)
    _grid_equal(dev, host)
    # the restart does not force the per-round path: one sync a segment
    assert sa["host_syncs_per_round"] == pytest.approx(1.0 / K)


def test_standard_es_direct_segments_match_host_replay():
    _grid_equal(_sweep(["standard_es"], ["mm1"], "cloud", True),
                _sweep(["standard_es"], ["mm1"], "cloud", False))


def _tiny_spmms():
    """SpMMs small enough that random direct genomes often translate on
    ``maple_edge`` (three levels): there ``standard_es`` finds valid
    designs within a few hundred evaluations.  Their prime counts differ
    (3 and 4), so one segment carries two genome layouts."""
    return [spmm("tiny222", 2, 2, 2, 0.5, 0.5),
            spmm("tiny422", 4, 2, 2, 0.5, 0.25)]


def test_standard_es_direct_segments_with_valid_designs():
    """Direct segments that translate and evaluate rows: selection then
    runs on finite fitness, and the result still equals host replay bit
    for bit."""
    wls = _tiny_spmms()
    stats = {}
    dev = _sweep(["standard_es"], wls, "maple_edge", True, stats)
    host = _sweep(["standard_es"], wls, "maple_edge", False)
    _grid_equal(dev, host)
    assert stats["host_syncs_per_round"] <= 1 / K
    for wl in wls:
        r = dev["standard_es"][wl.name]
        assert r.evals == BUDGET
        assert r.valid_evals > 0, wl.name       # the case is not vacuous
        assert r.best_genome is not None and np.isfinite(r.best_edp)


def test_mixed_density_fleet_matches_host_replay():
    """Uniform mm1 + 2:4 N:M mm8 promote the fleet onto the structured
    evaluator; both ES flavours run device segments beside each other."""
    stats = {}
    dev = _sweep(["sparsemap", "standard_es"], ["mm1", "mm8"], "cloud",
                 True, stats)
    host = _sweep(["sparsemap", "standard_es"], ["mm1", "mm8"], "cloud",
                  False)
    _grid_equal(dev, host)
    assert len(stats["signatures"]) == 1
    assert stats["signatures"][0][3].startswith("s:")


def test_pipelined_equals_unpipelined_bitforbit():
    """A segmented ES, segmented direct ES and a per-round baseline over a
    uniform and a structured workload: deferring harvests one round
    changes no value and no dispatch."""
    wls = [by_name("mm1"), structured_workloads()[0]]
    on, off = {}, {}
    a = _sweep(["sparsemap", "standard_es", "pso"], wls, stats=on,
               pipeline=True)
    b = _sweep(["sparsemap", "standard_es", "pso"], wls, stats=off,
               pipeline=False)
    _grid_equal(a, b)
    assert on["pipeline"] and not off["pipeline"]
    assert on["dispatches"] == off["dispatches"]
    assert on["host_blocked_s"] >= 0.0 and off["host_blocked_s"] >= 0.0


# ------------------------------------------------ single-search drivers


@pytest.mark.parametrize("method", ["sparsemap", "standard_es"])
def test_run_segment_through_search_run_equals_host_replay(method):
    """``search.run(..., device_rounds=k)`` hands each segment to
    ``TorchCostModel.run_segment``; the same search behind a wrapper
    without that method replays every segment on the host."""
    wl = by_name("mm1")
    spec, ev = search.get_evaluator(wl, "cloud", device=CPU)
    torch_cost.reset_dispatch_count()
    dev = search.run(method, wl, "cloud", budget=BUDGET, seed=SEED,
                     device_rounds=K, device=CPU)
    dev_dispatches = torch_cost.dispatch_count()
    rec = Recorder(ev)
    host = METHODS[method](spec, rec, BUDGET, SEED, as_arch("cloud"),
                           device_rounds=K)
    _grid_equal({method: {"mm1": dev}}, {method: {"mm1": host}})
    assert dev.evals == BUDGET
    assert dev_dispatches > 0
    if method == "sparsemap":
        # a segment is one dispatch for k generations (standard_es on mm1
        # translates no row at this budget: its replay evaluates nothing)
        assert dev_dispatches < len(rec.batches)


def _identity_segment(spec, dspec, pop, edp):
    """A 1-generation direct segment whose children are exactly
    ``pop[:B-1]``: fitness is pre-sorted (stable order = identity), every
    child crosses parent i with itself, mutation inactive."""
    C = len(pop) - 1
    d = es_ops.GenDraws(
        ab=np.stack([np.arange(C)] * 2, axis=1),
        cuts=np.ones(C, dtype=np.int64),
        active=np.zeros(C, dtype=bool),
        gene=np.zeros((C, 2), dtype=np.int64),
        vals=np.zeros((C, 2), dtype=np.int64))
    aux = dict(
        scramble=np.asarray(dspec.scramble, dtype=np.int32),
        dim_sizes=np.asarray(
            [dspec.workload.dim_sizes[k] for k in dspec.workload.dim_order],
            dtype=np.float32))
    return DeviceSegment(spec=spec, pop=pop, edp=edp, rounds=1, gen0=0,
                         n_parents=C, n_elite=1, genes_per=2,
                         draws=es_ops.stack_draws([d]), kind="direct",
                         aux=aux)


@pytest.mark.parametrize("name", ["mm1", "mm8"])
def test_direct_translation_matches_numpy_oracle(name):
    """The in-segment translation of direct-value rows to canonical ones
    equals ``DirectValueSpec.to_canonical`` row for row; untranslatable
    rows come back as row 0 with fitness inf."""
    spec, ev = search.get_evaluator(by_name(name), "cloud", device=CPU)
    dspec = DirectValueSpec(spec)
    pop = dspec.random_genomes(np.random.default_rng(7), 33)
    # guarantee translatable rows: trivial and two-way factor splits
    nl = dspec.n_levels
    for i, split in enumerate([(0,), (1,), (0, 1)]):
        col = dspec.fact_sl.start
        for dim in dspec.workload.dim_order:
            size = dspec.workload.dim_sizes[dim]
            facs = [1] * nl
            if len(split) == 1 or len(dspec.div[dim]) < 3:
                facs[split[0] % nl] = size
            else:
                a = dspec.div[dim][1]       # smallest divisor > 1
                facs[0], facs[1] = a, size // a
            pop[i, col:col + nl] = facs
            col += nl
    edp = np.arange(len(pop), dtype=np.float32)    # pre-sorted fitness
    res = ev.run_segment(_identity_segment(spec, dspec, pop, edp))
    kids_canon, out = res.gens[0]
    n_ok = 0
    for i in range(len(pop) - 1):
        oracle = dspec.to_canonical(pop[i])
        if oracle is None:
            assert not out["valid"][i], i
            assert np.array_equal(kids_canon[i],
                                  np.zeros(spec.length, np.int64)), i
            assert not np.isfinite(out["edp"][i]), i
        else:
            n_ok += 1
            assert np.array_equal(kids_canon[i], oracle), i
            # the translated row was evaluated with its task's constants:
            # the same fitness as the broadcast call on the oracle's row
            want = ev(oracle[None])
            assert out["edp"][i] == want["edp"][0], i
            assert out["valid"][i] == want["valid"][0], i
    assert n_ok >= 3        # the crafted rows did translate


# ------------------------------------------------ ops with a task axis


def test_task_axis_operators_equal_per_task_numpy():
    """The segment's torch operators on ``(T, ...)`` tensors equal the
    numpy operators task by task, ties and ``inf`` included."""
    rng = np.random.default_rng(0)
    T, B, L, C, genes_per = 3, 20, 11, 17, 2
    pop = rng.integers(0, 5, (T, B, L)).astype(np.int64)
    edp = rng.choice(np.array([1.0, 2.0, 3.0, np.inf], np.float32), (T, B))
    ab = rng.integers(0, 8, (T, C, 2))
    cuts = rng.integers(1, L, (T, C))
    active = rng.random((T, C)) < 0.7
    gene = rng.integers(0, 3, (T, C, genes_per))   # forced collisions
    vals = rng.integers(0, 9, (T, C, genes_per))
    t = torch.from_numpy
    tp, te, tt = es_ops.select(t(pop), t(edp), 8, 2)
    kids = es_ops.apply_mutation(
        es_ops.apply_crossover(tp, t(ab), t(cuts)), t(active), t(gene),
        t(vals))
    for i in range(T):
        p, e, ee = es_ops.select(pop[i], edp[i], 8, 2)
        np.testing.assert_array_equal(tp[i].numpy(), p)
        np.testing.assert_array_equal(te[i].numpy(), e)
        np.testing.assert_array_equal(tt[i].numpy(), ee)
        want = es_ops.apply_mutation(es_ops.apply_crossover(
            p, ab[i], cuts[i]), active[i], gene[i], vals[i])
        np.testing.assert_array_equal(kids[i].numpy(), want)


# ------------------------------------------------ device_rounds default


def test_default_device_rounds_and_provenance():
    assert search.default_device_rounds("cpu") == 1
    assert search.default_device_rounds("gpu") == 4
    assert search.default_device_rounds("tpu") == 8
    assert search.default_device_rounds("metal") == 1   # unknown -> 1
    assert search._backend(torch.device("cuda", 0)) == "gpu"
    assert search._backend(torch.device("cpu")) == "cpu"
    ms = search.MultiSearch([by_name("mm1")], device=CPU)
    assert (ms.device_rounds, ms.device_rounds_source) == (1, "default:cpu")
    ms2 = search.MultiSearch([by_name("mm1")],
                             search.FleetConfig(device_rounds=2), device=CPU)
    assert (ms2.device_rounds, ms2.device_rounds_source) == (2, "explicit")
    with pytest.raises(ValueError):
        search.FleetConfig(device_rounds=0)


def test_counters_thread_safe_under_hammer():
    torch_cost.reset_dispatch_count()
    n, readers_ok = 20_000, []

    def hammer():
        for _ in range(n):
            torch_cost._count_dispatch()

    def read():
        for _ in range(2_000):
            readers_ok.append(torch_cost.dispatch_count() >= 0)
            torch_cost.stack_prep_counts()
            torch_cost.host_blocked_s()

    threads = [threading.Thread(target=fn) for fn in (hammer, hammer, read)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert torch_cost.dispatch_count() == 2 * n
    assert all(readers_ok)


# ------------------------------------------------ across the packages


@pytest.mark.parametrize("method", ["sparsemap", "standard_es"])
def test_host_replay_lands_on_the_reference_host_replay(method):
    """The port's k = 4 host replay against the JAX package's k = 4 host
    replay (``device_execute=False``: the reference compiles no scan),
    both on the numpy plan stream: same counts, same best genome, best
    log10 EDP within the reference's tolerance."""
    wls = ["mm1", "mm3"]
    kw = {"sparsemap": dict(rng_backend="numpy")}
    ref = ref_search.run_method_sweep(
        [method], [ref_by_name(w) for w in wls], "cloud", budget=BUDGET,
        seed=SEED, stack_batches=True, device_rounds=K,
        device_execute=False, method_kw=kw)
    mine = _sweep([method], wls, "cloud", False, method_kw=kw)
    for w in wls:
        a, b = ref[method][w], mine[method][w]
        assert a.evals == b.evals == BUDGET
        assert a.valid_evals == b.valid_evals
        assert len(a.history) == len(b.history)
        if a.best_genome is None:       # nothing valid at this budget
            assert b.best_genome is None and np.isinf(b.best_edp)
            continue
        np.testing.assert_array_equal(a.best_genome, b.best_genome)
        assert lg_close(np.log10(b.best_edp), np.log10(a.best_edp))
