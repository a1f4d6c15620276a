"""ES operator parity: the same ``GenDraws`` in give the same children
out, bit for bit, in the JAX package's numpy branch, the port's numpy
branch and the port's ``torch.Tensor`` branch."""
import numpy as np
import pytest
import torch

from _torch_port_util import Recorder
from repro.core import es_ops as ref_ops
from repro.core.encoding import GenomeSpec as RefSpec
from repro.core.workload import spmm as ref_spmm
from repro_torch.core import es_ops as port_ops
from repro_torch.core import evolution as port_evolution
from repro_torch.core.encoding import GenomeSpec as PortSpec
from repro_torch.core.torch_cost import TorchCostModel
from repro_torch.core.workload import spmm as port_spmm


def _plan(seed, spec, n_children=96, n_parents=24, genes_per=3,
          annealed=False):
    rng = np.random.default_rng(seed)
    L = spec.length
    hi = lo = None
    if annealed:
        hi, lo = np.arange(0, L, 2), np.arange(1, L, 2)
    kw = dict(n_children=n_children, n_parents=n_parents,
              cut_arr=ref_ops.crossover_cut_points(L),
              gene_ub=spec.gene_ub, genes_per=genes_per, p_mut=0.6,
              p_high=0.7, hi=hi, lo=lo)
    return kw, rng


@pytest.fixture(scope="module")
def specs():
    return (RefSpec(ref_spmm("mm", 32, 64, 48, 0.2, 0.5)),
            PortSpec(port_spmm("mm", 32, 64, 48, 0.2, 0.5)))


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plans_are_the_same_stream(specs, seed, annealed):
    rs, ps = specs
    kw, rng_a = _plan(seed, rs, annealed=annealed)
    _, rng_b = _plan(seed, ps, annealed=annealed)
    a = ref_ops.plan_generation(rng_a, **kw)
    b = port_ops.plan_generation(rng_b, **kw)
    for f in ("ab", "cuts", "active", "gene", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    sa, sb = ref_ops.stack_draws([a, a]), port_ops.stack_draws([b, b])
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
        assert sa[key].dtype == sb[key].dtype


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_draws_same_children_bit_for_bit(specs, seed, annealed):
    rs, ps = specs
    kw, rng = _plan(seed, rs, annealed=annealed)
    d = ref_ops.plan_generation(rng, **kw)
    parents = rs.random_genomes(np.random.default_rng(seed + 100),
                                kw["n_parents"])
    want = ref_ops.apply_mutation(
        ref_ops.apply_crossover(parents, d.ab, d.cuts),
        d.active, d.gene, d.vals)
    got_np = port_ops.apply_mutation(
        port_ops.apply_crossover(parents, d.ab, d.cuts),
        d.active, d.gene, d.vals)
    np.testing.assert_array_equal(got_np, want)

    t = torch.from_numpy
    for idx_dtype in (np.int64, np.int32):      # stack_draws gives int32
        kids = port_ops.apply_crossover(
            t(parents), t(d.ab.astype(idx_dtype)),
            t(d.cuts.astype(idx_dtype)))
        before = kids.clone()
        got_t = port_ops.apply_mutation(
            kids, t(d.active), t(d.gene.astype(idx_dtype)),
            t(d.vals.astype(idx_dtype)))
        assert torch.equal(kids, before)        # the input is not modified
        assert got_t.dtype == torch.int64
        np.testing.assert_array_equal(got_t.numpy(), want)


def test_duplicate_gene_draws_overwrite_in_draw_order():
    g = np.zeros((2, 5), np.int64)
    active = np.array([True, False])
    gene = np.array([[3, 3, 1], [0, 0, 0]])
    vals = np.array([[7, 8, 9], [5, 5, 5]])
    want = ref_ops.apply_mutation(g, active, gene, vals)
    assert want[0].tolist() == [0, 9, 0, 8, 0] and not want[1].any()
    np.testing.assert_array_equal(
        port_ops.apply_mutation(g, active, gene, vals), want)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        port_ops.apply_mutation(t(g), t(active), t(gene), t(vals)).numpy(),
        want)


def test_stable_order_select_and_best_so_far_on_ties():
    edp = np.array([3.0, 1.0, 2.0, 1.0, np.inf, 2.0, 1.0, np.inf],
                   np.float32)
    pop = np.arange(8 * 4).reshape(8, 4)
    want = ref_ops.stable_order(edp)
    assert want.tolist() == [1, 3, 6, 2, 5, 0, 4, 7]
    np.testing.assert_array_equal(port_ops.stable_order(edp), want)
    np.testing.assert_array_equal(
        port_ops.stable_order(torch.from_numpy(edp)).numpy(), want)
    for a, b, c in zip(ref_ops.select(pop, edp, 5, 2),
                       port_ops.select(pop, edp, 5, 2),
                       port_ops.select(torch.from_numpy(pop),
                                       torch.from_numpy(edp), 5, 2)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())
    seq = np.array([5.0, 7.0, 3.0, 3.0, 4.0, 1.0, np.inf], np.float32)
    np.testing.assert_array_equal(port_ops.best_so_far(seq),
                                  ref_ops.best_so_far(seq))
    np.testing.assert_array_equal(
        port_ops.best_so_far(torch.from_numpy(seq)).numpy(),
        ref_ops.best_so_far(seq))


def test_padded_layout_and_segment_key_equal(specs):
    rs, ps = specs
    a, b = ref_ops.PaddedLayout(rs, 32), port_ops.PaddedLayout(ps, 32)
    g = rs.random_genomes(np.random.default_rng(0), 5)
    np.testing.assert_array_equal(a.pad_rows(g), b.pad_rows(g))
    np.testing.assert_array_equal(b.unpad_rows(b.pad_rows(g)), g)
    idx = np.arange(rs.length)
    np.testing.assert_array_equal(a.pad_index(idx), b.pad_index(idx))
    np.testing.assert_array_equal(a.pad_cut(idx), b.pad_cut(idx))
    np.testing.assert_array_equal(a.pad_vector(rs.gene_ub, 1),
                                  b.pad_vector(ps.gene_ub, 1))
    kw = dict(spec=None, pop=g, edp=np.zeros(5, np.float32), rounds=4,
              gen0=0, n_parents=2, n_elite=1, genes_per=3, draws={})
    assert ref_ops.segment_shape_key(ref_ops.DeviceSegment(**kw)) == \
        port_ops.segment_shape_key(port_ops.DeviceSegment(**kw))


def test_torch_keyed_plans_are_deterministic_and_in_range(specs):
    """The keyed stream is a DIFFERENT stream from numpy's (documented),
    but a pure function of (seed, generation) with the same shapes and
    ranges."""
    _, ps = specs
    for annealed in (False, True):
        kw, rng = _plan(0, ps, annealed=annealed)
        a = port_ops.torch_plan_generation(5, 3, **kw)
        b = port_ops.torch_plan_generation(5, 3, **kw)
        c = port_ops.torch_plan_generation(5, 4, **kw)
        n = port_ops.plan_generation(rng, **kw)
        for f in ("ab", "cuts", "active", "gene", "vals"):
            x = getattr(a, f)
            np.testing.assert_array_equal(x, getattr(b, f))
            assert x.shape == getattr(n, f).shape
            assert x.dtype == getattr(n, f).dtype
        assert not np.array_equal(a.ab, c.ab)
        assert not np.array_equal(a.ab, n.ab)
        assert a.ab.min() >= 0 and a.ab.max() < kw["n_parents"]
        assert np.isin(a.cuts, kw["cut_arr"]).all()
        assert a.gene.min() >= 0 and a.gene.max() < ps.length
        assert (a.vals >= 0).all() and (a.vals < ps.gene_ub[a.gene]).all()


@pytest.mark.parametrize("rng_backend", ["numpy", "torch"])
def test_device_rounds_replay_on_the_host(specs, rng_backend):
    """Behind an evaluator without ``run_segment`` a ``device_rounds > 1``
    search sends ``None`` for every segment and the generator replays it
    on the host, spending the budget exactly and landing where
    ``TorchCostModel.run_segment`` (the device segments) lands, on either
    plan stream."""
    _, ps = specs
    ev = TorchCostModel(ps, "cloud", device="cpu")
    cfg = port_evolution.ESConfig(budget=900, pop_size=48, seed=1,
                                  device_rounds=4, rng_backend=rng_backend)
    res = port_evolution.evolve(ps, Recorder(ev), cfg)
    again = port_evolution.evolve(ps, Recorder(ev), cfg)
    dev = port_evolution.evolve(ps, ev, cfg)
    assert res.evals == 900 and len(res.history) == 900
    assert np.isfinite(res.best_edp)
    for other in (again, dev):
        assert res.best_edp == other.best_edp
        np.testing.assert_array_equal(res.history, other.history)
        np.testing.assert_array_equal(res.best_genome, other.best_genome)
