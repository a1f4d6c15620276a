"""The PyTorch row cost evaluator (``TorchCostModel``, on the CPU here)
against the JAX evaluator and the float64 numpy oracle, on the same
seeded genome batches, at the reference's own tolerance:
``|dlog10_edp| <= 2e-3 * max(|log10_edp|, 1)``, validity equal except
within a 5e-3 relative capacity margin — over all eight registered
topologies and both density modes."""
import zlib

import numpy as np
import pytest
import torch

from _torch_port_util import Recorder, lg_close, within_capacity_margin
from repro.configs import paper_workloads as ref_wl
from repro.core import arch as ref_arch
from repro.core import workload as ref_workload
from repro.core.encoding import GenomeSpec as RefSpec
from repro.core.jax_cost import JaxCostModel
from repro_torch.configs import paper_workloads as port_wl
from repro_torch.core import arch as port_arch
from repro_torch.core import baselines as port_baselines
from repro_torch.core import torch_cost
from repro_torch.core import workload as port_workload
from repro_torch.core.cost_model import evaluate
from repro_torch.core.encoding import GenomeSpec as PortSpec
from repro_torch.core.torch_cost import TorchCostModel

ARCHS = ["cloud", "maple_edge", "cluster_cloud", "systolic_mesh",
         "quant_edge", "eyeriss_like", "sigma_like", "dstc_like"]
SMALL = ("spmm", ("mm_small", 32, 64, 48, 0.2, 0.5))
CONV = ("spconv", ("conv", 64, 32, 32, 256, 1, 1, 0.45, 0.252))
BMM = ("batched_spmm", ("bmm", 4, 16, 32, 16, 0.3, 0.7))

CASES = [(a, SMALL) for a in ARCHS] + [
    ("cloud", CONV), ("cloud", BMM), ("edge", SMALL), ("mobile", CONV),
    ("cloud", "mm9"), ("cloud", "battn1"), ("cloud", "mm13"),
    ("maple_edge", "battn1"), ("dstc_like", "battn1"),
    ("quant_edge", "mm9"), ("eyeriss_like", CONV),
]


def _case_id(case):
    arch, wl = case
    return f"{arch}-{wl if isinstance(wl, str) else wl[1][0]}"


def _workloads(wl):
    if isinstance(wl, str):
        return ref_wl.by_name(wl), port_wl.by_name(wl)
    build, args = wl
    return (getattr(ref_workload, build)(*args),
            getattr(port_workload, build)(*args))


def _genomes(spec, arch, seed, n_random=192, budget=1500):
    """Seeded random genomes (mostly invalid: they exercise the validity
    logic) plus the request batches of a short SparseMap search on the
    port (mostly valid: they exercise the numbers)."""
    rng = np.random.default_rng(seed)
    rec = Recorder(TorchCostModel(spec, arch, device="cpu"))
    port_baselines.METHODS["sparsemap"](spec, rec, budget, seed % 1000, arch)
    return np.concatenate([spec.random_genomes(rng, n_random)]
                          + [g for g, _ in rec.batches]).astype(np.int64)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_torch_vs_jax_vs_oracle(case):
    arch_name, wl = case
    rw, pw = _workloads(wl)
    ra, pa = ref_arch.as_arch(arch_name), port_arch.as_arch(arch_name)
    rs, ps = RefSpec(rw, arch=ra), PortSpec(pw, arch=pa)
    jm = JaxCostModel(rs, ra)
    tm = TorchCostModel(ps, pa, device="cpu")
    assert tm.signature == jm.signature
    G = _genomes(ps, pa, zlib.crc32(_case_id(case).encode()))
    jo, to = jm(G), tm(G)
    assert set(to) == {"valid", "energy_pj", "cycles", "edp", "log10_edp"}
    for key in to:
        assert to[key].shape == (len(G),)
        assert to[key].dtype == (bool if key == "valid" else np.float32)

    # torch vs JAX, every row
    both = jo["valid"] & to["valid"]
    assert np.all(lg_close(to["log10_edp"][both], jo["log10_edp"][both]))
    for i in np.flatnonzero(jo["valid"] != to["valid"]):
        assert within_capacity_margin(evaluate(ps.decode(G[i]), pa), pa), \
            f"row {i}: jax valid={jo['valid'][i]} torch valid={to['valid'][i]}"
    assert np.all(np.isinf(to["edp"][~to["valid"]]))

    # torch vs the float64 oracle, a seeded subset of the rows: up to 100
    # that the evaluator calls valid, and 60 of any kind
    rng = np.random.default_rng(1)
    n_valid = 0
    rows = np.concatenate([rng.permutation(np.flatnonzero(to["valid"]))[:100],
                           rng.permutation(len(G))[:60]])
    for i in rows:
        rep = evaluate(ps.decode(G[i]), pa)
        if rep.valid != bool(to["valid"][i]):
            assert within_capacity_margin(rep, pa), \
                f"row {i}: oracle valid={rep.valid} ({rep.reason})"
            continue
        if rep.valid:
            n_valid += 1
            assert lg_close(to["log10_edp"][i], np.log10(rep.edp)), \
                f"row {i}: oracle {rep.edp:.5e} torch {to['edp'][i]:.5e}"
    if arch_name == "cloud":
        assert n_valid > 0      # the comparison is not vacuous
    print(f"{_case_id(case)}: {len(G)} rows, {int(to['valid'].sum())} valid, "
          f"{n_valid} held against the oracle")


@pytest.mark.parametrize("case", [("cloud", SMALL), ("cloud", "mm9"),
                                  ("dstc_like", "battn1")], ids=_case_id)
def test_from_numpy_consts_carries_the_reference_state(case):
    """An evaluator loaded from the reference's constant tuple computes
    what the reference computes, and bit for bit what the port's own
    derivation computes (the tuples are equal)."""
    arch_name, wl = case
    rw, pw = _workloads(wl)
    ra, pa = ref_arch.as_arch(arch_name), port_arch.as_arch(arch_name)
    rs, ps = RefSpec(rw, arch=ra), PortSpec(pw, arch=pa)
    jm = JaxCostModel(rs, ra)
    own = TorchCostModel(ps, pa, device="cpu")
    loaded = TorchCostModel.from_numpy_consts(ps, pa, jm._np_consts,
                                              device="cpu")
    assert loaded.signature == own.signature == jm.signature
    G = _genomes(ps, pa, 7)
    a, b, j = own(G), loaded(G), jm(G)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    both = j["valid"] & b["valid"]
    assert both.any()
    assert np.all(lg_close(b["log10_edp"][both], j["log10_edp"][both]))
    with pytest.raises(ValueError):
        TorchCostModel.from_numpy_consts(ps, pa, jm._np_consts[:8],
                                         device="cpu")


def test_n_pad_and_structured_promotion_are_inert():
    """Padding primes are 1.0 and a promoted Uniform row computes the
    uniform occupancy: same numbers under a wider signature."""
    wl = port_workload.spmm("mm_small", 32, 64, 48, 0.2, 0.5)
    spec = PortSpec(wl)
    G = _genomes(spec, port_arch.as_arch("cloud"), 3)
    base = TorchCostModel(spec, "cloud", device="cpu")
    wide = TorchCostModel(spec, "cloud", n_pad=48, device="cpu")
    promo = TorchCostModel(spec, "cloud", structured=True, device="cpu")
    assert wide.signature[1] == 48 and base.signature[1] == 16
    assert base.dens_key == "u" and promo.dens_key.startswith("s:")
    a, b, c = base(G), wide(G), promo(G)
    np.testing.assert_array_equal(a["valid"], b["valid"])
    np.testing.assert_array_equal(a["valid"], c["valid"])
    v = a["valid"]
    assert v.any()
    assert np.all(lg_close(b["log10_edp"][v], a["log10_edp"][v]))
    assert np.all(lg_close(c["log10_edp"][v], a["log10_edp"][v]))
    with pytest.raises(ValueError):
        TorchCostModel(PortSpec(port_wl.by_name("mm9")), "cloud",
                       structured=False, device="cpu")


def test_clog2_is_exact_at_powers_of_two():
    """ceil(log2 x) must not gain a bit at an exact power of two."""
    ks = np.arange(1, 100)
    x = np.concatenate([2.0 ** ks, np.nextafter(np.float32(2.0) ** ks,
                                                np.float32(np.inf)),
                        [0.0, 1.0, 1.5, 2.0, 3.0, 5.0, 1000.0, 12300.0]]
                       ).astype(np.float32)
    want = np.maximum(1.0, np.ceil(np.log2(np.maximum(
        x.astype(np.float64), 2.0))))
    got = torch_cost.clog2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_dense_operand_occupancy_is_one_not_nan():
    """mm8-mm10 have a dense P operand: pow(1 - 1, e) must give 0."""
    spec = PortSpec(port_wl.by_name("mm8"))
    out = TorchCostModel(spec, "cloud", device="cpu")(
        _genomes(spec, port_arch.as_arch("cloud"), 5))
    assert out["valid"].any()
    assert not np.any(np.isnan(out["energy_pj"]))
    assert not np.any(np.isnan(out["cycles"]))


def test_dispatch_counter_counts_evaluator_calls():
    spec = PortSpec(port_workload.spmm("mm_small", 32, 64, 48, 0.2, 0.5))
    tm = TorchCostModel(spec, "cloud", device="cpu")
    g = spec.random_genomes(np.random.default_rng(0), 7)
    torch_cost.reset_dispatch_count()
    tm(g)
    tm(g[:1])
    assert torch_cost.dispatch_count() == 2
    torch_cost.reset_dispatch_count()
    assert torch_cost.dispatch_count() == 0


def test_topology_mismatch_and_missing_device_raise():
    wl = port_workload.spmm("mm_small", 32, 64, 48, 0.2, 0.5)
    with pytest.raises(ValueError):
        TorchCostModel(PortSpec(wl), "maple_edge", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError):
        TorchCostModel(PortSpec(wl), "cloud")
    with pytest.raises(RuntimeError):
        TorchCostModel(PortSpec(wl), "cloud", device="cuda")
    # device segments run on the evaluator itself (``_drive`` finds it)
    assert callable(getattr(TorchCostModel, "run_segment", None))
