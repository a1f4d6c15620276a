"""The framework-free numpy modules of the PyTorch port are pinned
EXACTLY against the JAX package: for every registered arch x the paper
workloads, genome layout, parameter vectors, topology fingerprints, numpy
cost reports, mapping descriptions and the evaluator's constant tuple are
equal, value for value."""
import dataclasses
import zlib

import numpy as np
import pytest

from repro.configs import paper_workloads as ref_wl
from repro.core import accel as ref_accel
from repro.core import arch as ref_arch
from repro.core import cost_model as ref_cost
from repro.core import workload as ref_workload
from repro.core.encoding import GenomeSpec as RefSpec
from repro.core.jax_cost import JaxCostModel, _bucket as ref_bucket
from repro_torch.configs import paper_workloads as port_wl
from repro_torch.core import accel as port_accel
from repro_torch.core import arch as port_arch
from repro_torch.core import cost_model as port_cost
from repro_torch.core import workload as port_workload
from repro_torch.core.encoding import GenomeSpec as PortSpec
from repro_torch.core.torch_cost import _bucket as port_bucket, np_consts

ARCH_NAMES = sorted(ref_accel.PLATFORMS) + sorted(ref_arch.registered_archs())
GROUPS = {
    "mm": [w.name for w in ref_wl.mm_workloads()],
    "conv": [w.name for w in ref_wl.conv_workloads()],
    "banded": [w.name for w in ref_wl.banded_attention_workloads()],
}


def test_same_names_are_registered():
    assert sorted(port_accel.PLATFORMS) == sorted(ref_accel.PLATFORMS)
    assert sorted(port_arch.registered_archs()) == \
        sorted(ref_arch.registered_archs())
    assert [w.name for w in port_wl.all_workloads()] == \
        [w.name for w in ref_wl.all_workloads()]
    assert [w.name for w in port_wl.structured_workloads()] == \
        [w.name for w in ref_wl.structured_workloads()]
    assert not hasattr(port_accel, "TPU_V5E")


def test_platform_constants_equal():
    for name, p in ref_accel.PLATFORMS.items():
        assert dataclasses.asdict(p) == \
            dataclasses.asdict(port_accel.PLATFORMS[name])


@pytest.mark.parametrize("arch_name", ARCH_NAMES)
def test_arch_numbers_and_structure_equal(arch_name):
    ra, pa = ref_arch.as_arch(arch_name), port_arch.as_arch(arch_name)
    np.testing.assert_array_equal(ra.param_vector(), pa.param_vector())
    assert ra.param_vector().dtype == pa.param_vector().dtype
    assert ra.topology.fingerprint == pa.topology.fingerprint
    assert dataclasses.asdict(ra.topology) == dataclasses.asdict(pa.topology)
    assert ra.describe() == pa.describe()
    assert ra.level_names == pa.level_names
    assert ra.capacity_stores == pa.capacity_stores


def _report_dict(rep):
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("arch_name", ARCH_NAMES)
def test_layout_reports_and_consts_equal(arch_name, group):
    ra, pa = ref_arch.as_arch(arch_name), port_arch.as_arch(arch_name)
    for wname in GROUPS[group]:
        rw, pw = ref_wl.by_name(wname), port_wl.by_name(wname)
        assert repr(rw.cache_key()) == repr(pw.cache_key())
        assert ref_workload.workload_to_dict(rw) == \
            port_workload.workload_to_dict(pw)
        rs, ps = RefSpec(rw, arch=ra), PortSpec(pw, arch=pa)
        # genome layout and segments
        assert rs.length == ps.length and rs.primes == ps.primes
        assert list(rs.segments) == list(ps.segments)
        for name, seg in rs.segments.items():
            assert (seg.start, seg.stop) == \
                (ps.segments[name].start, ps.segments[name].stop)
        np.testing.assert_array_equal(rs.gene_ub, ps.gene_ub)
        # the same seeded genomes decode to the same designs and reports
        rng = np.random.default_rng(
            zlib.crc32(f"{arch_name}:{wname}".encode()))
        genomes = rs.random_genomes(rng, 3)
        rng2 = np.random.default_rng(
            zlib.crc32(f"{arch_name}:{wname}".encode()))
        np.testing.assert_array_equal(genomes, ps.random_genomes(rng2, 3))
        for g in genomes:
            rd, pd = rs.decode(g), ps.decode(g)
            assert rd.mapping.describe() == pd.mapping.describe()
            assert _report_dict(ref_cost.evaluate(rd, ra)) == \
                _report_dict(port_cost.evaluate(pd, pa))
        # the evaluator's constant tuple, derived independently
        n_pad = port_bucket(max(ps.n_primes, 1))
        assert n_pad == ref_bucket(max(rs.n_primes, 1))
        ref_consts = JaxCostModel(rs, ra)._np_consts
        port_consts = np_consts(ps, pa, n_pad)
        assert len(ref_consts) == len(port_consts) == 9
        for a, b in zip(ref_consts, port_consts):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_custom_workload_builders_equal():
    rw, pw = ref_workload, port_workload
    for build, args in (("spmm", ("a", 32, 64, 48, 0.2, 0.5)),
                        ("spconv", ("b", 64, 32, 32, 256, 1, 1, 0.45, 0.252)),
                        ("batched_spmm", ("c", 4, 16, 32, 16, 0.3, 0.7))):
        r, p = getattr(rw, build)(*args), getattr(pw, build)(*args)
        assert rw.workload_to_dict(r) == pw.workload_to_dict(p)
        assert r.prime_factors == p.prime_factors and r.macs == p.macs


def test_zoo_validation_report_equal():
    from repro.configs.archs import zoo_validation_report as ref_report
    from repro_torch.configs.archs import zoo_validation_report
    assert ref_report() == zoo_validation_report()
