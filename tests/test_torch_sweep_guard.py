"""The port's ``BENCH_sweep_torch.json`` regression gate
(``benchmarks/compare_sweep_torch.py``), the counterpart of the
``compare_sweep`` tests of ``tests/test_sweep_guard.py``, and a smoke run
of the port's harness (``benchmarks/run_torch.py``) on the CPU."""
import copy
import json
import os

from benchmarks import run_torch
from benchmarks.compare_sweep_torch import compare, explicit_entries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "benchmarks", "BENCH_sweep_torch.baseline.json")

BASE = dict(
    budget=300,
    archs=[
        dict(arch="cloud", seconds=10.0, dispatches_per_round=1.0,
             host_syncs_per_round=1.0, device_rounds_source="default:cpu"),
        dict(arch="maple_edge", seconds=5.0, dispatches_per_round=1.0,
             host_syncs_per_round=1.0, device_rounds_source="default:cpu"),
        dict(arch="cloud_device_k4", seconds=2.0,
             dispatches_per_round=0.429, host_syncs_per_round=0.25,
             device_rounds_source="explicit"),
    ],
    analysis=dict(violations=0),
    graph_hashes={"cloud/u/eval": "0123456789abcdef"})


def test_compare_passes_on_identical_runs():
    failures, warnings = compare(BASE, copy.deepcopy(BASE))
    assert failures == [] and warnings == []


def test_compare_fails_on_dispatch_and_host_sync_regressions():
    cur = copy.deepcopy(BASE)
    cur["archs"][1]["dispatches_per_round"] = 2.0
    cur["archs"][2]["host_syncs_per_round"] = 1.0
    failures, _ = compare(BASE, cur)
    assert failures == [
        "maple_edge: dispatches/round regressed 1.0 -> 2.0",
        "cloud_device_k4: host syncs/round regressed 0.25 -> 1.0"]


def test_compare_new_arch_timing_and_hash_drift_are_warn_only():
    cur = copy.deepcopy(BASE)
    cur["archs"].append(dict(arch="quant_edge", seconds=1.0,
                             dispatches_per_round=3.0))
    cur["archs"][0]["seconds"] = 100.0
    cur["graph_hashes"]["cloud/u/eval"] = "fedcba9876543210"
    failures, warnings = compare(BASE, cur)
    assert failures == []
    assert any("new arch" in w for w in warnings)
    assert any("100.00s" in w and "warn-only" in w for w in warnings)
    assert any("graph hash drift" in w for w in warnings)


def test_compare_budget_mismatch_downgrades_to_warnings():
    cur = copy.deepcopy(BASE)
    cur["budget"] = 1000
    cur["archs"][0]["dispatches_per_round"] = 9.0
    del cur["archs"][1]                 # disappearance downgrades too
    failures, warnings = compare(BASE, cur)
    assert failures == []
    assert any("budgets differ" in w for w in warnings)
    assert any("dispatches/round regressed" in w for w in warnings)
    assert any("disappeared" in w for w in warnings)


def test_compare_fails_when_an_arch_disappears():
    cur = copy.deepcopy(BASE)
    cur["archs"] = cur["archs"][:1] + cur["archs"][2:]
    failures, _ = compare(BASE, cur)
    assert failures == ["maple_edge: arch disappeared from the sweep"]


def test_compare_fails_on_a_recorded_analysis_violation():
    cur = copy.deepcopy(BASE)
    cur["analysis"]["violations"] = 2
    cur["budget"] = 1000                # even across budgets
    failures, _ = compare(BASE, cur)
    assert len(failures) == 1 and "2 contract violation(s)" in failures[0]


def test_compare_over_the_explicit_entries_only():
    """Another backend: the per-backend default fleets are left out."""
    cur = copy.deepcopy(BASE)
    cur["archs"][0]["dispatches_per_round"] = 0.5
    cur["archs"][0]["host_syncs_per_round"] = 0.25
    cur["archs"][0]["device_rounds_source"] = "default:gpu"
    assert explicit_entries(BASE) == ["cloud_device_k4"]
    failures, warnings = compare(BASE, cur, explicit_entries(BASE))
    assert failures == [] and warnings == []
    cur["archs"][2]["host_syncs_per_round"] = 0.5
    failures, _ = compare(BASE, cur, explicit_entries(BASE))
    assert failures == [
        "cloud_device_k4: host syncs/round regressed 0.25 -> 0.5"]


def test_committed_baseline_is_well_formed():
    base = json.load(open(BASELINE))
    failures, warnings = compare(base, base)
    assert failures == []
    # the CPU computes while it dispatches, so there the pipelined and
    # unpipelined fleets' host_blocked_s are equal in all but noise
    assert all("warn-only" in w for w in warnings), warnings
    assert base["budget"] == 300 and base["device"] == "cpu"
    archs = {a["arch"]: a for a in base["archs"]}
    assert set(archs) == {
        "cloud", "maple_edge", "cluster_cloud", "systolic_mesh",
        "quant_edge", "eyeriss_like", "sigma_like", "dstc_like",
        "structured_cloud", "cloud_device_k4", "cloud_device_k4_unpipelined",
        "serve_coalesce"}
    for a in base["archs"]:
        assert a["dispatches_per_round"] <= 1.0
        assert a["host_syncs_per_round"] <= 1.0
        assert a["pad_watermarks"] and a["pad_policies"]
        assert "compiles" not in a and "compile_ahead_misses" not in a
    assert archs["structured_cloud"]["dispatches_per_round"] == 1.0
    assert archs["serve_coalesce"]["dispatches_per_round"] == 1.0
    for name in ("cloud_device_k4", "cloud_device_k4_unpipelined"):
        assert archs[name]["device_rounds"] == 4
        assert archs[name]["host_syncs_per_round"] <= 1 / 4
    assert set(explicit_entries(base)) == {
        "cloud_device_k4", "cloud_device_k4_unpipelined", "serve_coalesce"}
    assert base["analysis"]["violations"] == 0
    assert base["analysis"]["rule_counts"] == dict(R2=0, R3=0, R4=0, R5=0)
    assert len(base["graph_hashes"]) == 16
    assert all(len(h) == 16 for h in base["graph_hashes"].values())


def test_run_torch_es_ops_smoke_on_the_cpu(capsys, monkeypatch, tmp_path):
    from benchmarks import roofline_torch
    monkeypatch.setattr(roofline_torch, "OUT_DIR", str(tmp_path))
    run_torch.main(["--quick", "--only", "es_ops,roofline",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,seconds,derived"
    es = [ln for ln in lines if ln.startswith("es_ops,")]
    assert len(es) == 1 and "combined_speedup=" in es[0]
    assert "device_pairs_per_s=" in es[0]
    # the roofline line is the dry-run table's summary, no longer
    # "not_ported"
    roof = [ln for ln in lines if ln.startswith("roofline,")]
    assert len(roof) == 1 and "records=80;ok=66;skipped=14" in roof[0]
    assert (tmp_path / "roofline_torch_16_16.md").exists()
