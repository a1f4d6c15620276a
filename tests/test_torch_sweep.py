"""The port's dry-run sweep and its tools (``repro_torch.launch.sweep``,
``benchmarks/roofline_torch.py``, ``repro_torch.launch.hillclimb``,
``benchmarks/prewarm_cache_torch.py``), on the CPU.

The first two tests are the counterparts of
``tests/test_moe_and_sweep.py::test_sweep_covers_all_cells_on_both_meshes``
and ``::test_sweep_records_have_roofline_terms``, on the committed
``benchmarks/dryrun_torch.jsonl`` (which the sweep wrote): they never
skip.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from benchmarks import roofline as ref_roofline
from benchmarks import roofline_torch
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, hillclimb, mesh, sweep
from repro_torch.models import sharding
from repro_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN = os.path.join(ROOT, "benchmarks", "dryrun_torch.jsonl")
MOE = ("arctic-480b", "kimi-k2-1t-a32b")


class _DataModel:
    mesh_dim_names = ("data", "model")


def _records():
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in roofline_torch.load(DRYRUN)}


def test_sweep_covers_all_cells_on_both_meshes():
    recs = _records()
    missing, failed = [], []
    for a in ARCHS:
        for s in SHAPES:
            for m in ("16x16", "2x16x16"):
                r = recs.get((a, s, m))
                if r is None:
                    missing.append((a, s, m))
                    continue
                ok, _ = applicable(a, s)
                if ok and r.get("status") != "ok":
                    failed.append((a, s, m, r.get("error", "")[:80]))
                if not ok and r.get("status") != "skipped":
                    failed.append((a, s, m, "expected skip"))
    assert not missing, f"missing cells: {missing}"
    assert not failed, f"failed cells: {failed}"
    assert len(recs) == 80


def test_sweep_records_have_roofline_terms():
    """Every ``ok`` record has the roofline terms, a train cell the
    optimizer's state; every arctic and kimi record holds exactly its
    specs' weights (the experts' hidden width over "data")."""
    for key, r in _records().items():
        if r.get("status") != "ok":
            continue
        assert r["flops_per_device"] > 0, key
        assert r["bytes_per_device"] > 0, key
        assert r["bottleneck"] in ("compute", "memory", "collective"), key
        assert r["t_memory_s"] > 0, key
        if r["kind"] == "train":
            assert r["state_bytes_per_device"] > 1e6, key
        if r["arch"] in MOE:
            assert r["param_bytes_per_device"] == \
                r["param_bytes_by_specs"], key
            if r["kind"] == "train":
                assert r["state_bytes_per_device"] == \
                    r["state_bytes_by_specs"], key


def _spy_subprocess(monkeypatch):
    calls = []
    real = subprocess.run

    def spy(cmd, **kw):
        calls.append(cmd)
        return real(cmd, **kw)
    monkeypatch.setattr(sweep.subprocess, "run", spy)
    return calls


def _all_but(path, cell):
    with open(DRYRUN) as src, open(path, "w") as out:
        for line in src:
            r = json.loads(line)
            if (r["arch"], r["shape"], r["mesh"]) != cell:
                out.write(line)


def test_sweep_resumes_with_the_one_missing_cell(tmp_path, monkeypatch,
                                                 capsys):
    """A JSONL holding every cell but one (a cheap one: a skipped cell)
    runs exactly that cell's subprocess, whose record lands in the file;
    a second sweep runs nothing."""
    cell = ("mistral-nemo-12b", "long_500k", "16x16")
    path = str(tmp_path / "d.jsonl")
    _all_but(path, cell)
    monkeypatch.setenv("PYTHONPATH", os.path.join(ROOT, "src"))
    calls = _spy_subprocess(monkeypatch)
    assert sweep.main(["--jsonl", path]) == 0
    assert len(calls) == 1
    assert calls[0][:3] == [sys.executable, "-m",
                            "repro_torch.launch.dryrun"]
    assert calls[0][3:7] == ["--arch", cell[0], "--shape", cell[1]]
    assert "--multi-pod" not in calls[0]
    assert cell in sweep.existing_keys(path)
    out = capsys.readouterr().out
    assert "1 cells to run" in out and "[1/1] mistral-nemo-12b long_500k " \
        "16x16: ok" in out
    calls.clear()
    assert sweep.main(["--jsonl", path]) == 0
    assert calls == []


def test_sweep_records_a_timeout(tmp_path, capsys):
    """``--timeout 1``: the missing cell's subprocess outlives it and its
    record is an error ``timeout 1s``."""
    cell = ("xlstm-350m", "decode_32k", "2x16x16")
    path = str(tmp_path / "d.jsonl")
    _all_but(path, cell)
    assert sweep.main(["--jsonl", path, "--timeout", "1",
                       "--only-mesh", "2x16x16"]) == 0
    with open(path) as f:
        last = json.loads(f.readlines()[-1])
    assert (last["arch"], last["shape"], last["mesh"]) == cell
    assert last["status"] == "error" and last["error"] == "timeout 1s"
    assert ": timeout (" in capsys.readouterr().out


def test_sweep_order_is_sorted_arches_shapes_then_meshes():
    cells = sweep.cells()
    assert len(cells) == len(ARCHS) * len(SHAPES) * 2
    assert cells[0][:3] == (sorted(ARCHS)[0], list(SHAPES)[0], "16x16")
    assert cells[1][:3] == (sorted(ARCHS)[0], list(SHAPES)[0], "2x16x16")
    assert [c[:3] for c in sweep.cells("16x16")] == \
        [c[:3] for c in cells if c[2] == "16x16"]


def _hand_made():
    ok = dict(arch="a-1", shape="train_4k", mesh="16x16", status="ok",
              kind="train", t_compute_s=2.0, t_memory_s=3.0,
              t_collective_s=1.0, useful_flops_ratio=0.5,
              state_bytes_per_device=4e9, compile_s=0.0, build_s=1.5,
              run_s=2.25)
    return [
        dict(ok, t_compute_s=9.0),      # replaced by the rerun below
        ok,
        dict(ok, shape="decode_32k", t_collective_s=7.0),
        dict(arch="a-1", shape="long_500k", mesh="16x16", status="error",
             error="rc=1"),
        dict(arch="a-1", shape="long_500k", mesh="16x16", status="skipped",
             reason="long_500k skipped: pure full-attention arch"),
        dict(arch="b-2", shape="prefill_32k", mesh="16x16", status="error",
             error="timeout 2400s"),
        dict(ok, arch="b-2", mesh="2x16x16", t_memory_s=0.5),
    ]


def test_roofline_table_matches_the_references(tmp_path):
    """``load`` / ``table`` / ``markdown`` on hand-made records against
    ``benchmarks/roofline.py`` on the same records: the last ok or
    skipped record wins, the same rows and terms; the port's table names
    ``6ND/counted`` and adds the cell's ``build_s + run_s``."""
    path = tmp_path / "d.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _hand_made()) +
                    "not json\n")
    ours, ref = roofline_torch.load(str(path)), ref_roofline.load(str(path))
    assert ours == ref and len(ours) == 5
    for m in ("16x16", "2x16x16"):
        rows, ref_rows = roofline_torch.table(ours, m), \
            ref_roofline.table(ref, m)
        assert [{k: v for k, v in r.items() if k != "seconds"}
                for r in rows] == \
            [{k: v for k, v in r.items() if k != "compile_s"}
             for r in ref_rows]
        md, ref_md = roofline_torch.markdown(rows).splitlines(), \
            ref_roofline.markdown(ref_rows).splitlines()
        assert len(md) == len(ref_md)
        assert "6ND/counted" in md[0] and "build_s + run_s" in md[0]
        for a, b in zip(md[2:], ref_md[2:]):
            assert a.startswith(b), (a, b)     # and one column more
    rows = roofline_torch.table(ours, "16x16")
    train = next(r for r in rows if r["shape"] == "train_4k")
    assert train["t_compute_s"] == 2.0 and train["seconds"] == 3.75
    assert "| 3.8 |" in roofline_torch.markdown([train])


def test_roofline_main_writes_both_tables(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(roofline_torch, "OUT_DIR", str(tmp_path))
    recs = roofline_torch.main(DRYRUN)
    assert len(recs) == 80
    for name in ("roofline_torch_16_16.md", "roofline_torch_2_16_16.md"):
        assert (tmp_path / name).read_text().count("\n") == 42
    assert "dryrun records: 80" in capsys.readouterr().out


def test_hillclimb_pure_dp_switch():
    """``v1_pure_dp`` on xlstm at a short train shape (seq 64, global batch
    256, chunk 64): one row a rank, every weight whole (the world of
    one's bytes), nothing over "model"; the tensor-parallel mapping is
    back after the cell, and after a cell that raises."""
    cfg = dataclasses.replace(get_config("xlstm-350m"), ssm_chunk=64)
    sh = ShapeSpec("short_train", 64, 256, "train")
    rec = hillclimb.run_variant("xlstm-350m", sh, "v1_pure_dp", cfg=cfg,
                                pure_dp=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["tag"] == "v1_pure_dp" and rec["rows_per_device"] == 1
    whole = sum(p.numel() * p.element_size()
                for p in Model(cfg, device="meta").parameters())
    assert rec["param_bytes_per_device"] == whole == \
        rec["param_bytes_by_specs"]
    assert "model" not in rec["coll_by_axis"]
    assert rec["coll_by_axis"]["data_model"] > 0
    assert sharding.mdl(16) == "model"
    assert mesh.batch_axes_of(_DataModel) == ("data",)

    def boom(*a, **k):
        assert sharding.mdl(16) is None
        assert mesh.batch_axes_of(_DataModel) == ("data", "model")
        raise RuntimeError("boom")
    orig, dryrun.run_cell = dryrun.run_cell, boom
    try:
        with pytest.raises(RuntimeError, match="boom"):
            hillclimb.run_variant("xlstm-350m", sh, "v1_pure_dp",
                                  pure_dp=True)
    finally:
        dryrun.run_cell = orig
    assert sharding.mdl(16) == "model"
    assert mesh.batch_axes_of(_DataModel) == ("data",)


def test_hillclimb_baseline_comes_from_the_sweep():
    rec = hillclimb.baseline("command-r-35b", "train_4k")
    assert rec["tag"] == "baseline" and rec["status"] == "ok"
    assert rec["mesh"] == "16x16"
    assert rec["flops_per_device"] == _records()[
        "command-r-35b", "train_4k", "16x16"]["flops_per_device"]


def _no_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    return _build


def test_prewarm_without_nvcc_names_the_compiler(monkeypatch, tmp_path):
    from benchmarks import prewarm_cache_torch
    _build = _no_nvcc(monkeypatch, tmp_path)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        prewarm_cache_torch.main()


def test_prewarm_of_a_built_cache_builds_nothing(monkeypatch, tmp_path,
                                                 capsys):
    """Every source already has its library: nothing is compiled (there
    is no compiler to call), the objects are counted, exit 0."""
    from benchmarks import prewarm_cache_torch
    _build = _no_nvcc(monkeypatch, tmp_path)
    out = _build.build_dir()
    out.mkdir(parents=True)
    for s in _build.sources():
        (out / f"lib{s.stem}.so").write_bytes(b"")
    rep = prewarm_cache_torch.prewarm()
    assert rep["cached"] and rep["objects"] == len(_build.sources()) == 2
    assert rep["dir"] == str(out)
    assert prewarm_cache_torch.main() == 0
    assert "(already built)" in capsys.readouterr().out
