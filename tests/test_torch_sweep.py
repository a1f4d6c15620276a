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
    optimizer's state; every record holds exactly its specs' weights
    (the experts' hidden width over "data"; every block's heads over
    "model", the recurrent blocks' too), a train cell its specs'
    state."""
    for key, r in _records().items():
        if r.get("status") != "ok":
            continue
        assert r["flops_per_device"] > 0, key
        assert r["bytes_per_device"] > 0, key
        assert r["bottleneck"] in ("compute", "memory", "collective"), key
        assert r["t_memory_s"] > 0, key
        if r["kind"] == "train":
            assert r["state_bytes_per_device"] > 1e6, key
        assert r["param_bytes_per_device"] == r["param_bytes_by_specs"], key
        if r["kind"] == "train":
            assert r["state_bytes_per_device"] == \
                r["state_bytes_by_specs"], key


#: the "data" bytes of arctic's and kimi's 16x16 cells when every MoE
#: call took the tokens form, before the rule could take the weights form
TOKENS_FORM_DATA = {("arctic-480b", "train_4k"): 1679733353096,
                    ("arctic-480b", "prefill_32k"): 559145359360,
                    ("kimi-k2-1t-a32b", "train_4k"): 2012193130632,
                    ("kimi-k2-1t-a32b", "prefill_32k"): 975182346240}


def test_moe_records_carry_their_width_form():
    """Every arctic and kimi record names the width form its MoE layers
    took: the expert slices in the train and prefill cells, the tokens in
    the decode cells (a few rows a rank); its parameters and state are
    the specs'; the weights form's train and prefill cells move at most a
    tenth (kimi's train: a fifth) of the tokens form's "data" bytes."""
    for (arch, shape, mesh), r in _records().items():
        if arch not in ("arctic-480b", "kimi-k2-1t-a32b") or \
                r.get("status") != "ok":
            continue
        want = "tokens" if shape == "decode_32k" else "weights"
        assert r["moe_width_form"] == want, (arch, shape, mesh)
        assert r.get("moe_rows_balanced", False) == (want == "weights"), \
            (arch, shape)
        assert r["param_bytes_per_device"] == r["param_bytes_by_specs"]
        assert r["state_bytes_per_device"] == r["state_bytes_by_specs"]
        was = TOKENS_FORM_DATA.get((arch, shape))
        if was is not None and mesh == "16x16":
            share = 5 if arch.startswith("kimi") else 10
            assert r["coll_by_axis"]["data"] <= was / share, (arch, shape)


def test_arctic_cells_are_no_longer_bound_by_the_data_exchange():
    """arctic at 16x16: ``prefill_32k`` is memory-bound; ``train_4k``'s
    collective term is led by the "model" axis (the tensor-parallel
    all-reduces), its "data" bytes a fifth of them or less, and the
    "data" exchange alone would take less time than the memory term."""
    recs = _records()
    assert recs["arctic-480b", "prefill_32k", "16x16"]["bottleneck"] == \
        "memory"
    r = recs["arctic-480b", "train_4k", "16x16"]
    by_axis = r["coll_by_axis"]
    assert by_axis["data"] * 4 <= by_axis["model"]
    t_data = r["t_collective_s"] * by_axis["data"] / sum(by_axis.values())
    assert t_data < r["t_memory_s"]


#: the decode cells' "model" all-gather bytes when every use of a leaf
#: whose stored slice is not the rank's part gathered the leaf whole
#: (the records before ``blocks.heads_form``), where there were any
LEAF_FORM_GATHERS = {
    ("arctic-480b", "decode_32k", "16x16"): 517872320,
    ("arctic-480b", "decode_32k", "2x16x16"): 515855200,
    ("command-r-35b", "decode_32k", "16x16"): 83886080,
    ("command-r-35b", "decode_32k", "2x16x16"): 83886080,
    ("gemma3-12b", "decode_32k", "16x16"): 94371840,
    ("gemma3-12b", "decode_32k", "2x16x16"): 94371840,
    ("gemma3-12b", "long_500k", "16x16"): 94371840,
    ("gemma3-12b", "long_500k", "2x16x16"): 94371840,
    ("kimi-k2-1t-a32b", "decode_32k", "16x16"): 105259648,
    ("kimi-k2-1t-a32b", "decode_32k", "2x16x16"): 101695296,
    ("mistral-nemo-12b", "decode_32k", "16x16"): 52428800,
    ("mistral-nemo-12b", "decode_32k", "2x16x16"): 52428800,
    ("qwen2-vl-7b", "decode_32k", "16x16"): 102760448,
    ("qwen2-vl-7b", "decode_32k", "2x16x16"): 102760448,
    ("starcoder2-7b", "decode_32k", "16x16"): 188743680,
    ("starcoder2-7b", "decode_32k", "2x16x16"): 188743680,
    ("xlstm-350m", "decode_32k", "16x16"): 37748736,
    ("xlstm-350m", "decode_32k", "2x16x16"): 37748736,
    ("xlstm-350m", "long_500k", "16x16"): 37748736,
    ("xlstm-350m", "long_500k", "2x16x16"): 37748736,
    ("zamba2-2.7b", "decode_32k", "16x16"): 150451200,
    ("zamba2-2.7b", "decode_32k", "2x16x16"): 150451200,
    ("zamba2-2.7b", "long_500k", "16x16"): 150451200,
    ("zamba2-2.7b", "long_500k", "2x16x16"): 150451200}
#: the JAX package's own collective bytes of zamba2 ``decode_32k`` on
#: 16x16 (``python -m repro.launch.dryrun``, CPU counts)
REFERENCE_ZAMBA2_DECODE = 1.06e7
#: and of xlstm ``decode_32k`` on 16x16 (1.0295e8: the same command)
REFERENCE_XLSTM_DECODE = 1.03e8
#: the leaves that kept the weights form at decode before the sLSTM's
#: channels split (``blocks.slstm_split``): its ``r`` (stored on ``hd``,
#: cut on heads), 12 layers
SLSTM_LEAVES = {"xlstm-350m": 12}
#: the bytes of the slice of one ``r`` a rank gathered: ``[4, H, hd,
#: hd/16]`` in bf16 (4 heads of 256)
SLSTM_R_SLICE = {"xlstm-350m": 4 * 4 * 256 * (256 // 16) * 2}
#: xlstm ``long_500k``'s bound, the larger of its t_memory and
#: t_collective, before the mLSTM's value split cut its cache a quarter
#: (the records of ``blocks.heads_form``'s products, both meshes)
XLSTM_LONG_BOUND_BEFORE = 4.377973582089552e-05
#: and after it, with the sLSTM's ``r`` gathered at every step: its
#: t_collective, which bounded it
XLSTM_LONG_BOUND_R_GATHERED = 3.29728e-05


def test_decode_records_exchange_the_products():
    """Every decode and ``long_500k`` record: each use of a leaf whose
    slice is not the rank's part took the activations form, and no leaf
    is gathered whole (the sLSTM takes its channels split at decode and
    gathers ``h``, not ``r``); each record that gathered a leaf before
    gathers fewer bytes, xlstm's fewer than the ``r`` slices alone it
    gathered; zamba2's cells and xlstm's ``decode_32k`` on 16x16 move at
    most the reference's "model" bytes,
    and they, xlstm's and arctic's ``decode_32k`` on 2x16x16 are
    memory-bound.  xlstm's ``long_500k`` (one row), which the ``r``
    gathers made collective-bound, is memory-bound again, its bound below
    its bound with them and before the mLSTM's value split."""
    for key, r in _records().items():
        arch, shape, mesh = key
        if r.get("status") != "ok" or r["kind"] not in ("decode",
                                                         "long_decode"):
            continue
        assert r["heads_forms"].get("weights", 0) == 0, key
        assert r["leaf_gathers"].get("model", 0) == 0, key
        if key in LEAF_FORM_GATHERS:
            assert r["heads_forms"]["activations"] > 0, key
            assert r["coll_all-gather"] < LEAF_FORM_GATHERS[key], key
        if arch in SLSTM_LEAVES:
            assert r["coll_all-gather"] < \
                SLSTM_LEAVES[arch] * SLSTM_R_SLICE[arch], key
        if arch == "zamba2-2.7b":
            assert r["coll_by_axis"]["model"] <= REFERENCE_ZAMBA2_DECODE
        if key == ("xlstm-350m", "decode_32k", "16x16"):
            assert r["coll_by_axis"]["model"] <= REFERENCE_XLSTM_DECODE
        if key[:2] == ("xlstm-350m", "long_500k"):
            assert max(r["t_collective_s"], r["t_memory_s"]) < \
                XLSTM_LONG_BOUND_R_GATHERED < XLSTM_LONG_BOUND_BEFORE, key
        if arch in ("zamba2-2.7b", "xlstm-350m") or key == (
                "arctic-480b", "decode_32k", "2x16x16"):
            assert r["bottleneck"] == "memory", key


def test_train_and_prefill_records_gather_the_leaves():
    """A train or prefill step's rows (thousands a rank) make the leaf
    the cheaper exchange: no use there took the activations form."""
    for key, r in _records().items():
        if r.get("status") == "ok" and r["kind"] in ("train", "prefill"):
            assert "activations" not in r["heads_forms"], key


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
