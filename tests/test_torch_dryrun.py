"""The PyTorch port's production-mesh dry-run (``repro_torch.launch.dryrun``,
``launch.specs``), on the CPU: one rank's step of a cell on ``meta``
tensors under a fake process group of 256 ranks, the counterpart of
``tests/test_launch.py::test_dryrun_single_cell``.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models.model import Model


def test_dryrun_single_cell(capsys):
    """``xlstm-350m`` ``decode_32k`` on 16x16 through the CLI: one JSON
    record, status ok, FLOPs, bytes and the memory term positive, run on
    meta tensors (the rank's parameters allocate nothing)."""
    assert dryrun.main(["--arch", "xlstm-350m", "--shape",
                        "decode_32k"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["status"] == "ok", rec
    assert rec["backend"] == "torch-meta" and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["t_memory_s"] > 0 and rec["t_compute_s"] > 0
    assert rec["rows_per_device"] == 128 // 16
    assert rec["state_bytes_per_device"] > rec["param_bytes_per_device"] > 0
    for k in ("coll_all-gather", "coll_all-reduce", "coll_reduce-scatter",
              "coll_total", "t_collective_s", "model_flops_total",
              "useful_flops_ratio", "bottleneck"):
        assert k in rec, k


def _tp_smoke(**kw):
    """mistral's smoke config with 16 heads of 16 (q/kv width 256): every
    attention, MLP and vocabulary width splits whole over 16."""
    return dataclasses.replace(smoke_config("mistral-nemo-12b"), n_heads=16,
                               n_kv_heads=16, head_dim=16, **kw)


def test_dense_train_cell_flops_against_8_n_tokens():
    """A dense smoke train cell (remat full, seq 64, batch 256) on 16x16:
    the rank's FLOPs times 256 equal the world of one's step on the same
    global batch (counted the same way, on ``meta``) exactly, and lie
    within 15 % of 8·N·tokens.

    8·N·T counts every parameter in a product 8 times (forward, remat's
    recompute, backward's two); the count differs by the embedding (a
    lookup: no products), the unembedding (not rematerialised) and the
    chunked attention's scores and values (4·S·H·hd FLOPs a token and
    layer forward): +9 % here."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import loss_and_grads
    cfg = _tp_smoke(remat="full")
    sh = ShapeSpec("smoke_train", seq_len=64, global_batch=256, kind="train")
    rec = dryrun.run_cell("mistral-nemo-12b", sh, False, arch_cfg=cfg)
    assert rec["status"] == "ok", rec
    one = Model(cfg, device="meta")
    one.requires_grad_(True)
    toks = torch.empty((256, 64), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as counted:
        loss_and_grads(one, dict(tokens=toks, labels=toks))
    got = rec["flops_per_device"] * 256
    assert got == counted.get_total_flops()
    t = sh.global_batch * sh.seq_len
    assert abs(got / (8 * cfg.param_count() * t) - 1) <= 0.15
    # perfectly sharded: the state is the specs' share, nothing gathered
    # over "model", every leaf's ZeRO-1 slice gathered over "data"
    assert rec["state_bytes_per_device"] == rec["state_bytes_by_specs"]
    assert rec["leaf_gathers"] == {"data": len(list(one.parameters()))}
    assert rec["useful_flops_ratio"] == pytest.approx(
        6 * cfg.active_param_count() * t / got)


def test_meta_model_allocates_and_draws_nothing(monkeypatch):
    """``Model(cfg, device="meta")`` of kimi-k2 (1T parameters) on its
    shards of 16 and whole: no draw (``torch.randn`` raises if called),
    every weight on ``meta``, the shards a 16th of each sliced leaf."""
    def no_draw(*a, **k):
        raise AssertionError("a meta build drew a tensor")
    monkeypatch.setattr(torch, "randn", no_draw)
    cfg = get_config("kimi-k2-1t-a32b")
    whole = Model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in whole.parameters())
    n = sum(p.numel() for p in whole.parameters())
    assert n > 1e12
    part = Model(cfg, device="meta", tp=(3, 16))
    layout = part.layout()
    held = sum(p.numel() for p in part.parameters())
    sliced = sum(p.numel() for name, p in whole.named_parameters()
                 if layout[name].shard_dim is not None)
    assert held == n - sliced + sliced // 16


def test_prefill_cell_runs_tensor_parallel():
    """A prefill cell on 16x16 (the tp smoke config at 4,096 positions,
    32 sequences): the rank's 2 rows through the tensor-parallel forward,
    its logits' vocabulary sharded; an all-reduce over "model" after
    each row-parallel product and the embedding, nothing over "data"."""
    cfg = _tp_smoke()
    sh = ShapeSpec("smoke_prefill", seq_len=4096, global_batch=32,
                   kind="prefill")
    rec = dryrun.run_cell("mistral-nemo-12b", sh, False, arch_cfg=cfg)
    assert rec["status"] == "ok", rec
    assert rec["rows_per_device"] == 2
    per = 2 * 4096 * cfg.d_model * 2            # one bf16 [2, S, d]
    # the embedding, then attention and MLP in each of 2 layers
    assert rec["coll_all-reduce"] == 5 * per
    assert set(rec["coll_by_axis"]) == {"model"}


def test_multi_pod_train_cell():
    """The tp smoke config's train cell on 2x16x16 (512 fake ranks): the
    rows go over ("pod", "data"), the gradients are summed over "pod"."""
    cfg = _tp_smoke()
    sh = ShapeSpec("smoke_train", seq_len=64, global_batch=256, kind="train")
    rec = dryrun.run_cell("mistral-nemo-12b", sh, True, arch_cfg=cfg)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "2x16x16"
    assert {"pod", "data", "model", "pod_data"} <= set(rec["coll_by_axis"])


def test_inapplicable_cell_is_skipped():
    rec = dryrun.run_cell("mistral-nemo-12b", "long_500k", False)
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


@pytest.mark.parametrize("seq,form", [(256, "tokens"), (512, "weights")])
def test_dryrun_records_the_moe_width_form_the_rule_takes(seq, form):
    """arctic-480b prefill cells of batch 16 on 16x16 (one sequence a data
    rank): at 256 rows a rank the tokens move fewer bytes over the width
    axis than the rank's 8 experts' slices (105 MB), at 512 more; the
    record names the form every layer took, and where the weights form
    sized the flat dispatch's expert rows without counts (``meta``), it
    says so.  The other counts stay the specs'."""
    from repro_torch.models import moe
    cfg = get_config("arctic-480b")
    rows = seq          # 16 rows of the batch over 16 data ranks
    assert moe.width_form(rows, cfg.d_model, cfg.moe_d_ff,
                          cfg.n_experts // 16, cfg.top_k, 16, 2, 2) == form
    rec = dryrun.run_cell("arctic-480b", ShapeSpec("p", seq, 16, "prefill"),
                          False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rows_per_device"] == 1
    assert rec["moe_width_form"] == form
    assert rec.get("moe_rows_balanced", False) == (form == "weights")
    assert rec["param_bytes_per_device"] == rec["param_bytes_by_specs"]
    assert rec["leaf_gathers"].get("data", 0) == (
        3 * cfg.n_layers if form == "weights" else 0)
