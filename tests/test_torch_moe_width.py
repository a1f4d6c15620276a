"""The experts' hidden width split over "data" (``Model(cfg, dp=(rank,
D))``, ``models.moe`` under a width axis, ``launch.steps.
build_sharded_train_step``), on the CPU: gloo ranks against one rank in
fp32 at the tolerances of ``tests/test_torch_tp.py``, the build's and
``convert``'s slices against the world of one's leaves bit for bit, a
sharded checkpoint's resume, and the production-mesh dry-run's bytes.

The reference shards the experts as ``P(E over "model", None, "data")``
(``src/repro/models/blocks.py`` ``build_moe``): each rank holds ``[E/m, d,
d_ff/D]`` of ``w1`` / ``w3`` and ``[E/m, d_ff/D, d]`` of ``w2``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import selftest
from repro_torch.launch import dryrun
from repro_torch.models import moe, sharding
from repro_torch.models.convert import load_jax_params, named_from_jax
from repro_torch.models.model import Model
from test_torch_moe_dp import CAPACITY, DISPATCH
from test_torch_tp import CPU, F32, RTOL, _assert_parity, _cfg, _spawn

def _expert_shape(cfg, name, m, d):
    e, f = cfg.n_experts // m, cfg.moe_d_ff // d
    return [e, f, cfg.d_model] if name == "w2" else [e, cfg.d_model, f]


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_moe_width_over_data_on_2x2_equals_world_one(tmp_path, dispatch,
                                                      capacity):
    """arctic smoke with 16 experts on a (2, 2) mesh, two steps of batch 4
    x 32: the experts over "model", their hidden width over "data".  The
    losses, the first step's gradients and the updated leaves equal the
    world of one's; each rank holds ``[E/2, d, d_ff/2]`` of every expert
    leaf (the specs' share of every parameter); the width gathers and
    sum-scatters run over "data"."""
    grouped, groups = DISPATCH[dispatch]
    cfg = _cfg("arctic-480b", n_experts=16, moe_grouped=grouped,
               moe_n_groups=groups, capacity_factor=CAPACITY[capacity])
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 4,
                  (cfg, (2, 2), 4, 32, 2))
    _assert_parity(outs)
    for o in outs:
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["not_the_share"] == [], o
        for n, shape in o["expert_shapes"].items():
            assert shape == _expert_shape(cfg, n[-2:], 2, 2), (n, shape)
        assert o["moe_width_forms"] == {"tokens": 2 * cfg.n_layers}
        assert o["coll_bytes_by_axis"]["data"] > 0


def test_moe_width_over_data_on_2x1_holds_half_of_each_expert(tmp_path):
    """arctic smoke on (2, 1), the flat dispatch at the low capacity: each
    rank holds every expert at half its hidden width, nothing of an
    expert is gathered whole, and the step equals the world of one."""
    cfg = _cfg("arctic-480b", capacity_factor=0.5)
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 2,
                  (cfg, (2, 1), 4, 32, 2))
    _assert_parity(outs)
    for o in outs:
        assert len(o["expert_shapes"]) == 3 * cfg.n_layers
        for n, shape in o["expert_shapes"].items():
            assert shape == _expert_shape(cfg, n[-2:], 1, 2), (n, shape)
        assert not any(".moe.w" in n and not n.endswith("wg") for n in
                       o["leaf_gathers"].get("data", {})), o["leaf_gathers"]
        assert o["moe_width_forms"] == {"tokens": 2 * cfg.n_layers}


@pytest.mark.parametrize("m,d", [(1, 2), (2, 2), (1, 4)])
def test_width_slices_concatenate_to_the_one_device_leaves(m, d):
    """``Model(cfg, tp=(r, m), dp=(q, D))`` for every (r, q): each expert
    leaf is ``[E/m, d, d_ff/D]`` (``w2``: ``[E/m, d_ff/D, d]``), and the
    slices concatenated along the hidden width, then over "model", equal
    the world of one's leaf bit for bit; ``whole_shapes`` and ``layout``
    say so."""
    cfg = dataclasses.replace(smoke_config("arctic-480b"), n_experts=16)
    whole = dict(Model(cfg, device=CPU).named_parameters())
    parts = [[Model(cfg, device=CPU, tp=(r, m), dp=(q, d))
              for q in range(d)] for r in range(m)]
    layout = parts[0][0].layout()
    assert parts[0][0].whole_shapes() == {n: tuple(p.shape)
                                          for n, p in whole.items()}
    for n, w in whole.items():
        got = [[dict(p.named_parameters())[n] for p in row] for row in parts]
        if ".moe.w" in n and not n.endswith("wg"):
            assert list(got[0][0].shape) == _expert_shape(cfg, n[-2:], m, d)
            assert layout[n].width_dim == layout[n].data_dim is not None
            rows = [torch.cat(row, dim=layout[n].width_dim) for row in got]
        else:
            assert layout[n].width_dim is None
            assert all(torch.equal(g, row[0]) for row in got for g in row)
            rows = [row[0] for row in got]
        if layout[n].shard_dim is None:
            assert all(torch.equal(r, w) for r in rows), n
        else:
            assert torch.equal(torch.cat(rows, dim=layout[n].shard_dim), w), n


@pytest.mark.parametrize("d", [2, 4])
def test_reference_weights_load_onto_width_slices(d):
    """``load_jax_params`` / ``named_from_jax`` onto each rank of a (D, 1)
    model slice the reference's expert leaves as the build slices its
    draws: the slices equal the one-device model's loaded leaves, sliced
    along the hidden width, and concatenate back to them."""
    cfg = _cfg("arctic-480b")
    ref_cfg = dataclasses.replace(ref_smoke_config("arctic-480b"), **F32)
    tree = jax.tree.map(np.asarray, RefModel(ref_cfg).init(
        jax.random.PRNGKey(5)))
    whole = dict(load_jax_params(Model(cfg, device=CPU), tree)
                 .named_parameters())
    parts = [load_jax_params(Model(cfg, device=CPU, dp=(q, d)), tree)
             for q in range(d)]
    layout = parts[0].layout()
    for q, part in enumerate(parts):
        named = named_from_jax(part, tree)
        for n, p in part.named_parameters():
            want = whole[n]
            if layout[n].width_dim is not None:
                want = sharding.shard_of(want, layout[n].width_dim, q, d)
            assert torch.equal(p, want), n
            assert torch.equal(named[n], want), n
    for n, w in whole.items():
        dim = layout[n].width_dim
        if dim is not None:
            got = torch.cat([dict(p.named_parameters())[n] for p in parts],
                            dim=dim)
            assert torch.equal(got, w), n


def test_sharded_moe_training_resumes_from_its_checkpoint(tmp_path):
    """``run_train`` of arctic smoke on a (2, 1) mesh (each rank half of
    every expert's width) with a checkpoint every 2 steps and a failure
    injected at step 3: the checkpoint gathers the width slices whole and
    restores them in place, so the replayed losses equal an uninterrupted
    meshed run's bit for bit, and that run's equal the world of one's
    within 1e-5 relative."""
    from repro_torch.launch import train
    cfg = _cfg("arctic-480b")
    kw = dict(steps=5, batch=4, seq=32, log_every=100)
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
    plain = _spawn(tmp_path / "a", train._train_rank, 2, (cfg, (2, 1), kw))
    resumed = _spawn(tmp_path / "b", train._train_rank, 2, (cfg, (2, 1), dict(
        kw, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
        inject_failure_at=3)))
    single = train.run_train(cfg, device=CPU, log=lambda line: None,
                             **kw)["losses"]
    for losses in plain:
        rel = np.abs(np.array(losses) - single) / np.abs(single)
        assert rel.max() <= RTOL, (losses, single)
    for losses in resumed:
        assert losses[:3] == plain[0][:3]
        assert losses[3:] == plain[0][2:], (losses, plain[0])


#: short cells of arctic at its full width on the production meshes
SHORT = {"train": ShapeSpec("short_train", 128, 256, "train"),
         "prefill": ShapeSpec("short_prefill", 128, 32, "prefill"),
         "decode": ShapeSpec("short_decode", 128, 128, "decode")}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", sorted(SHORT))
def test_dryrun_arctic_holds_the_specs_weights(kind, multi_pod):
    """arctic-480b on ``meta`` at 16x16 and 2x16x16: rank 0 holds exactly
    the specs' share of the weights (4.69 GB: 8 experts at 304 of their
    4,864 hidden units a layer), of the state too; the width gathers move
    bytes over "data" only, never over "pod"."""
    rec = dryrun.run_cell("arctic-480b", SHORT[kind], multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["param_bytes_per_device"] == rec["param_bytes_by_specs"]
    assert rec["state_bytes_per_device"] == rec["state_bytes_by_specs"]
    assert rec["param_bytes_per_device"] == pytest.approx(4.6946e9, 1e-4)
    assert rec["coll_by_axis"]["data"] > 0


def test_dryrun_decode_of_one_replicated_sequence():
    """A decode cell of one sequence, which every rank holds: the width
    ranks gather nothing and all-reduce their partial outputs over
    "data"."""
    moe.width_forms.clear()
    rec = dryrun.run_cell("arctic-480b", ShapeSpec("one", 128, 1, "decode"),
                          False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rows_per_device"] == 1
    assert moe.width_forms == {"replicated": get_config(
        "arctic-480b").n_layers}
    assert rec["coll_by_axis"]["data"] > 0


def test_width_groups_number_the_gathered_groups():
    """``moe._width_groups``: rank-local groups each their own, members
    that share a group one buffer group, members strided along the rows
    (the rows over ("data", "model")) numbered compactly."""
    width = sharding.Axis(None, 4, 1, "data")
    with sharding.parallel(data=sharding.Axis(None, 8, 5, "pod_data"),
                           width=width):
        assert moe._width_groups(2, 1, width) == list(range(8))
        assert moe._width_groups(1, 2, width) == [0, 0, 1, 1]
        assert moe._width_groups(1, 8, width) == [0, 0, 0, 0]
    width = sharding.Axis(None, 4, 2, "data", stride=4)
    with sharding.parallel(data=sharding.Axis(None, 16, 9, "data_model"),
                           width=width):
        assert moe._width_groups(1, 2, width) == [0, 1, 2, 3]
        assert moe._width_groups(1, 16, width) == [0, 0, 0, 0]
