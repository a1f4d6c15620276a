"""The experts' hidden width split over "data" (``Model(cfg, dp=(rank,
D))``, ``models.moe`` under a width axis, ``launch.steps.
build_sharded_train_step``), on the CPU: gloo ranks against one rank in
fp32 at the tolerances of ``tests/test_torch_tp.py``, the build's and
``convert``'s slices against the world of one's leaves bit for bit, a
sharded checkpoint's resume, and the production-mesh dry-run's bytes.
Each call takes one of two width forms (``moe.width_form``, from its
shapes): the tokens gathered over "data" (the cases at batch 4 x 32), or
the experts' slices gathered whole (the cases at ``WEIGHTS_SEQ``): the
rule against hand arithmetic, both forms against the world of one and
against each other, the bytes each moves against the rule's count (the
weights form's one-step parity cases are in
``tests/test_torch_moe_width_weights.py``).

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
from test_torch_tp import (CPU, F32, GRAD_MAX_RTOL, RTOL, _assert_parity,
                           _cfg, _spawn)

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


# ------------------------------------------- the width form of each call

#: the rows a rank routes at 16x16 in each cell (the global batch over 16
#: data ranks; a decode step is one token a row)
CELL_ROWS = {"train_4k": 256 // 16 * 4096, "prefill_32k": 32 // 16 * 32768,
             "decode_32k": 128 // 16}


@pytest.mark.parametrize("cell,want", [("train_4k", "weights"),
                                       ("prefill_32k", "weights"),
                                       ("decode_32k", "tokens")])
@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_width_form_rule_against_hand_arithmetic(arch, cell, want):
    """``moe.width_form_bytes`` at 16x16, bf16, written out by hand: the
    tokens form gathers each row (``d`` bf16, its ``k`` combine weights
    in fp32 and its experts, positions and keep masks in int64) and
    sum-scatters the 16 ranks' partial outputs; the weights form gathers
    the rank's experts' ``w1`` / ``w3`` / ``w2`` slices (``E/16``
    experts, ``d_ff/16`` wide) and, in training, reduce-scatters their
    gradients; arctic and kimi train under ``remat="full"``, so the
    forward's collectives count twice.  The rule takes the weights form
    for ``train_4k`` and ``prefill_32k`` and the tokens form for
    ``decode_32k``; at arctic ``train_4k`` that is 47.9 GB against
    1.88 GB a layer."""
    cfg = get_config(arch)
    d, f, k = cfg.d_model, cfg.moe_d_ff, cfg.top_k
    e = cfg.n_experts // 16
    t = CELL_ROWS[cell]
    train = cell == "train_4k"
    tokens_fwd = t * d * 2 + t * k * 4 + 3 * t * k * 8 + 16 * t * d * 2
    tokens_bwd = 16 * t * d * 2 + 16 * t * k * 4 + t * d * 2
    weights_fwd = 3 * e * d * (f // 16) * 2
    weights_bwd = 3 * e * d * f * 2
    if train:
        want_bytes = dict(tokens=2 * tokens_fwd + tokens_bwd,
                          weights=2 * weights_fwd + weights_bwd)
    else:
        want_bytes = dict(tokens=tokens_fwd, weights=weights_fwd)
    args = (t, d, f, e, k, 16, 2, 2, train, cfg.remat == "full")
    assert cfg.remat == "full"
    assert moe.width_form_bytes(*args) == want_bytes
    assert moe.width_form(*args) == want
    if arch == "arctic-480b" and train:
        assert want_bytes["tokens"] == pytest.approx(47.9e9, rel=2e-3)
        assert want_bytes["weights"] == pytest.approx(1.88e9, rel=3e-3)


def test_width_form_ties_go_to_the_tokens():
    """Equal bytes take the tokens form; one byte fewer the weights."""
    args = dict(d=1, d_ff=2, n_local=1, top_k=1, width=2, act_bytes=1,
                w_bytes=1)
    # tokens: rows·(1 + 4 + 24) + 2·rows = 31·rows; weights: 3
    assert moe.width_form_bytes(1, **args) == dict(tokens=31, weights=3)
    tie = dict(args, n_local=31)      # weights 3·31 = 93 = 31·3 rows
    assert moe.width_form_bytes(3, **tie) == dict(tokens=93, weights=93)
    assert moe.width_form(3, **tie) == "tokens"
    assert moe.width_form(3, **dict(tie, n_local=30)) == "weights"
    with pytest.raises(ValueError, match="unknown width form"):
        moe.moe_ffn(torch.zeros(1, 2, 4), dict(
            wg=torch.zeros(4, 2), w1=torch.zeros(2, 4, 4),
            w3=torch.zeros(2, 4, 4), w2=torch.zeros(2, 4, 4)), 1,
            form="rows")


#: the sequence of batch 4 at which the weights-form cases run: the
#: smallest power of two at which the smoke config's rule takes the
#: weights form (512 rows a data rank move 823,296 bytes in the tokens
#: form against 589,824: the rank's 8 experts' slices gathered and their
#: gradients reduce-scattered; at the other tests' 32, 102,912)
WEIGHTS_SEQ = 256


def _weights_cfg(mesh, dispatch, capacity):
    grouped, groups = DISPATCH[dispatch]
    return _cfg("arctic-480b", n_experts=8 * mesh[1], moe_grouped=grouped,
                moe_n_groups=groups, capacity_factor=CAPACITY[capacity])


def _rule_at(cfg, mesh, seq, batch=4):
    """The rule's form and bytes for ``cfg``'s smoke MoE on ``mesh``, a
    training call without remat, at ``batch`` x ``seq``."""
    args = (batch // mesh[0] * seq, cfg.d_model, cfg.moe_d_ff,
            cfg.n_experts // mesh[1], cfg.top_k, mesh[0], 4, 4, True)
    return moe.width_form(*args), moe.width_form_bytes(*args)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_the_rule_keeps_the_tokens_form_where_the_tests_took_it(mesh):
    """At the other tests' batch 4 x 32 the rule still takes the tokens
    form (their cases assert it); at ``WEIGHTS_SEQ`` the weights form."""
    cfg = _weights_cfg(mesh, "flat", "drops")
    assert _rule_at(cfg, mesh, 32)[0] == "tokens"
    assert _rule_at(cfg, mesh, 32)[1] == dict(tokens=102_912,
                                              weights=589_824)
    assert _rule_at(cfg, mesh, WEIGHTS_SEQ) == (
        "weights", dict(tokens=823_296, weights=589_824))
    assert _rule_at(cfg, mesh, WEIGHTS_SEQ // 2)[0] == "tokens"


def _router_bytes(cfg, shared):
    """The width-independent "data" bytes of one MoE call: the expert
    counts' and the router probabilities' sums all-reduced (fp32 [E];
    the second again backward), and where ranks share a group their
    per-expert counts gathered (int64 [1, G, E], G = 1 here)."""
    return 12 * cfg.n_experts + (8 * cfg.n_experts if shared else 0)


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_both_width_forms_agree_and_move_what_the_rule_counts(
        tmp_path, mesh, dispatch):
    """The first block's routed FFN forced into each form on the same
    rows (``selftest.moe_width_forms``), forward and backward: the loss
    and the gradients of the input and of every leaf the rank holds
    agree within the file's bounds.  The bytes each moved over "data"
    are the rule's count plus the router's statistics, exactly; the
    weights form gathered each expert leaf whole once and no token,
    the tokens form no leaf."""
    cfg = _weights_cfg(mesh, dispatch, "drops")
    outs = _spawn(tmp_path, selftest.moe_width_forms, mesh[0] * mesh[1],
                  (cfg, mesh, 4, WEIGHTS_SEQ))
    _, rule = _rule_at(cfg, mesh, WEIGHTS_SEQ)
    grouped, groups = DISPATCH[dispatch]
    shared = not grouped or groups == 1
    for o in outs:
        f = o["figures"]
        assert f["loss_rel_err"]["loss"] <= RTOL, f
        assert max(f["grad_rel_norm"].values()) <= RTOL, f
        assert max(f["grad_err_over_max"].values()) <= GRAD_MAX_RTOL, f
        assert set(f["grad_rel_norm"]) == {"x", "wg", "w1", "w3", "w2"}
        for form in moe.FORMS:
            assert o[form]["forms"] == {form: 1}
            assert o[form]["by_axis"]["data"] == \
                rule[form] + _router_bytes(cfg, shared), (form, o[form])
        assert o["weights"]["leaf_gathers"] == {"data": {
            f"blocks.0.moe.{n}": 1 for n in ("w1", "w3", "w2")}}
        assert o["tokens"]["leaf_gathers"] == {}


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_weights_form_runs_a_ranks_own_kept_slots(tmp_path, capacity):
    """The flat dispatch on (2, 1): the tokens form runs each expert on
    the whole batch's capacity of rows; the weights form on as many rows
    as the rank keeps for its busiest expert, counted here from the
    world of one's routing of the whole batch (the (token, slot) pairs it
    keeps among the rank's tokens; the two ranks' together are the world
    of one's), fewer than the capacity where nothing is dropped (with
    drops the first rank may fill an expert's capacity alone)."""
    cfg = _weights_cfg((2, 1), "flat", capacity)
    outs = _spawn(tmp_path, selftest.moe_width_forms, 2,
                  (cfg, (2, 1), 4, WEIGHTS_SEQ))
    model = Model(cfg, device=CPU,
                  generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, WEIGHTS_SEQ, cfg.d_model)).astype(np.float32))
    _, _, top_i = moe.route(x.reshape(1, -1, cfg.d_model),
                            model.blocks[0].moe.wg, cfg.top_k)
    cap = moe.capacity(x.shape[0] * x.shape[1], cfg.top_k,
                       cfg.capacity_factor, cfg.n_experts)
    _, keep = moe.slot_positions(top_i, cfg.n_experts, cap)
    flat_e, per_rank = top_i.reshape(-1), keep.shape[1] // 2

    def kept(pairs):
        return torch.bincount(flat_e[pairs][keep[0, pairs]],
                              minlength=cfg.n_experts)
    mine = [kept(slice(q * per_rank, (q + 1) * per_rank)) for q in (0, 1)]
    assert torch.equal(mine[0] + mine[1], kept(slice(None)))
    for q, o in enumerate(outs):
        assert o["tokens"]["expert_rows"] == cap
        assert o["weights"]["expert_rows"] == max(1, int(mine[q].max()))
        assert o["weights"]["expert_rows"] <= cap
        if capacity == "no_drops":
            assert o["weights"]["expert_rows"] < cap // 4


def test_weights_form_over_pods_equals_world_one(tmp_path):
    """arctic smoke on a (pod, data, model) mesh of (2, 2, 1), batch 4 x
    ``2 · WEIGHTS_SEQ`` (one row a rank, as many rows as the (2, 1)
    cases': the rule gathers the slices over "data"), three sharded steps (``selftest.sharded_losses``): the
    train step sums the slices' gradients over "pod" only (each has seen
    its pod's every data rank through the width gather's
    reduce-scatter), so the losses are the world of one's within 1e-5
    relative; every rank holds the specs' share."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import optimizer as opt
    cfg = _weights_cfg((2, 1), "flat", "no_drops")
    seq, steps = 2 * WEIGHTS_SEQ, 3
    assert moe.width_form(seq, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                          cfg.top_k, 2, 4, 4, True) == "weights"
    outs = _spawn(tmp_path, selftest.sharded_losses, 4,
                  (cfg, (2, 2, 1), 4, seq, steps))
    model = Model(cfg, device=CPU,
                  generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = build_train_step(model, ocfg, opt.init(
        dict(model.named_parameters()), ocfg))
    data = selftest._batch(cfg, 4, seq, torch.device(CPU))
    single = [float(step(data)["loss"]) for _ in range(steps)]
    for o in outs:
        assert o["moe_width_forms"] == {"weights": steps * cfg.n_layers}
        assert o["param_bytes"] == o["spec_param_bytes"], o
        rel = np.abs(np.array(o["losses"]) - single) / np.abs(single)
        assert rel.max() <= RTOL, (o["losses"], single)
