"""Tensor- and data-parallel compute of the PyTorch port's multi-device
training path (``models.sharding``'s collectives, ``Model(cfg, tp=...)``,
``Model.layout``, the expert- and data-parallel ``models.moe``,
``launch.steps.build_sharded_train_step``), on the CPU.

``tests/test_torch_tp_mesh.py`` holds the (2, 2) mesh and a sharded
checkpoint's resume, ``tests/test_torch_moe_dp.py`` the mixture-of-experts
on a data-sharded mesh, with this file's helpers and tolerances.

The multi-rank tests start gloo ranks, one process each
(``distributed.launch.spawn``), with a ``FileStore`` under the test's
``tmp_path`` and a time limit of 240 s each, and hold the sharded step
against the world of one in fp32: every loss within 1e-5 relative; the
first step's gradients (averaged over "data", gathered whole) within
1e-5 relative in norm and 1e-4 of each leaf's largest element (the
card's gradient tolerance in ``chip_smoke.py``'s ``train`` line); and
after the last step every parameter leaf within 1e-5 relative in norm
(``|a - b| / |a|``), and every element within 1e-3 of its leaf's largest
element.  AdamW's update divides by each element's own gradient scale,
so an element whose gradient is near 0 turns a last-bit difference in
the gradient's summation order (the shards' products and the
all-reduces sum in another order) into a step of up to 2·lr (lr 1e-3
here): the norm bounds the whole leaf, the element bound one such
step.  After the first step, that difference is predicted element by
element from the two runs' gradients (``selftest._first_step``), and
what the prediction leaves is held within 1e-6 of each leaf's largest
element: a wrong sharded update of any element shows there.  (The data-parallel step's differences stay within 1e-4 of the
largest element, as ``test_torch_distributed.py`` holds them; the
tensor-parallel ones reach 1.3e-4 on some ``wk``.)  The world of one is itself held against the JAX package's step
by ``tests/test_torch_train.py``, ``test_torch_moe.py``,
``test_torch_encdec.py`` and ``test_torch_vlm.py``
(``test_torch_moe_dp.py`` ties the two again on the MoE config its
data-parallel tests use).

The smoke configs' 8 experts do not divide the production degree 16, so
their specs replicate the experts; the expert-parallel cases raise the
count to 16 (``E16``), which the specs then shard over "model".
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import selftest
from repro_torch.distributed.launch import spawn
from repro_torch.launch.specs import state_bytes_by_specs
from repro_torch.models import blocks, sharding
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import Leaf, Model

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: a hang guard: a rank here takes 5-20 s alone, several times that
#: while the other test files' workers share the host's cores
RANK_TIMEOUT = 240.0
RTOL = 1e-5
LEAF_MAX_RTOL = 1e-3
GRAD_MAX_RTOL = 1e-4
FIRST_STEP_MAX = 1e-6


def _spawn(tmp_path, fn, world, args=()):
    return spawn(fn, world, args, device_type=CPU, timeout=RANK_TIMEOUT,
                 store_dir=str(tmp_path))


def _cfg(arch, **kw):
    return dataclasses.replace(smoke_config(arch), **F32, **kw)


def _assert_parity(outs):
    for o in outs:
        assert {"worst_grad_leaf", "worst_leaf"} <= set(o), o
        assert o["loss_rel_err"] <= RTOL, o
        assert o["worst_grad_rel_norm"] <= RTOL, o
        assert o["worst_grad_err_over_max"] <= GRAD_MAX_RTOL, o
        assert o["worst_leaf_rel_norm"] <= RTOL, o
        assert o["worst_leaf_err_over_max"] <= LEAF_MAX_RTOL, o
        assert o["first_step_unexplained_over_max"] <= FIRST_STEP_MAX, o


# --------------------------------------------------- fault (b): "model"

#: the five configs of the tensor-parallel parity (smoke widths, fp32)
TP_CONFIGS = {
    "mistral-nemo-12b": {},
    # sliding window; one super-block (5 local + 1 global layers)
    "gemma3-12b": dict(n_super=1),
    "qwen2-vl-7b": {},                  # GQA, M-RoPE, the frontend
    "arctic-480b": dict(n_experts=16),  # experts over "model", dense FFN
    "seamless-m4t-large-v2": {},        # encoder, cross-attention
}


@pytest.mark.parametrize("mesh", [(1, 2)])
@pytest.mark.parametrize("arch", sorted(TP_CONFIGS))
def test_tensor_parallel_step_equals_world_one(tmp_path, arch, mesh):
    """Each rank holds only its shards and computes on them: the losses
    and the updated leaves equal the world of one's; every rank's
    parameter bytes are the specs' share over "model" (but for the
    leaves the layout holds whole); no attention, MLP, MoE or embedding
    leaf is gathered over "model"."""
    cfg = _cfg(arch, **TP_CONFIGS[arch])
    outs = _spawn(tmp_path, selftest.sharded_step_parity, mesh[0] * mesh[1],
                  (cfg, mesh, 4, 32, 2))
    _assert_parity(outs)
    for o in outs:
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["not_the_share"] == [], o
        assert "model" not in o["leaf_gathers"], o


@pytest.mark.parametrize("heads,gathered", [
    ((4, 2), ("wk", "wv")),
    ((2, 2), ("wq", "wk", "wv", "wo")),
])
def test_heads_that_do_not_split_are_gathered_at_use(tmp_path, heads,
                                                    gathered):
    """mistral smoke on a (1, 4) mesh with heads that do not split whole
    over 4, computed on shards all the same (``blocks.heads_split``).  4
    query heads over 2 K/V heads: each rank computes one query head and
    the K/V head it reads, so ``wq`` / ``wo`` are used as stored and
    ``wk`` / ``wv`` gathered at use and cut to that head (their gradients
    reduce-scattered back).  2 query heads: ranks 1 and 3 compute one
    each, ranks 0 and 2 none (their share of the row-parallel sum is
    zeros), and all four leaves are gathered at use and cut.  Either way
    the leaves stay sharded in storage, each is gathered once a step
    (the smoke config does not remat), and the step equals the world of
    one."""
    cfg = _cfg("mistral-nemo-12b", n_heads=heads[0], n_kv_heads=heads[1])
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 4,
                  (cfg, (1, 4), 4, 32, 1))
    _assert_parity(outs)
    got = outs[0]["leaf_gathers"]["model"]
    assert got == {f"blocks.{i}.attn.{w}": 1 for i in range(2)
                   for w in gathered}
    for r, o in enumerate(outs):
        assert o["param_bytes"] == o["spec_param_bytes"]
        lo, hi = o["heads"]["_AttnParams"]["heads"]
        assert (lo, hi) == (heads[0] * r // 4, heads[0] * (r + 1) // 4)
        assert o["heads"]["_AttnParams"]["leaves"]["wq"] == [
            64, heads[0] * 16 // 4]


def test_recurrent_leaves_are_held_whole_and_gathered_at_step(tmp_path):
    """xlstm smoke on (1, 2): the recurrent blocks compute on shards,
    each rank two of the 4 heads of every mLSTM and sLSTM block; every
    leaf is held as the specs' share (none whole, none gathered by the
    step); the leaves whose slice is not the part the rank's heads read
    (``up``'s x half and its z channels, ``wx``'s four gates, ``r``
    sliced by its output width, ``out`` by its columns) are gathered at
    use, once a step; the vocab-parallel tied embedding is sharded; the
    step equals the world of one."""
    cfg = _cfg("xlstm-350m")
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 2,
                  (cfg, (1, 2), 4, 32, 1))
    _assert_parity(outs)
    for r, o in enumerate(outs):
        assert o["param_bytes"] == o["spec_param_bytes"]
        assert o["not_the_share"] == []
        assert {k: v["heads"] for k, v in o["heads"].items()} == {
            "MlstmBlock": [2 * r, 2 * r + 2],
            "SlstmBlock": [2 * r, 2 * r + 2]}
    assert outs[0]["leaf_gathers"]["model"] == {
        f"blocks.{i}.{w}": 1 for i in range(4)
        for w in (("up",) if i % 2 == 0 else ("wx", "r", "out"))}


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "xlstm-350m"])
def test_embedding_sharded_by_width(tmp_path, arch):
    """``embed_shard="dmodel"`` (the reference's perf variant): the table
    is sharded by width, its lookup gathered over "model"; tied
    (xlstm) it is gathered whole for the logits.  The step on (1, 2)
    equals the world of one."""
    cfg = _cfg(arch, embed_shard="dmodel")
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 2,
                  (cfg, (1, 2), 4, 32, 1))
    _assert_parity(outs)


# --------------------------------------------------- build on shards


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_shards_concatenate_to_the_one_device_leaves(arch, m):
    """``Model(cfg, tp=(r, m))`` for every rank r: each sliced leaf's
    shards concatenated along its "model" dimension equal the one-device
    model's leaf bit for bit (the world of one's draws); the others are
    that leaf itself."""
    cfg = smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=16)
    whole = dict(Model(cfg, device=CPU).named_parameters())
    parts = [Model(cfg, device=CPU, tp=(r, m)) for r in range(m)]
    layout = parts[0].layout()
    for n, w in whole.items():
        dim = layout[n].shard_dim
        got = [dict(p.named_parameters())[n] for p in parts]
        if dim is None:
            assert all(torch.equal(g, w) for g in got), n
        else:
            assert torch.equal(torch.cat(got, dim=dim), w), n


def test_first_step_prediction_holds_a_flip_and_shows_a_wrong_update():
    """``selftest._first_step``: two runs from the same leaves whose
    gradients differ in the last bits, one element's sign flipped (its
    AdamW step turns by 2·lr): the prediction explains their difference
    to rounding; a wrong update of one element is left unexplained."""
    from repro_torch.optim import optimizer as opt
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(64, 8, generator=gen) * 0.02
    g_one = torch.randn(64, 8, generator=gen) * 1e-3
    g_one[3, 4] = 1e-6
    g = g_one * (1 + 1e-7)
    g[3, 4] = -1e-6
    runs, ks = [], []
    for grads in (g_one, g):
        p = p0.clone()
        state = opt.init({"w": p}, ocfg)
        opt.apply({"w": p}, {"w": grads}, state, ocfg)
        runs.append(p)
        ks.append(opt.step_scalars(opt.OptState(
            torch.zeros((), dtype=torch.int32), {}, {}),
            opt.global_norm([grads]), ocfg))
    layout = {"w": Leaf(None, None, None, None)}
    assert float((runs[1] - runs[0]).abs().max()) > 1e-3  # the flip
    got = selftest._first_step({"w": runs[0]}, {"w": runs[1]}, layout,
                               None, {"w": g_one}, {"w": g}, ks, ocfg)
    assert got["first_step_unexplained_over_max"] <= FIRST_STEP_MAX
    wrong = runs[1].clone()
    wrong[7, 1] += 1e-4
    got = selftest._first_step({"w": runs[0]}, {"w": wrong}, layout, None,
                               {"w": g_one}, {"w": g}, ks, ocfg)
    assert got["first_step_unexplained_over_max"] > 1e-3


def test_shard_of_a_width_that_does_not_split_raises():
    with pytest.raises(ValueError, match="does not split over 3"):
        sharding.shard_of(torch.zeros(4, 8), 1, 0, 3)


#: the leaves each config gathers at use at a "model" dimension of 16,
#: by kind: ``wk`` / ``wv`` where the K/V heads do not split (8 of
#: them), all four attention leaves where the query heads split unevenly
#: (56, 28 and 36 of them), ``in_proj`` of Mamba-2 (its packed
#: ``[z | x | B C | dt]``), every leaf of the xLSTM's blocks but the
#: norm and the gates (4 heads of 512 / 256 over 16 ranks), except the
#: mLSTM's ``wv`` and ``down``, whose stored slices are the value
#: channels the rank computes (``blocks.value_split``); seamless's 16
#: query and K/V heads split whole
ALL_AT_16 = {"wq", "wk", "wv", "wo"}
USE_AT_16 = {"arctic-480b": ALL_AT_16, "command-r-35b": {"wk", "wv"},
             "gemma3-12b": {"wk", "wv"}, "kimi-k2-1t-a32b": {"wk", "wv"},
             "mistral-nemo-12b": {"wk", "wv"}, "qwen2-vl-7b": ALL_AT_16,
             "seamless-m4t-large-v2": set(), "starcoder2-7b": ALL_AT_16,
             "xlstm-350m": {"up", "wq", "wk", "wx", "r", "out"},
             "zamba2-2.7b": {"in_proj"}}


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_layout_at_the_production_degree(arch):
    """``Model.layout`` on the full config at tp (0, 16) and (15, 16),
    built on ``meta``: the one rule of what is gathered at use, pinned;
    no leaf is held whole where its spec names "model", so each rank's
    parameters are the specs' share; every block computes at most
    ``⌈h/16⌉`` of its ``h`` heads, the last rank exactly that many: the
    heads of ``blocks.heads_split``, and in an mLSTM block the heads and
    value channels of ``blocks.value_split`` (xlstm: head ⌊r/4⌋,
    channels ``[(r%4)·128, +128)``, so rank 0 computes head 0 too)."""
    cfg = get_config(arch)
    whole = dict(Model(cfg, device="meta").named_parameters())
    for rank in (0, 15):
        m = Model(cfg, device="meta", tp=(rank, 16))
        layout = m.layout()
        assert {leaf.gather for leaf in layout.values()} <= {None, "use"}
        use = {n for n, leaf in layout.items() if leaf.gather == "use"}
        assert {n.rsplit(".", 1)[1] for n in use} == USE_AT_16[arch]
        for n, leaf in layout.items():
            assert (leaf.shard_dim is None) == (
                sharding.model_dim(leaf.spec) is None), n
            if ".moe.w" in n and n[-2:] != "wg":
                assert leaf.data_dim is not None and leaf.shard_dim == 0, n
            if n in ("embed", "unembed"):
                assert leaf.shard_dim is not None and leaf.gather is None, n
        chans = m.computed_channels()
        for name, (lo, hi) in m.computed_heads().items():
            mod = m.get_submodule(name)
            h = blocks._mamba_dims(cfg)[2] if isinstance(
                mod, blocks.Mamba2Block) else cfg.n_heads
            if isinstance(mod, blocks.MlstmBlock):
                hd = blocks._mlstm_dims(cfg)[2]
                assert (lo, hi, *chans[name]) == blocks.value_split(
                    h, hd, 16, rank), name
                if h < 16:
                    assert (lo, *chans[name]) == (
                        rank // 4, rank % 4 * 128, rank % 4 * 128 + 128)
            else:
                assert name not in chans, name
                assert (lo, hi) == blocks.heads_split(h, 16, rank), name
            assert hi - lo <= math.ceil(h / 16), name
            if rank == 15:
                assert hi - lo == math.ceil(h / 16), name
        assert sum(p.numel() * p.element_size() for p in m.parameters()) \
            == state_bytes_by_specs(m, {"data": 1, "model": 16})[0]
        assert all(p.device.type == "meta" for p in m.parameters())
        assert m.whole_shapes() == {n: tuple(p.shape)
                                    for n, p in whole.items()}


def test_a_sharded_model_runs_only_inside_its_group():
    cfg = _cfg("mistral-nemo-12b")
    m = Model(cfg, device=CPU, tp=(0, 2))
    with pytest.raises(RuntimeError, match="group of 2"):
        m(torch.zeros(1, 8, dtype=torch.long))


def test_collectives_are_the_identity_without_an_axis():
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (sharding.copy_to_model, sharding.reduce_from_model,
               sharding.sum_over_data):
        assert fn(x) is x
    assert sharding.gather_from_model(x, 1) is x
    assert sharding.all_reduce(x, None) is x
    assert sharding.reduce_scatter(x, None) is x


def test_reference_weights_load_onto_shards():
    """``load_jax_params`` onto each rank of a (1, 2) model slices the
    reference's leaves as the build slices its draws: the shards equal
    the one-device model's loaded leaves, sliced."""
    cfg = _cfg("arctic-480b", n_experts=16)
    ref_cfg = dataclasses.replace(ref_smoke_config("arctic-480b"), **F32,
                                  n_experts=16)
    tree = jax.tree.map(np.asarray, RefModel(ref_cfg).init(
        jax.random.PRNGKey(3)))
    whole = dict(load_jax_params(Model(cfg, device=CPU), tree)
                 .named_parameters())
    for r in range(2):
        part = load_jax_params(Model(cfg, device=CPU, tp=(r, 2)), tree)
        layout = part.layout()
        for n, p in part.named_parameters():
            want = whole[n]
            if layout[n].shard_dim is not None:
                want = sharding.shard_of(want, layout[n].shard_dim, r, 2)
            assert torch.equal(p, want), n
