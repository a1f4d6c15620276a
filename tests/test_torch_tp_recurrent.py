"""The recurrent blocks split by heads over "model" (``blocks.heads_split``;
Mamba-2's SSD heads, the sLSTM's heads; the mLSTM's heads and, where
they are fewer than the ranks, their value channels,
``blocks.value_split``), on the CPU: the
sharded train step of zamba2 and xlstm smoke against the world of one,
and each recurrent block's per-head outputs, concatenated over the
ranks, against the JAX package's block on the same numpy inputs
(``tests/test_torch_tp_heads.py``'s :func:`check_block_heads`).

xlstm is held at ``tests/test_torch_tp.py``'s bounds.  zamba2 is held
at the same bounds too, figure by figure and leaf by leaf, or, where a
leaf's figure is above its bound, within ``FLOOR_K`` times the world of
one's own fp32 floor for that leaf and figure
(``selftest.sharded_step_parity(floor=True)``: the world of one run
again from its embedding table one ulp up and one ulp down, the larger
of the two differences; ``selftest.beyond_floor``).  Mamba-2's per-head
fp32 scalars ``a_log``, ``d_skip`` and ``dt_bias`` take gradients that
are sums over every token with heavy cancellation, so that any other
fp32 order of the same sums moves them by more than the 1e-5 bound: the
world of one run one ulp apart does (up to 11x the bound here), and so
does the world of one with a single ``out_proj`` product split in two
halves (the mathematically identical sum a row-parallel product
computes); AdamW's first update carries that into the leaves, which
start at 0 for ``a_log`` and ``dt_bias``.  ``FLOOR_K`` is set from
readings: the sharded run's figures above their bound sat at most 2.15x
their floor over these four cases, 2.5x at full width on an H100.  A
floor whose ``FLOOR_K`` times reaches a tenth of its leaf opens no way
past the bound.  The loss (1e-5) and the first update's prediction
(1e-6 of each leaf's largest element) hold unconditionally.  Every rank
other than rank 0 also holds its copies of the leaves ranks hold alike
(the norms, Mamba-2's scalars and ``conv_w``) and of their gradients to
rank 0's, bit for bit (``selftest._replicas_checked``).
"""
import pytest
import torch

from repro_torch.distributed import selftest
from repro_torch.models.blocks import (_mamba_dims, _mlstm_dims,
                                       heads_split, value_split)
from repro_torch.models.model import Leaf
from repro_torch.models.sharding import P
from test_torch_tp import (FIRST_STEP_MAX, GRAD_MAX_RTOL, LEAF_MAX_RTOL,
                           RTOL, _assert_parity, _cfg, _spawn)
from test_torch_tp_heads import check_block_heads

#: the bound of each figure of ``selftest.FIGURES``: the file's
BOUNDS = dict(loss_rel_err=RTOL, grad_rel_norm=RTOL,
              grad_err_over_max=GRAD_MAX_RTOL, leaf_rel_norm=RTOL,
              leaf_err_over_max=LEAF_MAX_RTOL)
#: a figure above its bound is held within this many times the world of
#: one's own floor for it (two runs one ulp apart, the larger)
FLOOR_K = 4.0
#: zamba2 smoke at d_model 128 and ssm_state 14: ``in_proj``'s width
#: 2·256 + 28 + 4 = 544 divides by 16, so its spec shards it (as at full
#: width) and its slice is not the rank's [z | x | B C | dt] columns
ZAMBA2_SHARDED_IN_PROJ = dict(d_model=128, ssm_state=14)


def _heads(cfg, kind):
    return _mamba_dims(cfg)[2] if kind == "Mamba2Block" else cfg.n_heads


def _assert_shards(outs, cfg, m):
    """Every rank holds the specs' share and computes its heads (an
    mLSTM's heads and value channels); every rank but rank 0 compared its
    copies of the leaves held alike."""
    for r, o in enumerate(outs):
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["not_the_share"] == [], o
        assert o["replica_checks"] > 0 or r == 0, o["replica_checks"]
        for kind, got in o["heads"].items():
            if kind == "MlstmBlock":
                assert got["heads"] + got["channels"] == list(value_split(
                    cfg.n_heads, _mlstm_dims(cfg)[2], m, r % m)), got
            else:
                assert got["heads"] == list(heads_split(
                    _heads(cfg, kind), m, r % m)), (kind, got)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2), (1, 8)])
def test_xlstm_step_equals_world_one(tmp_path, mesh):
    """xlstm smoke (4 heads) on each mesh: 2 or 1 heads a rank, and on
    (1, 8) two ranks an mLSTM head (half its value channels each) and
    every other rank no sLSTM head; the step equals the world of one."""
    cfg = _cfg("xlstm-350m")
    outs = _spawn(tmp_path, selftest.sharded_step_parity,
                  mesh[0] * mesh[1], (cfg, mesh, 4, 32, 2))
    _assert_parity(outs)
    _assert_shards(outs, cfg, mesh[1])


@pytest.mark.parametrize("mesh,kw", [
    ((1, 2), {}), ((1, 4), {}), ((2, 2), {}),
    ((1, 4), ZAMBA2_SHARDED_IN_PROJ)])
def test_zamba2_step_equals_world_one(tmp_path, mesh, kw):
    """zamba2 smoke (2 Mamba-2 heads, or 4 at d_model 128; 4 shared
    attention heads) on each mesh: on (1, 4) ranks 0 and 2 compute no
    Mamba-2 head; the step equals the world of one, each figure at its
    bound or within ``FLOOR_K`` of the world of one's own floor."""
    cfg = _cfg("zamba2-2.7b", **kw)
    outs = _spawn(tmp_path, selftest.sharded_step_parity,
                  mesh[0] * mesh[1], (cfg, mesh, 4, 32, 2, 1e-3, True))
    for o in outs:
        assert o["loss_rel_err"] <= RTOL, o["loss_rel_err"]
        assert o["first_step_unexplained_over_max"] <= FIRST_STEP_MAX, o
        assert selftest.beyond_floor(o, BOUNDS, FLOOR_K) == []
    _assert_shards(outs, cfg, mesh[1])
    if kw:
        assert "blocks.0.in_proj" in outs[0]["leaf_gathers"]["model"]


@pytest.mark.parametrize("kind,arch,m", [
    ("mamba2", "zamba2-2.7b", 4), ("mlstm", "xlstm-350m", 8),
    ("slstm", "xlstm-350m", 8)])
def test_recurrent_heads_against_the_reference(tmp_path, kind, arch, m):
    """Each recurrent block over m ranks, some of which compute no head
    (2 Mamba-2 heads over 4, 4 sLSTM heads over 8), or, the mLSTM's 4
    heads over 8, two ranks a head, half its value channels each: the
    ranks' per-head outputs concatenated, through the whole
    out-projection with the residual, are the reference's block output;
    every rank's block and decode outputs are the reference's."""
    check_block_heads(tmp_path, kind, arch, m)


def test_sharded_losses_are_the_parity_runs(tmp_path):
    """``selftest.sharded_losses`` (the sharded steps alone, as
    ``chip_smoke.py`` runs xlstm at full depth) takes the parity run's
    sharded steps: the same losses, bit for bit, every rank's alike,
    and the specs' share and heads on each rank."""
    cfg = _cfg("xlstm-350m")
    args = (cfg, (1, 2), 4, 32, 2)
    alone = _spawn(tmp_path, selftest.sharded_losses, 2, args)
    both = _spawn(tmp_path, selftest.sharded_step_parity, 2, args)
    for a, b in zip(alone, both):
        assert a["losses"] == b["losses_sharded"], (a["losses"], b)
        assert a["param_bytes"] == b["param_bytes"] == b["spec_param_bytes"]
        assert a["heads"] == b["heads"]


@pytest.mark.parametrize("floor,passes", [
    (None, False), (2e-6, False), (4e-6, True), (3e-2, False)])
def test_a_floor_opens_a_way_only_while_it_is_small(floor, passes):
    """A gradient figure 1.5e-5 against its 1e-5 bound: without a floor it
    fails; within ``FLOOR_K`` times a floor of 4e-6 it passes, not of
    2e-6; a floor whose ``FLOOR_K`` times reaches ``FLOOR_CAP`` of the
    leaf opens no way, however far the figure sits under it."""
    figures = {f: {"w": 0.0} for f in selftest.FIGURES}
    figures["grad_rel_norm"]["w"] = 1.5e-5
    out = dict(figures=figures)
    if floor is not None:
        out["floors"] = {f: {"w": floor} for f in selftest.FIGURES}
    beyond = selftest.beyond_floor(out, BOUNDS, FLOOR_K)
    assert beyond == ([] if passes else
                      [("grad_rel_norm", "w", 1.5e-5, floor or 0.0)])


def _replicas_of(off):
    """A (1, 2) mesh: a leaf held whole on both ranks (a norm's), the same
    on each but for one element one ulp up on rank ``off``, and a leaf
    sliced over "model", which differs between the ranks by design."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding
    mesh = make_test_mesh((1, 2), ("data", "model"))
    rank = dist.get_rank()
    whole = torch.ones(8)
    if rank == off:
        whole[3] = torch.nextafter(whole[3], torch.tensor(2.0))
    layout = dict(ln=Leaf(P(None), None, None, None),
                  w=Leaf(P("model"), 0, None, None))
    return selftest._replicas_checked(
        dict(ln=whole, w=torch.full((4,), float(rank))), layout,
        sharding.mesh_axis(mesh, "model"), sharding.mesh_axis(mesh, "data"),
        "step 1")


@pytest.mark.parametrize("off", [None, 0, 1])
def test_copies_held_alike_are_compared_bit_for_bit(tmp_path, off):
    """Rank 1's copy of a whole leaf is held to rank 0's: equal copies
    pass (one compared, on rank 1; the sliced leaf is not a copy), and
    one ulp apart on either rank fails every rank, naming rank 1."""
    if off is None:
        assert _spawn(tmp_path, _replicas_of, 2, (off,)) == [0, 1]
        return
    with pytest.raises(RuntimeError, match=r"\(1, 'ln'\)"):
        _spawn(tmp_path, _replicas_of, 2, (off,))
