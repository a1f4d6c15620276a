"""The two forms of a leaf whose stored "model" slice is not the part its
rank's heads read (``blocks._Heads.product``, ``blocks.heads_form``), on
the CPU: the leaf gathered whole and cut (``"weights"``), or the product
of the stored slice exchanged (``"activations"``: a column leaf's
product columns gathered, a row leaf's head outputs gathered and its
stored rows' product summed as before).

* Each block kind, the activations form forced, against the JAX
  package's block on the same numpy inputs (forward and decode, at
  ``tests/test_torch_tp_heads.py``'s tolerance), on (1, 2), (1, 4) and a
  mesh where some rank computes no head; the decode steps' calls took
  the activations form wherever a leaf has it (the sLSTM: its channels
  split, ``h`` exchanged in place of ``r`` gathered), and their "model"
  all-gathers moved what the rule counts.
* One sharded train step of zamba2 and xlstm smoke, the activations
  form forced (its backward reduce-scatters the products' gradients),
  against the world of one at ``tests/test_torch_tp.py``'s bounds
  (zamba2's gradients as ``tests/test_torch_tp_recurrent.py`` holds
  them: at the bound or within ``FLOOR_K`` of its own fp32 floor).
* The rule against hand arithmetic at the production mesh's shapes.
"""
import pytest

from repro_torch.distributed import selftest
from repro_torch.models import blocks
from test_torch_tp import (FIRST_STEP_MAX, GRAD_MAX_RTOL, RTOL, _cfg,
                           _spawn)
from test_torch_tp_heads import check_block_heads
from test_torch_tp_recurrent import BOUNDS, FLOOR_K, ZAMBA2_SHARDED_IN_PROJ

#: (kind, arch, m, config changes, the leaves whose exchange has two
#: forms there): each kind on (1, 2), (1, 4), and 2 heads over 4 ranks,
#: where some rank computes no head (the mLSTM's ranks share a head)
BLOCK_CASES = [
    # 10 query heads over 5 K/V heads: 5 a rank reading 3 K/V heads
    # where the stored slice is 2.5; then 2, 3, 2, 3 a rank
    ("attn", "mistral-nemo-12b", 2, dict(n_heads=10, n_kv_heads=5),
     {"wk", "wv"}),
    ("attn", "mistral-nemo-12b", 4, dict(n_heads=10, n_kv_heads=5),
     {"wq", "wk", "wv", "wo"}),
    ("attn", "mistral-nemo-12b", 4, dict(n_heads=2, n_kv_heads=2),
     {"wq", "wk", "wv", "wo"}),
    # d_model 128: in_proj 544 wide, sharded, 4 heads; ssm_state 15 at
    # d_model 64: in_proj 288 wide, 2 heads, out_proj's rows uneven
    ("mamba2", "zamba2-2.7b", 2, ZAMBA2_SHARDED_IN_PROJ, {"in_proj"}),
    ("mamba2", "zamba2-2.7b", 4, ZAMBA2_SHARDED_IN_PROJ, {"in_proj"}),
    ("mamba2", "zamba2-2.7b", 4, dict(ssm_state=15),
     {"in_proj", "out_proj"}),
    ("mlstm", "xlstm-350m", 2, {}, {"up"}),
    ("mlstm", "xlstm-350m", 4, {}, {"up"}),
    # 2 heads over 4 ranks: two ranks a head, half its value channels
    # each (``blocks.value_split``), which are the stored slices of
    # ``wv`` and ``down``
    ("mlstm", "xlstm-350m", 4, dict(n_heads=2), {"up", "wq", "wk"}),
    # the sLSTM in its channels split (``blocks.slstm_split``): ``wx``'s
    # product, and ``h`` at every step in place of ``r``; ``out`` takes
    # the whole ``h`` and exchanges nothing
    ("slstm", "xlstm-350m", 2, {}, {"wx", "r"}),
    ("slstm", "xlstm-350m", 4, {}, {"wx", "r"}),
    ("slstm", "xlstm-350m", 4, dict(n_heads=2), {"wx", "r"}),
]


def _ids(case):
    kind, _, m, kw, _ = case
    return f"{kind}-m{m}" + "".join(f"-{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("case", BLOCK_CASES, ids=_ids)
def test_activations_form_against_the_reference(tmp_path, case):
    """The block with the activations form forced is the reference's
    (per-head outputs, block output, decode outputs:
    ``check_block_heads``); in its decode steps every call on a leaf that
    has two forms took the activations form (the sLSTM's ``r``: ``h``
    exchanged, no leaf gathered whole), and the "model" all-gathers
    moved exactly the bytes the rule counts for the forms taken."""
    kind, arch, m, kw, leaves = case
    outs = check_block_heads(tmp_path, kind, arch, m, "activations", **kw)
    for o in outs:
        # one call a leaf a step, none gathered whole
        assert o["heads_forms"] == {"activations": len(leaves) * 4}, \
            o["heads_forms"]
        assert o["leaf_gathers"] == {}, o["leaf_gathers"]
        assert o["model_bytes"]["all-gather"] == sum(
            o["heads_moved"].values()) > 0, o


@pytest.mark.parametrize("kind,arch,m,kw", [
    ("mamba2", "zamba2-2.7b", 2, ZAMBA2_SHARDED_IN_PROJ),
    ("mlstm", "xlstm-350m", 4, dict(n_heads=2))])
def test_the_rule_takes_the_activations_form_at_decode(tmp_path, kind, arch,
                                                       m, kw):
    """Under the rule, a decode step's 2 rows take the activations form
    on every leaf that has it; the forward's rows may take either."""
    outs = check_block_heads(tmp_path, kind, arch, m, None, **kw)
    for o in outs:
        assert set(o["heads_forms"]) == {"activations"}, o["heads_forms"]
        assert o["model_bytes"]["all-gather"] == \
            o["heads_moved"]["activations"], o


@pytest.mark.parametrize("arch,kw", [
    ("zamba2-2.7b", ZAMBA2_SHARDED_IN_PROJ), ("xlstm-350m", {})])
def test_activations_form_step_equals_world_one(tmp_path, arch, kw):
    """One sharded step on (1, 2), the activations form forced (128 rows
    a rank, under the 544 / 256 columns of zamba2's ``in_proj`` and
    xlstm's ``up`` / ``wx``: the products' gradients reduce-scattered
    backward) against the world of one: the loss and the first update at
    ``tests/test_torch_tp.py``'s bounds, the gradients too (zamba2's as
    ``tests/test_torch_tp_recurrent.py`` holds them in either form: at
    the bound or within ``FLOOR_K`` of the world of one's own fp32
    floor, since Mamba-2's per-head scalars take their gradients with
    heavy cancellation); every rank holds the specs' share, and no leaf
    was gathered whole (the sLSTM in its channels split: ``h`` gathered
    at every token, its gradient reduce-scattered back)."""
    cfg = _cfg(arch, **kw)
    floor = arch == "zamba2-2.7b"
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 2,
                  (cfg, (1, 2), 4, 32, 1, 1e-3, floor, "activations"))
    for o in outs:
        assert o["loss_rel_err"] <= RTOL, o
        assert o["first_step_unexplained_over_max"] <= FIRST_STEP_MAX, o
        if floor:
            assert selftest.beyond_floor(o, BOUNDS, FLOOR_K) == []
        else:
            assert o["worst_grad_rel_norm"] <= RTOL, o
            assert o["worst_grad_err_over_max"] <= GRAD_MAX_RTOL, o
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["heads_forms"].get("activations", 0) > 0, o["heads_forms"]
        gathered = {n.rsplit(".", 1)[1]
                    for n in o["leaf_gathers"].get("model", {})}
        assert gathered == set(), gathered


# the production mesh's rows a rank: decode_32k (batch 128 over 16 data
# ranks) and train_4k (256 x 4,096 over 16); bf16 weights and products
DECODE_ROWS, TRAIN_ROWS, BF16 = 8, 65_536, 2


@pytest.mark.parametrize("leaf,shape,share", [
    # zamba2 in_proj [2560, 2·5120 + 2·64 + 80]: 653 columns a rank
    ("in_proj", (2560, 10_448), 653),
    # xlstm's sLSTM wx [1024, 4096]: 256 columns a rank
    ("wx", (1024, 4096), 256),
    # arctic wq [7168, 56·128]: 448 columns a rank
    ("wq", (7168, 7168), 448),
    # arctic wo [56·128, 7168], row-parallel: ⌈56/16⌉ = 4 heads of 128
    ("wo", (7168, 7168), 512)])
def test_the_rule_against_hand_arithmetic(leaf, shape, share):
    """Each form's forward bytes for one call at decode_32k and at
    train_4k on 16x16, counted by hand: at decode the activations form,
    at train the weights form."""
    d_in, width = shape
    m = 16
    sl = d_in * width // m * BF16               # the stored slice
    args = (d_in, width, m, BF16, BF16, share)
    for rows, form in ((DECODE_ROWS, "activations"), (TRAIN_ROWS, "weights")):
        got = blocks.heads_form_bytes(rows, *args)
        assert got == dict(weights=sl, activations=rows * share * BF16)
        assert blocks.heads_form(rows, *args) == form


def test_the_rule_hand_arithmetic_in_numbers():
    """zamba2's ``in_proj`` at decode_32k, in numbers: 3,343,360 bytes of
    slice against 10,448 of products (the ~45 calls of a step then move
    ~4.7e5 bytes); and a tie, rows equal to ``d_in``, keeps the weights
    form."""
    assert blocks.heads_form_bytes(8, 2560, 10_448, 16, 2, 2) == dict(
        weights=3_343_360, activations=10_448)
    tie = blocks.heads_form_bytes(2560, 2560, 10_448, 16, 2, 2)
    assert tie["weights"] == tie["activations"]
    assert blocks.heads_form(2560, 2560, 10_448, 16, 2, 2) == "weights"
    assert blocks.heads_form(2559, 2560, 10_448, 16, 2, 2) == "activations"


def test_an_unknown_form_is_refused():
    with pytest.raises(ValueError, match="unknown heads form"):
        blocks.force_heads_form(blocks._Heads(), "columns")
