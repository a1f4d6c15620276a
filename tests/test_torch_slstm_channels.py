"""The sLSTM's second split over "model" (``blocks.SlstmBlock``'s channels
split, the reference's split of ``r [4, H, hd, hd]`` on its ``hd`` output
axis), on the CPU: rank r of m computes the channels
``heads_split(hd, m, r)`` of every head and gate, uses ``r`` as stored
and gathers ``h`` at every step.

* The block with the channels split forced (``"activations"``) against
  the JAX package's block on the same numpy inputs, in fp32 at
  ``tests/test_torch_tp_heads.py``'s tolerance (each head's channels of
  the forward, concatenated over the ranks, through ``out``; every
  rank's block output and decode outputs), at m = 2, 4 and 8 (4 heads
  over 8 ranks, 2 channels each).
* ``blocks.slstm_split`` at xlstm's production shapes, from shapes only.
* Under the rule, a decode step on (1, 4) takes the channels split and
  gathers no leaf.
* A cache made in one split and stepped in the other raises.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import blocks, sharding
from repro_torch.models.blocks import heads_split
from test_torch_tp import F32
from test_torch_tp_heads import DECODE_STEPS, check_block_heads


def _assert_channels(outs, m, forward):
    """Every rank computed the channels ``heads_split(hd, m, r)`` of every
    head (``check_block_heads`` holds them) in its decode steps, and its
    forward in ``forward``; the decode steps gathered no leaf whole, each
    step exchanged ``wx``'s product and ``h`` once, and the "model"
    all-gathers moved exactly the bytes the rule counts."""
    for r, o in enumerate(outs):
        assert o["splits"] == dict(forward=forward, decode="channels"), o
        assert tuple(o["channels"]) == heads_split(16, m, r), o["channels"]
        assert o["heads_forms"] == {"activations": 2 * DECODE_STEPS}, \
            o["heads_forms"]
        assert o["leaf_gathers"] == {}, o["leaf_gathers"]
        assert o["model_bytes"]["all-gather"] == \
            o["heads_moved"]["activations"] > 0, o


@pytest.mark.parametrize("m", [2, 4, 8])
def test_channels_split_against_the_reference(tmp_path, m):
    """xlstm smoke (4 heads of 16) over m ranks, the channels split
    forced: 8, 4 or 2 channels of every head a rank; the forward's
    channels concatenated in head order, through ``out``, the block
    output and every decode output are the reference's."""
    outs = check_block_heads(tmp_path, "slstm", "xlstm-350m", m,
                             "activations")
    _assert_channels(outs, m, "channels")


def test_decode_under_the_rule_takes_the_channels_split(tmp_path):
    """On (1, 4) under the rule: the forward (2 rows x 32 tokens: 33
    collectives in the channels split against 3) keeps the heads split,
    a decode step (2 rows, 1 token) takes the channels split, and no
    decode step gathers ``r``."""
    outs = check_block_heads(tmp_path, "slstm", "xlstm-350m", 4)
    _assert_channels(outs, 4, "heads")


#: xlstm at full width: d 1,024, 4 heads of 256, 16 ranks, bf16
XLSTM = dict(d=1024, h=4, m=16, act_bytes=2, w_bytes=2)
#: the bytes of the rank's slice of r [4, 4, 256, 256/16] in bf16
R_SLICE = 4 * 4 * 256 * 16 * 2


@pytest.mark.parametrize("shape,rows,steps,h_bytes,rest_heads,rest,want", [
    # wx's and out's products at 8 rows, 256 columns each: 4,096 B each
    ("decode_32k", 8, 1, 2_048, 8_192, 4_096, "channels"),
    ("long_500k", 1, 1, 256, 1_024, 512, "channels"),
    # 65,536 rows·steps: wx's and out's slices gathered, 524,288 and
    # 131,072 B
    ("train_4k", 16, 4_096, 16_777_216, 655_360, 524_288, "heads"),
    ("prefill_32k", 2, 32_768, 16_777_216, 655_360, 524_288, "heads")])
def test_the_rule_at_the_production_shapes(shape, rows, steps, h_bytes,
                                           rest_heads, rest, want):
    """Rank 15's bytes a layer in each split, counted by hand: ``r``'s
    slice 131,072 B against ``h``'s 4 heads x 16 channels in fp32 at
    every row and step, each with ``wx``'s (and in the heads split
    ``out``'s) exchange in its cheaper form; the decode cells take the
    channels split, train and prefill the heads split."""
    args = (rows, steps, *XLSTM.values())
    assert blocks.slstm_split_bytes(*args) == dict(
        heads=R_SLICE + rest_heads, channels=h_bytes + rest)
    assert blocks.slstm_split(*args) == want


def test_the_rule_counts_the_collectives():
    """Fewer bytes alone do not take the channels split where it issues
    more collectives than the heads split's 3: xlstm smoke in fp32 on
    (1, 2), 2 rows, moves fewer bytes in the channels split at 1, 2 and
    32 steps, and takes it at 1 and 2 only."""
    smoke = dict(d=64, h=4, m=2, act_bytes=4, w_bytes=4)
    for steps, want in ((1, "channels"), (2, "channels"), (3, "heads"),
                        (32, "heads")):
        b = blocks.slstm_split_bytes(2, steps, *smoke.values())
        assert b["channels"] < b["heads"], (steps, b)
        assert blocks.slstm_split(2, steps, *smoke.values()) == want


def _block(m, form):
    """Rank 0's xlstm smoke sLSTM of a "model" group of ``m`` (fp32), in
    ``form``."""
    cfg = dataclasses.replace(smoke_config("xlstm-350m"), **F32)
    with sharding.build_shards(0, m):
        blk = blocks.SlstmBlock(cfg, generator=torch.Generator(
        ).manual_seed(0))
    blocks.force_heads_form(blk, form)
    return blk


@pytest.mark.parametrize("made,stepped", [("weights", "activations"),
                                          ("activations", "weights")])
def test_a_cache_of_the_other_split_raises(made, stepped):
    """A cache made in one split ([2, 2, 16] of rank 0's two heads, or
    [2, 4, 8] of its channels and ``h`` [2, 4, 16]) and stepped in the
    other raises before any collective."""
    blk = _block(2, made)
    cache = blk.init_cache(2, 4)
    want = {"weights": ((2, 2, 16), (2, 2, 16)),
            "activations": ((2, 4, 8), (2, 4, 16))}[made]
    assert (tuple(cache["c"].shape), tuple(cache["h"].shape)) == want
    blocks.force_heads_form(blk, stepped)
    with pytest.raises(ValueError, match="made in the other split"):
        blk.decode(cache, torch.zeros((2, 1, 64)), 0)
