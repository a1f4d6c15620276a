"""The mLSTM's value channels split over the ranks that share a head
(``blocks.value_split``), on the CPU: where the heads are fewer than the
"model" ranks, each rank of a head computes its q, k, gates and
normalizer whole and its own value channels of v, z and ``down``'s rows.

* ``ssm.mlstm_chunked`` / ``mlstm_decode_step`` on v cut to the channels
  ``[a, b)`` give the whole run's channels ``[a, b)`` (fresh numpy seeds,
  fp32): against the port's whole run at ``CUT_TOL`` (the same sums, the
  products split by columns), against the JAX package's at
  ``tests/test_torch_ssm.py``'s 1e-5; with every channel, bit for bit the
  function as it stood before v's width could differ from q's
  (:func:`_mlstm_chunked_before`).
* An mLSTM block on 3 ranks with 2 heads (groups of 2 and 1: 48, 48 and
  96 channels) against the JAX block, forward and decode, in each heads
  form, at ``tests/test_torch_tp_heads.py``'s ``TOL``.
* One sharded train step of xlstm smoke on (1, 8) (two ranks an mLSTM
  head) against the world of one at ``tests/test_torch_tp.py``'s bounds:
  the loss, the first step's gradients (each rank's partial gradients of
  its head's q, k, gates and normalizer summed), the first update
  explained.
* :func:`blocks.value_split` against hand arithmetic.
"""
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as ref_ssm
from repro_torch.distributed import selftest
from repro_torch.models import ssm
from repro_torch.models.attention import _scale
from repro_torch.models.blocks import value_split
from test_torch_tp import (FIRST_STEP_MAX, GRAD_MAX_RTOL, RTOL, _cfg,
                           _spawn)
from test_torch_tp_heads import check_block_heads

#: the port's cut run against its whole run, fp32
CUT_TOL = 1e-6
#: the port's cut run against the JAX package's whole run
#: (``tests/test_torch_ssm.py``'s functions' tolerance)
REF_TOL = 1e-5
#: q / k width N, heads H, batch B, positions S (3 chunks of 8)
N, H, B, S, CHUNK = 16, 2, 2, 24, 8


def _mlstm_chunked_before(q, k, v, i_gate, f_gate, chunk,
                          state: Optional[Tuple] = None):
    """``ssm.mlstm_chunked`` as it stood with v as wide as q, verbatim."""
    B, S, H, hd = q.shape
    logf = F.logsigmoid(f_gate.float())
    i_act = torch.exp(torch.clamp(i_gate.float(), max=10.0))

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, t.shape[-1])

    xq = fold(v * i_act[..., None].to(v.dtype))
    a = logf.permute(0, 2, 1).reshape(B * H, S, 1)
    bmat = fold(k.float() * _scale(hd)).reshape(B * H, S, hd)
    cmat = fold(q).reshape(B * H, S, hd)
    h0 = None if state is None else state[0]
    y, hT = ssm.ssd_chunked(xq, a, bmat, cmat, chunk, h0)
    ones = i_act.permute(0, 2, 1).reshape(B * H, S, 1, 1).to(v.dtype)
    n0 = None if state is None else state[1]
    nrm, nT = ssm.ssd_chunked(ones, a, bmat, cmat, chunk, n0)
    denom = torch.clamp(nrm[..., 0].abs(), min=1.0)
    y = y[:, :, 0] / denom
    y = y.reshape(B, H, S, hd).permute(0, 2, 1, 3)
    return y, (hT, nT)


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, s, H, N)).astype(np.float32)
           for _ in range(3)]
    gates = [(rng.standard_normal((B, s, H)) * 2 + 1).astype(np.float32)
             for _ in range(2)]
    state = (rng.standard_normal((B * H, 1, N, N)).astype(np.float32),
             np.abs(rng.standard_normal((B * H, 1, 1, N))).astype(np.float32))
    return qkv + gates, state


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("cut", [(0, 16), (0, 5), (5, 12), (12, 16)])
def test_chunked_on_a_cut_of_the_values(cut, carry):
    """v cut to the channels ``[a, b)`` (and a carried state's ``C`` to
    its rows ``[a, b)``): y and ``C`` are the whole run's ``[a, b)``,
    ``n`` the whole run's; every channel: bit for bit the function before
    the cut."""
    a, b = cut
    arrays, state = _inputs(11 + a)
    q, k, v, ig, fg = (torch.from_numpy(x) for x in arrays)
    whole_state = cut_state = None
    if carry:
        whole_state = tuple(torch.from_numpy(x) for x in state)
        cut_state = (whole_state[0][:, :, a:b], whole_state[1])
    y, (c, n) = ssm.mlstm_chunked(q, k, v, ig, fg, CHUNK, whole_state)
    yc, (cc, nc) = ssm.mlstm_chunked(q, k, v[..., a:b], ig, fg, CHUNK,
                                     cut_state)
    assert yc.shape == (B, S, H, b - a) and cc.shape == (B * H, 1, b - a, N)
    _close(yc, y[..., a:b], CUT_TOL)
    _close(cc, c[:, :, a:b], CUT_TOL)
    assert torch.equal(nc, n)
    ref_state = None if not carry else tuple(jnp.asarray(x) for x in state)
    ry, (rc, rn) = ref_ssm.mlstm_chunked(*(jnp.asarray(x) for x in arrays),
                                         CHUNK, ref_state)
    _close(yc, np.asarray(ry)[..., a:b], REF_TOL)
    _close(cc, np.asarray(rc)[:, :, a:b], REF_TOL)
    _close(nc, rn, REF_TOL)
    if (a, b) == (0, N):
        by, (bc, bn) = _mlstm_chunked_before(q, k, v, ig, fg, CHUNK,
                                             whole_state)
        assert torch.equal(y, by) and torch.equal(c, bc) and \
            torch.equal(n, bn)


@pytest.mark.parametrize("cut", [(0, 7), (7, 16)])
def test_decode_steps_on_a_cut_of_the_values(cut):
    """Six tokens from the zero state with v cut to ``[a, b)``: each
    step's y and the state ``C`` are the whole run's ``[a, b)`` (its
    state from ``mlstm_init_state(..., values=b - a)``), ``n`` the whole
    run's, and the whole run is the JAX package's."""
    a, b = cut
    arrays, _ = _inputs(23 + a, s=6)
    whole = ssm.mlstm_init_state(B, H, N, torch.float32)
    part = ssm.mlstm_init_state(B, H, N, torch.float32, values=b - a)
    ref = ref_ssm.mlstm_init_state(B, H, N, jnp.float32)
    assert part[0].shape == (B * H, 1, b - a, N)
    assert part[1].shape == whole[1].shape
    for t in range(6):
        q, k, v, ig, fg = (torch.from_numpy(x[:, t]) for x in arrays)
        y, whole = ssm.mlstm_decode_step(whole, q, k, v, ig, fg)
        yc, part = ssm.mlstm_decode_step(part, q, k, v[..., a:b], ig, fg)
        ry, ref = ref_ssm.mlstm_decode_step(
            ref, *(jnp.asarray(x[:, t]) for x in arrays))
        assert yc.shape == (B, H, b - a)
        _close(yc, y[..., a:b], CUT_TOL)
        _close(part[0], whole[0][:, :, a:b], CUT_TOL)
        assert torch.equal(part[1], whole[1])
        _close(yc, np.asarray(ry)[..., a:b], REF_TOL)
        _close(part[0], np.asarray(ref[0])[:, :, a:b], REF_TOL)


#: xlstm smoke with 2 heads of 96 (d 96, dp 192, which 3 and 16 divide,
#: so the specs shard every "model" leaf into 3 slices of 64 rows or
#: columns): head 0 over ranks 0 and 1 (48 channels each), head 1 on
#: rank 2 (all 96); no rank's stored slice of ``wv`` or ``down`` is its
#: part, so both are exchanged too
UNEVEN = dict(n_heads=2, d_model=96)


@pytest.mark.parametrize("form", [None, "weights", "activations"])
def test_uneven_groups_against_the_reference(tmp_path, form):
    """The mLSTM block over 3 ranks in groups of 2 and 1: each rank's
    heads and channels are ``value_split``'s; their outputs
    concatenated, through the whole ``down`` with the residual, the
    block's output and its decode steps are the JAX block's, in each
    heads form."""
    outs = check_block_heads(tmp_path, "mlstm", "xlstm-350m", 3, form,
                             **UNEVEN)
    assert [o["channels"] for o in outs] == [[0, 48], [48, 96], [0, 96]]
    assert [o["head_outputs"].shape[-1] for o in outs] == [48, 48, 96]
    if form is not None:
        assert set(outs[0]["heads_forms"]) == {form}


def test_one_step_on_eight_ranks_equals_world_one(tmp_path):
    """xlstm smoke (4 heads of 32) at 2 layers and seq 64 on (1, 8): two
    ranks an mLSTM head, 16 value channels each; ``wv`` and ``down`` are
    stored as used (the rank's 16 columns and rows of 128), the other
    leaves exchanged; one step equals the world of one at the bounds."""
    cfg = _cfg("xlstm-350m", n_super=1)
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 8,
                  (cfg, (1, 8), 4, 64, 1))
    for r, o in enumerate(outs):
        assert o["loss_rel_err"] <= RTOL, o["loss_rel_err"]
        assert o["worst_grad_rel_norm"] <= RTOL, o["worst_grad_leaf"]
        assert o["worst_grad_err_over_max"] <= GRAD_MAX_RTOL, o
        assert o["first_step_unexplained_over_max"] <= FIRST_STEP_MAX, o
        assert o["param_bytes"] == o["spec_param_bytes"], o
        got = o["heads"]["MlstmBlock"]
        assert got["heads"] + got["channels"] == [
            r // 2, r // 2 + 1, r % 2 * 16, r % 2 * 16 + 16], got
        gathered = {n.rsplit(".", 1)[1] for n in o["leaf_gathers"]["model"]
                    if n.startswith(got["module"] + ".")}
        assert gathered <= {"up", "wq", "wk"}, gathered


@pytest.mark.parametrize("h,hd,m,want", [
    # as many heads as ranks or more: heads_split's, every channel
    (4, 512, 4, [(r, r + 1, 0, 512) for r in range(4)]),
    (4, 512, 2, [(0, 2, 0, 512), (2, 4, 0, 512)]),
    (6, 8, 4, [(0, 1, 0, 8), (1, 3, 0, 8), (3, 4, 0, 8), (4, 6, 0, 8)]),
    # fewer: head ⌊r·h/m⌋, the i-th of its g ranks channels
    # [⌊hd·i/g⌋, ⌊hd·(i+1)/g⌋)
    (2, 96, 3, [(0, 1, 0, 48), (0, 1, 48, 96), (1, 2, 0, 96)]),
    (3, 10, 4, [(0, 1, 0, 5), (0, 1, 5, 10), (1, 2, 0, 10),
                (2, 3, 0, 10)]),
    (2, 10, 5, [(0, 1, 0, 3), (0, 1, 3, 6), (0, 1, 6, 10), (1, 2, 0, 5),
                (1, 2, 5, 10)]),
    (4, 512, 16, [(r // 4, r // 4 + 1, r % 4 * 128, r % 4 * 128 + 128)
                  for r in range(16)]),
])
def test_value_split_by_hand(h, hd, m, want):
    got = [value_split(h, hd, m, r) for r in range(m)]
    assert got == want
    # every head's channels are covered once, in rank order
    for j in range(h):
        spans = [(lo, hi) for a, b, lo, hi in got if a <= j < b]
        assert spans[0][0] == 0 and spans[-1][1] == hd
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
