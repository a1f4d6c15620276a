"""The experts' width split's weights form (``moe.width_form``: the
experts' slices gathered whole over "data" at ``WEIGHTS_SEQ``), on the
CPU: one sharded step against the world of one for every dispatch and
capacity case on (2, 1) and (2, 2), at ``tests/test_torch_tp.py``'s
tolerances.  Apart from ``tests/test_torch_moe_width.py`` (whose helpers
it uses) so that the two halves run on two workers.
"""
import pytest

from repro_torch.distributed import selftest
from test_torch_moe_dp import CAPACITY, DISPATCH
from test_torch_moe_width import (WEIGHTS_SEQ, _expert_shape, _rule_at,
                                  _weights_cfg)
from test_torch_tp import (FIRST_STEP_MAX, GRAD_MAX_RTOL, RTOL, _spawn)


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_weights_form_step_equals_world_one(tmp_path, mesh, dispatch,
                                            capacity):
    """arctic smoke (16 experts over "model" on (2, 2)) at batch 4 x
    ``WEIGHTS_SEQ``, where the rule gathers the experts' slices: one
    sharded step against the world of one, held at the file's bounds in
    what fp32 rounding reaches unamplified: the loss, the gradients (in
    norm and by element) and the first update, explained element by
    element (``first_step_unexplained_over_max``).  The leaves' own
    figures after the update are not held to ``RTOL``: AdamW's first
    update turns a last-bit difference of a near-zero gradient into a
    step of up to 2·lr, which the first-update check predicts element by
    element, and a further step compounds it in either width form alike.
    (The optimizer sees the same slices' gradients in either form: its
    later steps on them are the tokens form's cases'.)  Every dispatch took the weights form; each expert leaf was gathered whole
    over "data" once (the smoke config does not remat; the other leaves'
    gathers over "data" are ZeRO-1's); every rank holds the specs'
    share, its slices ``[E/m, d, d_ff/2]``."""
    cfg = _weights_cfg(mesh, dispatch, capacity)
    assert _rule_at(cfg, mesh, WEIGHTS_SEQ)[0] == "weights"
    outs = _spawn(tmp_path, selftest.sharded_step_parity, mesh[0] * mesh[1],
                  (cfg, mesh, 4, WEIGHTS_SEQ, 1))
    experts = [f"blocks.{i}.moe.{n}" for i in range(cfg.n_layers)
               for n in ("w1", "w3", "w2")]
    for o in outs:
        assert o["loss_rel_err"] <= RTOL, o
        assert o["worst_grad_rel_norm"] <= RTOL, o
        assert o["worst_grad_err_over_max"] <= GRAD_MAX_RTOL, o
        assert o["first_step_unexplained_over_max"] <= FIRST_STEP_MAX, o
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["moe_width_forms"] == {"weights": cfg.n_layers}
        gathered = o["leaf_gathers"]["data"]      # with ZeRO-1's gathers
        assert {n: gathered.get(n) for n in experts} == \
            {n: 1 for n in experts}
        for n, shape in o["expert_shapes"].items():
            assert shape == _expert_shape(cfg, n[-2:], mesh[1], mesh[0])
