"""Fault (a) closed: a mixture-of-experts model on a data-sharded mesh
(``models.moe`` under a "data" axis, ``launch.steps.
build_sharded_train_step``), on the CPU: gloo ranks against one rank in
fp32, with the tolerances of ``tests/test_torch_tp.py``, and the world of
one tied to the JAX package's step.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro_torch.distributed import selftest
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import sharding
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import Model
from test_torch_tp import CPU, F32, _assert_parity, _cfg, _spawn


#: (moe_grouped, moe_n_groups): the flat dispatch; groups that fall whole
#: inside each rank's rows (4 groups of the batch's 128 tokens, 2 a
#: rank); one group that spans both ranks
DISPATCH = {"flat": (False, 256), "grouped": (True, 4),
            "grouped_spanning": (True, 1)}
#: capacity factors: 0.5 drops (the slots outnumber the capacity), 8.0
#: keeps every (token, slot) pair
CAPACITY = {"drops": 0.5, "no_drops": 8.0}


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_moe_step_on_a_data_sharded_mesh_equals_world_one(tmp_path,
                                                          dispatch,
                                                          capacity):
    """arctic smoke (MoE + dense residual), a (2, 1) mesh, two steps of
    batch 4 x 32: the balance loss, the capacity and the slot positions
    are the whole batch's, so the losses and updated leaves are the
    world of one's."""
    grouped, groups = DISPATCH[dispatch]
    cfg = _cfg("arctic-480b", moe_grouped=grouped, moe_n_groups=groups,
               capacity_factor=CAPACITY[capacity])
    _assert_parity(_spawn(tmp_path, selftest.sharded_step_parity, 2,
                          (cfg, (2, 1), 4, 32, 2)))


def test_moe_drops_some_slots_at_the_low_capacity():
    """The "drops" cases drop: at capacity factor 0.5 the world of one
    keeps fewer (token, slot) pairs than it routes."""
    from repro_torch.models import moe
    cfg = _cfg("arctic-480b", capacity_factor=0.5)
    m = Model(cfg, device=CPU)
    x = torch.randn(1, 128, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, _, top_i = moe.route(x, m.blocks[0].moe.wg, cfg.top_k)
    cap = moe.capacity(128, cfg.top_k, 0.5, cfg.n_experts)
    _, keep = moe.slot_positions(top_i, cfg.n_experts, cap)
    assert 0 < int(keep.sum()) < keep.numel()


def test_grouped_dispatch_refuses_groups_that_do_not_nest():
    """3 groups of 96 tokens over 2 data ranks nest neither way."""
    from repro_torch.models import moe
    p = dict(wg=torch.zeros(8, 4), w1=torch.zeros(4, 8, 8),
             w3=torch.zeros(4, 8, 8), w2=torch.zeros(4, 8, 8))
    axis = sharding.Axis(group=None, size=2, rank=0)
    with sharding.parallel(data=axis):
        with pytest.raises(ValueError, match="do not nest with 2 data"):
            moe.moe_ffn_grouped(torch.zeros(1, 48, 8), p, 2, n_groups=3)


def test_world_one_moe_step_matches_the_reference():
    """The world of one these tests hold the mesh against, tied to the
    reference: the arctic smoke config at the low capacity, the
    reference's ``Model.init`` weights, ``loss_fn`` and its gradients
    against ``jax.value_and_grad``."""
    import jax.numpy as jnp
    from repro_torch.models.convert import named_from_jax
    ref_cfg = dataclasses.replace(ref_smoke_config("arctic-480b"), **F32,
                                  capacity_factor=0.5)
    cfg = _cfg("arctic-480b", capacity_factor=0.5)
    rm = RefModel(ref_cfg)
    params = rm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    (rloss, _), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    m = load_jax_params(Model(cfg, device=CPU),
                        jax.tree.map(np.asarray, params))
    m.requires_grad_(True)
    loss, grads = loss_and_grads(m, {k: torch.from_numpy(v).long()
                                     for k, v in batch.items()})
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    want = named_from_jax(m, jax.tree.map(np.asarray, rgrads))
    for n, g in grads.items():
        scale = max(float(want[n].abs().max()), 1e-30)
        assert float((g - want[n]).abs().max()) / scale <= 1e-4, n
