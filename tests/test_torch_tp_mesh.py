"""Tensor parallelism on a (2, 2) mesh and a sharded checkpoint's resume,
the multi-rank half of ``tests/test_torch_tp.py`` (split from it so the
test runner's workers share the ranks' time), on the CPU: the same five
configs and the same tolerances, each rank on its shards of a "model"
group of 2 and its rows of a "data" group of 2.
"""
import numpy as np
import pytest

from repro_torch.distributed import selftest
from test_torch_tp import (CPU, RTOL, TP_CONFIGS, _assert_parity, _cfg,
                           _spawn)


@pytest.mark.parametrize("arch", sorted(TP_CONFIGS))
def test_tensor_parallel_step_equals_world_one_on_2x2(tmp_path, arch):
    """As ``test_tensor_parallel_step_equals_world_one`` on a (2, 2)
    mesh: the gradients reduce-scattered over "data" into the ZeRO-1
    slices, the slices gathered back."""
    cfg = _cfg(arch, **TP_CONFIGS[arch])
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 4,
                  (cfg, (2, 2), 4, 32, 2))
    _assert_parity(outs)
    for o in outs:
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["not_the_share"] == [], o
        assert "model" not in o["leaf_gathers"], o


def test_sharded_training_resumes_from_its_checkpoint(tmp_path):
    """``run_train`` on a (1, 2) mesh with a checkpoint every 2 steps and
    a failure injected at step 3: the checkpoint saves each rank's shards
    gathered whole and restores them in place, so the replayed losses
    equal an uninterrupted meshed run's bit for bit, and that run's equal
    the world of one's within 1e-5 relative."""
    from repro_torch.launch import train
    cfg = _cfg("mistral-nemo-12b")
    kw = dict(steps=5, batch=4, seq=32, log_every=100)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    plain = _spawn(tmp_path / "a", train._train_rank, 2, (cfg, (1, 2), kw))
    resumed = _spawn(tmp_path / "b", train._train_rank, 2, (cfg, (1, 2), dict(
        kw, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
        inject_failure_at=3)))
    single = train.run_train(cfg, device=CPU, log=lambda line: None,
                             **kw)["losses"]
    for losses in plain:
        rel = np.abs(np.array(losses) - single) / np.abs(single)
        assert rel.max() <= RTOL, (losses, single)
    for losses in resumed:
        # the failure comes before step 3 runs; the checkpoint of step 1
        # is restored and steps 2.. run again
        assert losses[:3] == plain[0][:3]
        assert losses[3:] == plain[0][2:], (losses, plain[0])
