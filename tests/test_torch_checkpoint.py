"""Checkpoints and the supervisor of the PyTorch port
(``repro_torch.checkpoint``, ``repro_torch.runtime.fault_tolerance``):
the cases of the JAX package's ``tests/test_substrates.py`` re-aimed at
the port, plus checkpoints written by one package and read by the other,
key for key and bit for bit."""
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.runtime.fault_tolerance import (ElasticPlan, StepMonitor,
                                                 Supervisor)


def _numpy_tree(seed=0):
    """A nested dict of float32, bf16 (as float32 values exactly
    representable in bf16) and int32 arrays, from a numpy seed."""
    rng = np.random.default_rng(seed)
    bf = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)
                          ).to(torch.bfloat16).float().numpy()
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "blk": {"bf": bf,
                    "idx": rng.integers(-50, 50, (7,)).astype(np.int32),
                    "deep": {"b": rng.standard_normal(2).astype(np.float32)}},
            "scalar": np.float32(rng.standard_normal())}


def _torch_tree(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "blk": {"bf": torch.from_numpy(tree["blk"]["bf"]).to(
                        torch.bfloat16),
                    "idx": torch.from_numpy(tree["blk"]["idx"]),
                    "deep": {"b": torch.from_numpy(tree["blk"]["deep"]["b"])}},
            "scalar": torch.tensor(float(tree["scalar"]))}


def _jax_tree(tree):
    return {"w": jnp.asarray(tree["w"]),
            "blk": {"bf": jnp.asarray(tree["blk"]["bf"], jnp.bfloat16),
                    "idx": jnp.asarray(tree["blk"]["idx"]),
                    "deep": {"b": jnp.asarray(tree["blk"]["deep"]["b"])}},
            "scalar": jnp.float32(tree["scalar"])}


def _leaves(tree, prefix=""):
    """{path: float64 numpy array} of a nested dict of tensors/arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.float().numpy().astype(np.float64)
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float64)
    return out


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta.pop("time")
    return meta


# ------------------------------------------------------------ the port


def test_checkpoint_roundtrip_and_prune():
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, tree, keep_last=2)
        assert ckpt.latest_step(d) == 5
        steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert len(steps) == 2          # pruned
        restored = ckpt.restore(d, 5, tree)
        assert torch.equal(restored["a"], tree["a"])
        assert restored["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_shape_mismatch_raises():
    tree = {"a": torch.ones((3, 4))}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 0, tree)
        with pytest.raises(ValueError):
            ckpt.restore(d, 0, {"a": torch.ones((4, 4))})


def test_checkpoint_missing_leaf_raises():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 0, {"a": torch.ones(3)})
        with pytest.raises(KeyError, match="b"):
            ckpt.restore(d, 0, {"a": torch.ones(3), "b": torch.ones(2)})


def test_restore_takes_the_target_dtype_and_structure():
    """Each leaf lands in its target tensor's dtype; lists, tuples and
    None keep their places; fp8 round-trips by its raw bits; a numpy leaf
    (a step counter) comes back as a tensor of its dtype."""
    tree = {"x": torch.linspace(-2, 2, 6),
            "seq": [torch.arange(3), (torch.ones(2), None)],
            "f8": torch.linspace(-1, 1, 8).to(torch.float8_e4m3fn),
            "step": np.int64(12)}
    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save(d, 3, tree)
        meta = _meta(path)
        assert meta["paths"] == ["['f8']", "['seq']/[0]", "['seq']/[1]/[0]",
                                 "['step']", "['x']"]
        assert meta["dtypes"] == ["float8_e4m3fn", "int64", "float32",
                                  "int64", "float32"]
        target = {"x": torch.zeros(6, dtype=torch.float64),
                  "seq": [torch.zeros(3, dtype=torch.int32),
                          (torch.zeros(2), None)],
                  "f8": torch.zeros(8, dtype=torch.float8_e4m3fn),
                  "step": np.int64(0)}
        got = ckpt.restore(d, 3, target)
    assert got["x"].dtype == torch.float64
    assert torch.equal(got["x"], tree["x"].double())
    assert got["seq"][0].dtype == torch.int32
    assert isinstance(got["seq"][1], tuple) and got["seq"][1][1] is None
    assert torch.equal(got["f8"].view(torch.uint8),
                       tree["f8"].view(torch.uint8))
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 12


def test_flat_roundtrip_and_tree_refusal():
    rng = np.random.default_rng(3)
    arrays = {"t000/pop": rng.integers(0, 9, (4, 5)),
              "t000/hist": rng.standard_normal(11),
              "t001/rng": np.frombuffer(b'{"a": 1}', dtype=np.uint8)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_flat(d, 8, arrays, extra_meta={"round": 8})
        got, extra = ckpt.load_flat(d, 8)
        assert extra == {"round": 8} and sorted(got) == sorted(arrays)
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
            assert got[k].dtype == arrays[k].dtype
        ckpt.save(d, 9, {"a": torch.ones(2)})
        with pytest.raises(ValueError, match="tree checkpoint"):
            ckpt.load_flat(d, 9)


# ------------------------------------------------------ across packages


def test_meta_json_equals_the_references_for_the_same_tree():
    """The same state, saved by each package: same leaf paths, shapes and
    dtype names in ``meta.json``, and the same bytes in every leaf."""
    tree = _numpy_tree(1)
    with tempfile.TemporaryDirectory() as d:
        p_ref = ref_ckpt.save(os.path.join(d, "ref"), 4, _jax_tree(tree))
        p_port = ckpt.save(os.path.join(d, "port"), 4, _torch_tree(tree))
        assert _meta(p_ref) == _meta(p_port)
        for i in range(len(_meta(p_ref)["paths"])):
            a = np.load(os.path.join(p_ref, f"leaf_{i:05d}.npy"))
            b = np.load(os.path.join(p_port, f"leaf_{i:05d}.npy"))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tree_checkpoint_reads_across_packages(writer):
    tree = _numpy_tree(2)
    with tempfile.TemporaryDirectory() as d:
        if writer == "reference":
            ref_ckpt.save(d, 7, _jax_tree(tree))
            got = ckpt.restore(d, 7, _torch_tree(_numpy_tree(9)))
            assert got["blk"]["bf"].dtype == torch.bfloat16
            assert got["blk"]["idx"].dtype == torch.int32
        else:
            ckpt.save(d, 7, _torch_tree(tree))
            got = ref_ckpt.restore(d, 7, _jax_tree(_numpy_tree(9)))
            assert got["blk"]["bf"].dtype == jnp.bfloat16
        want, have = _leaves(tree), _leaves(_host(got))
        assert sorted(have) == sorted(want)
        for k in want:
            assert have[k].tobytes() == want[k].tobytes(), k


def _host(tree):
    """A restored tree with every JAX leaf as a float32 numpy array."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree.astype(jnp.float32))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_flat_checkpoint_reads_across_packages(writer):
    rng = np.random.default_rng(4)
    arrays = {"t000/pop": rng.integers(0, 97, (6, 9)).astype(np.int64),
              "t000/edp": rng.standard_normal(6),
              "t000/ints": np.array([3, 1, 40, 900, 310], dtype=np.int64),
              "t001/rng": np.frombuffer(json.dumps({"s": 5}).encode(),
                                        dtype=np.uint8)}
    extra = {"round": 16, "tasks": [{"_name": "mm1@cloud"}]}
    save, load = (ref_ckpt.save_flat, ckpt.load_flat) \
        if writer == "reference" else (ckpt.save_flat, ref_ckpt.load_flat)
    with tempfile.TemporaryDirectory() as d:
        save(d, 16, arrays, extra_meta=extra)
        got, got_extra = load(d, 16)
    assert got_extra == extra and sorted(got) == sorted(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        assert got[k].tobytes() == arrays[k].tobytes(), k


# ------------------------------------------------------------ supervisor


def test_supervisor_recovers_from_crash():
    with tempfile.TemporaryDirectory() as d:
        crashed = {"done": False}

        def step_fn(state, step):
            if step == 7 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected node failure")
            return {"x": state["x"] + 1.0}

        sup = Supervisor(d, ckpt_every=3, max_restarts=2)
        state, report = sup.run({"x": torch.tensor(0.0)}, step_fn, 10)
        assert report["restarts"] == 1
        assert float(state["x"]) == 10.0     # every step applied once
        assert state["x"].dtype == torch.float32


def test_supervisor_gives_up():
    with tempfile.TemporaryDirectory() as d:
        def step_fn(state, step):
            raise RuntimeError("permafail")
        sup = Supervisor(d, ckpt_every=1, max_restarts=2)
        with pytest.raises(RuntimeError):
            sup.run({"x": torch.tensor(0.0)}, step_fn, 3)


def test_supervisor_run_loop_rebuilds_from_the_latest_step():
    """``run_loop`` (the sweep server's shape): a crash rebuilds the state
    from the newest checkpoint and the loop ends on its own predicate."""
    with tempfile.TemporaryDirectory() as d:
        built, crashed = [], {"done": False}

        def make_state(step):
            built.append(step)
            if step is None:
                return {"n": 0}
            arrays, _ = ckpt.load_flat(d, step)
            return {"n": int(arrays["n"])}

        def step_fn(state, s):
            if state["n"] == 6 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected")
            state["n"] += 1
            return state["n"] >= 10

        def save_fn(state, s):
            ckpt.save_flat(d, state["n"], {"n": np.int64(state["n"])})

        sup = Supervisor(d, ckpt_every=4, max_restarts=1)
        state, report = sup.run_loop(make_state, step_fn, save_fn)
    assert report["restarts"] == 1 and state["n"] == 10
    assert built == [None, 4]


def test_straggler_monitor():
    m = StepMonitor(warmup_steps=2, straggler_factor=2.0)
    flags = [m.observe(i, 0.1) for i in range(5)]
    assert not any(flags)
    assert m.observe(5, 0.5)            # 5x slower -> straggler
    assert m.straggler_rate > 0


def test_elastic_plan():
    p = ElasticPlan.plan(n_devices=256, model_parallel=16)
    assert p.data_parallel == 16
    p2 = ElasticPlan.plan(n_devices=240, model_parallel=16)
    assert p2.data_parallel == 15       # shrink tolerated
    with pytest.raises(RuntimeError):
        ElasticPlan.plan(n_devices=8, model_parallel=16)
    assert p.host_shard(3) == (3, 16)
