"""The multi-device training path of the PyTorch port (``models.sharding``,
``Model.param_specs``, ``optim.optimizer`` ZeRO-1 specs,
``optim.compression``, ``distributed.pipeline``, ``checkpoint.restore(...,
shardings=)``, ``launch.steps.build_sharded_train_step``, ``launch.train
--mesh``, ``distributed.selftest``, ``core.autoshard``) against the JAX
package's, on the CPU.

Specs and the single-process functions are held to the reference on the
same inputs: specs equal leaf for leaf, ``quantize_int8`` and
``topk_sparsify`` exactly, ``topk_ef_step``'s mass as the reference's own
test holds it, the autoshard estimator and its exhaustive optimum equal
with the reference's TPU constants passed in.  The multi-rank tests start
gloo ranks, one process each (``distributed.launch.spawn``), with a
``FileStore`` under the test's ``tmp_path`` and a time limit of 60 s
each: the pipeline against the sequential product (rtol = atol = 2e-4),
the int8 all-reduce against the reference's formula in numpy, the sharded
train step on a 2 x 4 mesh against the single one in fp32 (loss within
1e-5 relative, each parameter leaf within 1e-4 of its largest element),
the elastic restore exactly, and ``selftest`` as a subprocess.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.core import autoshard as ref_autoshard
from repro.core.accel import TPU_V5E
from repro.models.model import Model as RefModel
from repro.optim import compression as ref_comp
from repro.optim import optimizer as ref_opt
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import accel, autoshard
from repro_torch.distributed import selftest
from repro_torch.distributed.launch import spawn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import sharding
from repro_torch.models.convert import _named_slots, specs_from_jax
from repro_torch.models.model import Model
from repro_torch.optim import compression as comp
from repro_torch.optim import optimizer as opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
RANK_TIMEOUT = 60.0
#: the reference's TPU constants, with the 16 GB capacity its estimator
#: hard-codes, as a plain dict
TPU = dict(TPU_V5E, hbm_bytes=16e9)


# ---------------------------------------------------------------- specs

@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_specs_equal_the_references(arch):
    m = Model(smoke_config(arch), device=CPU)
    ref = specs_from_jax(m, RefModel(ref_smoke_config(arch)).param_specs())
    got = m.param_specs()
    assert list(got) == [n for n, _ in m.named_parameters()]
    assert {n: tuple(s) for n, s in got.items()} == ref


@pytest.mark.parametrize("spec,shape,want", [
    ((None, "model"), (64, 32), ("data", "model")),
    ((None, None), (48, 64), (None, "data")),
    (("model", None, "data"), (16, 8, 32), ("model", None, "data")),
    ((None,), (7,), (None,)),
    ((), (32, 16), ("data", None)),
])
def test_zero1_spec_equals_the_references(spec, shape, want):
    from jax.sharding import PartitionSpec as JP
    ref = ref_opt.zero1_spec(JP(*spec), shape)
    got = opt.zero1_spec(sharding.P(*spec), shape)
    assert tuple(got) == tuple(ref) == want


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "arctic-480b"])
def test_opt_state_specs_equal_the_references(arch):
    from jax.sharding import PartitionSpec as JP
    rm = RefModel(ref_smoke_config(arch))
    rspecs = rm.param_specs()
    shapes = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    rshapes = jax.tree.map(lambda s: s.shape, shapes)
    rstate = ref_opt.opt_state_specs(rspecs, rshapes, data_size=4)
    m = Model(smoke_config(arch), device=CPU)
    got = opt.opt_state_specs(
        m.param_specs(), {n: tuple(p.shape) for n, p in m.named_parameters()},
        data_size=4)
    assert tuple(got.step) == tuple(rstate.step) == ()
    # the reference's moments are stacked [n_super, repeat, ...] and its
    # ZeRO-1 axis is chosen over the stacked shape: where it lands on a
    # layer axis (which the port's leaves do not have) the two differ by
    # design; everywhere else they are equal
    compared = 0
    for n, _, leaf, _, idx in _named_slots(m, rstate.mu):
        assert tuple(got.nu[n]) == tuple(got.mu[n])
        if "data" in tuple(leaf)[:len(idx)]:
            continue
        assert tuple(got.mu[n]) == tuple(leaf)[len(idx):], n
        compared += 1
    assert compared == len(got.mu)
    assert isinstance(rstate.mu["embed"], JP)


def test_placements_and_batch_spec():
    class Mesh:
        mesh_dim_names = ("data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements(Mesh, sharding.P(None, "model")) == \
        [Replicate(), Shard(1)]
    assert sharding.placements(Mesh, sharding.P("model", None, "data")) == \
        [Shard(2), Shard(0)]
    with pytest.raises(ValueError, match="pipe"):
        sharding.placements(Mesh, sharding.P("pipe"))
    assert sharding.bspec(None) == sharding.P()
    with sharding.batch_axes(("data",)):
        assert sharding.bspec(None, "model") == sharding.P("data", None,
                                                           "model")
        x = torch.ones(3)
        assert sharding.constrain_batch(x, None) is x   # plain tensors pass
    with sharding.batch_axes(("data", "model")):
        assert sharding.bspec(None, "model") == sharding.P(("data",
                                                            "model"), None,
                                                           None)
    assert sharding.get_batch_axes() is None


def test_meshes_over_a_group_of_one(tmp_path):
    """The production mesh names the device count it lacks; a test mesh
    over the group carries its dimension names."""
    from repro_torch.distributed.launch import process_group
    with process_group(CPU, store_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="need 256 devices for mesh "
                           r"\(16, 16\), have 1"):
            mesh_lib.make_production_mesh()
        with pytest.raises(RuntimeError, match="need 512 devices"):
            mesh_lib.make_production_mesh(multi_pod=True)
        m = mesh_lib.make_test_mesh((1, 1), ("data", "model"))
        assert m.mesh_dim_names == ("data", "model")
        assert mesh_lib.batch_axes_of(m) == ("data",)
        with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
            mesh_lib.make_test_mesh((2, 2))


def test_batch_axes_of_reads_the_dim_names():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert mesh_lib.batch_axes_of(Mesh) == ("pod", "data")
    mesh_lib.set_batch_axes_override(("data", "model"))
    try:
        assert mesh_lib.batch_axes_of(Mesh) == ("data", "model")
    finally:
        mesh_lib.set_batch_axes_override(None)


# ---------------------------------------------------------------- compression

def test_quantize_int8_equals_the_references():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((128,)) * 3).astype(np.float32)
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    y = comp.dequantize_int8(q, s)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(ref_comp.dequantize_int8(rq, rs)))
    assert float((y - torch.from_numpy(x)).abs().max()) <= float(s) * 0.51


def test_stochastic_rounding_takes_a_generator():
    x = torch.linspace(-1, 1, 257)
    a, _ = comp.quantize_int8(x, True, torch.Generator().manual_seed(5))
    b, _ = comp.quantize_int8(x, True, torch.Generator().manual_seed(5))
    c, _ = comp.quantize_int8(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int((a.int() - c.int()).abs().max()) <= 1


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
def test_topk_sparsify_equals_the_references(frac):
    x = np.random.default_rng(2).standard_normal((40, 25)).astype(
        np.float32)
    rsx, rmask = ref_comp.topk_sparsify(jnp.asarray(x), frac)
    sx, mask = comp.topk_sparsify(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(rsx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


def test_topk_error_feedback_preserves_mass():
    """``tests/test_substrates.py``'s check, and step for step the
    reference's compressed gradients and residuals."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 64)).astype(np.float32)
    ef = comp.init_error_feedback({"w": torch.from_numpy(g)})
    ref_ef = ref_comp.init_error_feedback({"w": jnp.asarray(g)})
    total = torch.zeros(64, 64)
    for i in range(50):
        sent, ef = comp.topk_ef_step({"w": torch.from_numpy(g)}, ef,
                                     frac=0.05)
        if i < 5:
            rsent, ref_ef = ref_comp.topk_ef_step({"w": jnp.asarray(g)},
                                                  ref_ef, frac=0.05)
            np.testing.assert_allclose(sent["w"].numpy(),
                                       np.asarray(rsent["w"]), atol=1e-6)
        total += sent["w"]
    np.testing.assert_allclose(total.numpy() / 50, g, atol=0.35)


def test_psum_oracle_is_the_references_formula():
    """The numpy oracle of ``compressed_psum`` against the reference's
    own ``quantize_int8`` scales, row by row."""
    rows = np.random.default_rng(1).standard_normal((8, 64)).astype(
        np.float32)
    smax = max(float(ref_comp.quantize_int8(jnp.asarray(r))[1])
               for r in rows)
    q = np.clip(np.round(rows / np.float32(smax)), -127, 127).astype(
        np.int32)
    want = q.sum(axis=0).astype(np.float32) * np.float32(smax)
    np.testing.assert_array_equal(selftest.psum_oracle(rows), want)


# ---------------------------------------------------------------- autoshard

DECISIONS = [
    dict(remat="none", microbatches=1, logits="vocab", embed="vocab",
         attn_chunk=0, mlp_shard="megatron", zero1=True, moe_ff="data",
         kv_seq="model", moments="bf16"),
    dict(remat="full", microbatches=4, logits="gather", embed="dmodel",
         attn_chunk=2048, mlp_shard="fsdp", zero1=False,
         moe_ff="replicated", kv_seq="data_model", moments="int8"),
]


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "kimi-k2-1t-a32b",
                                  "gemma3-12b"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_autoshard_estimate_equals_the_references(arch, kind):
    for mesh in ({"data": 16, "model": 16},
                 {"pod": 2, "data": 16, "model": 16}):
        for dec in DECISIONS:
            ref = ref_autoshard.estimate(ref_get_config(arch), 4096, 256,
                                         mesh, dec, kind)
            got = autoshard.estimate(get_config(arch), 4096, 256, mesh, dec,
                                     kind, accel=TPU)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_autoshard_exhaustive_best_equals_the_references():
    mesh = {"data": 16, "model": 16}
    ref = ref_autoshard.exhaustive_best(ref_get_config("mistral-nemo-12b"),
                                        4096, 256, mesh)
    got = autoshard.exhaustive_best(get_config("mistral-nemo-12b"), 4096,
                                    256, mesh, accel=TPU)
    assert got == ref


def test_autoshard_search_finds_the_h100_optimum():
    """The port's ES on the H100 constants (its default) lands on the
    exhaustive optimum, as the reference's test holds its own."""
    cfg = get_config("mistral-nemo-12b")
    mesh = {"data": 32, "model": 8}
    dec, est, res = autoshard.search(cfg, 4096, 256, mesh, budget=2000,
                                     seed=0)
    best, best_t = autoshard.exhaustive_best(cfg, 4096, 256, mesh)
    assert dec is not None
    assert res.best_edp == pytest.approx(best_t, rel=1e-6)
    assert accel.H100_SXM["hbm_bytes"] == 80e9
    assert est.hbm_bytes_per_device < accel.H100_SXM["hbm_bytes"]


# ---------------------------------------------------------------- multi-rank

def _spawn(tmp_path, fn, world, args=()):
    return spawn(fn, world, args, device_type=CPU, timeout=RANK_TIMEOUT,
                 store_dir=str(tmp_path))


def test_pipeline_apply_matches_the_sequential_product(tmp_path):
    outs = _spawn(tmp_path, selftest.check_pipeline, 4)
    assert all(o["stages"] == 4 and o["max_abs_err"] <= 2e-4 for o in outs)


def test_compressed_psum_matches_the_references_formula(tmp_path):
    outs = _spawn(tmp_path, selftest.check_compressed_psum, 8)
    assert all(o["ranks"] == 8 and o["rel_err"] < 0.02 for o in outs)


def test_sharded_train_step_matches_world_one(tmp_path):
    """mistral smoke, fp32, batch 4 x 32, two steps on a 2 x 4 mesh
    against the same steps on one rank."""
    cfg = dataclasses.replace(smoke_config("mistral-nemo-12b"), **F32)
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 8,
                  (cfg, (2, 4), 4, 32, 2))
    for o in outs:
        assert o["loss_rel_err"] <= 1e-5, o
        assert o["worst_leaf_err_over_max"] <= 1e-4, o


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    outs = _spawn(tmp_path, selftest.check_elastic_restore, 8,
                  (str(tmp_path / "ckpt"),))
    assert outs[0] == dict(saved_on=[2, 4], restored_on=[1, 4])


def test_train_mesh_losses_equal_the_unmeshed_run(tmp_path):
    """``run_train`` on a 2 x 2 mesh (``--mesh 2x2``'s ranks) against the
    un-meshed run, fp32, four steps: every loss within 1e-5 relative."""
    cfg = dataclasses.replace(smoke_config("mistral-nemo-12b"), **F32)
    kw = dict(steps=4, batch=4, seq=32, log_every=100)
    meshed = _spawn(tmp_path, train._train_rank, 4, (cfg, (2, 2), kw))
    single = train.run_train(cfg, device=CPU, log=lambda line: None,
                             **kw)["losses"]
    for losses in meshed:
        rel = np.abs(np.array(losses) - single) / np.abs(single)
        assert rel.max() <= 1e-5, (losses, single)


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """Rank 0 writes the checkpoint and fails; rank 1, waiting for it at
    a barrier, is ended rather than left to hang."""
    with pytest.raises(RuntimeError, match="(?s)rank 0 of 2 failed.*null"):
        _spawn(tmp_path, selftest.check_elastic_restore, 2,
               (str(tmp_path / "missing" / "\0"),))


def test_selftest_subprocess():
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.distributed.selftest", "--device",
                        "cpu"], capture_output=True, text=True,
                       timeout=RANK_TIMEOUT, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[-1] == "SELFTEST OK"


def test_one_number_mesh_is_data_by_one(capfd, monkeypatch, tmp_path):
    """``--mesh 2`` is a (2, 1) mesh here; the reference builds a 1-D
    ("data",) mesh for it, which its "model" specs cannot be placed on
    (it raises ``ValueError``: "Resource axis: model ... is not found in
    mesh").  The CLI's ranks get this test's time limit and store."""
    from repro_torch.distributed import launch
    real = launch.spawn

    def bounded(fn, world, args=(), **kw):
        kw.update(timeout=RANK_TIMEOUT, store_dir=str(tmp_path))
        return real(fn, world, args, **kw)

    monkeypatch.setattr(launch, "spawn", bounded)
    assert train.parse_mesh("2") == (2, 1)
    assert train.parse_mesh("2x4") == (2, 4)
    for bad in ("0x2", "2x4x2", "two"):
        with pytest.raises(ValueError, match="want D or DxM"):
            train.parse_mesh(bad)
    assert train.main(["--arch", "mistral-nemo-12b", "--smoke", "--device",
                       "cpu", "--mesh", "2", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--log-every", "1"]) == 0
    assert "step     1 loss" in capfd.readouterr().out   # rank 0's lines
