"""Training on the PyTorch port (``repro_torch``: ``layers.softmax_xent``,
``Model.loss_fn`` and its remat, ``optim.optimizer``, ``data.pipeline``,
``launch.steps.build_train_step``, ``launch.train``) against the JAX
package's, on the CPU: the same seeded numpy inputs, and the reference's
own ``Model.init`` weights, gradients and ``OptState`` carried over by
``models.convert``.

Tolerances:

* ``SyntheticLM`` batches: bit-equal (numpy in both).
* fp32 values (losses, gradients, fp32 parameters and moments):
  ``|Δ| <= 1e-4·|ref| + 1e-4·max|ref of the leaf|`` — the model tests'
  fp32 ``1e-4``, with the absolute part scaled by the leaf, since
  gradients span orders of magnitude.  Two sums differ in order between
  the packages (``global_norm`` in tree order, matrix products), which
  moves the last bits only.
* bf16 parameters and moments after ``apply``: ``|Δ| <= 2⁻⁷·|ref| +
  2⁻⁸·max|ref of the leaf|``, one bf16 unit in the last place of the
  element plus half of one of the leaf's largest: the fp32 update is the
  same to the last bits, the cast to bf16 may round a value on a rounding
  edge the other way, and a bf16 moment ``b1·m + (1 - b1)·g`` that nearly
  cancels keeps the rounding error of its larger term.
* Parameters after AdamW steps: all but 0.1 % of each leaf's elements
  at the fp32 limit, and every element within ``0.1·lr`` a step.  AdamW
  divides by ``sqrt(v) + eps``, so an element whose gradient is near
  ``eps`` turns the gradients' last-bit differences into up to a few
  percent of ``lr`` (measured: 0.025·lr after three steps), and under
  bf16 moments a moment that rounded the other way moves each later
  update by up to ``2⁻⁷`` of it.
* The port against itself (remat on and off, a resumed run against an
  uninterrupted one): bit for bit.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro.optim import optimizer as ref_opt
from repro_torch.configs import smoke_config
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step, loss_and_grads
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.convert import (load_jax_params, named_from_jax,
                                        opt_state_from_jax)
from repro_torch.models.model import Model
from repro_torch.optim import optimizer as opt

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-4
BF16_ULP = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_f32_close(got, ref, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    lim = TOL * np.abs(ref) + TOL * max(float(np.abs(ref).max()), 1e-30)
    worst = float(np.max(np.abs(got - ref) - lim))
    assert worst <= 0, f"{what}: off by {worst:.3g} beyond the limit"


def assert_leaf_close(got: torch.Tensor, ref: torch.Tensor, what=""):
    """fp32 leaves at the fp32 limit, bf16 leaves at the bf16 one."""
    assert got.dtype == ref.dtype, what
    if got.dtype == torch.float32:
        return assert_f32_close(got, ref, what)
    g, r = _np(got), _np(ref)
    lim = BF16_ULP * np.abs(r) + BF16_ULP / 2 * float(np.abs(r).max())
    assert np.all(np.abs(g - r) <= lim), what


def assert_params_close(got: torch.Tensor, ref: torch.Tensor, lr: float,
                        steps: int, what=""):
    """Parameters after ``steps`` AdamW steps at ``lr``: every element
    within ``0.1·lr`` a step, all but 0.1 % at the leaf's own limit."""
    g, r = _np(got), _np(ref)
    assert np.abs(g - r).max() <= 0.1 * lr * steps, what
    if got.dtype == torch.float32:
        lim = TOL * np.abs(r) + TOL * float(np.abs(r).max())
    else:
        lim = BF16_ULP * np.abs(r) + BF16_ULP / 2 * float(np.abs(r).max())
    assert np.mean(np.abs(g - r) > lim) <= 1e-3, what


def _pair(name, **kw):
    return (dataclasses.replace(ref_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


def _models(name, seed=0, **kw):
    """The reference model and params, and the port's model holding them
    (trainable)."""
    rcfg, tcfg = _pair(name, **kw)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(seed))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    return rcfg, rm, params, tm


def _batch(cfg, b, s, step=0, seed=1234):
    data = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed))
    return data.batch_at(step)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_softmax_xent(softcap, dtype):
    rng = np.random.default_rng(0)
    lg = (rng.standard_normal((2, 7, 97)) * 20).astype(np.float32)
    labels = rng.integers(0, 97, (2, 7)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = ref_layers.softmax_xent(jnp.asarray(lg, jdt), jnp.asarray(labels),
                                  softcap)
    got = layers.softmax_xent(torch.from_numpy(lg).to(tdt),
                              torch.from_numpy(labels), softcap)
    assert got.dtype == torch.float32 and got.shape == ()
    assert_f32_close(got, ref, "xent")
    if softcap:                 # the cap changes the value
        plain = layers.softmax_xent(torch.from_numpy(lg).to(tdt),
                                    torch.from_numpy(labels))
        assert abs(float(plain) - float(got)) > 1e-3


# ---------------------------------------------------------------- data

DATA_CASES = {
    "text": dict(vocab_size=512, seq_len=32, global_batch=4),
    "vision": dict(vocab_size=300, seq_len=24, global_batch=4,
                   frontend="vision", n_frontend_tokens=8, d_model=16),
    "audio": dict(vocab_size=300, seq_len=16, global_batch=2,
                  frontend="audio", d_model=8, seed=7, zipf_a=1.1),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_synthetic_lm_batches_are_the_references(case):
    kw = DATA_CASES[case]
    ref = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw))
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    n = kw["global_batch"]
    for step in (0, 1, 5, 123):
        for shard in ((0, 1), (0, 2), (1, 2), (n - 1, n)):
            a, b = got.batch_at(step, shard), ref.batch_at(step, shard)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    it, rit = got.iterate(3, (1, 2)), ref.iterate(3, (1, 2))
    for _ in range(3):
        a, b = next(it), next(rit)
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_make_data_is_the_references():
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro_torch.configs.shapes import SHAPES
    for arch in ("mistral-nemo-12b", "qwen2-vl-7b", "seamless-m4t-large-v2"):
        rcfg, tcfg = _pair(arch)
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                    global_batch=2)
        rshape = dataclasses.replace(REF_SHAPES["train_4k"], seq_len=32,
                                     global_batch=2)
        a = pipeline.make_data(tcfg, shape)
        b = ref_pipeline.make_data(rcfg, rshape)
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
        for k, v in a.batch_at(2).items():
            np.testing.assert_array_equal(v, b.batch_at(2)[k])


# ---------------------------------------------------------------- optimizer

def test_schedule_is_the_references():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    rcfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = opt.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        ref = ref_opt.schedule(jnp.int32(step), rcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   atol=1e-12)


def test_global_norm_is_the_references():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(s).astype(np.float32) * 3
          for s in ((4, 5), (7,), (2, 3, 4))]
    got = opt.global_norm([torch.from_numpy(x).to(torch.bfloat16)
                           for x in xs])
    ref = ref_opt.global_norm([jnp.asarray(x, jnp.bfloat16) for x in xs])
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_init_zeros_every_moment_beside_its_parameter():
    _, _, _, tm = _models("mistral-nemo-12b")
    params = dict(tm.named_parameters())
    for md, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = opt.init(params, opt.OptConfig(moment_dtype=md))
        assert st.step.dtype == torch.int32 and int(st.step) == 0
        assert list(st.mu) == list(params) == list(st.nu)
        for n, p in params.items():
            assert st.mu[n].shape == p.shape and st.mu[n].dtype == dt
            assert not st.nu[n].any()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
def test_apply_matches_the_reference_leaf_for_leaf(params_dtype, moments):
    """Three steps of ``apply`` on identical parameters, gradients and
    state: every parameter and moment, the step, the norm and the lr."""
    kw = F32 if params_dtype == "float32" else {}
    _, _, params, tm = _models("gemma3-12b", **kw)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5,
                moment_dtype=moments)
    rocfg, tocfg = ref_opt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    rstate = ref_opt.init(params, rocfg)
    tparams = dict(tm.named_parameters())
    tstate = opt.init(tparams, tocfg)
    rng = np.random.default_rng(4)
    for step in range(3):
        # the last step's gradients are small: the clip does not bind
        amp = 1e-4 if step == 2 else 1.0
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * amp,
                                  p.dtype), params)
        tgrads = named_from_jax(tm, jax.tree.map(np.asarray, grads))
        params, rstate, rstats = ref_opt.apply(params, grads, rstate, rocfg)
        tstats = opt.apply(tparams, tgrads, tstate, tocfg)
        assert int(tstate.step) == int(rstate.step) == step + 1
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tstats["lr"]), float(rstats["lr"]),
                                   rtol=1e-6)
    want = named_from_jax(tm, jax.tree.map(np.asarray, params))
    mu = named_from_jax(tm, jax.tree.map(np.asarray, rstate.mu))
    nu = named_from_jax(tm, jax.tree.map(np.asarray, rstate.nu))
    for n, p in tparams.items():
        assert_params_close(p, want[n], tocfg.lr, 3, f"param {n}")
        assert_leaf_close(tstate.mu[n], mu[n], f"mu {n}")
        assert_leaf_close(tstate.nu[n], nu[n], f"nu {n}")


def test_opt_state_crosses_from_the_reference():
    _, _, params, tm = _models("mistral-nemo-12b", **F32)
    rocfg = ref_opt.OptConfig()
    st = ref_opt.init(params, rocfg)
    grads = jax.tree.map(jnp.ones_like, params)
    _, st, _ = ref_opt.apply(params, grads, st, rocfg)
    got = opt_state_from_jax(tm, jax.tree.map(np.asarray, st))
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    assert list(got.mu) == [n for n, _ in tm.named_parameters()]
    # block 1 is layer [1, 0] of the reference's stack
    np.testing.assert_array_equal(got.mu["blocks.1.attn.wq"].numpy(),
                                  np.asarray(st.mu["g0"]["attn"]["wq"][1, 0]))
    np.testing.assert_array_equal(got.nu["unembed"].numpy(),
                                  np.asarray(st.nu["unembed"]))


# ---------------------------------------------------------------- loss_fn

@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-12b"])
def test_loss_and_grads_match_value_and_grad(arch):
    rcfg, rm, params, tm = _models(arch, **F32)
    batch = _batch(rcfg, 2, 64)
    (rloss, raux), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, _jax_batch(batch))
    tloss, taux = tm.loss_fn(_torch_batch(batch))
    assert_f32_close(tloss, rloss, "loss")
    assert_f32_close(taux["xent"], raux["xent"], "xent")
    assert float(taux["aux"]) == float(raux["aux"]) == 0.0
    loss, grads = loss_and_grads(tm, _torch_batch(batch))
    assert_f32_close(loss, rloss, "loss")
    want = named_from_jax(tm, jax.tree.map(np.asarray, rgrads))
    assert list(grads) == list(want)
    for n, g in grads.items():
        assert g.dtype == torch.float32
        assert_f32_close(g, want[n], f"grad {n}")


def test_bf16_grads_keep_the_parameter_dtype():
    _, _, _, tm = _models("mistral-nemo-12b")
    batch = _torch_batch(_batch(tm.cfg, 2, 32))
    _, g1 = loss_and_grads(tm, batch)
    _, g2 = loss_and_grads(tm, batch, n_microbatches=2)
    assert all(g.dtype == torch.bfloat16 for g in g1.values())
    assert all(g.dtype == torch.float32 for g in g2.values())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_grads(policy):
    """Remat on and remat off: the same loss and gradients bit for bit,
    and each block's forward runs twice (once more in the backward)."""
    cfg = dataclasses.replace(smoke_config("gemma3-12b"), **F32)
    out = {}
    for remat in ("none", policy):
        tm = Model(dataclasses.replace(cfg, remat=remat), device=CPU,
                   generator=torch.Generator().manual_seed(3))
        tm.requires_grad_(True)
        batch = _torch_batch(_batch(cfg, 2, 64))
        attn.attention.calls.update(flash=0, chunked=0)
        out[remat] = loss_and_grads(tm, batch)
        assert attn.attention.calls["chunked"] == \
            cfg.n_layers * (1 if remat == "none" else 2)
    (l0, g0), (l1, g1) = out["none"], out[policy]
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_is_off_without_autograd():
    cfg = dataclasses.replace(smoke_config("mistral-nemo-12b"), **F32)
    tm = Model(cfg, device=CPU)
    toks = torch.from_numpy(_batch(cfg, 1, 32)["tokens"])
    tm.requires_grad_(True)
    with torch.no_grad():
        attn.attention.calls.update(flash=0, chunked=0)
        tm(toks)
    assert attn.attention.calls["chunked"] == cfg.n_layers


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_the_reference(n_micro):
    """Three steps of ``build_train_step`` on identical weights and
    batches: the loss, norm and lr of each, and the final parameters."""
    rcfg, rm, params, tm = _models("mistral-nemo-12b", **F32)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    rocfg, tocfg = ref_opt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    rstate = ref_opt.init(params, rocfg)
    rstep = jax.jit(ref_build_train_step(rm, rocfg, n_microbatches=n_micro))
    tstate = opt.init(dict(tm.named_parameters()), tocfg)
    tstep = build_train_step(tm, tocfg, tstate, n_microbatches=n_micro)
    for step in range(3):
        batch = _batch(rcfg, 4, 32, step=step)
        params, rstate, rm_ = rstep(params, rstate, _jax_batch(batch))
        tm_ = tstep(_torch_batch(batch))
        for k in ("loss", "grad_norm", "lr"):
            assert_f32_close(tm_[k], rm_[k], f"step {step} {k}")
    want = named_from_jax(tm, jax.tree.map(np.asarray, params))
    for n, p in tm.named_parameters():
        assert_params_close(p, want[n], tocfg.lr, 3, n)


def test_microbatches_give_the_same_loss_sequence():
    losses = {}
    for n_micro in (1, 2):
        _, _, _, tm = _models("mistral-nemo-12b", **F32)
        tocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
        tstate = opt.init(dict(tm.named_parameters()), tocfg)
        step = build_train_step(tm, tocfg, tstate, n_microbatches=n_micro)
        losses[n_micro] = [float(step(_torch_batch(
            _batch(tm.cfg, 4, 32, step=s)))["loss"]) for s in range(3)]
    assert_f32_close(np.array(losses[2]), np.array(losses[1]), "losses")


def test_build_train_step_refuses_a_foreign_state():
    _, _, _, tm = _models("mistral-nemo-12b", **F32)
    st = opt.init({"w": torch.zeros(2)}, opt.OptConfig())
    with pytest.raises(ValueError, match="trainable"):
        build_train_step(tm, opt.OptConfig(), st)


def test_loss_decreases_on_fixed_batch():
    """``tests/test_archs_smoke.py::test_loss_decreases_on_fixed_batch``
    on the port: 8 steps on one batch at lr 3e-3 lower the loss by more
    than 0.2."""
    cfg = smoke_config("mistral-nemo-12b")
    tm = Model(cfg, device=CPU)
    tm.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=50)
    step = build_train_step(tm, ocfg, opt.init(dict(tm.named_parameters()),
                                               ocfg))
    losses = [float(step(batch)["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.2, losses


# ---------------------------------------------------------------- the CLI

_NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]\d+)?")


def _skeleton(text):
    """The lines with every number a ``#`` and runs of blanks one blank
    (the padding of a fixed-width number depends on its size)."""
    return [re.sub(r"\s+", " ", _NUM.sub("#", line.strip()))
            for line in text.splitlines() if line.strip()]


def test_cli_prints_the_references_lines(capsys):
    args = ["--arch", "mistral-nemo-12b", "--smoke", "--steps", "20",
            "--batch", "2", "--seq", "32", "--log-every", "5"]
    assert train.main(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert ref_train.main(args) == 0
    ref = capsys.readouterr().out
    assert _skeleton(ours) == _skeleton(ref)
    assert re.match(r"step +0 loss +\d+\.\d{4} gnorm +\d+\.\d{3} "
                    r"lr \d\.\d\de-\d\d \( *\d+\.\ds\)", ours)
    assert re.search(r"loss \d+\.\d{4} -> \d+\.\d{4} \((NOT )?improved\)",
                     ours.splitlines()[-1])


def _leaf_files(d):
    step = sorted(x for x in os.listdir(d) if x.startswith("step_"))[-1]
    full = os.path.join(d, step)
    return step, {f: open(os.path.join(full, f), "rb").read()
                  for f in os.listdir(full) if f.endswith(".npy")}


def test_injected_failure_resumes_bit_for_bit(tmp_path, capsys):
    """``--inject-failure-at`` with ``--ckpt-dir``: the run restores the
    last checkpoint, replays from there, and ends in the same state as an
    uninterrupted run, leaf for leaf and byte for byte."""
    base = ["--arch", "gemma3-12b", "--smoke", "--steps", "7", "--batch",
            "2", "--seq", "64", "--ckpt-every", "2", "--log-every", "1",
            "--device", "cpu"]
    assert train.main(base + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    clean = capsys.readouterr().out
    assert train.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                              "--inject-failure-at", "5"]) == 0
    crashed = capsys.readouterr().out
    assert '"restarts": 0' in clean and '"restarts": 1' in crashed
    # steps 4 (from the step-3 checkpoint) and 5 ran again after the crash
    assert len([ln for ln in crashed.splitlines()
                if ln.startswith("step")]) == 7 + 1
    sa, a = _leaf_files(tmp_path / "a")
    sb, b = _leaf_files(tmp_path / "b")
    assert sa == sb == "step_00000006" and sorted(a) == sorted(b)
    for f in a:
        assert a[f] == b[f], f
    # the losses of the last step agree too
    assert clean.splitlines()[-2].split("(")[0] == \
        crashed.splitlines()[-2].split("(")[0]


def test_run_train_returns_the_live_state():
    cfg = smoke_config("mistral-nemo-12b")
    out = train.run_train(cfg, steps=3, batch=2, seq=32, device=CPU,
                          log=lambda line: None)
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert int(out["opt_state"].step) == 3
    assert all(p.requires_grad for p in out["model"].parameters())
    assert np.all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("argv,reason,gpus", [
    ([], "no CUDA device", 0),
    # once the MoE arch's refusal, then qwen2-vl's (M-RoPE and the vision
    # frontend, ported now): without a GPU it is refused for the device
    (["--arch", "qwen2-vl-7b"], "no CUDA device", 0),
    # once "not ported"; now a mesh of more ranks than GPUs
    (["--arch", "mistral-nemo-12b", "--smoke", "--mesh", "2x4"],
     "--mesh 2x4 needs 8 GPUs, one process each; 1 visible", 1),
    (["--arch", "mistral-nemo-12b"], "no CUDA device", 0),
], ids=["xlstm-default", "kimi-moe", "mesh-2x4", "no-gpu"])
def test_cli_refusals_name_the_reason(argv, reason, gpus, monkeypatch,
                                      capsys):
    """Each refusal exits 2 before anything is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def no_build(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(Model, "__init__", no_build)
    assert train.main(argv) == 2
    assert reason in capsys.readouterr().err
