"""qwen2-vl on the PyTorch port (``layers.apply_m_rope``, M-RoPE in the
attention blocks, ``Model.forward(frontend=...)`` and the frontend slice
of ``loss_fn``, the ``serve decode`` and ``train`` CLIs) against the JAX
package's, on the CPU: the same seeded numpy inputs, and the reference's
own ``Model.init`` weights carried over by ``load_jax_params``.

Tolerances:

* ``apply_m_rope``: fp32 within 1e-6 (max abs), bf16 equal.  Both compute
  the angles in fp32 and cast once.
* Model logits and losses: the dense decoder's
  (``tests/test_torch_models.py``): fp32 ``atol = rtol = 1e-4``; bf16
  logits per position, the error's rms over the vocabulary within 5 % of
  the logits' rms; a bf16 loss within 1 % of the reference's.
* Gradients against ``jax.value_and_grad`` (fp32): ``|Δ| <= 1e-4·|ref| +
  1e-4·max|ref of the leaf|`` (``tests/test_torch_train.py``).
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

from repro.configs import smoke_config as ref_smoke_config
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import pipeline
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      loss_and_grads)
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.convert import load_jax_params, named_from_jax
from repro_torch.models.model import Model, unported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-vl-7b"
CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-4
REL_RMS = 0.05


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


def assert_logits_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
        return
    ratio = np.sqrt(np.mean((got - ref) ** 2, axis=-1)) / \
        np.sqrt(np.mean(ref ** 2, axis=-1))
    assert ratio.max() <= REL_RMS, \
        f"per-position error rms {ratio.max():.3g} of the logits' rms"


def _models(**kw):
    rcfg = dataclasses.replace(ref_smoke_config(ARCH), **kw)
    tcfg = dataclasses.replace(smoke_config(ARCH), **kw)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    return rcfg, rm, params, tm


def _batch(cfg, b, s, step=0):
    """A ``SyntheticLM`` batch of the vision config: ``frontend`` [b, nf,
    d] and ``s - nf`` text tokens and labels."""
    data = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
        frontend="vision", n_frontend_tokens=cfg.n_frontend_tokens,
        d_model=cfg.d_model, seed=1234))
    return data.batch_at(step)


# ---------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", ["one", "three"])
def test_apply_m_rope_matches_the_reference(streams, dtype):
    """``[B,S]`` positions (stacked three times) and three distinct
    streams ``[B,S,3]``, which the model path never feeds."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    shape = (2, 24) if streams == "one" else (2, 24, 3)
    pos = rng.integers(0, 4096, shape).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = ref_layers.apply_m_rope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                  1e6)
    got = layers.apply_m_rope(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(pos), 1e6)
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "float32":
        assert np.abs(_np(got) - _np(ref)).max() <= 1e-6
    else:
        np.testing.assert_array_equal(_np(got), _np(ref))


def test_m_rope_sections_rotate_by_their_own_stream():
    """Section (2, 1, 1) of hd 32: frequencies 0..7 turn with stream 0,
    8..11 with stream 1, 12..15 with stream 2; with one stream, M-RoPE
    is plain RoPE."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 5, 2, 32))).float()
    pos = torch.from_numpy(rng.integers(0, 100, (1, 5)))
    torch.testing.assert_close(layers.apply_m_rope(x, pos, 1e4),
                               layers.apply_rope(x, pos, 1e4))
    three = torch.stack([pos, pos + 7, pos + 11], dim=-1)
    out = layers.apply_m_rope(x, three, 1e4)
    for i, (a, b) in enumerate(((0, 8), (8, 12), (12, 16))):
        want = layers.apply_rope(x, three[..., i], 1e4)
        for half in (0, 16):
            torch.testing.assert_close(out[..., half + a:half + b],
                                       want[..., half + a:half + b])


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_frontend_matches_the_reference(dtype):
    rcfg, rm, params, tm = _models(**(F32 if dtype == "float32" else {}))
    batch = _batch(rcfg, 2, 40)
    nf = rcfg.n_frontend_tokens
    ref, _ = rm.forward(params, jnp.asarray(batch["tokens"]),
                        frontend=jnp.asarray(batch["frontend"]))
    attn.attention.calls.update(flash=0, chunked=0)
    got = build_prefill_step(tm)({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert got.shape == (2, 40, rcfg.vocab_size)
    assert attn.attention.calls["chunked"] == rcfg.n_layers
    assert_logits_close(got, ref, dtype)
    # the frontend is really in the stream: without it the text logits
    # move (every text position attends to the nf frontend positions)
    with torch.inference_mode():
        text = tm(torch.from_numpy(batch["tokens"]))
    assert text.shape == (2, 40 - nf, rcfg.vocab_size)
    assert float((text.float() - got[:, nf:].float()).abs().max()) > 1e-3


def test_loss_and_grads_with_frontend_match_value_and_grad():
    """The frontend-sliced loss (fp32) and every gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    rcfg, rm, params, tm = _models(**F32)
    tm.requires_grad_(True)
    batch = _batch(rcfg, 2, 48)
    assert batch["labels"].shape == (2, 48 - rcfg.n_frontend_tokens)
    (rloss, raux), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, taux = tm.loss_fn(tb)
    assert_f32_close(tloss, rloss, "loss")
    assert_f32_close(taux["xent"], raux["xent"], "xent")
    loss, grads = loss_and_grads(tm, tb)
    assert_f32_close(loss, rloss, "loss")
    want = named_from_jax(tm, jax.tree.map(np.asarray, rgrads))
    assert list(grads) == list(want)
    for n, g in grads.items():
        assert_f32_close(g, want[n], f"grad {n}")


def test_bf16_loss_with_frontend_matches_the_reference():
    rcfg, rm, params, tm = _models()
    batch = _batch(rcfg, 2, 40, step=3)
    rloss, _ = rm.loss_fn(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    with torch.no_grad():
        tloss, _ = tm.loss_fn({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(float(tloss) - float(rloss)) <= 0.01 * abs(float(rloss))


def test_decode_steps_match_the_forward_and_the_reference():
    """Text-only decode (the CLI's prompt), fp32: the port's
    ``decode_step`` position by position equals its forward over the
    same tokens, and the reference's decode step by step."""
    rcfg, rm, params, tm = _models(**F32)
    s = 12
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size, (2, s))
    fwd = build_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    cache = tm.init_cache(2, s)
    step = build_serve_step(tm)
    dec = torch.cat([step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
                     for i in range(s)], dim=1)
    np.testing.assert_allclose(_np(dec), _np(fwd), atol=TOL, rtol=TOL)
    rcache = rm.init_cache(2, s)
    ref_step = jax.jit(rm.decode_step)
    for i in range(s):
        rl, rcache = ref_step(params, rcache,
                              jnp.asarray(toks[:, i:i + 1], jnp.int32),
                              jnp.int32(i))
        np.testing.assert_allclose(_np(dec[:, i:i + 1]), _np(rl),
                                   atol=TOL, rtol=TOL)


def test_every_config_is_buildable():
    """No config of ``configs/archs.py`` is refused for a missing part of
    the LM substrate; a block kind the port lacks is named."""
    from repro_torch.configs import ARCHS
    for arch in ARCHS:
        assert unported(get_config(arch)) is None, arch
    bad = dataclasses.replace(
        smoke_config(ARCH),
        pattern=(dataclasses.replace(smoke_config(ARCH).pattern[0],
                                     kind="retnet"),))
    assert "block kind 'retnet'" in unported(bad)
    with pytest.raises(NotImplementedError, match="retnet"):
        Model(bad, device=CPU)


# ---------------------------------------------------------------- CLIs

def _cli(module, args):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


def test_serve_decode_cli():
    out = _cli("repro_torch.launch.serve",
               ["decode", "--arch", ARCH, "--smoke", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={ARCH}-smoke batch=4 prompt=64 gen=32")
    assert lines[-1] == "serve ok"


def test_train_cli_improves():
    out = _cli("repro_torch.launch.train",
               ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                "24", "--batch", "2", "--seq", "64"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].endswith("(improved)")
