"""``serve decode`` of the PyTorch port (``repro_torch.launch.serve``) on
the CPU: the CLI end to end on the smoke configs, its refusals (an
unknown arch, no GPU without ``--device``), the configs registry against
the JAX package's, and the decode loop against the reference's on the
same weights and prompts."""
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
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config, \
    smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import Model, unported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("mistral-nemo-12b", "gemma3-12b", "starcoder2-7b",
          "command-r-35b", "xlstm-350m", "zamba2-2.7b", "arctic-480b",
          "kimi-k2-1t-a32b", "seamless-m4t-large-v2", "qwen2-vl-7b")


def _run(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-12b"])
def test_decode_cli_on_the_cpu(arch):
    out = _run(["decode", "--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "16", "--gen", "8"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke batch=2 prompt=16 gen=8")
    assert "device=cpu" in lines[0]
    assert lines[1].startswith("prefill:") and "decode:" in lines[1]
    assert lines[2].startswith("first generated rows:")
    assert lines[-1] == "serve ok"


@pytest.mark.slow
def test_decode_cli_refuses_an_unported_arch():
    """Every arch of the registry is ported now (the MoE arch, then
    ``qwen2-vl-7b``, were refused here before): an arch the registry does
    not have is refused, naming it."""
    out = _run(["decode", "--arch", "qwen3-vl-8b", "--smoke",
                "--device", "cpu"])
    assert out.returncode != 0
    assert "qwen3-vl-8b" in out.stderr
    assert "serve ok" not in out.stdout


def test_decode_main_resolves_the_device_before_building(monkeypatch,
                                                         capsys):
    """Without ``--device`` and without a GPU, the full 12 B config fails
    at once: no weights are built on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_build(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(Model, "__init__", no_build)
    assert serve.decode_main(["--arch", "gemma3-12b"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_moe_config_is_refused():
    """Once the MoE arch's refusal, then ``qwen2-vl-7b``'s (M-RoPE and
    the vision frontend); both are ported now, so what is refused is a
    block kind the port does not have."""
    for arch in ("arctic-480b", "qwen2-vl-7b"):
        assert unported(smoke_config(arch)) is None
    cfg = smoke_config("qwen2-vl-7b")
    cfg = dataclasses.replace(cfg, pattern=(dataclasses.replace(
        cfg.pattern[0], kind="hyena"),))
    assert "block kind 'hyena'" in unported(cfg)
    with pytest.raises(NotImplementedError, match="block kind 'hyena'"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_equal_the_references(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(ref_smoke_config(arch))
    assert (unported(cfg) is None) == (arch in PORTED)


def test_registry_and_shapes_equal_the_references():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert all_cells() == ref_all_cells()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_prompts_are_the_references():
    """Both CLIs feed the same tokens (``np.random.default_rng(0)``)."""
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(serve.make_inputs(512, 4, 64)[0],
                                  rng.integers(0, 512, (4, 64)))


def test_decode_loop_generates_the_references_tokens():
    """The serving loop of both packages on the same fp32 weights and
    prompts: the reference's ``decode_main`` loop, transcribed, against
    ``serve.run_decode``."""
    cfg = dataclasses.replace(ref_smoke_config("gemma3-12b"),
                              param_dtype="float32",
                              compute_dtype="float32")
    rm = RefModel(cfg)
    params = rm.init(jax.random.PRNGKey(0))
    b, pl_, g = 2, 8, 8
    prompts = serve.make_inputs(cfg.vocab_size, b, pl_)[0]
    cache = rm.init_cache(b, pl_ + g + 1)
    decode = jax.jit(rm.decode_step)
    tok = jnp.asarray(prompts[:, 0:1], jnp.int32)
    for i in range(pl_):
        logits, cache = decode(params, cache, tok, jnp.int32(i))
        tok = jnp.asarray(prompts[:, i + 1:i + 2], jnp.int32) \
            if i + 1 < pl_ else \
            jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    ref = []
    for i in range(g):
        logits, cache = decode(params, cache, tok, jnp.int32(pl_ + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        ref.append(np.asarray(tok)[:, 0])

    tcfg = dataclasses.replace(smoke_config("gemma3-12b"),
                               param_dtype="float32",
                               compute_dtype="float32")
    tm = load_jax_params(Model(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, params))
    res = serve.run_decode(tm, torch.from_numpy(prompts), g)
    np.testing.assert_array_equal(res["tokens"], np.stack(ref, axis=1))
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    assert res["encode_s"] is None
