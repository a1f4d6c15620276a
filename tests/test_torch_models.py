"""The LM substrate of the PyTorch port (``repro_torch.models``,
``repro_torch.launch.steps``) against the JAX package's (``repro.models``):
the same seeded numpy inputs, and the reference's own ``Model.init``
weights carried over by ``load_jax_params``, through both, on the CPU.

Configs: the smoke configs of ``mistral-nemo-12b`` (hd 16: the chunked
route), ``gemma3-12b`` (``attn_local`` with window 32 plus ``attn``) and
``starcoder2-7b`` (tanh-GELU MLP); one at ``head_dim=64``, S = 128 with
GQA (``n_rep = 2``), so that attention takes the flash route and runs the
kernel's plain version; one with ``attention_chunk=64`` so that the
reference scans query chunks.

Tolerances:

* fp32 (``param_dtype = compute_dtype = "float32"``): every output within
  ``atol = rtol = 1e-4``; greedy tokens identical.
* bf16, one op or one block: ``|Δ| <= 0.05·rms(ref) + 2⁻⁶·|ref|`` element
  by element (the limit ``chip_smoke.py`` holds the kernels to).
* bf16, model logits: per position, the error's rms over the vocabulary
  ``<= 0.05·rms(ref)``; decode teacher-forced, so that one argmax flip
  cannot cascade.  The element-by-element limit is bf16's own spread at
  the model level: the reference's bf16 logits miss its own fp32 logits
  of the same weights by up to 1.3 times it (two layers, three seeds),
  while the per-position error rms of both packages stays near 1 %.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.blocks import AttnBlock
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import Model

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = RTOL = 1e-4
REL_RMS = 0.05


# ---------------------------------------------------------------- helpers

def _jnp(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, ref, dtype):
    """fp32: atol = rtol = 1e-4; bf16: the kernel limit, element-wise."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
        return
    limit = 0.05 * np.sqrt(np.mean(ref ** 2)) + 2.0 ** -6 * np.abs(ref)
    share = np.max(np.abs(got - ref) / limit)
    assert share <= 1.0, f"bf16 error is {share:.3g} of the limit"


def assert_logits_close(got, ref, dtype):
    """fp32: atol = rtol = 1e-4; bf16: per-position error rms."""
    if dtype == "float32":
        return assert_close(got, ref, dtype)
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    ratio = np.sqrt(np.mean((got - ref) ** 2, axis=-1)) / \
        np.sqrt(np.mean(ref ** 2, axis=-1))
    assert ratio.max() <= REL_RMS, \
        f"per-position error rms {ratio.max():.3g} of the logits' rms"


def _pair(name, **kw):
    """The same config in both packages: the smoke variant of ``name``
    with ``kw`` replaced."""
    return (dataclasses.replace(ref_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


MODEL_CASES = {
    # case: (arch, replaced fields, prompt length, route of every layer)
    "mistral_f32": ("mistral-nemo-12b", F32, 32, "chunked"),
    "mistral_bf16": ("mistral-nemo-12b", {}, 32, "chunked"),
    "gemma3_f32": ("gemma3-12b", F32, 64, "chunked"),
    "gemma3_bf16": ("gemma3-12b", {}, 64, "chunked"),
    "starcoder2_f32": ("starcoder2-7b", F32, 32, "chunked"),
    "flash_hd64_f32": ("mistral-nemo-12b",
                       dict(F32, head_dim=64, n_kv_heads=2), 128, "flash"),
    "flash_hd64_bf16": ("mistral-nemo-12b",
                        dict(head_dim=64, n_kv_heads=2), 128, "flash"),
    "chunk64_f32": ("gemma3-12b",
                    dict(F32, attention_chunk=64, head_dim=32, n_kv_heads=2),
                    128, "chunked"),
}


@functools.lru_cache(maxsize=None)
def model_pair(case):
    """(reference config, reference model, its params, port model with
    those params, dtype name, prompt length, route) for ``case``."""
    arch, kw, s, route = MODEL_CASES[case]
    rcfg, tcfg = _pair(arch, **kw)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    return rcfg, rm, params, tm, tcfg.compute_dtype, s, route


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _reset_routes():
    attn.attention.calls.update(flash=0, chunked=0)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    ref = ref_layers.rms_norm(_jnp(x, dtype), _jnp(w, dtype))
    got = layers.rms_norm(_torch(x, dtype), _torch(w, dtype))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6)])
def test_apply_rope(dtype, hd, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = np.arange(100, 112)[None, :]
    ref = ref_layers.apply_rope(_jnp(x, dtype), jnp.asarray(pos), theta)
    got = layers.apply_rope(_torch(x, dtype), torch.from_numpy(pos), theta)
    assert_close(got, ref, dtype)
    # half-split rotation: position 0 leaves x unchanged
    zero = layers.apply_rope(_torch(x, dtype), torch.zeros(1, 12), theta)
    np.testing.assert_array_equal(_np(zero), _np(_torch(x, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind, dtype):
    rng = np.random.default_rng(2)
    d, ff = 32, 96
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    ws = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])
              ).astype(np.float32)
          for k, shape in (("w1", (d, ff)), ("w3", (d, ff)), ("w2", (ff, d)))}
    if kind == "gelu":
        del ws["w3"]
    ref = ref_layers.mlp(_jnp(x, dtype),
                         {k: _jnp(v, dtype) for k, v in ws.items()})
    p = type("P", (), {k: _torch(v, dtype) for k, v in ws.items()})
    if kind == "gelu":
        p.w3 = None
    got = layers.mlp(_torch(x, dtype), p)
    assert_close(got, ref, dtype)


def test_mlp_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101).reshape(1, 101)
    p = type("P", (), dict(w1=torch.eye(101), w2=torch.eye(101), w3=None))
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(layers.mlp(x, p).numpy(), ref, atol=1e-6)
    erf = torch.nn.functional.gelu(x).numpy()
    assert np.abs(erf - ref).max() > 1e-4      # a different function


# ---------------------------------------------------------------- attention

ATTN_CASES = {
    # case: (B, Sq, Sk, H, KV, hd, causal, window, q_offset, chunk, route)
    "flash_gqa_hd64": (2, 128, 128, 4, 2, 64, True, None, 0, 0, "flash"),
    "flash_hd128_mha": (1, 64, 64, 2, 2, 128, True, None, 0, 0, "flash"),
    "window": (2, 64, 64, 4, 2, 64, True, 16, 0, 0, "chunked"),
    "offset": (1, 32, 96, 4, 1, 16, True, None, 64, 0, "chunked"),
    "hd16_chunked": (2, 128, 128, 4, 2, 16, True, None, 0, 32, "chunked"),
    "hd256": (1, 64, 64, 2, 1, 256, True, None, 0, 0, "chunked"),
    "full": (1, 64, 64, 2, 2, 64, False, None, 0, 0, "chunked"),
    "window_chunked": (1, 128, 128, 4, 4, 32, True, 24, 0, 64, "chunked"),
}


def _qkv(b, sq, sk, h, kv, hd, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case, dtype):
    b, sq, sk, h, kv, hd, causal, window, off, chunk, route = \
        ATTN_CASES[case]
    q, k, v = _qkv(b, sq, sk, h, kv, hd)
    ref = ref_attn.attention(*(_jnp(a, dtype) for a in (q, k, v)),
                             causal=causal, window=window, q_offset=off,
                             chunk=chunk)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    assert attn.attention_route(tq, tk, causal, window, off)[0] == route
    _reset_routes()
    got = attn.attention(tq, tk, tv, causal=causal, window=window,
                         q_offset=off, chunk=chunk)
    assert attn.attention.calls == {route: 1, ("chunked" if route == "flash"
                                               else "flash"): 0}
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert_close(got, ref, dtype)
    if route == "flash":       # the chunked route computes the same
        forced = attn.attention(tq, tk, tv, causal=causal, chunk=chunk,
                                force_chunked=True)
        assert_close(got, forced, dtype)


def test_repeat_kv_interleaves_heads():
    k = torch.arange(3, dtype=torch.float32).reshape(1, 1, 3, 1)
    got = attn._repeat_kv(k, 2)[0, 0, :, 0].tolist()
    assert got == [0, 0, 1, 1, 2, 2]
    ref = np.asarray(ref_attn._repeat_kv(jnp.asarray(k.numpy()), 2))
    np.testing.assert_array_equal(got, ref[0, 0, :, 0])


ROUTE_CASES = [
    # (B, Sq, Sk, H, KV, hd, dtype, causal, window, off, route, reason)
    (1, 128, 128, 4, 2, 128, torch.bfloat16, True, None, 0, "flash",
     "causal self-attention"),
    (2, 64, 64, 4, 4, 64, torch.float32, True, None, 0, "flash",
     "causal self-attention"),
    (1, 128, 128, 4, 2, 128, torch.bfloat16, False, None, 0, "chunked",
     "not causal"),
    (1, 128, 128, 4, 2, 128, torch.bfloat16, True, 32, 0, "chunked",
     "sliding window"),
    (1, 64, 128, 4, 2, 128, torch.bfloat16, True, None, 64, "chunked",
     "query offset"),
    (1, 64, 128, 4, 2, 128, torch.bfloat16, True, None, 0, "chunked",
     "Sq=64 != Sk=128"),
    (1, 96, 96, 4, 2, 128, torch.bfloat16, True, None, 0, "chunked",
     "not a multiple of 64"),
    (1, 128, 128, 4, 2, 256, torch.bfloat16, True, None, 0, "chunked",
     "head_dim 256"),
    (1, 128, 128, 4, 2, 16, torch.float32, True, None, 0, "chunked",
     "head_dim 16"),
    (1, 128, 128, 4, 2, 128, torch.float16, True, None, 0, "chunked",
     "dtype torch.float16"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[-1])
def test_attention_route(case):
    b, sq, sk, h, kv, hd, dtype, causal, window, off, route, reason = case
    q = torch.zeros((b, sq, h, hd), dtype=dtype)
    k = torch.zeros((b, sk, kv, hd), dtype=dtype)
    got, why = attn.attention_route(q, k, causal, window, off)
    assert got == route and reason in why
    if route == "flash":     # exactly what the kernel wrapper accepts
        assert hd in flash_mod.HD_CHOICES and sq % flash_mod.S_MULTIPLE == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_and_update_cache(window, dtype):
    b, s, h, kv, hd, pos = 2, 24, 4, 2, 16, 13
    q, kc, vc = _qkv(b, 1, s, h, kv, hd, seed=4)
    knew, vnew = _qkv(b, 1, 1, kv, kv, hd, seed=5)[1:]
    rk, rv = ref_attn.update_cache(_jnp(kc, dtype), _jnp(vc, dtype),
                                   _jnp(knew, dtype), _jnp(vnew, dtype),
                                   jnp.int32(pos))
    ref = ref_attn.decode_attention(_jnp(q, dtype), rk, rv,
                                    jnp.int32(pos + 1), window=window)
    tk, tv = _torch(kc, dtype), _torch(vc, dtype)
    out_k, out_v = attn.update_cache(tk, tv, _torch(knew, dtype),
                                     _torch(vnew, dtype), pos)
    assert out_k is tk and out_v is tv           # written in place
    np.testing.assert_array_equal(_np(tk), _np(rk))
    np.testing.assert_array_equal(_np(tv), _np(rv))
    got = attn.decode_attention(_torch(q, dtype), tk, tv, pos + 1,
                                window=window)
    assert_close(got, ref, dtype)


# ---------------------------------------------------------------- block

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local", [False, True])
def test_attn_block_forward_and_decode(local, dtype):
    kw = dict(head_dim=64, n_kv_heads=2, sliding_window=48)
    if dtype == "float32":
        kw.update(F32)
    rcfg, tcfg = _pair("mistral-nemo-12b", **kw)
    params, _ = ref_blocks.build_attn(rcfg, jax.random.PRNGKey(3))
    blk = AttnBlock(tcfg, local=local, generator=torch.Generator())
    with torch.no_grad():
        for name, p in blk.named_parameters():
            leaf = params
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(_torch(np.asarray(leaf, np.float32), dtype))
    x = np.random.default_rng(6).standard_normal((2, 128, 64)).astype(
        np.float32)
    ref, _ = ref_blocks.train_attn(rcfg, params, _jnp(x, dtype), local=local)
    _reset_routes()
    with torch.inference_mode():
        got = blk(_torch(x, dtype))
    assert attn.attention.calls == ({"flash": 0, "chunked": 1} if local
                                    else {"flash": 1, "chunked": 0})
    assert_close(got, ref, dtype)

    # decode four tokens into a cache, from position 0
    cache = ref_blocks.cache_init_attn(rcfg, 2, 8)
    tcache = blk.init_cache(2, 8)
    assert tcache["k"].shape == tuple(cache["k"].shape)
    for pos in range(4):
        xt = x[:, pos:pos + 1]
        ref_t, cache = ref_blocks.decode_attn(rcfg, params, cache,
                                              _jnp(xt, dtype),
                                              jnp.int32(pos), local=local)
        with torch.inference_mode():
            got_t = blk.decode(tcache, _torch(xt, dtype), pos)
        assert_close(got_t, ref_t, dtype)
        assert_close(tcache["k"], cache["k"], dtype)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_forward(case):
    rcfg, rm, params, tm, dtype, s, route = model_pair(case)
    toks = _tokens(rcfg.vocab_size, 2, s)
    ref, _ = rm.forward(params, jnp.asarray(toks, jnp.int32))
    _reset_routes()
    got = build_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert attn.attention.calls[route] == rcfg.n_layers
    assert got.shape == (2, s, rcfg.vocab_size)
    assert_logits_close(got, ref, dtype)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_greedy_decode(case):
    """A 4-token prompt stepped through ``decode_step``, then 8 greedy
    steps; bf16 teacher-forced on the reference's tokens."""
    rcfg, rm, params, tm, dtype, _, _ = model_pair(case)
    prompt = _tokens(rcfg.vocab_size, 2, 4, seed=7)
    steps = prompt.shape[1] + 8
    rcache = rm.init_cache(2, steps)
    tcache = tm.init_cache(2, steps)
    assert len(tcache) == rcfg.n_layers
    ref_step = jax.jit(rm.decode_step)
    step = build_serve_step(tm)
    rtok = ttok = prompt[:, :1]
    for i in range(steps):
        rl, rcache = ref_step(params, rcache, jnp.asarray(rtok, jnp.int32),
                              jnp.int32(i))
        feed = rtok if dtype == "bfloat16" else ttok
        tl = step(tcache, torch.from_numpy(np.array(feed)), i)
        assert tl.shape == (2, 1, rcfg.vocab_size)
        assert_logits_close(tl, rl, dtype)
        if i + 1 < prompt.shape[1]:
            rtok = ttok = prompt[:, i + 1:i + 2]
            continue
        rtok = np.asarray(jnp.argmax(rl[:, -1:], axis=-1))
        ttok = torch.argmax(tl[:, -1:], dim=-1).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, rtok)


def test_decode_steps_match_the_forward():
    """The port against itself: ``decode_step`` position by position
    equals one forward over the same tokens (flash route, fp32)."""
    _, _, _, tm, _, s, _ = model_pair("flash_hd64_f32")
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 1, s, seed=8))
    fwd = build_prefill_step(tm)({"tokens": toks})
    cache = tm.init_cache(1, s)
    step = build_serve_step(tm)
    dec = torch.cat([step(cache, toks[:, i:i + 1], i) for i in range(s)],
                    dim=1)
    assert_close(dec, fwd, "float32")


@pytest.mark.parametrize("case", ["flash_hd64_f32", "flash_hd64_bf16"])
def test_forced_chunked_route_matches_flash(case):
    _, _, _, tm, dtype, s, _ = model_pair(case)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 2, s, seed=9))
    with torch.inference_mode():
        _reset_routes()
        flash = tm(toks)
        assert attn.attention.calls == {"flash": tm.cfg.n_layers,
                                        "chunked": 0}
        _reset_routes()
        chunked = tm(toks, force_chunked=True)
        assert attn.attention.calls == {"flash": 0,
                                        "chunked": tm.cfg.n_layers}
    assert_logits_close(flash, chunked, dtype)


def test_load_jax_params_follows_the_scan_order():
    """Block ``n`` of the port holds layer ``[s, r]`` of pattern entry
    ``i`` in the order the reference's scan visits them."""
    rcfg, _, params, tm, _, _, _ = model_pair("gemma3_f32")
    per = sum(b.repeat for b in rcfg.pattern)
    assert len(tm.blocks) == per * rcfg.n_super
    n = 0
    for s in range(rcfg.n_super):
        for i, b in enumerate(rcfg.pattern):
            for r in range(b.repeat):
                blk = tm.blocks[n]
                assert blk.local == (b.kind == "attn_local")
                np.testing.assert_array_equal(
                    blk.attn.wq.numpy(),
                    np.asarray(params[f"g{i}"]["attn"]["wq"][s, r]))
                n += 1
    np.testing.assert_array_equal(tm.unembed.numpy(),
                                  np.asarray(params["unembed"]))


def test_load_jax_params_carries_bf16_bits():
    _, _, params, tm, _, _, _ = model_pair("mistral_bf16")
    assert tm.embed.dtype == torch.bfloat16
    ref = np.asarray(params["embed"]).view(np.uint16)
    got = tm.embed.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, ref)


def test_load_jax_params_refuses_a_wrong_shape():
    _, _, params, _, _, _, _ = model_pair("mistral_f32")
    _, tcfg = _pair("mistral-nemo-12b", d_ff=64, **F32)
    with pytest.raises(ValueError, match="w1"):
        load_jax_params(Model(tcfg, device=CPU),
                        jax.tree.map(np.asarray, params))


def test_model_builds_on_the_generator_device_and_needs_no_grad():
    cfg = dataclasses.replace(smoke_config("starcoder2-7b"), **F32)
    a = Model(cfg, device=CPU, generator=torch.Generator().manual_seed(5))
    b = Model(cfg, device=CPU, generator=torch.Generator().manual_seed(5))
    assert all(not p.requires_grad and p.device.type == "cpu"
               for p in a.parameters())
    assert a.blocks[0].mlp.w3 is None             # 2-matrix GELU MLP
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    n = sum(p.numel() for p in a.parameters())
    norms = cfg.d_model * (2 * cfg.n_layers + 1)   # not in param_count
    assert n == cfg.param_count() + norms


def test_tied_embeddings_use_the_embedding_as_head():
    rcfg, tcfg = _pair("mistral-nemo-12b", tie_embeddings=True, **F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(2))
    assert "unembed" not in params
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    assert tm.unembed is None
    toks = _tokens(rcfg.vocab_size, 1, 16)
    ref, _ = rm.forward(params, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    assert_close(got, ref, "float32")


def test_full_width_config_is_the_references():
    """``mistral-nemo-12b``, the config the card runs at full width."""
    cfg, ref = get_config("mistral-nemo-12b"), ref_get_config(
        "mistral-nemo-12b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.hd in flash_mod.HD_CHOICES
