"""The encoder-decoder path of the PyTorch port (``blocks.AttnBlock`` with
cross-attention, ``Model``'s encoder, the cross K/V of ``init_cache``,
non-causal attention on the flash route) against the JAX package's, on
the CPU: the same seeded numpy inputs, and the reference's own
``build_attn`` / ``Model.init`` weights carried over, through both.

Config: the smoke config of ``seamless-m4t-large-v2`` (2 encoder and 2
decoder layers, d 64, 4 heads of 16), in fp32 unless a test says so.

One fault of the reference is not copied, and a test pins it: its
``init_cache`` projects the cross K/V with the decoder's self-attention
weights (``attn.wk`` / ``attn.wv``), where its forward uses ``xattn``'s,
so its decode misses its own forward (137 % of the logits' rms at the
worst position, fp32, this config).  The port projects with ``xattn``'s
in both; the reference's decode is held against the port's with its
cache's ``xk`` / ``xv`` made as its forward makes them.

Tolerances: fp32 ``atol = rtol = 1e-4`` and greedy tokens identical;
gradients ``|Δ| <= 1e-4·|ref| + 1e-4·max|ref of the leaf|``
(``test_torch_train.py``'s); the flash kernel's plain full mode against
the chunked route ``1e-5`` (fp32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import blocks as ref_blocks
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import serve, train
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      loss_and_grads)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models.blocks import AttnBlock
from repro_torch.models.convert import (_named_leaves, load_jax_params,
                                        named_from_jax)
from repro_torch.models.model import Model, unported

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-4
ARCH = "seamless-m4t-large-v2"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(**kw):
    return (dataclasses.replace(ref_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def assert_close(got, ref, tol=TOL):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, atol=tol, rtol=tol)


def assert_grad_close(got, ref, what=""):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    lim = TOL * np.abs(r) + TOL * max(float(np.abs(r).max()), 1e-30)
    worst = float(np.max(np.abs(g - r) - lim))
    assert worst <= 0, f"{what}: off by {worst:.3g} beyond the limit"


def _embeds(b, s, d, seed=4):
    return (_rng(seed).standard_normal((b, s, d)) * 0.3).astype(np.float32)


# ---------------------------------------------------------------- attention

def test_attention_route_sends_non_causal_self_attention_to_the_kernel():
    """Non-causal with Sq == Sk in the kernel's shapes: flash (its full
    mode); Sq != Sk (cross-attention to a longer encoder), or an input
    that needs a gradient while autograd records: chunked."""
    q = torch.zeros((1, 128, 4, 64))
    k = torch.zeros((1, 128, 2, 64))
    route, why = attn.attention_route(q, k, False, None, 0)
    assert route == "flash" and "full mode" in why
    route, why = attn.attention_route(q, torch.zeros((1, 192, 2, 64)),
                                      False, None, 0)
    assert route == "chunked" and "Sq=128 != Sk=192" in why
    v = torch.zeros((1, 128, 2, 64), requires_grad=True)
    route, why = attn.attention_route(q, k, False, None, 0, v)
    assert route == "chunked" and "gradient" in why
    with torch.no_grad():
        assert attn.attention_route(q, k, False, None, 0, v)[0] == "flash"


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_full_mode_plain_version_equals_the_chunked_route(hd):
    """The kernel's plain version in its full mode (what a CPU tensor
    runs, tile by tile as the kernel) against the chunked route's fp32
    softmax, and ``attention`` through both routes with GQA."""
    rng = _rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 192, 4, hd))
                                .astype(np.float32)) for _ in range(3))
    plain = flash_mod.flash_attention_plain(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)), causal=False)
    chunked = attn.attention(q, k, v, causal=False, chunk=64,
                             force_chunked=True)
    np.testing.assert_allclose(_np(plain.transpose(1, 2)), _np(chunked),
                               atol=1e-5, rtol=1e-5)
    kv = k[:, :, :2], v[:, :, :2]
    attn.attention.calls.update(flash=0, chunked=0)
    got = attn.attention(q, *kv, causal=False)
    assert attn.attention.calls == {"flash": 1, "chunked": 0}
    want = attn.attention(q, *kv, causal=False, force_chunked=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- block

def _cross_pair(seed=3):
    """The reference's ``build_attn(cross=True)`` weights (norms drawn
    anew) and the port's cross block holding them."""
    rcfg, tcfg = _pair(**F32)
    params, _ = ref_blocks.build_attn(rcfg, jax.random.PRNGKey(seed),
                                      cross=True)
    rng = _rng(seed)
    for name in ("ln1", "ln2", "lnx"):
        params[name] = jnp.asarray(
            1 + 0.3 * rng.standard_normal(params[name].shape), jnp.float32)
    blk = AttnBlock(tcfg, cross=True, generator=torch.Generator())
    names = sorted(n for n, _ in blk.named_parameters())
    assert names == sorted(
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0])
    with torch.no_grad():
        for name, p in blk.named_parameters():
            leaf = params
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return rcfg, params, blk


@pytest.mark.parametrize("enc_len", [16, 24], ids=["Sq==Sk", "Sq!=Sk"])
def test_cross_block_forward(enc_len):
    """``forward(x, enc_out=...)`` against ``train_attn`` with an encoder
    output, and without one (no cross-attention)."""
    rcfg, params, blk = _cross_pair()
    x = _embeds(2, 16, rcfg.d_model, seed=5)
    enc = _embeds(2, enc_len, rcfg.d_model, seed=6)
    ref, _ = ref_blocks.train_attn(rcfg, params, jnp.asarray(x), 0,
                                   jnp.asarray(enc))
    attn.attention.calls.update(flash=0, chunked=0)
    with torch.inference_mode():
        got, aux = blk(torch.from_numpy(x), 0, False, torch.from_numpy(enc))
    # hd 16 is outside the kernel's: both attentions take the chunked route
    assert attn.attention.calls == {"flash": 0, "chunked": 2}
    assert_close(got, ref)
    assert float(aux) == 0.0
    with torch.inference_mode():
        plain, _ = blk(torch.from_numpy(x))
    ref_plain, _ = ref_blocks.train_attn(rcfg, params, jnp.asarray(x))
    assert_close(plain, ref_plain)


def test_cross_block_decode_attends_to_the_cross_cache():
    """6 tokens through ``decode`` against ``decode_attn`` with the same
    ``xk`` / ``xv``; the self-attention caches after each."""
    rcfg, params, blk = _cross_pair()
    x = _embeds(2, 6, rcfg.d_model, seed=7)
    enc = torch.from_numpy(_embeds(2, 12, rcfg.d_model, seed=8))
    tcache = blk.init_cache(2, 8)
    tcache.update(blk.cross_kv(enc))
    cache = ref_blocks.cache_init_attn(rcfg, 2, 8, cross_len=12)
    cache.update(xk=jnp.asarray(_np(tcache["xk"])),
                 xv=jnp.asarray(_np(tcache["xv"])))
    for pos in range(6):
        xt = x[:, pos:pos + 1]
        ref_t, cache = ref_blocks.decode_attn(rcfg, params, cache,
                                              jnp.asarray(xt),
                                              jnp.int32(pos))
        with torch.inference_mode():
            got_t = blk.decode(tcache, torch.from_numpy(xt), pos)
        assert_close(got_t, ref_t)
        for key in ("k", "v"):
            assert_close(tcache[key], cache[key])


def test_cross_kv_is_the_forward_projection():
    """``cross_kv`` gives the K/V the forward's cross-attention uses:
    ``enc_out @ xattn.wk`` / ``wv``, by head."""
    rcfg, params, blk = _cross_pair()
    enc = _embeds(2, 12, rcfg.d_model, seed=8)
    kv = blk.cross_kv(torch.from_numpy(enc))
    _, k, v = ref_blocks._qkv(rcfg, params["xattn"], jnp.asarray(enc[:, :1]),
                              x_kv=jnp.asarray(enc))
    assert_close(kv["xk"], k)
    assert_close(kv["xv"], v)


# ---------------------------------------------------------------- model

@functools.lru_cache(maxsize=None)
def model_pair(dtype="float32"):
    rcfg, tcfg = _pair(**(F32 if dtype == "float32" else {}))
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    return rcfg, rm, params, tm


def _inputs(rcfg, b=2, s=16, seed=1):
    toks = _rng(seed).integers(0, rcfg.vocab_size, (b, s))
    return toks, _embeds(b, s, rcfg.d_model, seed=seed + 10)


def _ref_cross_cache(rm, params, rcfg, b, max_len, enc,
                     init_cache=RefModel.init_cache):
    """The reference's cache with the cross K/V its forward would use
    (``xattn``'s projection of its own encoder's output)."""
    cache = init_cache(rm, b, max_len, params=params, enc_embeds=enc)
    enc_out = rm._encoder(params, enc)

    def proj(w):
        return jax.vmap(jax.vmap(lambda p: (enc_out @ p["xattn"][w]).reshape(
            b, -1, rcfg.n_kv_heads, rcfg.hd)))(params["g0"])

    cache["g0"]["xk"], cache["g0"]["xv"] = proj("wk"), proj("wv")
    return cache


def test_encoder_matches_the_reference():
    """``Model.encode`` against ``Model._encoder``: the encoder blocks
    non-causal, then ``enc_ln``; fp32."""
    rcfg, rm, params, tm = model_pair()
    _, enc = _inputs(rcfg)
    ref = rm._encoder(params, jnp.asarray(enc))
    attn.attention.calls.update(flash=0, chunked=0)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(enc))
    assert attn.attention.calls == {"flash": 0,
                                    "chunked": rcfg.n_enc_layers}
    assert_close(got, ref)


@pytest.mark.parametrize("enc_len", [16, 24], ids=["Sq==Sk", "Sq!=Sk"])
def test_model_forward(enc_len):
    rcfg, rm, params, tm = model_pair()
    toks, _ = _inputs(rcfg)
    enc = _embeds(2, enc_len, rcfg.d_model, seed=12)
    ref, _ = rm.forward(params, jnp.asarray(toks, jnp.int32),
                        enc_embeds=jnp.asarray(enc))
    got = build_prefill_step(tm)({"tokens": torch.from_numpy(toks),
                                  "enc_embeds": torch.from_numpy(enc)})
    assert_close(got, ref)
    # without enc_embeds there is no cross-attention, in both
    ref0, _ = rm.forward(params, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        assert_close(tm(torch.from_numpy(toks)), ref0)


def test_init_cache_cross_kv_against_the_references():
    """``init_cache(enc_embeds=...)`` fills each decoder position's ``xk``
    / ``xv`` [B, S_enc, KV, hd]: the reference forward's projection of its
    encoder output (``xattn``).  The reference's own ``init_cache``
    projects with ``attn`` instead (its fault, pinned here)."""
    rcfg, rm, params, tm = model_pair()
    _, enc = _inputs(rcfg, s=12)
    with torch.inference_mode():
        caches = tm.init_cache(2, 20, enc_embeds=torch.from_numpy(enc))
    want = _ref_cross_cache(rm, params, rcfg, 2, 20, jnp.asarray(enc))
    theirs = rm.init_cache(2, 20, params=params, enc_embeds=jnp.asarray(enc))
    assert len(caches) == rcfg.n_super
    for n, c in enumerate(caches):
        assert set(c) == {"k", "v", "xk", "xv"}
        assert tuple(c["xk"].shape) == (2, 12, rcfg.n_kv_heads, rcfg.hd)
        for key in ("xk", "xv"):
            assert_close(c[key], want["g0"][key][n, 0])
            assert not np.allclose(_np(c[key]), _np(theirs["g0"][key][n, 0]),
                                   atol=1e-3)
    enc_out = rm._encoder(params, jnp.asarray(enc))
    assert_close(theirs["g0"]["xk"][1, 0], (enc_out @ params["g0"]["attn"][
        "wk"][1, 0]).reshape(2, 12, rcfg.n_kv_heads, rcfg.hd))
    with torch.inference_mode():
        later = tm.init_cache(2, 20)
        assert "xk" not in later[0]
        tm.encode_into(later, torch.from_numpy(enc))    # serve's order
    for c, c2 in zip(caches, later):
        for key in ("xk", "xv"):
            assert torch.equal(c[key], c2[key])


def test_model_greedy_decode():
    """A 4-token prompt stepped through ``decode_step`` after
    ``init_cache(enc_embeds=...)``, then 8 greedy steps: logits and tokens
    against the reference's decode on the cross cache its forward
    implies."""
    rcfg, rm, params, tm = model_pair()
    prompt, enc = _inputs(rcfg, s=4, seed=7)
    steps = prompt.shape[1] + 8
    rcache = _ref_cross_cache(rm, params, rcfg, 2, steps, jnp.asarray(enc))
    with torch.inference_mode():
        tcache = tm.init_cache(2, steps, enc_embeds=torch.from_numpy(enc))
    ref_step = jax.jit(rm.decode_step)
    step = build_serve_step(tm)
    rtok = ttok = prompt[:, :1]
    for i in range(steps):
        rl, rcache = ref_step(params, rcache, jnp.asarray(rtok, jnp.int32),
                              jnp.int32(i))
        tl = step(tcache, torch.from_numpy(np.array(ttok)), i)
        assert_close(tl, rl)
        if i + 1 < prompt.shape[1]:
            rtok = ttok = prompt[:, i + 1:i + 2]
            continue
        rtok = np.asarray(jnp.argmax(rl[:, -1:], axis=-1))
        ttok = torch.argmax(tl[:, -1:], dim=-1).numpy()
        np.testing.assert_array_equal(ttok, rtok)


def test_decode_steps_match_the_forward():
    """The port against itself in fp32: 16 ``decode_step``s after
    ``init_cache(enc_embeds=...)`` equal one forward with the same
    encoder input (the reference's decode misses its forward by 137 %
    here)."""
    rcfg, _, _, tm = model_pair()
    toks, enc = _inputs(rcfg, b=1, seed=2)
    toks, enc = torch.from_numpy(toks), torch.from_numpy(enc)
    fwd = build_prefill_step(tm)({"tokens": toks, "enc_embeds": enc})
    step = build_serve_step(tm)
    with torch.inference_mode():
        cache = tm.init_cache(1, 16, enc_embeds=enc)
        dec = torch.cat([step(cache, toks[:, i:i + 1], i)
                         for i in range(16)], dim=1)
    assert_close(dec, fwd)


def test_loss_and_grads_match_value_and_grad():
    """fp32: the loss over ``{"tokens", "labels", "enc_embeds"}`` and every
    parameter's gradient (encoder, ``enc_ln``, ``xattn``, ``lnx``
    included) against ``jax.value_and_grad``."""
    rcfg, tcfg = _pair(**F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(1))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    toks = _rng(2).integers(0, rcfg.vocab_size, (2, 17))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                 enc_embeds=_embeds(2, 16, rcfg.d_model, seed=3))
    (rloss, _), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(
        tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_grad_close(loss, rloss, "loss")
    want = named_from_jax(tm, jax.tree.map(np.asarray, rgrads))
    assert list(grads) == list(want) == [n for n, _ in tm.named_parameters()]
    for part in ("enc.1.attn.wq", "enc_ln", "blocks.0.xattn.wk",
                 "blocks.1.lnx"):
        assert part in grads
    for n, g in grads.items():
        assert float(g.abs().max()) > 0, n
        assert_grad_close(g, want[n], f"grad {n}")


def test_encoder_under_remat_gives_the_same_gradients():
    rcfg, tcfg = _pair(**F32)
    params = jax.tree.map(np.asarray,
                          RefModel(rcfg).init(jax.random.PRNGKey(1)))
    toks = torch.from_numpy(_rng(3).integers(0, tcfg.vocab_size, (2, 17)))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                 enc_embeds=torch.from_numpy(_embeds(2, 16, tcfg.d_model)))
    out = {}
    for remat in ("none", "full"):
        m = load_jax_params(Model(dataclasses.replace(tcfg, remat=remat),
                                  device=CPU), params)
        m.requires_grad_(True)
        out[remat] = loss_and_grads(m, batch)
    assert float(out["none"][0]) == float(out["full"][0])
    for n, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][n]), n


def test_load_jax_params_reads_the_encoder():
    """bf16: ``enc.{n}.*`` from ``enc.*[n]``, ``enc_ln``, the decoder's
    ``lnx`` / ``xattn.*`` at ``[s, r]``, bit for bit, in
    ``named_parameters`` order."""
    rcfg, _, params, tm = model_pair("bfloat16")
    leaves = list(_named_leaves(tm, jax.tree.map(np.asarray, params)))
    assert [n for n, *_ in leaves] == [n for n, _ in tm.named_parameters()]
    paths = [path for *_, path in leaves]
    assert "enc.mlp.w2[1]" in paths and "enc_ln" in paths
    assert "g0.xattn.wv[1, 0]" in paths and "g0.lnx[0, 0]" in paths
    got = tm.enc[1].attn.wq.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        got, np.asarray(params["enc"]["attn"]["wq"][1]).view(np.uint16))


def test_run_train_feeds_enc_embeds():
    """``run_train`` moves the pipeline's ``enc_embeds`` to the device and
    into ``loss_fn``: the first loss equals ``loss_fn`` on that batch."""
    cfg = smoke_config(ARCH)
    seen = []
    orig = Model.loss_fn

    def spy(self, batch):
        seen.append(sorted(batch))
        return orig(self, batch)

    Model.loss_fn = spy
    try:
        out = train.run_train(cfg, steps=2, batch=2, seq=32, device=CPU,
                              log=lambda line: None)
    finally:
        Model.loss_fn = orig
    assert seen[0] == ["enc_embeds", "labels", "tokens"]
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------- entry points

def test_unported_names_only_the_vision_frontend():
    """Once the one part left (the vision frontend and M-RoPE of
    ``qwen2-vl-7b``); it is ported now, so ``unported`` names nothing for
    this arch nor for qwen2-vl."""
    assert unported(get_config(ARCH)) is None
    assert unported(smoke_config(ARCH)) is None
    assert unported(get_config("qwen2-vl-7b")) is None
    assert unported(smoke_config("qwen2-vl-7b")) is None


def test_enc_embeds_are_the_reference_clis():
    """The CLI's encoder input: drawn after the prompts from the same
    generator, rounded to bf16 and scaled by bf16's 0.02, bit for bit."""
    prompts, enc = serve.make_inputs(512, 4, 64, 64)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(prompts, rng.integers(0, 512, (4, 64)))
    ref = jnp.asarray(rng.standard_normal((4, 64, 64)), jnp.bfloat16) * 0.02
    assert enc.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        enc.view(torch.int16).numpy(),
        np.asarray(ref).view(np.int16))


def test_serve_decode_cli_generates_the_reference_clis_tokens(
        monkeypatch, capsys):
    """``serve decode --arch seamless-m4t-large-v2 --smoke --device cpu``
    on the reference CLI's weights generates the reference CLI's tokens,
    its ``init_cache`` making the cross K/V as its forward does."""
    rcfg = ref_smoke_config(ARCH)
    params = RefModel(rcfg).init(jax.random.PRNGKey(0))
    orig_init = RefModel.init_cache

    def init_cache(self, b, max_len, params=None, enc_embeds=None):
        if enc_embeds is None:
            return orig_init(self, b, max_len)
        return _ref_cross_cache(self, params, self.cfg, b, max_len,
                                enc_embeds, orig_init)

    monkeypatch.setattr(RefModel, "init_cache", init_cache)
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "8"]
    assert ref_serve.decode_main(argv) == 0
    ref_rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("first generated rows:")]

    class Loaded(Model):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            load_jax_params(self, jax.tree.map(np.asarray, params))

    monkeypatch.setattr(model_mod, "Model", Loaded)
    assert serve.main(["decode"] + argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "serve ok"
    rows = [ln for ln in out if ln.startswith("first generated rows:")]
    assert rows == ref_rows and len(rows) == 1


def test_train_cli_improves(capsys):
    assert train.main(["--arch", ARCH, "--smoke", "--steps", "20",
                       "--batch", "2", "--seq", "32", "--log-every", "10",
                       "--device", "cpu"]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("loss ") and last.endswith("(improved)"), last
