"""The mixture-of-experts path of the PyTorch port (``repro_torch.models.
moe``, ``blocks.MoeBlock``, ``Model`` with MoE blocks and its balance
loss) against the JAX package's, on the CPU: the same seeded numpy
inputs, and the reference's own ``build_moe`` / ``Model.init`` weights
carried over, through both.

Configs: the smoke configs of ``arctic-480b`` (8 experts, top 2, the
dense residual FFN) and ``kimi-k2-1t-a32b`` (8 experts, top 2, GQA).

Tolerances:

* ``moe_ffn`` / ``moe_ffn_grouped`` in fp32: the output within ``1e-5``
  of the output's largest |value|, ``aux`` within ``1e-6``, the routed
  experts and kept slots equal;
* the reference's own cases (``tests/test_moe_and_sweep.py``) at its
  tolerance (``rtol 1e-4``, ``atol 1e-5``);
* blocks and ``Model`` in fp32: ``atol = rtol = 1e-4``, greedy tokens
  identical; gradients ``|Δ| <= 1e-4·|ref| + 1e-4·max|ref of the leaf|``
  (``test_torch_train.py``'s);
* bf16 ``Model`` logits: held against the reference's fp32 logits of the
  same weights: the port's worst per-position error rms against them at
  most the reference's own bf16 logits' worst plus ``0.05·rms``
  (``test_torch_ssm.py``'s rule).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.models import blocks as ref_blocks
from repro.models import moe as ref_moe
from repro.models.model import Model as RefModel
from repro.optim import optimizer as ref_opt
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, loss_and_grads)
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.blocks import MoeBlock
from repro_torch.models.convert import (_named_leaves, load_jax_params,
                                        named_from_jax)
from repro_torch.models.model import Model, unported
from repro_torch.optim import optimizer as opt

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-4
REL_RMS = 0.05
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")


# ---------------------------------------------------------------- helpers

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(name, **kw):
    return (dataclasses.replace(ref_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


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


def _worst_rel_rms(got, ref):
    g, r = _np(got), _np(ref)
    g, r = g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1])
    return float(np.max(np.sqrt(np.mean((g - r) ** 2, -1)) /
                        np.sqrt(np.mean(r ** 2, -1))))


def _moe_params(rng, d, e, f, scale=0.2):
    """Expert weights as numpy (the reference test's ``_params``)."""
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in ref_moe.moe_params_shape(d, e, f).items()}


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v.copy()) for k, v in params.items()})


def _ref_routing(x, wg, top_k, groups, cf):
    """The reference's routed experts ``[G, Tg, k]`` and kept slots ``[G,
    Tg·k]``, by its own formulas (``jax.lax.top_k``, the one-hot
    cumsum)."""
    b, s, d = x.shape
    t = b * s
    xf = jnp.asarray(x).reshape(groups, t // groups, d)
    probs = jax.nn.softmax((xf @ jnp.asarray(wg)).astype(jnp.float32), -1)
    _, top_i = jax.lax.top_k(probs, top_k)
    e = wg.shape[1]
    cap = max(1, int(t // groups * top_k * cf / e))
    flat_e = top_i.reshape(groups, -1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), 1) - 1
    flat_pos = jnp.take_along_axis(pos, flat_e[..., None], 2)[..., 0]
    return np.asarray(top_i), np.asarray(flat_pos < cap)


# ---------------------------------------------------------------- moe.py

FN_CASES = {
    # name: (groups, capacity_factor, drops)
    "flat_drops": (None, 0.5, True),
    "flat_no_drops": (None, 4.0, False),
    "grouped_drops": (4, 0.5, True),
    "grouped_no_drops": (4, 4.0, False),
}


@pytest.mark.parametrize("case", sorted(FN_CASES))
def test_moe_functions_match_the_reference(case):
    """fp32, 8 experts, top 2, 2 x 32 tokens: the output, ``aux``, the
    routed experts and the kept slots against ``moe_ffn`` /
    ``moe_ffn_grouped``."""
    groups, cf, drops = FN_CASES[case]
    rng = _rng(0)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    rp, tp = _both(_moe_params(rng, 16, 8, 24))
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    if groups is None:
        ref, raux = ref_moe.moe_ffn(jx, rp, 2, cf)
        got, aux = moe.moe_ffn(tx, tp, 2, cf)
    else:
        ref, raux = ref_moe.moe_ffn_grouped(jx, rp, 2, cf, n_groups=groups)
        got, aux = moe.moe_ffn_grouped(tx, tp, 2, cf, n_groups=groups)
    g = groups or 1
    r = _np(ref)
    assert got.shape == tx.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=1e-6)
    top_i, keep = _ref_routing(x, rp["wg"], 2, g, cf)
    _, _, ti = moe.route(tx.reshape(g, -1, 16), tp["wg"], 2)
    np.testing.assert_array_equal(ti.numpy(), top_i)
    cap = moe.capacity(64 // g, 2, cf, 8)
    _, tkeep = moe.slot_positions(ti, 8, cap)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert (not keep.all()) == drops


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_break_as_jax_does(top_k):
    """Two equal router columns (experts 3 and 6), scaled to lead: every
    token ties between them, and both packages route to the lower one
    first (``jax.lax.top_k``'s order), so the outputs and aux agree."""
    rng = _rng(5)
    params = _moe_params(rng, 16, 8, 24)
    params["wg"][:, 6] = params["wg"][:, 3] = 3.0 * np.abs(
        rng.standard_normal(16))
    x = np.abs(rng.standard_normal((1, 32, 16))).astype(np.float32)
    rp, tp = _both(params)
    tx = torch.from_numpy(x.copy())
    top_i, _ = _ref_routing(x, rp["wg"], top_k, 1, 1.25)
    _, _, ti = moe.route(tx.reshape(1, -1, 16), tp["wg"], top_k)
    assert (top_i[..., 0] == 3).all()
    if top_k == 2:
        assert (top_i[..., 1] == 6).all()
    np.testing.assert_array_equal(ti.numpy(), top_i)
    ref, raux = ref_moe.moe_ffn(jnp.asarray(x), rp, top_k, 1.25)
    got, aux = moe.moe_ffn(tx, tp, top_k, 1.25)
    r = _np(ref)
    np.testing.assert_allclose(_np(got), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=1e-6)


def test_a_dropped_slot_leaves_the_kept_token_at_the_last_place():
    """Capacity 1 per expert, and all tokens to one expert pair: the
    first token keeps slot 0 (``cap - 1``); every later one is dropped
    there with a zero row, which must add, not overwrite."""
    rng = _rng(6)
    params = _moe_params(rng, 16, 8, 24)
    params["wg"][:, 2] = 4.0
    x = np.abs(rng.standard_normal((1, 8, 16))).astype(np.float32)
    rp, tp = _both(params)
    ref, _ = ref_moe.moe_ffn(jnp.asarray(x), rp, 1, 1.0)
    got, _ = moe.moe_ffn(torch.from_numpy(x.copy()), tp, 1, 1.0)
    assert moe.capacity(8, 1, 1.0, 8) == 1
    assert float(np.abs(_np(ref)[0, 0]).max()) > 0
    assert np.all(_np(ref)[0, 1:] == 0)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                               atol=1e-5 * np.abs(_np(ref)).max())


def test_capacity_and_group_count_are_the_references():
    for t, k, cf, e in ((32768, 2, 1.25, 128), (8192, 8, 1.25, 384),
                        (4, 2, 1.25, 128), (37, 3, 0.7, 5)):
        assert moe.capacity(t, k, cf, e) == max(1, int(t * k * cf / e))
    for t, n in ((64, 8), (4096, 256), (96, 256), (37, 16), (1, 256)):
        g = min(n, t)
        while t % g:
            g //= 2
        assert moe.n_groups_for(t, n) == g


def _ref_case_params(rng, d, e, f):
    return _both({k: np.asarray(v) for k, v in _moe_params(
        rng, d, e, f).items()})[1]


def test_grouped_equals_flat_without_drops():
    """The reference's ``test_grouped_equals_flat_without_drops`` on the
    port."""
    rng = _rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 64, 16))).float()
    p = _ref_case_params(rng, 16, 8, 32)
    y1, _ = moe.moe_ffn(x, p, 2, capacity_factor=8.0)
    y2, _ = moe.moe_ffn_grouped(x, p, 2, capacity_factor=8.0, n_groups=8)
    np.testing.assert_allclose(_np(y1), _np(y2), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2, 16])
def test_grouped_group_count_invariance(groups):
    rng = _rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 32, 8))).float()
    p = _ref_case_params(rng, 8, 4, 16)
    y_ref, _ = moe.moe_ffn_grouped(x, p, 2, capacity_factor=16.0,
                                   n_groups=1)
    y, _ = moe.moe_ffn_grouped(x, p, 2, capacity_factor=16.0,
                               n_groups=groups)
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=1e-4, atol=1e-5)


def test_capacity_drops_tokens_gracefully():
    rng = _rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 64, 8))).float()
    p = _ref_case_params(rng, 8, 4, 16)
    y, _ = moe.moe_ffn(x, p, 2, capacity_factor=0.1)
    assert bool(torch.isfinite(y).all())
    y_full, _ = moe.moe_ffn(x, p, 2, capacity_factor=8.0)
    assert float(y.abs().sum()) < float(y_full.abs().sum())


def test_router_aux_loss_positive():
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 32, 8))).float()
    p = _ref_case_params(rng, 8, 4, 16)
    _, aux = moe.moe_ffn(x, p, 2)
    assert float(aux) >= 1.0 - 1e-3


# ---------------------------------------------------------------- block

def _block_pair(arch, dtype, grouped=False, seed=3):
    """The reference's ``build_moe`` weights (norms drawn anew from a
    seed) and the port's ``MoeBlock`` holding them."""
    kw = dict(F32) if dtype == "float32" else {}
    if grouped:
        kw.update(moe_grouped=True, moe_n_groups=4)
    rcfg, tcfg = _pair(arch, **kw)
    params, _ = ref_blocks.build_moe(rcfg, jax.random.PRNGKey(seed))
    rng = _rng(seed)
    for name in ("ln1", "ln2"):
        params[name] = jnp.asarray(
            1 + 0.3 * rng.standard_normal(params[name].shape),
            params[name].dtype)
    blk = MoeBlock(tcfg, generator=torch.Generator())
    with torch.no_grad():
        for name, p in blk.named_parameters():
            leaf = params
            for key in name.split("."):
                leaf = leaf[key]
            assert tuple(leaf.shape) == tuple(p.shape), name
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)).to(p.dtype))
    return rcfg, params, blk


def test_moe_block_parameters_carry_the_reference_names():
    for arch, dense in (("arctic-480b", True), ("kimi-k2-1t-a32b", False)):
        rcfg, params, blk = _block_pair(arch, "float32")
        names = sorted(n for n, _ in blk.named_parameters())
        flat = sorted(".".join(str(getattr(k, "key", k)) for k in path)
                      for path, _ in jax.tree_util.tree_flatten_with_path(
                          params)[0])
        assert names == flat
        assert ("dense.w1" in names) == dense


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_forward_decode_and_cache(arch, grouped):
    """fp32: ``forward`` against ``train_moe`` (``(x, aux)``), then 6
    tokens through ``decode`` against ``decode_moe`` with the caches."""
    rcfg, params, blk = _block_pair(arch, "float32", grouped)
    x = _rng(6).standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
    ref, raux = ref_blocks.train_moe(rcfg, params, jnp.asarray(x))
    with torch.inference_mode():
        got, aux = blk(torch.from_numpy(x.copy()))
    assert_close(got, ref)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=1e-6)

    cache = ref_blocks.CACHE_FNS["moe"](rcfg, 2, 8)
    tcache = blk.init_cache(2, 8)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[1])
         for k, v in tcache.items()}
    for pos in range(6):
        xt = x[:, pos:pos + 1]
        ref_t, cache = ref_blocks.decode_moe(rcfg, params, cache,
                                             jnp.asarray(xt), jnp.int32(pos))
        with torch.inference_mode():
            got_t = blk.decode(tcache, torch.from_numpy(xt.copy()), pos)
        assert_close(got_t, ref_t)
        for k, v in cache.items():
            assert_close(tcache[k], v)


def test_moe_block_draws_each_expert_at_its_scale():
    """The init scale is the reference's: ``1/sqrt(shape[-2])`` for the
    experts, ``1/sqrt(d)`` for the router; each expert is its own
    draw."""
    cfg = dataclasses.replace(smoke_config("arctic-480b"), n_experts=4,
                              moe_d_ff=256, **F32)
    blk = MoeBlock(cfg, generator=torch.Generator().manual_seed(0))
    d, f = cfg.d_model, cfg.moe_d_ff
    for name, fan_in in (("w1", d), ("w3", d), ("w2", f)):
        w = getattr(blk.moe, name)
        std = w.reshape(w.shape[0], -1).std(dim=1)
        np.testing.assert_allclose(std.numpy(), 1 / np.sqrt(fan_in),
                                   rtol=0.05)
        assert not torch.equal(w[0], w[1])
    np.testing.assert_allclose(float(blk.moe.wg.std()), 1 / np.sqrt(d),
                               rtol=0.1)


# ---------------------------------------------------------------- model

MODEL_CASES = {
    "arctic_f32": ("arctic-480b", F32),
    "arctic_bf16": ("arctic-480b", {}),
    "kimi_f32": ("kimi-k2-1t-a32b", F32),
    "kimi_bf16": ("kimi-k2-1t-a32b", {}),
}


@functools.lru_cache(maxsize=None)
def model_pair(case):
    arch, kw = MODEL_CASES[case]
    rcfg, tcfg = _pair(arch, **kw)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    return rcfg, rm, params, tm, tcfg.compute_dtype


def _tokens(vocab, b, s, seed=1):
    return _rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_forward(case):
    """Logits and aux over 2 x 32 tokens; every layer's attention on the
    flash route (hd 16 is outside the kernel's: chunked)."""
    rcfg, rm, params, tm, dtype = model_pair(case)
    toks = _tokens(rcfg.vocab_size, 2, 32)
    ref, raux = rm.forward(params, jnp.asarray(toks, jnp.int32))
    attn.attention.calls.update(flash=0, chunked=0)
    got = build_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert attn.attention.calls == {"flash": 0, "chunked": rcfg.n_layers}
    with torch.inference_mode():
        _, aux = tm.forward_with_aux(torch.from_numpy(toks))
    if dtype == "float32":
        assert_close(got, ref)
        np.testing.assert_allclose(float(aux), float(raux), rtol=0,
                                   atol=1e-6)
        return
    rm32 = RefModel(dataclasses.replace(rcfg, **F32))
    params32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    ref32, _ = rm32.forward(params32, jnp.asarray(toks, jnp.int32))
    ours, theirs = _worst_rel_rms(got, ref32), _worst_rel_rms(ref, ref32)
    assert ours <= theirs + REL_RMS, (ours, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_greedy_decode(arch):
    """fp32: a 4-token prompt stepped through ``decode_step``, then 8
    greedy steps, logits and tokens against the reference's."""
    rcfg, rm, params, tm, _ = model_pair(arch.split("-")[0] + "_f32")
    prompt = _tokens(rcfg.vocab_size, 2, 4, seed=7)
    steps = prompt.shape[1] + 8
    rcache = rm.init_cache(2, steps)
    tcache = tm.init_cache(2, steps)
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


def test_decode_steps_match_the_forward_without_drops():
    """The port against itself in fp32, nothing dropped (``capacity_factor
    = E / top_k``): ``decode_step`` position by position equals one
    forward.  With the default 1.25 they part where prefill drops and
    decode, with its capacity of 1 per B tokens, does not, or the other
    way round (the reference's own arithmetic)."""
    rcfg, tcfg = _pair("arctic-480b", capacity_factor=4.0, **F32)
    params = RefModel(rcfg).init(jax.random.PRNGKey(2))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, 1, 24, seed=8))
    fwd = build_prefill_step(tm)({"tokens": toks})
    cache = tm.init_cache(1, 24)
    step = build_serve_step(tm)
    dec = torch.cat([step(cache, toks[:, i:i + 1], i) for i in range(24)],
                    dim=1)
    assert_close(dec, fwd)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad(arch):
    """fp32: total, xent and aux of ``loss_fn``, and every parameter's
    gradient (router and experts included) against
    ``jax.value_and_grad``."""
    rcfg, tcfg = _pair(arch, **F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(1))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    toks = _rng(2).integers(0, rcfg.vocab_size, (2, 33))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    (rloss, raux), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, parts = tm.loss_fn(tbatch)
    assert_grad_close(total, rloss, "total")
    assert_grad_close(parts["xent"], raux["xent"], "xent")
    aux = float(parts["aux"].detach())
    np.testing.assert_allclose(aux, float(raux["aux"]), rtol=0, atol=1e-6)
    assert aux > 0
    np.testing.assert_allclose(float(total.detach()), float(
        parts["xent"].detach()) + 0.01 * aux, rtol=1e-6)
    _, grads = loss_and_grads(tm, tbatch)
    want = named_from_jax(tm, jax.tree.map(np.asarray, rgrads))
    assert list(grads) == list(want) == [n for n, _ in tm.named_parameters()]
    for n, g in grads.items():
        assert float(g.abs().max()) > 0, n
        assert_grad_close(g, want[n], f"grad {n}")


def test_aux_survives_remat():
    """Under remat "full" the blocks' aux leaves the recomputed function
    as an output: the loss and gradients equal remat "none"'s bit for
    bit."""
    rcfg, tcfg = _pair("arctic-480b", **F32)
    params = jax.tree.map(np.asarray,
                          RefModel(rcfg).init(jax.random.PRNGKey(1)))
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, 2, 17, seed=3))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    out = {}
    for remat in ("none", "full"):
        m = load_jax_params(Model(dataclasses.replace(tcfg, remat=remat),
                                  device=CPU), params)
        m.requires_grad_(True)
        out[remat] = loss_and_grads(m, batch)
    assert float(out["none"][0]) == float(out["full"][0])
    for n, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][n]), n


def test_load_jax_params_reads_the_nested_leaves():
    """arctic (bf16): ``moe.*`` and ``dense.*`` at ``[s, r]``, bit for
    bit, every leaf once, in ``named_parameters`` order."""
    rcfg, _, params, tm, _ = model_pair("arctic_bf16")
    leaves = list(_named_leaves(tm, jax.tree.map(np.asarray, params)))
    assert [n for n, *_ in leaves] == [n for n, _ in tm.named_parameters()]
    paths = [path for *_, path in leaves]
    assert "g0.moe.w1[1, 0]" in paths and "g0.dense.w2[0, 0]" in paths
    got = tm.blocks[1].moe.w1.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        got, np.asarray(params["g0"]["moe"]["w1"][1, 0]).view(np.uint16))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """One ``build_train_step`` step in fp32 on identical weights and
    batch: loss, norm, lr, and every parameter after it (all but 0.1 % of
    each leaf's elements at the fp32 limit, every element within
    ``0.5·lr``; ``test_torch_ssm.py``'s rule)."""
    rcfg, tcfg = _pair(arch, **F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    rocfg, tocfg = ref_opt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    rstep = jax.jit(ref_build_train_step(rm, rocfg))
    tstep = build_train_step(tm, tocfg, opt.init(dict(tm.named_parameters()),
                                                 tocfg))
    toks = _rng(3).integers(0, rcfg.vocab_size, (2, 33))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    params, _, rmet = rstep(params, ref_opt.init(params, rocfg),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tmet = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert_grad_close(tmet[k], rmet[k], k)
    want = named_from_jax(tm, jax.tree.map(np.asarray, params))
    for n, p in tm.named_parameters():
        g, r = _np(p), _np(want[n])
        lim = TOL * np.abs(r) + TOL * float(np.abs(r).max())
        assert np.mean(np.abs(g - r) > lim) <= 1e-3, n
        assert np.abs(g - r).max() <= 0.5 * tocfg.lr, n


@pytest.mark.parametrize("arch", ARCHS)
def test_run_train_takes_a_step(arch):
    out = train.run_train(smoke_config(arch), steps=2, batch=2, seq=32,
                          device=CPU, log=lambda line: None)
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert int(out["opt_state"].step) == 2


# ---------------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", ARCHS)
def test_unported_names_nothing_for_the_moe_archs(arch):
    assert unported(get_config(arch)) is None
    assert unported(smoke_config(arch)) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_cli(arch, capsys):
    assert serve.main(["decode", "--arch", arch, "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16",
                       "--gen", "8"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke batch=2 prompt=16 gen=8")
    assert lines[-1] == "serve ok"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_improves(arch, capsys):
    assert train.main(["--arch", arch, "--smoke", "--steps", "20",
                       "--batch", "2", "--seq", "32", "--log-every", "10",
                       "--device", "cpu"]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("loss ") and last.endswith("(improved)"), last
