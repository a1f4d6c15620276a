"""The recurrent families of the PyTorch port (``repro_torch.models.ssm``,
the ``mamba2`` / ``mlstm`` / ``slstm`` blocks, ``Model`` with zamba2's
shared attention block) against the JAX package's, on the CPU: the same
seeded numpy inputs, and the reference's own ``build_*`` / ``Model.init``
weights carried over, through both.

Configs: the smoke configs of ``xlstm-350m`` (mLSTM + sLSTM, tied
embeddings) and ``zamba2-2.7b`` (five Mamba-2 blocks and one shared
attention block a super-block), chunk 16.

Tolerances:

* the 7 functions of ``ssm.py`` in fp32: ``atol = rtol = 1e-5``;
* blocks and ``Model`` in fp32 (``param_dtype = compute_dtype =
  "float32"``): ``atol = rtol = 1e-4``, greedy tokens identical; gradients
  ``|Δ| <= 1e-4·|ref| + 1e-4·max|ref of the leaf|``;
* bf16, functions and blocks: per position, the error's rms over the
  last axes ``<= 0.05·rms(ref)`` (the model tests' limit).
* bf16, model logits: held against the reference's fp32 logits of the
  same weights (cast): the port's worst per-position error rms against
  them at most the reference's own bf16 logits' worst, plus the model
  tests' ``0.05·rms``.  At the smoke width bf16's own spread is larger
  than 5 %: the reference's bf16 forward misses its fp32 one by 6.3 %
  (zamba2) and 9.4 % (xlstm) of the rms at the worst position, and XLA
  on the CPU keeps fp32 between fused bf16 ops where the port rounds
  each, so the two packages' bf16 logits can sit on different sides of
  the fp32 ones (8.1 % apart for zamba2's forward, each 5.6–6.3 % from
  it).  Decode is teacher-forced on the reference's tokens.
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
from repro.models import ssm as ref_ssm
from repro.models.model import Model as RefModel
from repro.optim import optimizer as ref_opt
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, loss_and_grads)
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.blocks import Mamba2Block, MlstmBlock, SlstmBlock
from repro_torch.models.convert import (_named_leaves, load_jax_params,
                                        named_from_jax)
from repro_torch.models.model import Model, unported
from repro_torch.optim import optimizer as opt

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
FN_TOL = 1e-5
TOL = 1e-4
REL_RMS = 0.05
ARCHS = ("xlstm-350m", "zamba2-2.7b")
BLOCKS = {"mamba2": (Mamba2Block, "zamba2-2.7b"),
          "mlstm": (MlstmBlock, "xlstm-350m"),
          "slstm": (SlstmBlock, "xlstm-350m")}


# ---------------------------------------------------------------- helpers

def _dt(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)


def _both(a, dtype="float32"):
    """``a`` (numpy) as a JAX array and a torch tensor of ``dtype``."""
    jd, td = _dt(dtype)
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a.copy()).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, ref, dtype, tol=TOL, lead=2):
    """fp32: ``atol = rtol = tol``; bf16: per position (the first
    ``lead`` axes) the error's rms within ``REL_RMS`` of the ref's."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, r, atol=tol, rtol=tol)
        return
    g = g.reshape(int(np.prod(g.shape[:lead])), -1)
    r = r.reshape(g.shape)
    ratio = np.sqrt(np.mean((g - r) ** 2, -1)) / \
        np.maximum(np.sqrt(np.mean(r ** 2, -1)), 1e-30)
    assert ratio.max() <= REL_RMS, \
        f"per-position error rms {ratio.max():.3g} of the ref's rms"


def _worst_rel_rms(got, ref):
    g, r = _np(got), _np(ref)
    g, r = g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1])
    return float(np.max(np.sqrt(np.mean((g - r) ** 2, -1)) /
                        np.sqrt(np.mean(r ** 2, -1))))


def assert_bf16_spread(got, ref, ref_f32):
    """bf16 logits ``got`` no farther from the reference's fp32 logits
    ``ref_f32`` than the reference's own bf16 logits ``ref`` are, plus
    ``REL_RMS``, at the worst position."""
    ours, theirs = _worst_rel_rms(got, ref_f32), _worst_rel_rms(ref, ref_f32)
    assert ours <= theirs + REL_RMS, \
        f"bf16 logits {ours:.3g} from fp32, the reference's {theirs:.3g}"


def assert_grad_close(got, ref, what=""):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    lim = TOL * np.abs(r) + TOL * max(float(np.abs(r).max()), 1e-30)
    worst = float(np.max(np.abs(g - r) - lim))
    assert worst <= 0, f"{what}: off by {worst:.3g} beyond the limit"


def _pair(name, **kw):
    return (dataclasses.replace(ref_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- ssm.py

def test_segsum():
    a = -np.abs(_rng(0).standard_normal((2, 3, 8)))
    ja, ta = _both(a)
    ref, got = _np(ref_ssm._segsum(ja)), _np(ssm._segsum(ta))
    assert np.array_equal(np.isneginf(ref), np.isneginf(got))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=FN_TOL, rtol=FN_TOL)


def _ssd_inputs(seed, b=2, s=24, h=3, p=4, n=5):
    rng = _rng(seed)
    return dict(x=rng.standard_normal((b, s, h, p)),
                a=-np.abs(rng.standard_normal((b, s, h))) * 0.5,
                b=rng.standard_normal((b, s, n)) * 0.5,
                c=rng.standard_normal((b, s, n)) * 0.5,
                h0=rng.standard_normal((b, h, p, n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["h0-none", "h0"])
def test_ssd_chunked(carry, dtype):
    """S = 3 chunks of 8, with and without a carried state."""
    inp = _ssd_inputs(1)
    args = {k: _both(inp[k], "float32" if k == "a" else dtype)
            for k in ("x", "a", "b", "c")}
    h0 = _both(inp["h0"], dtype) if carry else (None, None)
    ry, rh = ref_ssm.ssd_chunked(*(args[k][0] for k in "xabc"), 8, h0[0])
    ty, th = ssm.ssd_chunked(*(args[k][1] for k in "xabc"), 8, h0[1])
    assert ty.dtype == torch.float32 and ry.dtype == jnp.float32
    assert th.dtype == _dt(dtype)[1] and rh.dtype == _dt(dtype)[0]
    assert_close(ty, ry, dtype, FN_TOL)
    assert_close(th, rh, dtype, FN_TOL)


def test_ssd_chunked_refuses_a_partial_chunk():
    inp = _ssd_inputs(1, s=20)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.ssd_chunked(*(_both(inp[k])[1] for k in "xabc"), 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step(dtype):
    rng = _rng(2)
    h = rng.standard_normal((2, 3, 4, 5))
    x = rng.standard_normal((2, 3, 4))
    a = -np.abs(rng.standard_normal((2, 3)))
    b, c = rng.standard_normal((2, 5)), rng.standard_normal((2, 5))
    jh, th = _both(h, dtype)
    jx, tx = _both(x, dtype)
    ja, ta = _both(a)
    jb, tb = _both(b, dtype)
    jc, tc = _both(c, dtype)
    ry, rh = ref_ssm.ssd_decode_step(jh, jx, ja, jb, jc)
    ty, th2 = ssm.ssd_decode_step(th, tx, ta, tb, tc)
    assert th2.dtype == torch.float32 and rh.dtype == jnp.float32
    assert_close(ty, ry, dtype, FN_TOL)
    assert_close(th2, rh, dtype, FN_TOL)


def _mlstm_inputs(seed, b=2, s=24, h=2, hd=8):
    rng = _rng(seed)
    qkv = [rng.standard_normal((b, s, h, hd)) for _ in range(3)]
    gates = [rng.standard_normal((b, s, h)) * 2 + 1 for _ in range(2)]
    state = (rng.standard_normal((b * h, 1, hd, hd)),
             np.abs(rng.standard_normal((b * h, 1, 1, hd))))
    return qkv + gates, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
def test_mlstm_chunked(carry, dtype):
    """S = 3 chunks of 8, from a zero and from a carried state."""
    arrays, state = _mlstm_inputs(3)
    j, t = zip(*(_both(a, dtype) for a in arrays))
    rs = ts = None
    if carry:
        (jc, tc), (jn, tn) = _both(state[0], dtype), _both(state[1], dtype)
        rs, ts = (jc, jn), (tc, tn)
    ry, (rc, rn) = ref_ssm.mlstm_chunked(*j, 8, rs)
    ty, (tc2, tn2) = ssm.mlstm_chunked(*t, 8, ts)
    assert ty.dtype == torch.float32 and ry.dtype == jnp.float32
    assert tc2.dtype == _dt(dtype)[1] == tn2.dtype
    assert rc.dtype == _dt(dtype)[0] == rn.dtype
    assert_close(ty, ry, dtype, FN_TOL)
    assert_close(tc2, rc, dtype, FN_TOL)
    assert_close(tn2, rn, dtype, FN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_init_state(dtype):
    jd, td = _dt(dtype)
    rc, rn = ref_ssm.mlstm_init_state(2, 3, 8, jd)
    tc, tn = ssm.mlstm_init_state(2, 3, 8, td)
    for got, ref in ((tc, rc), (tn, rn)):
        assert tuple(got.shape) == ref.shape and got.dtype == td
        assert not got.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_steps_and_the_state_dtype(dtype):
    """Six tokens from the zero state: y of each step, and the state,
    which is fp32 from the first step on in both packages."""
    arrays, _ = _mlstm_inputs(4, s=6)
    jd, td = _dt(dtype)
    rstate = ref_ssm.mlstm_init_state(2, 2, 8, jd)
    tstate = ssm.mlstm_init_state(2, 2, 8, td)
    for i in range(6):
        j, t = zip(*(_both(a[:, i], dtype) for a in arrays))
        ry, rstate = ref_ssm.mlstm_decode_step(rstate, *j)
        ty, tstate = ssm.mlstm_decode_step(tstate, *t)
        assert [s.dtype for s in rstate] == [jnp.float32] * 2
        assert [s.dtype for s in tstate] == [torch.float32] * 2
        assert_close(ty, ry, dtype, FN_TOL)
        for got, ref in zip(tstate, rstate):
            assert_close(got, ref, dtype, FN_TOL)


def _slstm_inputs(seed, b=2, s=12, h=2, hd=4):
    rng = _rng(seed)
    parts = rng.standard_normal((b, s, 4, h, hd))
    r = rng.standard_normal((4, h, hd, hd)) * 0.3 / np.sqrt(hd)
    z = (b, h, hd)
    state = (rng.standard_normal(z), np.abs(rng.standard_normal(z)) + 0.5,
             rng.standard_normal(z), rng.standard_normal(z))
    return parts, r, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
def test_slstm_scan(carry, dtype):
    parts, r, state = _slstm_inputs(5)
    jp, tp = _both(parts, dtype)
    jr, tr = _both(r, dtype)
    rs = ts = None
    if carry:
        rs, ts = zip(*(_both(s) for s in state))
    rh, rfin = ref_ssm.slstm_scan(jp, jr, rs)
    th, tfin = ssm.slstm_scan(tp, tr, ts)
    assert th.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tfin)
    assert_close(th, rh, dtype, FN_TOL)
    for got, ref in zip(tfin, rfin):
        assert_close(got, ref, dtype, FN_TOL, lead=1)


# ---------------------------------------------------------------- blocks

def _block_pair(kind, dtype, seed=3):
    """The reference's ``build_<kind>`` weights (fp32 leaves and norms
    drawn anew from a seed, so that none is trivial), and the port's
    block holding them."""
    cls, arch = BLOCKS[kind]
    rcfg, tcfg = _pair(arch, **(F32 if dtype == "float32" else {}))
    params, _ = ref_blocks.BUILDERS[kind](rcfg, jax.random.PRNGKey(seed))
    rng = _rng(seed)
    for name in ("ln", "a_log", "d_skip", "dt_bias"):
        if name in params:
            p = params[name]
            params[name] = jnp.asarray(
                1 + 0.3 * rng.standard_normal(p.shape), p.dtype)
    blk = cls(tcfg, generator=torch.Generator())
    with torch.no_grad():
        for name, p in blk.named_parameters():
            src = torch.from_numpy(np.array(params[name], np.float32))
            assert tuple(src.shape) == tuple(p.shape), name
            assert str(p.dtype).split(".")[1] == str(params[name].dtype), \
                name
            p.copy_(src.to(p.dtype))
    return rcfg, params, blk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_forward_and_decode(kind, dtype):
    """``forward`` over 2 chunks against ``train_<kind>``; then 6 tokens
    through ``decode`` against ``decode_<kind>``, the cache's entries
    and their dtypes after every step."""
    rcfg, params, blk = _block_pair(kind, dtype)
    jd, td = _dt(dtype)
    x = _rng(6).standard_normal((2, 2 * rcfg.ssm_chunk, rcfg.d_model))
    jx, tx = _both(x, dtype)
    ref, _ = ref_blocks.TRAIN_FNS[kind](rcfg, params, jx, 0, None)
    with torch.inference_mode():
        got, aux = blk(tx)
    assert got.dtype == td and float(aux) == 0.0
    assert_close(got, ref, dtype)

    cache = ref_blocks.CACHE_FNS[kind](rcfg, 2, 8)
    tcache = blk.init_cache(2, 8)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[1])
         for k, v in tcache.items()}
    for pos in range(6):
        jt, tt = _both(x[:, pos:pos + 1], dtype)
        ref_t, cache = ref_blocks.DECODE_FNS[kind](rcfg, params, cache, jt,
                                                   jnp.int32(pos))
        with torch.inference_mode():
            got_t = blk.decode(tcache, tt, pos)
        assert_close(got_t, ref_t, dtype)
        for k, v in cache.items():
            assert str(tcache[k].dtype).split(".")[1] == str(v.dtype), k
            assert_close(tcache[k], v, dtype, lead=1)
    if kind == "mlstm":      # created in the compute dtype, fp32 after
        assert tcache["c"].dtype == tcache["n"].dtype == torch.float32


# ---------------------------------------------------------------- model

MODEL_CASES = {
    "xlstm_f32": ("xlstm-350m", F32),
    "xlstm_bf16": ("xlstm-350m", {}),
    "zamba2_f32": ("zamba2-2.7b", F32),
    "zamba2_bf16": ("zamba2-2.7b", {}),
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


def _f32_twin(rcfg, params):
    """The reference's fp32 model of the same weights, cast."""
    return (RefModel(dataclasses.replace(rcfg, **F32)),
            jax.tree.map(lambda t: t.astype(jnp.float32), params))


def _tokens(vocab, b, s, seed=1):
    return _rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_forward(case):
    rcfg, rm, params, tm, dtype = model_pair(case)
    toks = _tokens(rcfg.vocab_size, 2, 2 * rcfg.ssm_chunk)
    ref, _ = rm.forward(params, jnp.asarray(toks, jnp.int32))
    attn.attention.calls.update(flash=0, chunked=0)
    got = build_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    n_shared = rcfg.n_super if rcfg.name.startswith("zamba2") else 0
    # zamba2's hd 16 here (80 at full width) is outside the kernel's
    assert attn.attention.calls == {"flash": 0, "chunked": n_shared}
    if dtype == "float32":
        return assert_close(got, ref, dtype)
    rm32, params32 = _f32_twin(rcfg, params)
    ref32, _ = rm32.forward(params32, jnp.asarray(toks, jnp.int32))
    assert_bf16_spread(got, ref, ref32)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_greedy_decode(case):
    """A 4-token prompt stepped through ``decode_step``, then 8 greedy
    steps; bf16 teacher-forced on the reference's tokens."""
    rcfg, rm, params, tm, dtype = model_pair(case)
    prompt = _tokens(rcfg.vocab_size, 2, 4, seed=7)
    steps = prompt.shape[1] + 8
    rcache = rm.init_cache(2, steps)
    tcache = tm.init_cache(2, steps)
    assert len(tcache) == rcfg.n_layers
    ref_step = jax.jit(rm.decode_step)
    step = build_serve_step(tm)
    if dtype == "bfloat16":
        rm32, params32 = _f32_twin(rcfg, params)
        step32 = jax.jit(rm32.decode_step)
        cache32 = rm32.init_cache(2, steps)
        logits = []
    rtok = ttok = prompt[:, :1]
    for i in range(steps):
        rl, rcache = ref_step(params, rcache, jnp.asarray(rtok, jnp.int32),
                              jnp.int32(i))
        feed = rtok if dtype == "bfloat16" else ttok
        tl = step(tcache, torch.from_numpy(np.array(feed)), i)
        assert tl.shape == (2, 1, rcfg.vocab_size)
        if dtype == "float32":
            assert_close(tl, rl, dtype)
        else:
            l32, cache32 = step32(params32, cache32,
                                  jnp.asarray(rtok, jnp.int32), jnp.int32(i))
            logits.append((tl, rl, l32))
        if i + 1 < prompt.shape[1]:
            rtok = ttok = prompt[:, i + 1:i + 2]
            continue
        rtok = np.asarray(jnp.argmax(rl[:, -1:], axis=-1))
        ttok = torch.argmax(tl[:, -1:], dim=-1).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, rtok)
    if dtype == "bfloat16":
        got, ref, ref32 = (np.concatenate([_np(t) for t in ts], axis=1)
                           for ts in zip(*logits))
        assert_bf16_spread(got, ref, ref32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_forward(arch):
    """The port against itself in fp32: ``decode_step`` position by
    position equals one forward over 3 chunks (the carry between chunks
    included)."""
    _, _, _, tm, _ = model_pair(arch.split("-")[0] + "_f32")
    s = 3 * tm.cfg.ssm_chunk
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 1, s, seed=8))
    fwd = build_prefill_step(tm)({"tokens": toks})
    cache = tm.init_cache(1, s)
    step = build_serve_step(tm)
    dec = torch.cat([step(cache, toks[:, i:i + 1], i) for i in range(s)],
                    dim=1)
    assert_close(dec, fwd, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad(arch):
    """fp32: the loss and every parameter's gradient, the shared block's
    summed over its uses, the fp32 leaves of Mamba-2 and the sLSTM's
    ``r`` included."""
    rcfg, tcfg = _pair(arch, **F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(1))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    rng = _rng(2)
    toks = rng.integers(0, rcfg.vocab_size, (2, 2 * rcfg.ssm_chunk + 1))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    (rloss, _), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(
        tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_grad_close(loss, rloss, "loss")
    want = named_from_jax(tm, jax.tree.map(np.asarray, rgrads))
    assert list(grads) == list(want) == [n for n, _ in tm.named_parameters()]
    for n, g in grads.items():
        assert float(g.abs().max()) > 0, n
        assert_grad_close(g, want[n], f"grad {n}")


# ---------------------------------------------------------------- convert

def test_load_jax_params_shares_one_copy():
    """zamba2 (bf16): the shared block is one module at every 6th
    position, its weights read once from the unstacked ``g1``; the fp32
    leaves of the bf16 tree keep fp32."""
    rcfg, _, params, tm, _ = model_pair("zamba2_bf16")
    per = sum(b.repeat for b in rcfg.pattern)
    shared = [tm.blocks[s * per + per - 1] for s in range(rcfg.n_super)]
    assert all(b is shared[0] for b in shared)
    assert len({id(b) for b in tm.blocks}) == len(tm.blocks) - \
        rcfg.n_super + 1
    leaves = list(_named_leaves(tm, jax.tree.map(np.asarray, params)))
    names = [n for n, *_ in leaves]
    assert names == [n for n, _ in tm.named_parameters()]
    assert len(set(names)) == len(names)
    paths = [path for *_, path in leaves]
    assert f"g1.attn.wq" in paths and "blocks.5.attn.wq" in names
    assert not any(n.startswith(f"blocks.{2 * per - 1}.") for n in names)
    got = shared[0].attn.wq.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        got, np.asarray(params["g1"]["attn"]["wq"]).view(np.uint16))
    blk = tm.blocks[per + 2]                  # layer [1, 2] of g0
    for leaf in ("a_log", "d_skip", "dt_bias"):
        assert getattr(blk, leaf).dtype == torch.float32
        np.testing.assert_array_equal(
            getattr(blk, leaf).numpy(), np.asarray(params["g0"][leaf][1, 2]))
    assert blk.in_proj.dtype == torch.bfloat16


def test_apply_handles_fp32_leaves_of_a_bf16_model():
    """zamba2 (bf16 with fp32 leaves): two ``apply`` steps on identical
    parameters, gradients and state; every parameter and moment in its
    own dtype, bf16 within one unit in the last place."""
    rcfg, tcfg = _pair("zamba2-2.7b")
    params = RefModel(rcfg).init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=0.5)
    rocfg, tocfg = ref_opt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    rstate = ref_opt.init(params, rocfg)
    tparams = dict(tm.named_parameters())
    tstate = opt.init(tparams, tocfg)
    rng = _rng(4)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), p.dtype), params)
        tgrads = named_from_jax(tm, jax.tree.map(np.asarray, grads))
        params, rstate, rstats = ref_opt.apply(params, grads, rstate, rocfg)
        tstats = opt.apply(tparams, tgrads, tstate, tocfg)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-5)
    want = named_from_jax(tm, jax.tree.map(np.asarray, params))
    for n, p in tparams.items():
        assert p.dtype == want[n].dtype, n
        g, r = _np(p), _np(want[n])
        if p.dtype == torch.float32:
            assert_grad_close(p, want[n], n)
        else:
            lim = 2.0 ** -7 * np.abs(r) + 2.0 ** -8 * np.abs(r).max()
            assert np.all(np.abs(g - r) <= lim + 0.1 * tocfg.lr), n
    assert tparams["blocks.0.a_log"].dtype == torch.float32


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """One ``build_train_step`` step in fp32 on identical weights and
    batch: loss, norm, lr, and every parameter after it: all but 0.1 % of
    each leaf's elements at the fp32 limit, every element within
    ``0.5·lr``.  AdamW's first step moves an element by ``g / (|g| +
    eps)``, so a gradient at rounding-noise level moves by a sizeable
    part of ``lr`` (zamba2, one ``in_proj`` element: -1.28e-7 in the
    port, -7.88e-8 in the reference, against 0.1 for the leaf's
    largest)."""
    rcfg, tcfg = _pair(arch, **F32)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(Model(tcfg, device=CPU),
                         jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    rocfg, tocfg = ref_opt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    rstate = ref_opt.init(params, rocfg)
    rstep = jax.jit(ref_build_train_step(rm, rocfg))
    tstep = build_train_step(tm, tocfg, opt.init(dict(tm.named_parameters()),
                                                 tocfg))
    toks = _rng(3).integers(0, rcfg.vocab_size, (2, 2 * rcfg.ssm_chunk + 1))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    params, _, rmet = rstep(params, rstate,
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


# ---------------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", ARCHS)
def test_unported_names_nothing_for_the_recurrent_archs(arch):
    assert unported(get_config(arch)) is None
    assert unported(smoke_config(arch)) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_model_without_a_device_needs_the_gpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config(arch))


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
