"""The attention's heads split unevenly over "model" (``blocks.heads_split``:
rank r of m computes the query heads ``[⌊h·r/m⌋, ⌊h·(r+1)/m⌋)`` and the
K/V heads they read), on the CPU: the sharded train step against the
world of one at ``tests/test_torch_tp.py``'s bounds, and one attention
block's per-head outputs, concatenated over the ranks, against the JAX
package's attention on the same numpy inputs.

``tests/test_torch_tp_recurrent.py`` holds the recurrent blocks' cases
and uses :func:`check_block_heads`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models.layers import rms_norm as ref_rms_norm
from repro_torch.configs import smoke_config
from repro_torch.distributed import selftest
from repro_torch.models.blocks import _mlstm_dims, heads_split, value_split
from test_torch_tp import F32, _assert_parity, _cfg, _spawn

#: blocks in fp32: ``tests/test_torch_ssm.py``'s tolerance
TOL = 1e-4
#: decode steps each block case runs after its forward
DECODE_STEPS = 4
#: the leaf of each recurrent block kind's row-parallel product
OUT_LEAF = {"mamba2": "out_proj", "mlstm": "down", "slstm": "out"}


@pytest.mark.parametrize("heads", [(6, 2), (10, 5)])
def test_uneven_heads_step_equals_world_one(tmp_path, heads):
    """mistral smoke on (1, 4) with heads that split unevenly: 6 query
    heads over 2 K/V heads (1, 2, 1, 2 a rank, each rank's read one K/V
    head), and 10 over 5 (2, 3, 2, 3 a rank; ranks 1 and 3 straddle two
    K/V heads, read by 2 and 1 of their query heads, so the K/V heads are
    repeated to the query heads before the attention).  The step equals
    the world of one; every rank holds the specs' share and computes its
    heads."""
    cfg = _cfg("mistral-nemo-12b", n_heads=heads[0], n_kv_heads=heads[1])
    outs = _spawn(tmp_path, selftest.sharded_step_parity, 4,
                  (cfg, (1, 4), 4, 32, 2))
    _assert_parity(outs)
    for r, o in enumerate(outs):
        assert o["param_bytes"] == o["spec_param_bytes"], o
        assert o["heads"]["_AttnParams"]["heads"] == list(
            heads_split(heads[0], 4, r))


def _leaves(tree, prefix=""):
    """A reference block's parameter tree as numpy fp32 leaves by the
    port's parameter names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def check_block_heads(tmp_path, kind, arch, m, form=None, **kw):
    """One block of ``kind`` over a "model" group of ``m`` gloo ranks
    (``selftest.block_heads``) against the reference's block of the same
    weights (``build_<kind>``; its norms and Mamba-2's per-head scalars
    drawn anew, so that none is trivial) on the same numpy inputs, in
    fp32 at ``TOL``: each rank computes the heads of
    :func:`heads_split` (an mLSTM: the heads and value channels of
    :func:`value_split`; an sLSTM whose decode takes the channels split,
    ``blocks.slstm_split``: the channels ``heads_split(hd, m, r)`` of
    every head); their per-head outputs (an sLSTM's forward in the
    channels split: each head's channels), concatenated over the ranks
    in order, are the reference's (attention: its output before
    ``wo``; a recurrent block: through the whole out-projection, with the
    residual, its block's output); every rank's block output (the
    row-parallel sum) and its first ``DECODE_STEPS`` decode outputs are
    the reference's.  ``form``: the leaves' exchange forced into it
    (``blocks.force_heads_form``; ``None``: the rule's)."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), **F32, **kw)
    cfg = dataclasses.replace(smoke_config(arch), **F32, **kw)
    params, _ = ref_blocks.BUILDERS[kind](rcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    for name in ("ln", "ln1", "ln2", "a_log", "d_skip", "dt_bias"):
        if name in params:
            params[name] = jnp.asarray(
                1 + 0.3 * rng.standard_normal(params[name].shape),
                params[name].dtype)
    leaves = _leaves(params)
    x = rng.standard_normal((2, 2 * rcfg.ssm_chunk, rcfg.d_model)
                            ).astype(np.float32)
    outs = _spawn(tmp_path, selftest.block_heads, m,
                  (cfg, kind, leaves, x, DECODE_STEPS, form))
    jx = jnp.asarray(x)
    ref, _ = ref_blocks.TRAIN_FNS[kind](rcfg, params, jx, 0, None)
    if (outs[0]["splits"] or {}).get("forward") == "channels":
        # each rank's channels of every head [B,S,H·P], put in head order
        heads = np.concatenate([o["head_outputs"].reshape(
            *x.shape[:2], rcfg.n_heads, -1) for o in outs], axis=-1
        ).reshape(x.shape)
    else:
        heads = np.concatenate([o["head_outputs"] for o in outs], axis=-1)
    if kind in OUT_LEAF:
        h = (rcfg.n_heads if kind != "mamba2" else
             ref_blocks._mamba_dims(rcfg)[2])
        np.testing.assert_allclose(x + heads @ leaves[OUT_LEAF[kind]],
                                   np.asarray(ref), atol=TOL, rtol=TOL)
    else:
        h = rcfg.n_heads
        positions = jnp.arange(x.shape[1])[None, :]
        q, k, v = ref_blocks._qkv(rcfg, params["attn"],
                                  ref_rms_norm(jx, params["ln1"]),
                                  positions=positions)
        o = ref_attn.attention(q, k, v, causal=True,
                               chunk=rcfg.attention_chunk)
        np.testing.assert_allclose(heads, np.asarray(o).reshape(
            heads.shape), atol=TOL, rtol=TOL)
    cache = ref_blocks.CACHE_FNS[kind](rcfg, x.shape[0], DECODE_STEPS)
    ref_steps = []
    for t in range(DECODE_STEPS):
        y, cache = ref_blocks.DECODE_FNS[kind](rcfg, params, cache,
                                               jx[:, t:t + 1], jnp.int32(t))
        ref_steps.append(np.asarray(y))
    for r, o in enumerate(outs):
        if kind == "mlstm":
            got = (*o["heads"]["mlstm"], *o["channels"])
            assert got == value_split(h, _mlstm_dims(cfg)[2], m, r), got
        else:
            assert set(map(tuple, o["heads"].values())) == {
                heads_split(h, m, r)}, o["heads"]
            if kind == "slstm" and o["splits"]["decode"] == "channels":
                assert tuple(o["channels"]) == heads_split(
                    cfg.d_model // h, m, r), o["channels"]
        np.testing.assert_allclose(o["out"], np.asarray(ref), atol=TOL,
                                   rtol=TOL)
        assert len(o["decode"]) == DECODE_STEPS
        for got, want in zip(o["decode"], ref_steps):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    return outs


def test_attention_heads_against_the_reference(tmp_path):
    """mistral smoke with 10 query heads over 5 K/V heads on 4 ranks
    (2, 3, 2, 3 heads; two ranks straddle two K/V heads): the ranks'
    per-head outputs concatenated are the reference's attention output
    before ``wo``; the block and its decode are the reference's."""
    check_block_heads(tmp_path, "attn", "mistral-nemo-12b", 4,
                      n_heads=10, n_kv_heads=5)
