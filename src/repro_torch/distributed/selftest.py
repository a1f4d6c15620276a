"""Multi-rank self-test, the counterpart of the JAX package's
``distributed/selftest.py``: the pipeline, the compressed all-reduce, the
sharded train step against the single one, and an elastic restore onto a
smaller mesh.

    PYTHONPATH=src python -m repro_torch.distributed.selftest [--world N]
        [--device cpu|cuda]

It starts N ranks itself, one process each: gloo on the CPU (default 8,
the reference's 8 forced host devices), NCCL on the GPUs (default: every
visible one; a world of one runs in this process).  Prints "SELFTEST OK"
on success.  Each check is a function every rank of an initialised group
calls, so a caller that holds a group (a test, ``chip_smoke.py``) runs
them directly.

Tolerances are the reference's or tighter: the pipeline rtol = atol =
2e-4 against the sequential product; the int8 psum within 2 % of the
exact sum's largest element (and equal to the reference's formula
evaluated in numpy); the sharded step, in fp32, its loss within 1e-5
relative of the single step's and each parameter leaf within 1e-4 of its
largest element (the reference holds bf16 to 2e-2 / 0.1); the restore
exact.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
PSUM_RTOL = 0.02


def _mesh_2d(world: int) -> Tuple[int, int]:
    """The (data, model) shape of the checks: (2, world / 2) where the
    world is even (2 x 4 at 8), else (1, world)."""
    return (2, world // 2) if world % 2 == 0 else (1, world)


def _device() -> torch.device:
    from .launch import rank_device
    return rank_device()


def check_pipeline() -> Dict:
    """4 stages (or as many as the world has, up to 4) of tanh(h @ w) on 8
    microbatches against the sequential product, on a (data, pipe) mesh."""
    import torch.distributed as dist

    from ..distributed.pipeline import pipeline_apply
    from ..launch.mesh import make_test_mesh
    world = dist.get_world_size()
    n_stages = next(s for s in (4, 2, 1) if world % s == 0)
    mesh = make_test_mesh((world // n_stages, n_stages), ("data", "pipe"))
    n_micro, mb, d = 8, 2, 16
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((n_stages, d, d)) * 0.3
                         ).float().to(_device())
    x = torch.from_numpy(rng.standard_normal((n_micro, mb, d))
                         ).float().to(_device())
    y = pipeline_apply(lambda wi, h: torch.tanh(h @ wi), w, x, mesh,
                       axis="pipe")
    ref = x
    for s in range(n_stages):
        ref = torch.tanh(ref @ w[s])
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    return dict(stages=n_stages, micro=n_micro,
                max_abs_err=float((y - ref).abs().max()))


def psum_oracle(rows: np.ndarray) -> np.ndarray:
    """The reference's ``compressed_psum`` of one row per rank, in
    numpy: the largest per-row scale, each row requantised against it,
    summed in int32, rescaled."""
    x = rows.astype(np.float32)
    scales = np.maximum(np.abs(x).max(axis=1), np.float32(1e-12)) / \
        np.float32(127.0)
    smax = np.float32(scales.max())
    q = np.clip(np.round(x / smax), -127, 127).astype(np.int32)
    return (q.sum(axis=0).astype(np.float32) * smax).astype(np.float32)


def check_compressed_psum() -> Dict:
    """Each rank's row of one [world, 64] matrix summed by
    ``compressed_psum`` over a ("data",) mesh: within 2 % of the exact
    sum's largest element, and equal to :func:`psum_oracle`."""
    import torch.distributed as dist

    from ..launch.mesh import make_test_mesh
    from ..optim.compression import compressed_psum
    world = dist.get_world_size()
    mesh = make_test_mesh((world,), ("data",))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((world, 64)).astype(np.float32)
    mine = torch.from_numpy(x[dist.get_rank()]).to(_device())
    got = compressed_psum(mine, mesh.get_group("data")).cpu().numpy()
    exact = x.sum(axis=0)
    rel = float(np.abs(got - exact).max() / np.abs(exact).max())
    if rel >= PSUM_RTOL:
        raise AssertionError(f"int8 psum rel err {rel}")
    np.testing.assert_allclose(got, psum_oracle(x), rtol=1e-6, atol=1e-6)
    return dict(ranks=world, rel_err=rel)


def _smoke_fp32(arch: str):
    from ..configs import smoke_config
    return dataclasses.replace(smoke_config(arch), param_dtype="float32",
                               compute_dtype="float32")


def sharded_step_parity(cfg, shape: Tuple[int, int], batch: int = 4,
                        seq: int = 32, steps: int = 1,
                        lr: float = 1e-3, floor: bool = False,
                        form: Optional[str] = None) -> Dict:
    """``steps`` train steps of ``cfg`` (weights from seed 0) on one batch
    drawn with numpy (with a vision model's ``frontend`` and an
    encoder-decoder's ``enc_embeds``), by ``build_train_step`` on this
    rank alone and by ``build_sharded_train_step`` over a (data, model)
    mesh of ``shape`` on this rank's shards: the worst relative loss
    difference; the first step's gradients (averaged over "data",
    gathered whole) against the world of one's, the worst difference over
    its leaf's norm and over its largest element; after the last step,
    the same of the parameters; after the first step, the two runs'
    parameters' difference against the one AdamW's first update makes of
    their gradients' difference (:func:`_first_step`), the worst over its
    leaf's largest element; the sharded model's parameter bytes
    beside the specs' share (every leaf's whole bytes over the "model"
    size where its spec names "model" and over the "data" size where it
    names "data"), the leaves whose bytes are not that share, the shapes
    of the experts' leaves the rank holds, the heads it computes and its
    leaves' shapes in the first module of each kind (:func:`_heads_report`),
    the leaves the sharded steps gathered whole, by axis, and the
    collectives' operand bytes of the sharded steps by kind and axis
    (``sharding.stats``), and on CUDA the rank's peak memory over the
    sharded steps (``step_peak_bytes``).  Every figure of every leaf is under
    ``figures`` (:data:`FIGURES`).  The world of one runs, and is
    compared, on rank 0 alone, which broadcasts its figures; every other
    rank holds each copy of a leaf that ranks hold alike (a norm, a
    leaf whole over "model" or over "data") to rank 0's, or to the lowest
    rank's holding the same slice, by the CRC-32 of their bytes: the
    first step's gradients and the leaves after every step
    (:func:`_replicas_checked`, ``replica_checks`` the copies it
    compared; a copy that differs raises on every rank).

    ``floor``: also the world of one's own fp32 floor, leaf by leaf: its
    run twice more with the embedding table one ulp up and one ulp down
    (every activation then rounds otherwise, as the sharded run's
    reordered sums make it do), the larger of the two runs' differences
    from the first, in each figure, under ``floors`` (:func:`beyond_floor`
    reads both).

    ``form``: the sharded model's heads exchange forced into that form
    (``blocks.force_heads_form``); ``heads_forms``: the sharded steps'
    calls by form.

    ``seconds_by_part``: this rank's wall seconds (the device
    synchronised) by run (``one``, ``floor``, ``sharded``) and part: the
    build, the gradients, the steps, the host copies of whole leaves,
    the first update's prediction, the replicas' digests, and the
    comparison."""
    import torch.distributed as dist

    from ..launch.mesh import make_test_mesh
    from ..launch.steps import (build_sharded_train_step, build_train_step,
                                loss_and_grads, mesh_places)
    from ..models import blocks, moe, sharding
    from ..models.model import Model
    from ..optim import optimizer as opt
    dev = _device()
    mesh = make_test_mesh(shape, ("data", "model"))
    ax = sharding.mesh_axis(mesh, "model")
    dax = sharding.mesh_axis(mesh, "data")
    wax = sharding.width_axis_of(mesh)
    data = _batch(cfg, batch, seq, dev)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    # the world of one runs, and is compared, on rank 0 alone: its runs
    # take no collective; the other ranks' copies are held to rank 0's
    judge = dist.get_rank() == 0
    runs, nudged, first, k_one, checks = [], [], None, None, 0
    kinds = ("one",) + ((math.inf, -math.inf) if floor else ())
    spent: Dict[str, float] = {}
    for kind in (kinds if judge else ()) + ("sharded",):
        sharded = kind == "sharded"
        run = (kind if isinstance(kind, str) else "floor") + ": "
        with _timed(spent, run + "build", dev):
            model = Model(cfg, device=dev,
                          **(mesh_places(mesh) if sharded else {}),
                          generator=torch.Generator(device=dev).manual_seed(0))
        if not isinstance(kind, str):       # one ulp toward +-inf
            with torch.no_grad():
                model.embed.copy_(torch.nextafter(
                    model.embed, torch.tensor(kind, device=dev)))
        model.requires_grad_(True)
        if sharded:
            blocks.force_heads_form(model, form)
        params = dict(model.named_parameters())
        layout = model.layout()
        if sharded:
            rows = {k: sharding.shard_of(v, 0, dax.rank, dax.size)
                    for k, v in data.items()}
            with _timed(spent, run + "gradients", dev), \
                    sharding.parallel(model=ax, data=dax, width=wax):
                _, grads = loss_and_grads(model, rows)
                # a slice of the experts' width has seen every row already
                grads = {n: (g.float() if layout[n].width_dim is not None
                             else sharding.all_reduce(g.float(), dax)) /
                         dax.size for n, g in grads.items()}
            with _timed(spent, run + "replicas", dev):
                checks += _replicas_checked(grads, layout, ax, dax,
                                            "gradients")
        else:
            with _timed(spent, run + "gradients", dev):
                _, grads = loss_and_grads(model, data)
        with _timed(spent, run + "host copies", dev):
            grads = _whole(grads, layout, ax if sharded else None, dax,
                           judge)
        state = opt.init(params, ocfg)
        step = build_sharded_train_step(model, ocfg, state, mesh) \
            if sharded else build_train_step(model, ocfg, state)
        sharding.stats.reset()
        moe.width_forms.clear()
        blocks.heads_forms.clear()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with _timed(spent, run + "steps", dev):
            out = step(data)
            losses = [float(out["loss"])]
        step_one = sharding.stats.as_dict()     # the steps' own, not the
        # first update's scalars, as the step took them from its norm
        k = opt.step_scalars(opt.OptState(
            torch.zeros((), dtype=torch.int32), {}, {}),
            out["grad_norm"].float().cpu(), ocfg)
        if sharded:
            with _timed(spent, run + "replicas", dev):
                checks += _replicas_checked(params, layout, ax, dax,
                                            "step 1")
            with _timed(spent, run + "first step", dev):
                first = _first_step(first, params, layout, ax,
                                    runs[0][1] if judge else None, grads,
                                    (k_one, k), ocfg, dax=dax)
        elif kind == "one":
            with _timed(spent, run + "host copies", dev):
                first, k_one = _whole({n: p.detach() for n, p in
                                       params.items()}, layout, None), k
        sharding.stats.reset()                  # comparison's gathers
        for i in range(2, steps + 1):
            with _timed(spent, run + "steps", dev):
                losses.append(float(step(data)["loss"]))
            if sharded:
                with _timed(spent, run + "replicas", dev):
                    checks += _replicas_checked(params, layout, ax, dax,
                                                f"step {i}")
        coll = _added(step_one, sharding.stats.as_dict())
        with _timed(spent, run + "host copies", dev):
            final = _whole({n: p.detach() for n, p in params.items()},
                           layout, ax if sharded else None, dax, judge)
        if sharded:
            report = dict(**_held(params, layout, ax, dax),
                          replica_checks=checks,
                          leaf_gathers=coll["leaf_gathers"],
                          expert_shapes={n: list(p.shape) for n, p in
                                         params.items() if ".moe.w" in n
                                         and not n.endswith("wg")},
                          coll_bytes=coll["bytes"],
                          moe_width_forms=dict(moe.width_forms),
                          heads_forms=dict(blocks.heads_forms),
                          coll_bytes_by_axis=coll["by_axis"],
                          step_peak_bytes=(
                              torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
                          heads=_heads_report(model, params))
        (runs if isinstance(kind, str) else nudged).append(
            (losses, grads, final))
        del model, step, state
    with _timed(spent, "compare", dev):
        figures = [_compared(runs, nudged, first, dev) if judge else None]
        dist.broadcast_object_list(figures, src=0)
    return dict(mesh=list(shape), steps=steps, **figures[0], **report,
                seconds_by_part=spent)


def sharded_losses(cfg, shape: Tuple[int, ...], batch: int = 4,
                   seq: int = 32, steps: int = 1,
                   lr: float = 1e-3) -> Dict:
    """The sharded run of :func:`sharded_step_parity` alone (the same
    weights, batch and steps, no world of one: for a model too deep for
    two fp32 orders of its sums to agree), over a (data, model) mesh of
    ``shape``, or a (pod, data, model) one where ``shape`` has three
    sizes: its losses, this rank's parameter bytes beside the specs'
    share, its heads, and the MoE dispatches by width form."""
    from ..launch.mesh import make_test_mesh
    from ..launch.steps import build_sharded_train_step, mesh_places
    from ..models import moe, sharding
    from ..models.model import Model
    from ..optim import optimizer as opt
    dev = _device()
    mesh = make_test_mesh(shape, ("pod", "data", "model")[-len(shape):])
    data = _batch(cfg, batch, seq, dev)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    model = Model(cfg, device=dev, **mesh_places(mesh),
                  generator=torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    step = build_sharded_train_step(model, ocfg, opt.init(params, ocfg),
                                    mesh)
    moe.width_forms.clear()
    losses = [float(step(data)["loss"]) for _ in range(steps)]
    return dict(mesh=list(shape), steps=steps, losses=losses,
                **_held(params, model.layout(),
                        sharding.mesh_axis(mesh, "model"),
                        sharding.mesh_axis(mesh, "data")),
                heads=_heads_report(model, params),
                moe_width_forms=dict(moe.width_forms))


def moe_width_forms(cfg, shape: Tuple[int, int], batch: int = 4,
                    seq: int = 32) -> Dict:
    """The first block's routed FFN of ``cfg`` (weights from seed 0) on
    this rank's rows of one numpy-drawn input ``[batch, seq, d]``, over a
    (data, model) mesh of ``shape``, in each width form of
    ``moe._dispatch`` (``moe.FORMS``), forward and backward of
    ``sum(y · r) + aux`` (``r`` drawn alike): the figures of the
    ``"weights"`` form against the ``"tokens"`` form (the loss; the
    gradients of the input and of every leaf the rank holds, each
    relative in norm and over its largest element, as
    :func:`_figures`); for each form the collectives' operand bytes by
    kind and axis, the leaves gathered whole by axis and name, the
    dispatches by form, the rows each expert's products ran on
    (``expert_rows``: the first ``bmm``'s middle dimension), the seconds
    of its one pass (the tokens form's first, carrying the set-up) and,
    on CUDA, the rank's peak memory over it (``step_peak_bytes``) beside
    what it held as it began (``held_bytes``: the model, the input, the
    other form's gradients)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..launch.mesh import make_test_mesh
    from ..launch.steps import mesh_places
    from ..models import moe, sharding
    from ..models.layers import dtype_of
    from ..models.model import Model
    dev = _device()
    mesh = make_test_mesh(shape, ("data", "model"))
    dax = sharding.mesh_axis(mesh, "data")
    axes = dict(model=sharding.mesh_axis(mesh, "model"), data=dax,
                width=sharding.width_axis_of(mesh))
    model = Model(cfg, device=dev, **mesh_places(mesh),
                  generator=torch.Generator(device=dev).manual_seed(0))
    ffn = model.blocks[0].moe
    rng = np.random.default_rng(3)
    x, r = (sharding.shard_of(torch.from_numpy(rng.standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32)), 0, dax.rank,
        dax.size).to(dev) for _ in range(2))
    x = x.to(dtype_of(cfg.compute_dtype))
    kw = dict(n_groups=cfg.moe_n_groups) if cfg.moe_grouped else {}
    run = moe.moe_ffn_grouped if cfg.moe_grouped else moe.moe_ffn
    rows = []

    class _Rows(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                rows.append(args[0].shape[1])
            return func(*args, **(kwargs or {}))

    out, runs = {}, {}
    for form in moe.FORMS:
        leaves = {}
        for n, p in ffn.named_parameters():
            leaves[n] = p.detach().clone().requires_grad_(True)
            leaves[n].leaf_name = p.leaf_name
        xi = x.clone().requires_grad_(True)
        sharding.stats.reset()
        moe.width_forms.clear()
        rows.clear()
        cuda, held = dev.type == "cuda", None
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with sharding.parallel(**axes):
            with _Rows():
                y, aux = run(xi, leaves, cfg.top_k, cfg.capacity_factor,
                             expert_parallel=ffn.tp, form=form, **kw)
            loss = (y.float() * r).sum() + aux
            loss.backward()
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        grads = {"x": xi.grad, **{n: t.grad for n, t in leaves.items()}}
        runs[form] = ([float(loss.detach())], grads, {})
        out[form] = dict(expert_rows=rows[0], forms=dict(moe.width_forms),
                         seconds=seconds,
                         step_peak_bytes=(torch.cuda.max_memory_allocated(
                             dev) if cuda else None),
                         held_bytes=held,
                         **sharding.stats.as_dict())
        del y, aux, loss, xi, leaves
    out["figures"] = {f: v for f, v in _figures(
        runs["tokens"], runs["weights"]).items() if v}
    return out


def _batch(cfg, batch: int, seq: int, dev) -> Dict[str, torch.Tensor]:
    """The parity runs' batch, drawn with numpy from seed 2: tokens and
    labels, with a vision model's ``frontend`` and an encoder-decoder's
    ``enc_embeds``."""
    rng = np.random.default_rng(2)
    data = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, seq))).to(dev)
            for k in ("tokens", "labels")}
    extra = {"vision": ("frontend", cfg.n_frontend_tokens),
             "audio": ("enc_embeds", seq)}.get(cfg.frontend)
    if extra is not None:
        data[extra[0]] = torch.from_numpy(rng.standard_normal(
            (batch, extra[1], cfg.d_model)).astype(np.float32)).to(dev)
    return data


def _held(params, layout, ax, dax) -> Dict:
    """The parameter bytes this rank holds beside the specs' share (each
    leaf's whole bytes over the "model" size where its spec names
    "model" and over the "data" size where it names "data"), and the
    leaves whose bytes are not that share."""
    from ..models import sharding
    held, share, off = 0, 0.0, []
    for n, p in params.items():
        have = p.numel() * p.element_size()
        leaf, spec = layout[n], layout[n].spec
        whole = have * (ax.size if leaf.shard_dim is not None else 1) * (
            dax.size if leaf.width_dim is not None else 1)
        want = whole / (ax.size if sharding.model_dim(spec) is not None
                        else 1) / (
            dax.size if sharding.data_dim(spec) is not None else 1)
        held, share = held + have, share + want
        if have != want:
            off.append(n)
    return dict(param_bytes=held, spec_param_bytes=share, not_the_share=off)


def _replicas_checked(tensors: Dict[str, torch.Tensor], layout, ax, dax,
                      what: str) -> int:
    """Each of ``tensors`` (this rank's leaves or gradients, by name) that
    ranks hold alike, whole over "model" or over "data" (all but the
    experts' width slices), against the copy of the lowest rank holding
    the same slice (rank 0's where it is whole everywhere), by a digest
    of its bytes.  Every rank reads every rank's digests, so
    a copy that differs raises on every rank, naming the ranks and
    leaves.  The digest is the CRC-32 of the copy's bytes, which no change
    within one 32-bit word of it leaves alike.  Returns how many of this
    rank's copies were compared."""
    import zlib

    import torch.distributed as dist
    mine = {}
    for n, t in tensors.items():
        leaf = layout[n]
        if (leaf.shard_dim is None and ax.size > 1) or (
                leaf.width_dim is None and dax.size > 1):
            part = (ax.rank if leaf.shard_dim is not None else None,
                    dax.rank if leaf.width_dim is not None else None)
            raw = _host_copy(t, t.dtype).reshape(-1).view(
                torch.uint8).numpy()
            mine[n] = (part, zlib.crc32(raw.data))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    lowest, differ, compared = {}, [], 0
    for r, got in enumerate(every):
        for n, (part, digest) in got.items():
            if (n, part) not in lowest:
                lowest[n, part] = digest
                continue
            compared += r == dist.get_rank()
            if digest != lowest[n, part]:
                differ.append((r, n))
    if differ:
        raise AssertionError(
            f"{what}: these ranks' copies of leaves held alike differ from "
            f"the lowest rank's (rank, leaf): {differ[:8]}")
    return compared


def _compared(runs, nudged, first, dev=None) -> Dict:
    """The world of one's run and the sharded one's, each ``(losses,
    gradients, leaves)``, compared (on ``dev``, :func:`_figures`): every
    figure of every leaf, and the worst of each with its leaf; with
    ``nudged`` (the world of one's runs one ulp apart) their floors."""
    figures = _figures(*runs, dev=dev)
    out = dict(losses_single=runs[0][0], losses_sharded=runs[1][0],
               loss_rel_err=figures["loss_rel_err"]["loss"],
               figures=figures, **first)
    for kind, named in (("grad", "worst_grad_leaf"),
                        ("leaf", "worst_leaf")):
        over_max = figures[f"{kind}_err_over_max"]
        worst = max(over_max, key=over_max.get)
        out.update({f"worst_{kind}_err_over_max": over_max[worst],
                    named: worst,
                    f"worst_{kind}_rel_norm": max(
                        figures[f"{kind}_rel_norm"].values())})
    if nudged:
        each = [_figures(runs[0], run, dev=dev) for run in nudged]
        out["floors"] = {f: {n: max(v[f][n] for v in each)
                             for n in each[0][f]} for f in FIGURES}
    return out


def block_heads(cfg, kind: str, leaves: Optional[Dict[str, np.ndarray]],
                x: np.ndarray, decode_steps: int = 0,
                form: Optional[str] = None, alone: bool = False) -> Dict:
    """One block of ``kind`` (``models.model.BLOCKS``) on this rank's
    shards of a "model" group of every rank (each rank calls it), its
    leaves the whole numpy ``leaves`` (by parameter name) sliced as the
    build slices them (``None``: the block's own draws from seed 0, the
    world of one's, sliced): the heads it computes (an mLSTM's value
    ``channels`` of each too, an sLSTM's ``hd`` channels of every head
    where its decode steps take the channels split; ``None`` otherwise),
    an sLSTM's split of the forward and of a decode step (``splits``,
    ``SlstmBlock.split_of``; ``None`` for another kind), their outputs on
    ``x`` [B,S,d] before the row-parallel product (``head_outputs``),
    the block's output (summed over "model"), and its ``decode`` outputs
    on the first ``decode_steps`` positions of ``x``, all as numpy;
    ``form``: every leaf's exchange forced into that form
    (``blocks.force_heads_form``; ``None``: ``blocks.heads_form``'s
    rule).  Of the decode steps alone: the calls by form
    (``heads_forms``), the bytes the rule counts for them
    (``heads_moved``), the collectives' "model" bytes by kind
    (``model_bytes``), the leaves gathered whole over "model", by name
    (``leaf_gathers``), and the milliseconds a step (``decode_ms``, the
    device synchronised).  ``alone``: the world of one, on this rank by
    itself (no collective)."""
    import torch.distributed as dist

    from ..launch.mesh import make_test_mesh
    from ..models import blocks, sharding
    from ..models.layers import dtype_of
    from ..models.model import BLOCKS
    world, rank = (1, 0) if alone else (dist.get_world_size(),
                                        dist.get_rank())
    dev = _device()
    with sharding.build_shards(rank, world), torch.no_grad():
        blk = BLOCKS[kind](cfg, generator=torch.Generator(
            device=dev).manual_seed(0))
        specs = blk.param_specs()
        for n, p in blk.named_parameters():
            if leaves is not None:
                p.copy_(sharding.keep_shard(torch.from_numpy(
                    np.asarray(leaves[n])).to(dev, p.dtype), specs[n]))
    blocks.force_heads_form(blk, form)
    ax = None if alone else sharding.mesh_axis(
        make_test_mesh((world,), ("model",)), "model")
    tx = torch.from_numpy(x).to(dev, dtype_of(cfg.compute_dtype))
    with torch.inference_mode(), sharding.parallel(model=ax):
        heads = blk.head_outputs(tx)
        y = blk(tx)[0]
        cache = blk.init_cache(x.shape[0], max(decode_steps, 1))
        sharding.stats.reset()
        blocks.heads_forms.clear()
        blocks.heads_moved.clear()
        _sync(dev)
        t0 = time.perf_counter()
        steps = [blk.decode(cache, tx[:, t:t + 1], t)
                 for t in range(decode_steps)]
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / max(decode_steps, 1)
    coll = sharding.stats.as_dict()
    got = {n: mod.heads for n, mod in blk.named_modules()
           if isinstance(getattr(mod, "heads", None), tuple)}
    splits = channels = None
    if hasattr(blk, "channels"):
        channels = list(blk.channels)
    elif hasattr(blk, "split_of"):
        splits = dict(forward=blk.split_of(*x.shape[:2]),
                      decode=blk.split_of(x.shape[0], 1))
        if splits["decode"] == "channels":
            channels = list(blk.hd_channels)
    return dict(heads={n or kind: list(h) for n, h in got.items()},
                channels=channels, splits=splits,
                leaf_gathers=dict(coll["leaf_gathers"].get("model", {})),
                head_outputs=heads.float().cpu().numpy(),
                out=y.float().cpu().numpy(),
                decode=[t.float().cpu().numpy() for t in steps],
                heads_forms=dict(blocks.heads_forms),
                heads_moved=dict(blocks.heads_moved),
                model_bytes=dict(coll["bytes"]),
                decode_ms=ms)


def heads_decode_forms(cases, batch: int, seq: int, steps: int) -> Dict:
    """Each ``(cfg, kind)`` of ``cases`` as one block on this rank's
    shards of a "model" group of every rank, its leaves its own draws
    from seed 0, on one numpy input ``[batch, seq, d]`` (seed 0):
    :func:`block_heads` (the forward over ``seq`` positions, then
    ``steps`` decode steps) in each form of ``blocks.FORMS`` forced and
    under the rule (``"rule"``), against the world of one, which each
    rank computes alone: the worst relative rms, over the forward and
    each decode step, of the block's own output (its output less its
    input) against the world of one's; the decode steps' calls by form,
    the rule's bytes for them, their "model" collectives' bytes and
    their milliseconds a step, and the rank's heads and (an mLSTM's)
    value channels (an sLSTM's ``hd`` channels and its splits), by kind
    and form."""
    from ..models import blocks
    out = {}
    for cfg, kind in cases:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        one = block_heads(cfg, kind, None, x, steps, alone=True)
        want = [one["out"] - x] + [d - x[:, t:t + 1]
                                   for t, d in enumerate(one["decode"])]
        out[kind] = {}
        for form in blocks.FORMS + ("rule",):
            got = block_heads(cfg, kind, None, x, steps,
                              None if form == "rule" else form)
            have = [got["out"] - x] + [d - x[:, t:t + 1]
                                       for t, d in enumerate(got["decode"])]
            out[kind][form] = dict(
                rel_rms=max(float(np.sqrt(np.mean((h - w) ** 2)) /
                                  np.sqrt(np.mean(w ** 2)))
                            for h, w in zip(have, want)),
                **{k: got[k] for k in ("heads_forms", "heads_moved",
                                       "model_bytes", "decode_ms", "heads",
                                       "channels", "splits")})
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _timed(spent: Dict[str, float], part: str, dev: torch.device):
    """Add the block's wall seconds, the device synchronised at both
    ends, to ``spent[part]``."""
    _sync(dev)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(dev)
        spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0


def _heads_report(model, params) -> Dict:
    """The heads this rank computes in the first module of each kind
    that splits them (``Model.computed_heads``), the mLSTM's value
    channels (``Model.computed_channels``), and the shapes of that
    module's leaves as the rank holds them."""
    out = {}
    chans = model.computed_channels()
    for name, (lo, hi) in model.computed_heads().items():
        kind = type(model.get_submodule(name)).__name__
        if kind not in out:
            out[kind] = dict(module=name, heads=[lo, hi], leaves={
                n[len(name) + 1:]: list(p.shape) for n, p in params.items()
                if n.startswith(name + ".")})
            if name in chans:
                out[kind]["channels"] = list(chans[name])
    return out


def _added(a: Dict, b: Dict) -> Dict:
    """Two ``sharding.stats.as_dict()`` records added key by key."""
    if not isinstance(a, dict) and not isinstance(b, dict):
        return a + b
    a, b = a or {}, b or {}
    return {k: _added(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}


def _whole(leaves: Dict[str, torch.Tensor], layout, ax, dax=None,
           keep: bool = True) -> Dict:
    """fp32 host copies (:func:`_host_copy`) of ``leaves`` (a model's
    parameters or gradients by name: kept on the host, beside the models
    on the device, and compared a chunk at a time on the device; a copy
    even of a host fp32 leaf, which the steps update in place), each
    gathered whole over "model" (``ax``) and "data" (``dax``) where
    ``layout`` holds it sliced.  Plain collectives: DTensor's functional
    ones crash under gloo on CUDA tensors (two ranks on one card).  A
    rank that does not ``keep`` them (one that compares nothing) only
    joins the gathers, and returns ``{}``."""
    out = {}
    for n, t in leaves.items():
        t = _gathered(t, layout[n], ax, dax)
        if keep:
            out[n] = _host_copy(t)
    return out


def _host_copy(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A host copy of ``t`` in ``dtype``, in page-locked memory where
    ``t`` lies on a card: copies to and from it then run at the bus's
    rate, where through pageable memory they ran at 0.6 GB/s in gloo
    ranks sharing an H100 (``PERF.md`` §6, PR 27)."""
    if t.device.type != "cuda":
        return t.detach().to("cpu", dtype, copy=True)
    out = torch.empty(t.shape, dtype=dtype, pin_memory=True)
    out.copy_(t.detach().to(dtype))
    return out


def _gathered(t: torch.Tensor, leaf, ax, dax) -> torch.Tensor:
    """``t`` gathered whole over "model" (``ax``) and "data" (``dax``)
    along the dimensions ``leaf`` holds it sliced along."""
    from ..models import sharding
    if ax is not None and leaf.shard_dim is not None:
        t = sharding.all_gather(t, ax, leaf.shard_dim)
    if dax is not None and leaf.width_dim is not None:
        t = sharding.all_gather(t, dax, leaf.width_dim)
    return t


def _first_step(one: Dict[str, torch.Tensor], params, layout, ax,
                g_one: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
                ks, ocfg, chunk: int = 1 << 24, dax=None) -> Dict:
    """The sharded run's parameters ``params`` after its first step (each
    gathered whole in turn) against the world of one's, ``one``.  Both
    started from the same leaves, so AdamW's first update predicts their
    difference element by element from the two runs' gradients ``g_one``
    / ``g`` and step scalars ``ks``: ``u(g) - u(g_one)``, ``u`` the
    update of a zero parameter (``optimizer.update_leaf``).  An element
    whose gradient is near 0 turns the gradients' last-bit difference
    into a step of up to 2·lr, and the prediction holds that too; what is
    left is rounding, or a wrong sharded update.  Returns the worst
    ``|difference - prediction|`` over its leaf's largest element (the
    leaf named), and the worst difference itself over its leaf's norm.
    The host copies go to the parameters' device a chunk at a time.  A
    rank without ``one`` only joins the gathers, and returns ``{}``."""
    from ..optim import optimizer as opt
    worst, leaf, gap = 0.0, None, 0.0
    dev = next(iter(params.values())).device
    for n in params:
        b = _gathered(params[n].detach(), layout[n], ax, dax)
        if one is None:
            continue
        b, a = b.float().reshape(-1), one[n].reshape(-1)
        # |d - prediction| max, |d|², |a|², |a| max: summed on the device,
        # read once a leaf
        acc = torch.zeros(4, dtype=torch.float64, device=dev)
        for i in range(0, a.numel(), chunk):
            part = slice(i, i + chunk)
            u = []
            for grads, k in zip((g_one, g), ks):
                gi = grads[n].reshape(-1)[part].to(dev)
                p, m, v = (torch.zeros_like(gi) for _ in range(3))
                opt.update_leaf(p, gi, m, v, k, ocfg)
                u.append(p)
            ai = a[part].to(dev)
            d = b[part] - ai
            _accumulate(acc, (d - (u[1] - u[0])).abs().max(), d, ai)
        err, d_sq, a_sq, a_max = acc.tolist()
        err /= max(a_max, 1e-30)
        if err > worst:
            worst, leaf = err, n
        gap = max(gap, math.sqrt(d_sq) / max(math.sqrt(a_sq), 1e-30))
    if one is None:
        return {}
    return dict(first_step_unexplained_over_max=worst,
                first_step_unexplained_leaf=leaf,
                first_step_leaf_rel_norm=gap)


#: the figures of a parity run against the world of one: the worst
#: step's loss, relative; the first step's gradients and the last step's
#: leaves, leaf by leaf, each relative in norm and over the leaf's
#: largest element
FIGURES = ("loss_rel_err", "grad_rel_norm", "grad_err_over_max",
           "leaf_rel_norm", "leaf_err_over_max")


def _accumulate(acc: torch.Tensor, e_max: torch.Tensor, d: torch.Tensor,
                a: torch.Tensor) -> None:
    """Fold one chunk into ``acc`` (fp64, on the chunk's device): the
    largest of ``e_max``, ``|d|²`` and ``|a|²`` summed, the largest
    ``|a|``; no host sync."""
    norm = torch.linalg.vector_norm
    part = torch.stack([e_max.float(), norm(d), norm(a),
                        a.abs().max()]).double()
    acc[1:3] += part[1:3].square()
    acc[0::3] = torch.maximum(acc[0::3], part[0::3])


def _leaf_figures(a: torch.Tensor, b: torch.Tensor, dev=None,
                  chunk: int = 1 << 24) -> Tuple[float, float]:
    """``|b - a| / |a|`` in norm and ``max|b - a| / max|a|`` of two
    tensors of one shape (on the host or a device), a chunk at a time on
    ``dev`` (default: ``a``'s device), no chunk larger than ``chunk``
    elements: no temporary of the whole leaf on the host."""
    dev = a.device if dev is None else dev
    a, b = a.reshape(-1), b.reshape(-1)
    acc = torch.zeros(4, dtype=torch.float64, device=dev)
    for i in range(0, a.numel(), chunk):
        ai = a[i:i + chunk].to(dev, torch.float32)
        d = b[i:i + chunk].to(dev, torch.float32) - ai
        _accumulate(acc, d.abs().max(), d, ai)
    e_max, d_sq, a_sq, a_max = acc.tolist()
    return (math.sqrt(d_sq) / max(math.sqrt(a_sq), 1e-30),
            e_max / max(a_max, 1e-30))


def _figures(one, other, dev=None) -> Dict[str, Dict[str, float]]:
    """:data:`FIGURES` of a run ``other`` against ``one``, each ``(losses,
    gradients, leaves)``; the loss's under the name ``loss``.  Each leaf
    pair is compared a chunk at a time on ``dev`` (default: where the
    leaf lies; the host copies of :func:`sharded_step_parity` go to the
    card)."""
    out = dict(loss_rel_err=dict(loss=max(
        abs(a - b) / abs(a) for a, b in zip(one[0], other[0]))))
    for kind, a, b in (("grad", one[1], other[1]),
                       ("leaf", one[2], other[2])):
        each = {n: _leaf_figures(a[n], b[n], dev) for n in a}
        out[f"{kind}_rel_norm"] = {n: v[0] for n, v in each.items()}
        out[f"{kind}_err_over_max"] = {n: v[1] for n, v in each.items()}
    return out


#: a floor whose ``k`` times reaches this share of its leaf's scale
#: opens no way past the bound (:func:`beyond_floor`)
FLOOR_CAP = 0.1


def beyond_floor(out: Dict, bounds: Dict[str, float], k: float) -> list:
    """The figures of a :func:`sharded_step_parity` record ``out`` beyond
    their bound (``bounds``, by figure), ``(figure, leaf, value,
    floor)``.  Where the record holds the world of one's own fp32 floor
    (``floor=True``), a figure within ``k`` times its floor passes too,
    unless ``k`` times that floor reaches :data:`FLOOR_CAP` of its leaf's
    scale (its norm, or its largest element; the loss): a floor that
    large would pass a wrong leaf, so that leaf is held at its bound.  A
    record without floors is held at the bounds alone."""
    floors = out.get("floors", {})
    beyond = []
    for f in FIGURES:
        for n, v in out["figures"][f].items():
            floor = floors.get(f, {}).get(n, 0.0)
            if v > bounds[f] and not v <= k * floor < FLOOR_CAP:
                beyond.append((f, n, v, floor))
    return beyond


def mesh_train_report(cfg, shape: Tuple[int, int], kwargs: Dict) -> Dict:
    """One rank of ``launch.train.run_train(cfg, mesh=...)`` over a (data,
    model) mesh of ``shape`` (every rank of the group calls it): the
    losses, the host seconds of each step, the bytes of the parameters
    and moments the rank holds beside the specs' share, its peak device
    memory (CUDA), and the
    collectives' operand bytes and calls of one step, by kind and axis
    (``sharding.stats`` over the run, over the steps run)."""
    from ..launch.mesh import make_test_mesh
    from ..launch.specs import state_bytes_by_specs
    from ..launch.train import run_train
    from ..models import moe, sharding
    from ..optim.optimizer import OptConfig, moment_dtype_for
    dev = _device()
    mesh = make_test_mesh(shape, ("data", "model"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sharding.stats.reset()
    moe.width_forms.clear()
    out = run_train(cfg, device=dev, mesh=mesh, log=lambda line: None,
                    **kwargs)
    steps = len(out["losses"])
    coll = sharding.stats.as_dict()
    ostate = out["opt_state"]
    by_specs = state_bytes_by_specs(out["model"], dict(zip(
        ("data", "model"), shape)), OptConfig(
            moment_dtype=moment_dtype_for(cfg)))
    return dict(
        losses=out["losses"], step_s=out["step_s"],
        param_bytes_by_specs=by_specs[0], moment_bytes_by_specs=by_specs[1],
        param_bytes=sum(p.numel() * p.element_size()
                        for p in out["model"].parameters()),
        moment_bytes=sum(t.to_local().numel() * t.to_local().element_size()
                         for t in [*ostate.mu.values(), *ostate.nu.values()]),
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        coll_bytes_per_step={k: v / steps for k, v in coll["bytes"].items()},
        coll_calls_per_step={k: v / steps for k, v in coll["calls"].items()},
        coll_bytes_by_axis_per_step={k: v / steps for k, v in
                                     coll["by_axis"].items()},
        leaf_gathers={a: len(c) for a, c in coll["leaf_gathers"].items()},
        moe_width_forms=dict(moe.width_forms))


def check_sharded_train_step() -> Dict:
    """The mistral smoke config in fp32, batch 4 x 32, one step: the
    sharded step on a (2, world / 2) mesh equals the single one."""
    import torch.distributed as dist
    out = sharded_step_parity(_smoke_fp32("mistral-nemo-12b"),
                              _mesh_2d(dist.get_world_size()))
    if not (out["loss_rel_err"] <= LOSS_RTOL and
            out["worst_leaf_err_over_max"] <= LEAF_RTOL):
        raise AssertionError(f"sharded train step: {out}")
    return out


def check_elastic_restore(directory: Optional[str] = None) -> Dict:
    """A tree saved from a (2, world / 2) mesh, sharded P("data",
    "model") / P("model"), restored onto a (1, world / 2) mesh of the
    first ranks: exactly the saved values; ``ElasticPlan`` agrees."""
    import torch.distributed as dist

    from ..checkpoint import checkpoint as ckpt
    from ..launch.mesh import make_test_mesh
    from ..models.sharding import NamedSharding, P
    from ..runtime.fault_tolerance import ElasticPlan
    from torch.distributed.tensor import distribute_tensor
    dev = _device()
    shape_a = _mesh_2d(dist.get_world_size())
    mesh_a = make_test_mesh(shape_a, ("data", "model"))
    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 16))).float(),
            "b": torch.from_numpy(rng.standard_normal((16,))).float()}
    specs = {"w": P("data", "model"), "b": P("model")}
    tree_a = {k: distribute_tensor(v.to(dev), mesh_a,
                                   NamedSharding(mesh_a, specs[k]).placements,
                                   src_data_rank=None)
              for k, v in tree.items()}
    owned = directory is None
    if owned:                           # every rank must agree on it
        directory = [tempfile.mkdtemp(prefix="selftest-ckpt-")
                     if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(directory, src=0)
        directory = directory[0]
    ckpt.save(directory, 7, tree_a)
    if ckpt.latest_step(directory) != 7:
        raise AssertionError("latest_step after save")
    shape_b = (1, shape_a[1])
    mesh_b = make_test_mesh(shape_b, ("data", "model"))
    sh_b = {k: NamedSharding(mesh_b, specs[k]) for k in tree}
    restored = ckpt.restore(directory, 7, tree_a, shardings=sh_b)
    if mesh_b.get_coordinate() is not None:
        for k, v in tree.items():
            got = restored[k].full_tensor().cpu()
            if not torch.equal(got, v):
                raise AssertionError(f"restored {k} differs")
    plan = ElasticPlan.plan(n_devices=math.prod(shape_b),
                            model_parallel=shape_b[1])
    if plan.data_parallel != 1:
        raise AssertionError(f"elastic plan {plan}")
    dist.barrier()
    if owned and dist.get_rank() == 0:
        shutil.rmtree(directory, ignore_errors=True)
    return dict(saved_on=list(shape_a), restored_on=list(shape_b))


CHECKS = (("pipeline", check_pipeline),
          ("compressed_psum", check_compressed_psum),
          ("sharded_train_step", check_sharded_train_step),
          ("elastic_restore", check_elastic_restore))


def run_checks() -> Dict[str, Dict]:
    """Every check on this rank, in order; rank 0 prints each line."""
    import torch.distributed as dist
    out = {}
    for name, fn in CHECKS:
        out[name] = fn()
        if dist.get_rank() == 0:
            print(f"{name} ok {out[name]}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.distributed."
                                 "selftest", description=__doc__.split(
                                     "\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 8 on the CPU, every visible GPU)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: cuda where a GPU is visible, else cpu")
    args = ap.parse_args(argv)
    from .launch import BACKENDS, process_group, spawn
    from .selftest import run_checks as checks   # by module name
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if device == "cuda":
        have = torch.cuda.device_count()
        world = args.world or have
        if not have or world > have:
            print(f"selftest: {world} ranks need {world} GPUs, {have} "
                  f"visible", file=sys.stderr)
            return 2
    else:
        world = args.world or 8
    print(f"selftest: {world} rank(s), {BACKENDS[device]} on {device}",
          flush=True)
    if world == 1:
        with process_group(device):
            checks()
    else:
        spawn(checks, world, device_type=device, timeout=600.0)
    print("SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
