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
import dataclasses
import math
import shutil
import sys
import tempfile
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
                        lr: float = 1e-3) -> Dict:
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
    beside the specs' share over "model" (every leaf's whole bytes over
    the "model" size where its spec names "model"), the leaves whose
    bytes are not that share, and the leaves the sharded steps gathered
    whole, by axis (``sharding.stats``)."""
    from ..launch.mesh import make_test_mesh
    from ..launch.steps import (build_sharded_train_step, build_train_step,
                                loss_and_grads)
    from ..models import sharding
    from ..models.model import Model
    from ..optim import optimizer as opt
    dev = _device()
    mesh = make_test_mesh(shape, ("data", "model"))
    ax = sharding.mesh_axis(mesh, "model")
    dax = sharding.mesh_axis(mesh, "data")
    rng = np.random.default_rng(2)
    data = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, seq))).to(dev)
            for k in ("tokens", "labels")}
    extra = {"vision": ("frontend", cfg.n_frontend_tokens),
             "audio": ("enc_embeds", seq)}.get(cfg.frontend)
    if extra is not None:
        data[extra[0]] = torch.from_numpy(rng.standard_normal(
            (batch, extra[1], cfg.d_model)).astype(np.float32)).to(dev)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    runs = []
    for sharded in (False, True):
        model = Model(cfg, device=dev,
                      tp=(ax.rank, ax.size) if sharded else None,
                      generator=torch.Generator(device=dev).manual_seed(0))
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        layout = model.layout()
        if sharded:
            rows = {k: sharding.shard_of(v, 0, dax.rank, dax.size)
                    for k, v in data.items()}
            with sharding.parallel(model=ax, data=dax):
                _, grads = loss_and_grads(model, rows)
            grads = {n: sharding.all_reduce(g.float(), dax) / dax.size
                     for n, g in grads.items()}
        else:
            _, grads = loss_and_grads(model, data)
        grads = _whole(grads, layout, ax if sharded else None)
        state = opt.init(params, ocfg)
        step = build_sharded_train_step(model, ocfg, state, mesh) \
            if sharded else build_train_step(model, ocfg, state)
        sharding.stats.reset()
        out = step(data)
        losses = [float(out["loss"])]
        # the first update's scalars, as the step took them from its norm
        k = opt.step_scalars(opt.OptState(
            torch.zeros((), dtype=torch.int32), {}, {}),
            out["grad_norm"].float().cpu(), ocfg)
        if sharded:
            first = _first_step(first, params, layout, ax, runs[0][1],
                                grads, (k_one, k), ocfg)
        else:
            first, k_one = _whole({n: p.detach() for n, p in
                                   params.items()}, layout, None), k
        losses += [float(step(data)["loss"]) for _ in range(steps - 1)]
        gathers = sharding.stats.as_dict()["leaf_gathers"]
        final = _whole({n: p.detach() for n, p in params.items()}, layout,
                       ax if sharded else None)
        if sharded:
            held, share, off = 0, 0.0, []
            for n, p in params.items():
                whole = final[n].numel() * p.element_size()
                want = whole / (ax.size if sharding.model_dim(
                    layout[n].spec) is not None else 1)
                have = p.numel() * p.element_size()
                held, share = held + have, share + want
                if have != want:
                    off.append(n)
            report = dict(param_bytes=held, spec_param_bytes=share,
                          not_the_share=off, leaf_gathers=gathers,
                          gathered_at_step=[n for n in params if
                                            layout[n].gather == "step"])
        runs.append((losses, grads, final))
        del model, step, state
    (l1, g1, p1), (l2, g2, p2) = runs
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
    gmax, gleaf, gnorm = _worst(g1, g2)
    worst, leaf, worst_norm = _worst(p1, p2)
    return dict(mesh=list(shape), steps=steps, losses_single=l1,
                losses_sharded=l2, loss_rel_err=loss_rel,
                worst_grad_err_over_max=gmax, worst_grad_leaf=gleaf,
                worst_grad_rel_norm=gnorm,
                worst_leaf_err_over_max=worst, worst_leaf=leaf,
                worst_leaf_rel_norm=worst_norm, **first, **report)


def _whole(leaves: Dict[str, torch.Tensor], layout, ax) -> Dict:
    """fp32 host copies of ``leaves`` (a model's parameters or gradients
    by name: compared on the host, beside the models on the device; a
    copy even of a host fp32 leaf, which the steps update in place), each
    gathered whole over "model" (``ax``) where ``layout`` holds it sliced.
    Plain collectives: DTensor's functional ones crash under gloo on CUDA
    tensors (two ranks on one card)."""
    from ..models import sharding
    out = {}
    for n, t in leaves.items():
        dim = layout[n].shard_dim
        if ax is not None and dim is not None:
            t = sharding.all_gather(t, ax, dim)
        out[n] = t.detach().to("cpu", torch.float32, copy=True)
    return out


def _first_step(one: Dict[str, torch.Tensor], params, layout, ax,
                g_one: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
                ks, ocfg, chunk: int = 1 << 24) -> Dict:
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
    The host copies go to the parameters' device a chunk at a time."""
    from ..models import sharding
    from ..optim import optimizer as opt
    worst, leaf, gap = 0.0, None, 0.0
    dev = next(iter(params.values())).device
    for n, a in one.items():
        b = params[n].detach()
        if ax is not None and layout[n].shard_dim is not None:
            b = sharding.all_gather(b, ax, layout[n].shard_dim)
        b, a = b.float().reshape(-1), a.reshape(-1)
        err = d_sq = a_sq = 0.0
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
            err = max(err, float((d - (u[1] - u[0])).abs().max()))
            d_sq += float(torch.sum(torch.square(d)))
            a_sq += float(torch.sum(torch.square(ai)))
        err /= max(float(a.abs().max()), 1e-30)
        if err > worst:
            worst, leaf = err, n
        gap = max(gap, math.sqrt(d_sq) / max(math.sqrt(a_sq), 1e-30))
    return dict(first_step_unexplained_over_max=worst,
                first_step_unexplained_leaf=leaf,
                first_step_leaf_rel_norm=gap)


def _worst(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """The worst over leaves of ``|a - b|``'s largest element over ``a``'s
    largest, its leaf, and the worst ``‖a - b‖ / ‖a‖``."""
    worst, leaf, worst_norm = 0.0, None, 0.0
    for n in a:
        err = float((a[n] - b[n]).abs().max()) / \
            max(float(a[n].abs().max()), 1e-30)
        if err > worst:
            worst, leaf = err, n
        worst_norm = max(worst_norm, float(
            torch.linalg.vector_norm(a[n] - b[n]) /
            max(float(torch.linalg.vector_norm(a[n])), 1e-30)))
    return worst, leaf, worst_norm


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
    from ..models import sharding
    from ..optim.optimizer import OptConfig
    dev = _device()
    mesh = make_test_mesh(shape, ("data", "model"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sharding.stats.reset()
    out = run_train(cfg, device=dev, mesh=mesh, log=lambda line: None,
                    **kwargs)
    steps = len(out["losses"])
    coll = sharding.stats.as_dict()
    ostate = out["opt_state"]
    by_specs = state_bytes_by_specs(out["model"], dict(zip(
        ("data", "model"), shape)), OptConfig())
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
        leaf_gathers={a: len(c) for a, c in coll["leaf_gathers"].items()})


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
