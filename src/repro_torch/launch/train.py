"""End-to-end training driver, the counterpart of the JAX package's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mistral-nemo-12b --steps 200 --batch 8 --seq 256 \\
        [--smoke] [--ckpt-dir ckpt/] [--microbatches 2] [--device cpu] \\
        [--mesh 2x4]

Composes the deterministic, seekable synthetic data pipeline, the model
(every block under ``cfg.remat``), AdamW with its schedule and clipping,
checkpoint/restart through the crash-safe ``Supervisor``, and the
step-time straggler monitor.  The flags and printed lines are the
reference's, plus ``--device`` (default: the GPU, failing where there is
none); the default arch is the reference's, ``xlstm-350m``.  Every key of
a pipeline's batch goes to the device and into ``Model.loss_fn`` (an
encoder-decoder's ``enc_embeds`` too, a vision-language model's
``frontend``), whose total carries the MoE blocks' balance loss.

``--mesh DxM`` (``D`` alone means ``Dx1``) trains over a (data, model)
``DeviceMesh`` of D·M ranks, one process per device, which the CLI
starts itself (``distributed.launch.spawn``; a world of one runs in this
process): gloo on the CPU, NCCL on the GPUs, rank r on GPU r.  Each rank
builds only its shards over "model" and its slice of the experts'
hidden width over "data" (``Model(cfg, **steps.mesh_places(mesh))``) and
computes on them; the moments are ZeRO-1 slices over "data", the batch's
rows go over "data" (``steps.build_sharded_train_step``); rank 0 prints
the lines an un-meshed run prints.  Refused, with exit code 2 and
the reason on stderr, before anything is built: an arch with a block
kind the port does not have, a missing device, and a mesh of more ranks
than GPUs.

:func:`run_train` is the loop itself, for a caller that holds a
:class:`~repro_torch.models.config.ModelConfig` (a depth-reduced one, say),
and, with ``mesh=``, a process group.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"2x4"`` -> (2, 4), ``"2"`` -> (2, 1): the (data, model) shape."""
    try:
        dims = tuple(int(x) for x in text.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (1, 2) or min(dims) < 1:
        raise ValueError(f"--mesh {text!r}: want D or DxM, positive "
                         f"integers")
    return dims if len(dims) == 2 else (dims[0], 1)


def _copy_into(live: Any, restored: Any) -> Any:
    """Copy a restored state dict into the live tensors (the model's
    parameters, the optimizer's moments) and return the live state."""
    with torch.no_grad():
        if isinstance(live, dict):
            for k in live:
                _copy_into(live[k], restored[k])
        else:
            live.copy_(restored)
    return live


def run_train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
              device=None, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 50, microbatches: int = 1,
              log_every: int = 10, inject_failure_at: Optional[int] = None,
              log: Callable[[str], None] = print,
              mesh=None) -> Dict[str, Any]:
    """Train ``cfg`` from weights drawn with seed 0 on ``device`` for
    ``steps`` steps of ``batch`` x ``seq`` synthetic tokens; with a
    ``mesh`` (a ("data", "model") ``DeviceMesh`` over the process group,
    every rank calling), by ``steps.build_sharded_train_step``; the
    moments in ``optimizer.moment_dtype_for(cfg)``.

    Returns ``losses`` (one per step run, replayed steps included),
    ``step_s`` (host seconds of each, ended by reading its loss), the
    supervisor's ``report`` (with ``ckpt_dir``), and the live ``model``,
    ``opt_state``, ``train_step`` and ``data``."""
    from ..checkpoint import checkpoint as ckpt_lib
    from ..configs.shapes import ShapeSpec
    from ..data.pipeline import make_data
    from ..device import resolve_device
    from ..models.model import Model
    from ..optim import optimizer as opt
    from ..runtime.fault_tolerance import StepMonitor, Supervisor
    from .steps import (build_sharded_train_step, build_train_step,
                        mesh_places)

    device = resolve_device(device)
    shape = ShapeSpec("cli", seq, batch, "train")
    data = make_data(cfg, shape)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                         total_steps=steps,
                         moment_dtype=opt.moment_dtype_for(cfg))
    places = {} if mesh is None else mesh_places(mesh)  # only its shards
    model = Model(cfg, device=device, **places,
                  generator=torch.Generator(device=device).manual_seed(0))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    ostate = opt.init(params, ocfg)
    if mesh is None:
        train_step = build_train_step(model, ocfg, ostate,
                                      n_microbatches=microbatches)
    else:
        train_step = build_sharded_train_step(model, ocfg, ostate, mesh,
                                              n_microbatches=microbatches)
        params = train_step.master          # the sharded copies
    state = dict(params=params, step=ostate.step, mu=ostate.mu,
                 nu=ostate.nu)
    monitor = StepMonitor()
    t_start = time.time()
    losses, step_s = [], []
    crashed = []

    def one_step(state, step):
        if inject_failure_at is not None and step == inject_failure_at \
                and not crashed:
            crashed.append(step)
            raise RuntimeError("injected failure")
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(step).items()}
        metrics = train_step(b)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t_start
            log(f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:6.1f}s)")
        return state

    report = None
    if ckpt_dir:
        sup = Supervisor(ckpt_dir, ckpt_every=ckpt_every)
        state, report = sup.run(
            state, one_step, steps,
            restore_fn=lambda s, st: _copy_into(
                st, ckpt_lib.restore(ckpt_dir, s, st)))
        log(f"supervisor report: {json.dumps(report)}")
    else:
        for s in range(steps):
            t0 = time.time()
            state = one_step(state, s)
            monitor.observe(s, time.time() - t0)

    if len(losses) >= 20:
        first = np.mean(losses[:10])
        last = np.mean(losses[-10:])
        log(f"loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    return dict(losses=losses, step_s=step_s, report=report, model=model,
                opt_state=ostate, train_step=train_step, data=data)


def _train_rank(cfg, shape: Tuple[int, int], kwargs: Dict[str, Any]):
    """One rank of a meshed run (inside its process group): returns the
    losses; rank 0 logs."""
    import torch.distributed as dist

    from ..distributed.launch import rank_device
    from .mesh import make_test_mesh
    rank = dist.get_rank()
    device = rank_device()
    mesh = make_test_mesh(shape, ("data", "model"))
    log = (lambda line: print(line, flush=True)) if rank == 0 else \
        (lambda line: None)
    return run_train(cfg, device=device, mesh=mesh, log=log,
                     **kwargs)["losses"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="End-to-end training driver on synthetic data.")
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) mesh of D*M ranks, one "
                         "process per device (D alone: Dx1)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="testing: raise at this step once")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the GPU; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_config
    from ..device import resolve_device
    from ..models.model import unported

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    reason = unported(cfg)
    if reason:
        print(f"train: {reason}", file=sys.stderr)
        return 2
    try:
        shape = parse_mesh(args.mesh) if args.mesh else None
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    kwargs = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, microbatches=args.microbatches,
                  log_every=args.log_every,
                  inject_failure_at=args.inject_failure_at)
    if shape is None:
        run_train(cfg, device=device,
                  log=lambda line: print(line, flush=True), **kwargs)
        return 0
    from ..distributed.launch import process_group, spawn
    from .train import _train_rank     # by its module's name, not __main__
    world = shape[0] * shape[1]
    if device.type == "cuda" and torch.cuda.device_count() < world:
        print(f"train: --mesh {args.mesh} needs {world} GPUs, one process "
              f"each; {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if world == 1:
        with process_group(device.type):
            _train_rank(cfg, shape, kwargs)
    else:
        spawn(_train_rank, world, (cfg, shape, kwargs),
              device_type=device.type, timeout=24 * 3600.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
