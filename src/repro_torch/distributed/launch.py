"""One process per device, joined in one ``torch.distributed`` group.

:func:`spawn` starts ``world`` fresh processes (the ``spawn`` start
method), joins them in a process group whose rendezvous is a
``FileStore`` in a directory (no TCP port to collide on), runs ``fn(*args)``
on each and returns every rank's result.  The backend follows the device:
gloo on the CPU, NCCL on CUDA (rank r on GPU r).  ``backend="gloo"`` on
CUDA lets several ranks share a card (rank r on GPU r modulo the count):
NCCL refuses two ranks on one GPU ("Duplicate GPU detected"), while gloo
carries every collective of the train step on CUDA tensors, through the
host.  :func:`rank_device` is the device the launcher gave this rank.  A rank that raises, or a
run that outlasts ``timeout`` seconds, ends every rank and raises here,
with the failing rank's traceback: no fallback to another backend or
device hides it.

:func:`process_group` is the same group in the calling process, for a
world of one (the one-card case runs the multi-device path without
starting a process).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}

_RANK_DEVICE = None


def rank_device():
    """The device :func:`spawn` / :func:`process_group` gave this rank."""
    if _RANK_DEVICE is None:
        raise RuntimeError("no rank was started here (spawn / "
                           "process_group)")
    return _RANK_DEVICE


def rank_device_or_none():
    """:func:`rank_device`, or None where no rank was started here."""
    return _RANK_DEVICE


def _init(rank: int, world: int, store_file: str, device_type: str,
          timeout: float, backend: Optional[str] = None) -> None:
    import torch
    import torch.distributed as dist
    global _RANK_DEVICE
    if device_type not in BACKENDS:
        raise ValueError(f"no process-group backend for {device_type!r}")
    backend = backend or BACKENDS[device_type]
    if device_type == "cpu" and world > 1:  # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _RANK_DEVICE = torch.device("cpu")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if backend == "nccl" and have <= rank:
            raise RuntimeError(f"rank {rank} of {world} needs GPU {rank}; "
                               f"{have} visible")
        if have == 0:
            raise RuntimeError(f"rank {rank} of {world} needs a GPU; none "
                               f"visible")
        torch.cuda.set_device(rank % have)
        _RANK_DEVICE = torch.device("cuda", rank % have)
    dist.init_process_group(
        backend, store=dist.FileStore(store_file, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))


@contextlib.contextmanager
def process_group(device_type: str = "cpu",
                  store_dir: Optional[str] = None):
    """A process group of one (this process, rank 0) for the block."""
    import torch.distributed as dist
    global _RANK_DEVICE
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        _init(0, 1, os.path.join(d, "store"), device_type, 300.0)
        try:
            yield
        finally:
            dist.destroy_process_group()
            _RANK_DEVICE = None


def _rank_main(rank: int, world: int, store_file: str, device_type: str,
               timeout: float, backend: Optional[str], fn: Callable,
               args: Sequence[Any], results) -> None:
    import torch.distributed as dist
    try:
        _init(rank, world, store_file, device_type, timeout, backend)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *,
          device_type: str = "cpu", timeout: float = 300.0,
          store_dir: Optional[str] = None,
          backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, one process each, and return
    their results in rank order (``backend``: the device's by default,
    ``"gloo"`` to share CUDA cards).  ``fn`` and ``args`` must pickle (a
    module-level function).  Raises ``RuntimeError`` naming the first
    rank that failed, ``TimeoutError`` past ``timeout`` seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        store_file = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store_file, device_type,
                                   timeout, backend, fn, tuple(args),
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got = {}
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world - len(got)} of {world} ranks did not "
                        f"finish within {timeout:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_lib.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in got]
                    if dead:
                        # give its report a moment to arrive
                        try:
                            rank, ok, out = results.get(timeout=5.0)
                        except queue_lib.Empty:
                            raise RuntimeError(
                                f"rank {dead[0]} of {world} died with "
                                f"exit code {procs[dead[0]].exitcode}"
                            ) from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]
