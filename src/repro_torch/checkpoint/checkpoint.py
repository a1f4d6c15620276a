"""Fault-tolerant checkpointing: per-leaf ``.npy`` files, atomic commit.

Layout (the JAX package's, byte for byte, so a checkpoint written by
either package restores in the other):

    <dir>/step_00000123.tmp-<nonce>/   (staging)
        meta.json                      (step, leaf paths, shapes, dtypes)
        leaf_00000.npy ...
    <dir>/step_00000123/               (atomic rename = commit)

A tree checkpoint (:func:`save` / :func:`restore`) holds a torch state
dict — a nested dict (or list / tuple) of tensors — flattened to the
reference's path strings (``['a']/['b']``, ``[0]`` for a sequence index;
dict keys sorted, ``None`` holds no leaf).  bf16 and fp8 leaves are stored
as their raw bits (``uint16`` / ``uint8``) with the dtype's name in
``meta["dtypes"]``.  Restore is shape-checked against the target and puts
every leaf on the device and dtype of the target's tensor.  Every leaf is
stored whole: a DTensor leaf (a tensor sharded over a ``DeviceMesh``) is
gathered by every rank of its mesh, and rank 0 of the group writes.
``restore(..., shardings=)`` places each leaf by a
:class:`~repro_torch.models.sharding.NamedSharding` (a mesh and a spec),
the counterpart of the reference's ``shardings=``: restoring onto a
different mesh than the one that saved (an elastic shrink) is exactly
this path.  A DTensor target with no sharding given is placed as the
target is.

A flat checkpoint (:func:`save_flat` / :func:`load_flat`) is a
``{key: np.ndarray}`` dict restorable without a target; the sweep server
stores fleet state in it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: dtypes numpy cannot hold: stored as raw bits, as (the torch dtype to
#: view the tensor as, the numpy dtype of those bits, the unsigned dtype
#: written to disk)
_RAW_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
             torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
             torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _RAW_BITS}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> Tuple[List[str], List[Any]]:
    """Leaves of a nested dict / list / tuple in the reference's order and
    path strings (``jax.tree_util.tree_flatten_with_path``)."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths: List[str] = []
    leaves: List[Any] = []
    for key, sub in items:
        p, lv = _flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                    else key)
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """Rebuild ``tree``'s structure from its leaves in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}         # the target's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _dtensor_class():
    from torch.distributed.tensor import DTensor
    return DTensor


def _as_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's host array as stored on disk, and its dtype's name (a
    DTensor is gathered whole first: every rank of its mesh calls)."""
    if isinstance(leaf, _dtensor_class()):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _RAW_BITS:
            bits, _, on_disk = _RAW_BITS[t.dtype]
            return t.view(bits).numpy().view(on_disk), _dtype_name(t.dtype)
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _commit(directory: str, step: int, arrays: List[np.ndarray],
            meta: Dict, keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    staging = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-",
                               dir=directory)
    for i, arr in enumerate(arrays):
        np.save(os.path.join(staging, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(staging, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.rename(staging, final)           # atomic commit
    _prune(directory, keep_last)
    return final


def save(directory: str, step: int, tree: Any, keep_last: int = 3) -> str:
    """Write a state dict's checkpoint atomically; prune old ones; return
    its path.  With DTensor leaves every rank of the group calls it, and
    it returns once rank 0 has committed."""
    paths, leaves = _flatten_with_paths(tree)
    sharded = any(isinstance(leaf, _dtensor_class()) for leaf in leaves)
    stored = [_as_numpy(leaf) for leaf in leaves]
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return os.path.join(directory, f"step_{step:08d}")
    meta = {"step": step, "paths": paths,
            "shapes": [list(a.shape) for a, _ in stored],
            "dtypes": [name for _, name in stored],
            "time": time.time()}
    final = _commit(directory, step, [a for a, _ in stored], meta, keep_last)
    if sharded:
        dist.barrier()
    return final


def _prune(directory: str, keep_last: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and ".tmp-" not in d)
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # remove stale staging dirs (crashed writers)
    for d in os.listdir(directory):
        if ".tmp-" in d:
            full = os.path.join(directory, d)
            if time.time() - os.path.getmtime(full) > 3600:
                shutil.rmtree(full, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".tmp-" not in d]
    return max(steps) if steps else None


def save_flat(directory: str, step: int, arrays: dict,
              extra_meta: Optional[dict] = None,
              keep_last: int = 3) -> str:
    """Write a flat ``{key: np.ndarray}`` checkpoint — same staging-dir +
    atomic-rename + prune machinery as :func:`save`, but restorable
    WITHOUT a target (:func:`load_flat`).  The sweep server uses this:
    fleet state (populations, rng blobs, histories) changes shape across
    rounds and restarts.  ``extra_meta`` lands in ``meta.json`` under
    ``"extra"`` (JSON-able values only)."""
    keys = sorted(arrays)
    meta = {"step": step, "flat": True, "keys": keys,
            "extra": extra_meta or {}, "time": time.time()}
    return _commit(directory, step, [np.asarray(arrays[k]) for k in keys],
                   meta, keep_last)


def load_flat(directory: str, step: int) -> tuple:
    """Read a :func:`save_flat` checkpoint: ``(arrays, extra_meta)``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if not meta.get("flat"):
        raise ValueError(f"{path} is a tree checkpoint; use restore()")
    arrays = {k: np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
              for i, k in enumerate(meta["keys"])}
    return arrays, meta.get("extra", {})


def _to_tensor(arr: np.ndarray, saved_dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its saved dtype (raw bits viewed
    back as bf16 / fp8)."""
    if arr.dtype.kind == "u" and saved_dtype in _BY_NAME:
        dtype = _BY_NAME[saved_dtype]
        return torch.from_numpy(arr.view(_RAW_BITS[dtype][1])).view(dtype)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, target_tree: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``target_tree`` (a state dict): each
    leaf is looked up by path (a missing one raises ``KeyError``), checked
    against the target's shape (a mismatch raises ``ValueError``) and put
    on the target tensor's device and dtype.  ``shardings``, a tree shaped
    like the target with :class:`~repro_torch.models.sharding.
    NamedSharding` leaves, places each leaf on its mesh as a DTensor
    (every rank reads the file; a rank outside the mesh gets an empty
    shard)."""
    from ..models.sharding import NamedSharding
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    t_paths, t_leaves = _flatten_with_paths(target_tree)
    if shardings is None:
        sh_leaves = [None] * len(t_leaves)
    else:
        _, sh_leaves = _flatten_with_paths(shardings)
        if len(sh_leaves) != len(t_leaves):
            raise ValueError(f"shardings hold {len(sh_leaves)} leaves, the "
                             f"target {len(t_leaves)}")
    dtensor = _dtensor_class()
    by_path = {p: i for i, p in enumerate(meta["paths"])}
    out_leaves = []
    for tp, tl, sh in zip(t_paths, t_leaves, sh_leaves):
        if tp not in by_path:
            raise KeyError(f"checkpoint missing leaf {tp}")
        i = by_path[tp]
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        want = tuple(tl.shape) if isinstance(tl, torch.Tensor) \
            else tuple(np.shape(tl))
        if tuple(arr.shape) != want:
            raise ValueError(f"{tp}: checkpoint shape {arr.shape} != "
                             f"target {want}")
        t = _to_tensor(arr, meta["dtypes"][i])
        if sh is None and isinstance(tl, dtensor):
            sh = (tl.device_mesh, tl.placements)
        elif isinstance(sh, NamedSharding):
            sh = (sh.mesh, sh.placements)
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor
            mesh, places = sh
            t = t.to(device=mesh.device_type, dtype=tl.dtype)
            t = distribute_tensor(t, mesh, places, src_data_rank=None)
        elif isinstance(tl, torch.Tensor):
            t = t.to(device=tl.device, dtype=tl.dtype)
        else:
            t = t.to(dtype=torch.from_numpy(np.asarray(tl)).dtype)
        out_leaves.append(t)
    return _unflatten_like(target_tree, out_leaves)
