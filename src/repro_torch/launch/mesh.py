"""Device meshes over the process group, the counterpart of the JAX
package's ``launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the ranks of the current group, one process per device
(``repro_torch.distributed.launch``):

* production, one pod: (16, 16) over ("data", "model"); two pods:
  (2, 16, 16) over ("pod", "data", "model");
* :func:`make_test_mesh`: a small mesh over the group's first ranks.

The functions build nothing at import; each needs an initialised process
group.  The reference's ``make_search_mesh`` (the fleet's row sharding)
is not here: the fleet side of multi-device waits for its own slice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

_BATCH_AXES_OVERRIDE: Optional[Tuple[str, ...]] = None


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the group's first 256 (512) ranks; fewer
    ranks raise ``RuntimeError`` naming the count."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — start one "
            f"process per device "
            f"(repro_torch.distributed.launch.spawn(..., world={n}))")
    return _mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")):
    """A small mesh over the group's first ``prod(shape)`` ranks (every
    rank of the group must call it; the others get no coordinate)."""
    import torch.distributed as dist
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return _mesh(tuple(shape), tuple(axes))


def set_batch_axes_override(axes: Optional[Tuple[str, ...]]) -> None:
    """Perf variant hook: e.g. ("data", "model") = pure data parallelism
    over the whole mesh (TP disabled) for small models."""
    global _BATCH_AXES_OVERRIDE
    _BATCH_AXES_OVERRIDE = tuple(axes) if axes else None


def batch_axes_of(mesh) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    if _BATCH_AXES_OVERRIDE is not None:
        return tuple(a for a in _BATCH_AXES_OVERRIDE if a in names)
    return tuple(a for a in names if a in ("pod", "data"))
