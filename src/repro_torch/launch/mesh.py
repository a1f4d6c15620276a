"""Device meshes over the process group, the counterpart of the JAX
package's ``launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the ranks of the current group, one process per device
(``repro_torch.distributed.launch``):

* production, one pod: (16, 16) over ("data", "model"); two pods:
  (2, 16, 16) over ("pod", "data", "model");
* :func:`make_test_mesh`: a small mesh over the group's first ranks.

The functions build nothing at import; each needs an initialised process
group — except :func:`make_search_mesh`, the fleet's mesh, which is a
list of devices in this one process (``core.torch_cost.SearchMesh``): the
fleet shards its rows or tasks over devices from one host loop, as the
reference's ``shard_map`` does, and needs no process group.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

_BATCH_AXES_OVERRIDE: Optional[Tuple[str, ...]] = None


def _device_type() -> str:
    """The device type of this rank's devices: the launcher's (gloo may
    carry CUDA tensors), else the backend's (``nccl``: CUDA)."""
    import torch.distributed as dist

    from ..distributed import launch
    device = launch.rank_device_or_none()
    if device is not None:
        return device.type
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


def make_search_mesh(n_devices: Optional[int] = None, axis: str = "rows",
                     device=None):
    """1-D mesh for sharding search mega-batches and segment fleets
    (``torch_cost.eval_stacked`` shards batch rows, ``run_segments`` the
    task axis).  On CUDA (``device=None`` or a ``cuda`` device) it takes
    the first ``n_devices`` visible GPUs, every one by default, and
    raises ``RuntimeError`` naming both counts when fewer are visible;
    ``device="cpu"`` gives ``n_devices`` shards of the CPU (the tests'
    mesh).  Returns ``None`` for one device, so callers can pass the
    result straight to ``FleetConfig(mesh=...)`` and keep the unsharded
    path."""
    import torch
    from ..core.torch_cost import SearchMesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devices = [torch.device("cpu")] * n
    elif dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have or have == 0:
            raise RuntimeError(f"need {max(n, 1)} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"a search mesh runs on CUDA or the CPU, not "
                         f"{dev.type!r}")
    if n < 1:
        raise ValueError(f"a search mesh needs at least one device, got "
                         f"n_devices={n_devices}")
    if n == 1:
        return None
    return SearchMesh(tuple(devices), (axis,))


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
