"""Sharding context for model code, the counterpart of the JAX package's
``models/sharding.py``, and the port's partition specs.

A :class:`P` is the counterpart of ``jax.sharding.PartitionSpec``: one
entry per tensor dimension, each ``None`` (replicated), a mesh dimension's
name, or a tuple of names (sharded over their product).  :func:`placements`
turns it into the DTensor placements of a ``DeviceMesh`` whose dimensions
carry those names, and :class:`NamedSharding` pairs the two, as JAX's
``NamedSharding`` does.

The launcher declares the mesh's batch axes once (``("data",)`` on one
host); :func:`bspec` then leads a spec with them, and :func:`constrain` /
:func:`constrain_batch` redistribute a DTensor to a spec, the counterpart
of ``with_sharding_constraint``.  When no axes are declared (one device,
the tests on the CPU) both are no-ops, and a plain tensor is always
returned as it is, so the same model code runs everywhere.

``mdl(width)`` is the reference's ``blocks._mdl``: a width is sharded over
``"model"`` when it divides by the production mesh's tensor-parallel
degree ``TP``, and replicated otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Tuple

TP = 16     # tensor-parallel degree of the production mesh ("model" axis)

_BATCH_AXES: Optional[Tuple[str, ...]] = None


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mdl(width: int) -> Optional[str]:
    """``"model"`` if ``width`` divides evenly across ``TP``, else
    ``None`` (replicated)."""
    return "model" if width % TP == 0 else None


def _names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def placements(mesh, spec: P) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh`` (one per mesh
    dimension): ``Shard(i)`` for the mesh dimension named in tensor
    dimension ``i``'s entry, ``Replicate()`` for one named nowhere.  A
    name the mesh does not have raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names or ()
    out: List[Any] = [Replicate() for _ in names]
    for i, part in enumerate(spec):
        for name in _names(part):
            if name not in names:
                raise ValueError(f"{spec}: the mesh has no dimension "
                                 f"{name!r} (it has {names})")
            out[names.index(name)] = Shard(i)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`P` over its dimension names."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> List[Any]:
        return placements(self.mesh, self.spec)


def set_batch_axes(axes: Optional[Tuple[str, ...]]) -> None:
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes) if axes is not None else None


def get_batch_axes() -> Optional[Tuple[str, ...]]:
    return _BATCH_AXES


@contextlib.contextmanager
def batch_axes(axes: Optional[Tuple[str, ...]]):
    global _BATCH_AXES
    prev = _BATCH_AXES
    _BATCH_AXES = tuple(axes) if axes is not None else None
    try:
        yield
    finally:
        _BATCH_AXES = prev


def bspec(*rest) -> P:
    """A spec with the batch axes leading: ``bspec(None, "model")`` ->
    ``P("data", None, "model")``.  Names the batch axes already take are
    dropped from the tail (the pure data-parallel mapping folds "model"
    into the batch).  ``P()`` when no axes are declared."""
    if _BATCH_AXES is None:
        return P()
    used = set(_BATCH_AXES)

    def clean(part):
        kept = tuple(a for a in _names(part) if a not in used)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    lead = _BATCH_AXES if len(_BATCH_AXES) > 1 else _BATCH_AXES[0]
    return P(lead, *[clean(r) for r in rest])


def constrain(x, spec: P):
    """``x`` redistributed to ``spec`` over its own mesh when batch axes
    are declared and ``x`` is a DTensor; ``x`` itself otherwise."""
    from torch.distributed.tensor import DTensor
    if _BATCH_AXES is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def constrain_batch(x, *rest):
    return constrain(x, bspec(*rest))
