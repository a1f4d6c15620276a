"""Sharding context for model code, the counterpart of the JAX package's
``models/sharding.py``, the port's partition specs, and the collectives of
its tensor- and data-parallel compute.

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
degree ``TP``, and replicated otherwise.  :func:`pure_data_parallel`
turns on the pure data-parallel mapping of a small model (the
reference's ``blocks.set_tp_enabled(False)`` together with its batch axes
over ("data", "model")): ``mdl`` replicates every width and the batch's
rows go over every mesh dimension (:func:`row_axis_names`).

**Where the reference's GSPMD shards compute, the port shards it by hand**
(Megatron tensor parallelism).  A model built with ``Model(cfg,
tp=(rank, m))`` holds only its shard of each leaf whose spec names
"model" (:func:`keep_shard`, under :func:`build_shards`), and computes on
the rank's share of every block's heads (``blocks.heads_split``, an
uneven split where GSPMD pads: attention, Mamba-2, the mLSTM and sLSTM;
the mLSTM's ranks that share a head split its value channels,
``blocks.value_split``; at decode the sLSTM's ranks split every head's
output channels, as GSPMD splits its ``r``, ``blocks.slstm_split``)
and of the MLP's hidden units: column-parallel products into them, each
row-parallel product out of them followed by one
:func:`reduce_from_model`, experts parallel over "model", the vocabulary
sharded at both ends.  Where a stored slice is not the part the rank's
heads read, each use exchanges, by ``blocks.heads_form``'s byte count,
the leaf (gathered whole and cut) or the product of the stored slice
(gathered and cut), both by :func:`gather_from_model` with
``partial_grad``.
:func:`parallel` declares, for the duration of a step, the "model" and
"data" :class:`Axis` (a process group, its size and this rank's index in
it) that the model's collectives run over, and the "width" axis that the
experts' hidden width is split over (the mesh's "data" dimension alone,
where the rows go over "pod" too; ``Model(cfg, dp=(rank, D))`` keeps the
rank's slice of it, :func:`build_shards`):

* :func:`copy_to_model`: identity forward, all-reduce backward (the input
  of a column-parallel product);
* :func:`reduce_from_model`: all-reduce forward, identity backward (the
  output of a row-parallel product);
* :func:`gather_from_model`: all-gather forward, the rank's own slice
  backward (the router's logits), or a reduce-scatter where each rank's
  gradient is partial (a leaf whose slice is not the rank's part, or
  its product);
* :func:`sum_over_data`: all-reduce forward and backward (the
  mixture-of-experts' batch statistics, whose gradient every data rank's
  loss carries);
* :func:`gather_over_width` / :func:`scatter_over_width`: all-gather
  forward and reduce-scatter backward, and the converse (the expert
  inputs every width rank's slice of the experts needs, and those
  slices' partial outputs summed back to the rank that owns each row;
  or the slices themselves, gathered whole);
  :func:`copy_to_width` / :func:`reduce_from_width` where every width
  rank holds the same rows;
* :func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`: the
  plain collectives of the train step.

With no axis declared (or an axis of one rank) each is the identity, so
the same model code runs on one device, on the CPU and in the tests.
Every one of them adds the bytes of its operand to :data:`stats`, by
kind, and a leaf gathered whole over an axis is counted there by name.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

TP = 16     # tensor-parallel degree of the production mesh ("model" axis)
_PURE_DP = False

_BATCH_AXES: Optional[Tuple[str, ...]] = None


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@contextlib.contextmanager
def pure_data_parallel():
    """The pure data-parallel mapping of a small model, for the duration
    of the block: the specs name no "model" (:func:`mdl` replicates every
    width) and the batch's rows go over every mesh dimension
    (:func:`row_axis_names`); the mapping before the block is restored
    however it ends."""
    global _PURE_DP
    was, _PURE_DP = _PURE_DP, True
    try:
        yield
    finally:
        _PURE_DP = was


def mdl(width: int) -> Optional[str]:
    """``"model"`` if ``width`` divides evenly across ``TP``, else
    ``None`` (replicated); always ``None`` under
    :func:`pure_data_parallel`."""
    if _PURE_DP:
        return None
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


# ------------------------------------------------------ parallel compute


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dimension a rank computes over: its process group, its
    size, the rank's index along it and its name (under which
    :data:`stats` counts its bytes).  ``stride``, for the width axis: how
    far apart along the rows axis its consecutive members are (1 where
    the rows go over ("pod", "data"), the "model" size where they go over
    ("data", "model"))."""
    group: Any
    size: int
    rank: int
    name: str = ""
    stride: int = 1


def mesh_axis(mesh, name: str) -> Axis:
    """The :class:`Axis` of ``mesh``'s dimension ``name`` on this rank."""
    dim = mesh.mesh_dim_names.index(name)
    return Axis(mesh.get_group(name), mesh.shape[dim],
                mesh.get_local_rank(name), name)


def row_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh dimensions the batch's rows go over, in mesh order:
    ("pod", "data") where the mesh has "pod", ("data",) otherwise, and
    every dimension under :func:`pure_data_parallel`."""
    names = tuple(mesh.mesh_dim_names or ())
    return names if _PURE_DP else tuple(a for a in names
                                         if a in ("pod", "data"))


def rows_axis(mesh) -> Axis:
    """The :class:`Axis` the batch's rows go over on ``mesh``: "data", or
    the dimensions of :func:`row_axis_names` flattened in mesh order
    ("pod_data", pod-major; "data_model", data-major)."""
    axes = row_axis_names(mesh)
    if len(axes) == 1:
        return mesh_axis(mesh, axes[0])
    name = "_".join(axes)
    flat = mesh[axes]._flatten(name)
    return Axis(flat.get_group(), flat.size(), flat.get_local_rank(), name)


def width_axis_of(mesh) -> Axis:
    """The :class:`Axis` the experts' hidden width goes over on ``mesh``:
    its "data" dimension alone, with its members' ``stride`` along
    :func:`rows_axis`."""
    axes = row_axis_names(mesh)
    stride = 1
    for a in axes[axes.index("data") + 1:]:
        stride *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return dataclasses.replace(mesh_axis(mesh, "data"), stride=stride)


_MODEL: Optional[Axis] = None
_DATA: Optional[Axis] = None
_WIDTH: Optional[Axis] = None
_BUILD: Optional[Tuple[int, int, int, int]] = None


@contextlib.contextmanager
def parallel(model: Optional[Axis] = None, data: Optional[Axis] = None,
             width: Optional[Axis] = None):
    """Declare the "model" axis, the rows' "data" axis and the experts'
    width axis the model's collectives run over, for the block."""
    global _MODEL, _DATA, _WIDTH
    prev = _MODEL, _DATA, _WIDTH
    _MODEL, _DATA, _WIDTH = model, data, width
    try:
        yield
    finally:
        _MODEL, _DATA, _WIDTH = prev


def model_axis() -> Optional[Axis]:
    return _MODEL


def data_axis() -> Optional[Axis]:
    """The declared "data" axis, ``None`` without one or at one rank."""
    return _DATA if _DATA is not None and _DATA.size > 1 else None


def width_axis() -> Optional[Axis]:
    """The declared width axis, ``None`` without one or at one rank."""
    return _WIDTH if _live(_WIDTH) else None


def model_size() -> int:
    return 1 if _MODEL is None else _MODEL.size


def model_rank() -> int:
    return 0 if _MODEL is None else _MODEL.rank


# ------------------------------------------------------ building on shards


@contextlib.contextmanager
def build_shards(rank: int, size: int, width: Tuple[int, int] = (0, 1)):
    """Within the block, :func:`keep_shard` keeps rank ``rank``'s slice
    of ``size`` along each leaf's "model" dimension, and the experts keep
    the slice ``width = (rank, D)`` of their hidden width
    (:func:`build_width`)."""
    global _BUILD
    for r, n, what in ((rank, size, "tp"), (*width, "dp")):
        if not 0 <= r < n:
            raise ValueError(f"{what} rank {r} is outside a group of {n}")
    prev, _BUILD = _BUILD, (rank, size, *width)
    try:
        yield
    finally:
        _BUILD = prev


def build_size() -> int:
    """The "model" size the model being built is sharded for (1: whole)."""
    return 1 if _BUILD is None else _BUILD[1]


def build_rank() -> int:
    """The rank whose shards the model being built keeps."""
    return 0 if _BUILD is None else _BUILD[0]


def build_width() -> Tuple[int, int]:
    """``(rank, D)``: the slice of the experts' hidden width the model
    being built keeps (``(0, 1)``: whole)."""
    return (0, 1) if _BUILD is None else _BUILD[2:]


def model_dim(spec: Optional[P]) -> Optional[int]:
    """The tensor dimension ``spec`` shards over "model", or ``None``."""
    for i, part in enumerate(spec or ()):
        if "model" in _names(part):
            return i
    return None


def data_dim(spec: Optional[P]) -> Optional[int]:
    """The tensor dimension ``spec`` shards over "data", or ``None``."""
    for i, part in enumerate(spec or ()):
        if "data" in _names(part):
            return i
    return None


def shard_of(t: torch.Tensor, dim: int, rank: int, size: int
             ) -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of ``size`` along ``dim`` (which
    must divide evenly), as a view."""
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {size} ranks")
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def keep_shard(t: torch.Tensor, spec: Optional[P]) -> torch.Tensor:
    """``t`` itself, or, under :func:`build_shards` and where ``spec``
    names "model", a copy of the rank's slice (the whole ``t`` is then
    freed by its caller)."""
    dim = model_dim(spec)
    if _BUILD is None or dim is None or _BUILD[1] == 1:
        return t
    return shard_of(t, dim, *_BUILD[:2]).clone()


# ------------------------------------------------------ collectives


class CollectiveStats:
    """Bytes of the collectives' operands and their calls, by kind, and
    the leaves gathered whole, by axis and name."""

    KINDS = ("all-reduce", "all-gather", "reduce-scatter")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, int] = {k: 0 for k in self.KINDS}
        self.calls: Dict[str, int] = {k: 0 for k in self.KINDS}
        self.by_axis: Dict[str, int] = collections.Counter()
        self.leaf_gathers: Dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)

    def add(self, kind: str, t: torch.Tensor, axis: "Axis") -> None:
        n = t.numel() * t.element_size()
        self.bytes[kind] += n
        self.calls[kind] += 1
        self.by_axis[axis.name] += n

    def as_dict(self) -> Dict[str, Any]:
        return dict(bytes=dict(self.bytes), calls=dict(self.calls),
                    by_axis=dict(self.by_axis),
                    leaf_gathers={a: dict(c) for a, c in
                                  self.leaf_gathers.items()})


stats = CollectiveStats()


def _live(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def all_reduce(x: torch.Tensor, axis: Optional[Axis], op: str = "sum"
               ) -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over ``axis``, in
    place where it is contiguous (a new tensor otherwise); ``x`` itself
    with no live axis."""
    if not _live(axis):
        return x
    import torch.distributed as dist
    x = x.contiguous()
    stats.add("all-reduce", x, axis)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else
                    dist.ReduceOp.SUM, group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int = 0,
               leaf: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    rank order; ``leaf`` names a weight gathered whole (counted in
    :data:`stats` under the axis's name)."""
    if not _live(axis):
        return x
    import torch.distributed as dist
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    stats.add("all-gather", src, axis)
    if leaf is not None:
        stats.leaf_gathers[axis.name][leaf] += 1
    dist.all_gather_into_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axis: Optional[Axis], dim: int = 0
                   ) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over
    ``axis``."""
    if not _live(axis):
        return x
    import torch.distributed as dist
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // axis.size,) +
                        tuple(src.shape[1:]))
    stats.add("reduce-scatter", src, axis)
    dist.reduce_scatter_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, leaf):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim, leaf)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, leaf, partial_grad):
        ctx.dim, ctx.partial_grad = dim, partial_grad
        return all_gather(x, _MODEL, dim, leaf)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial_grad:
            g = reduce_scatter(g, _MODEL, ctx.dim)
        else:
            g = shard_of(g, ctx.dim, _MODEL.rank, _MODEL.size)
        return g, None, None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.clone(), _DATA)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), _DATA)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over "model" backward."""
    return _Copy.apply(x, _MODEL) if _live(_MODEL) else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over "model" forward, identity backward."""
    return _Reduce.apply(x, _MODEL) if _live(_MODEL) else x


def gather_from_model(x: torch.Tensor, dim: int,
                      leaf: Optional[str] = None,
                      partial_grad: bool = False) -> torch.Tensor:
    """All-gather over "model" along ``dim`` forward; backward, this
    rank's slice of the gradient, which every rank of the group holds
    whole, or with ``partial_grad`` of the sum of the ranks' partial
    gradients (a reduce-scatter); ``leaf`` names a weight gathered
    whole."""
    return _GatherFromModel.apply(x, dim, leaf, partial_grad) \
        if _live(_MODEL) else x


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over "data" forward and backward."""
    return _SumOverData.apply(x) if _live(_DATA) else x


def gather_over_width(x: torch.Tensor, dim: int = 0,
                      leaf: Optional[str] = None) -> torch.Tensor:
    """Every width rank's ``x`` concatenated along ``dim`` in rank order
    (all-gather forward); backward, this rank's slice of the sum of the
    ranks' gradients (reduce-scatter); ``leaf`` names a weight gathered
    whole."""
    return _Gather.apply(x, _WIDTH, dim, leaf) if _live(_WIDTH) else x


def scatter_over_width(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of the width ranks'
    ``x`` (reduce-scatter forward); backward, every rank's gradient
    concatenated (all-gather)."""
    return _Scatter.apply(x, _WIDTH, dim) if _live(_WIDTH) else x


def copy_to_width(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over the width axis backward."""
    return _Copy.apply(x, _WIDTH) if _live(_WIDTH) else x


def reduce_from_width(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over the width axis forward, identity backward."""
    return _Reduce.apply(x, _WIDTH) if _live(_WIDTH) else x
