"""Per-tensor statistical density models (the DensityModel hierarchy).

The seed's byte accounting and S/G intersection math assumed *uniform
random* nonzeros — one scalar density per tensor.  Real Table III
operands are anything but uniform: sparseGPT weights are N:M
block-pruned, windowed-attention scores are banded, pruned-VGG
activations are spatially clustered.  Following Sparseloop's statistical
density models and TeAAL's per-tensor occupancy specs, density is a
per-tensor *model*, not a scalar: anywhere a ``TensorSpec`` used to
carry ``density: float`` it now carries a :class:`DensityModel` (floats
are still accepted everywhere and mean :class:`Uniform`).

A model supplies three quantities the sparse stack consumes:

* ``density`` — the mean fraction of nonzero elements.  Prices data
  bytes (``sparse.fiber_tree_bytes``) and the dense->effectual MAC
  scaling.
* ``block_nonempty(e)`` — the probability that an (aligned) block of
  ``e`` elements contains at least one nonzero.  This is the fiber-fill
  distribution driving the format byte model: the expected number of
  kept coordinates of a fiber of length ``L`` whose positions each
  cover ``e`` elements is ``L * block_nonempty(e)``.
* ``hit_rate()`` — the expected fraction of a follower tensor's
  accesses that survive an element-granularity leader/follower
  intersection when this model's tensor leads a gate/skip mechanism
  (``cost_model.evaluate``).  For every built-in model this equals the
  mean density (element-level intersections see the mean); correlated
  custom models may override it.

Built-ins:

* :class:`Uniform` — i.i.d. Bernoulli nonzeros, the seed semantics.
  ``block_nonempty(e) = 1 - (1 - d)**e``, bit-identical to the
  pre-model code (pinned by the goldens).
* :class:`Banded` — a two-phase clustered model for diagonal / windowed
  operands: a fraction ``bandwidth`` of each tensor block lies inside
  the band (where nonzeros are uniform at density ``d / bandwidth``);
  the rest is exactly empty.  ``block_nonempty(e) =
  bandwidth * (1 - (1 - d/bandwidth)**e)`` — large out-of-band blocks
  are certainly empty, which is what makes RLE/CP-style formats (and
  coarse skipping) win on banded operands.
* :class:`BlockNM` — fixed-structured N:M pruning (e.g. sparseGPT 2:4):
  every aligned block of ``m`` elements keeps exactly ``n`` nonzeros,
  uniformly placed within the block.  ``block_nonempty(e)`` is the
  hypergeometric miss probability ``1 - C(m-n, e) / C(m, e)`` for
  ``e <= m - n`` and exactly 1 beyond (any window wider than the zero
  budget must hit a nonzero) — evaluated via log-gamma so the device
  kernel's float tile extents use the same formula.  Elements of a
  block are modeled as drawn from a single aligned m-block (the
  conservative case; windows straddling blocks hit at least as often).

Structural-vs-traced contract (mirrors ``ArchSpec.word_bytes``): the
density-model *mode* is structural in the evaluator signature —
all-:class:`Uniform` workloads compile the literal pre-model kernel
(bit-identical to the goldens), while any structured operand selects the
structured kernel variant, in which the per-tensor family code and its
numeric parameters (``params()``) are *traced*.  A whole family of N:M
workloads — or a mixed uniform/banded/N:M fleet — therefore shares ONE
evaluator signature.  Custom models must register here (numpy side,
:func:`register_density_model`) and in ``torch_cost``
(``register_density_occ``) — see COMPAT.md "Defining a custom
DensityModel".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Type, Union

#: anything that describes a tensor's nonzero statistics: a plain float
#: (mean density, meaning Uniform) or a DensityModel
DensityLike = Union[float, "DensityModel"]

#: traced per-tensor parameter row width: [family code, hit rate,
#: family params...] padded to the widest registered family
_N_FAMILY_PARAMS = 2


@dataclasses.dataclass(frozen=True)
class DensityModel:
    """Base class: one tensor's nonzero statistics.  Frozen/hashable so
    it can live inside ``TensorSpec`` and key evaluator caches."""

    #: family tag; structural on the device side (selects the occupancy
    #: formula), unique per registered subclass
    family = "abstract"

    @property
    def density(self) -> float:
        """Mean fraction of nonzero elements, in (0, 1]."""
        raise NotImplementedError

    def block_nonempty(self, elems) -> float:
        """P(an aligned block of ``elems`` elements holds a nonzero)."""
        raise NotImplementedError

    def hit_rate(self) -> float:
        """Expected fraction of follower accesses surviving an
        element-granularity intersection led by this tensor."""
        return self.density

    def params(self) -> Tuple[float, ...]:
        """Numeric family parameters, traced by the device evaluator (at most
        ``param_width() - 2`` values; the row is zero-padded)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Uniform(DensityModel):
    """i.i.d. uniform-random nonzeros at mean density ``d`` — the seed
    semantics, bit-identical to the pre-model byte accounting."""

    d: float
    family = "uniform"

    def __post_init__(self):
        if not 0.0 < self.d <= 1.0:
            raise ValueError(f"Uniform density must be in (0, 1], "
                             f"got {self.d}")

    @property
    def density(self) -> float:
        return self.d

    def block_nonempty(self, elems) -> float:
        return 1.0 - (1.0 - self.d) ** elems

    def params(self) -> Tuple[float, ...]:
        return (self.d,)


@dataclasses.dataclass(frozen=True)
class Banded(DensityModel):
    """Band/window-clustered nonzeros: fraction ``bandwidth`` of every
    block lies inside the band, where nonzeros are uniform at density
    ``d / bandwidth``; outside the band the tensor is exactly zero.
    Mean density is ``d``."""

    d: float
    bandwidth: float
    family = "banded"

    def __post_init__(self):
        if not 0.0 < self.bandwidth <= 1.0:
            raise ValueError(f"Banded bandwidth must be in (0, 1], got "
                             f"{self.bandwidth}")
        if not 0.0 < self.d <= self.bandwidth:
            raise ValueError(
                f"Banded density must be in (0, bandwidth={self.bandwidth}]"
                f" (in-band density d/bandwidth must be <= 1), got {self.d}")

    @property
    def density(self) -> float:
        return self.d

    def block_nonempty(self, elems) -> float:
        d_in = self.d / self.bandwidth
        return self.bandwidth * (1.0 - (1.0 - d_in) ** elems)

    def params(self) -> Tuple[float, ...]:
        return (self.d, self.bandwidth)


@dataclasses.dataclass(frozen=True)
class BlockNM(DensityModel):
    """Structured N:M pruning: every aligned block of ``m`` elements
    keeps exactly ``n`` nonzeros, uniformly placed within the block
    (sparseGPT 2:4 -> ``BlockNM(2, 4)``).  Mean density is ``n / m``
    exactly, with zero variance — the intersection hit rate of an N:M
    leader is deterministic."""

    n: int
    m: int
    family = "block_nm"

    def __post_init__(self):
        if not (isinstance(self.n, int) and isinstance(self.m, int)):
            raise ValueError("BlockNM n and m must be ints")
        if not 1 <= self.n <= self.m:
            raise ValueError(f"BlockNM needs 1 <= n <= m, got "
                             f"{self.n}:{self.m}")

    @property
    def density(self) -> float:
        return self.n / self.m

    def block_nonempty(self, elems) -> float:
        # P(miss) for a window of e elements of one aligned m-block is
        # hypergeometric: C(m-n, e) / C(m, e); via log-gamma so float
        # (tile-extent) windows use the same formula as the device evaluator
        free = self.m - self.n
        e = min(float(elems), float(free))
        if float(elems) > free:
            return 1.0
        p_miss = math.exp(
            math.lgamma(free + 1.0) + math.lgamma(self.m - e + 1.0)
            - math.lgamma(free - e + 1.0) - math.lgamma(self.m + 1.0))
        return 1.0 - p_miss

    def params(self) -> Tuple[float, ...]:
        return (float(self.n), float(self.m))


# ---------------------------------------------------------------- registry

#: family name -> (traced family code, model class), in registration
#: order.  The structured device evaluator bakes the registered family SET at
#: trace time and selects per tensor by the traced code — register
#: custom families before building evaluators (COMPAT.md).
_FAMILIES: Dict[str, Tuple[int, Type[DensityModel]]] = {}


def register_density_model(cls: Type[DensityModel]) -> Type[DensityModel]:
    """Register a DensityModel subclass (numpy side).  The device evaluator
    additionally needs ``torch_cost.register_density_occ(family, fn)``."""
    global _N_FAMILY_PARAMS
    fam = cls.family
    if fam in _FAMILIES and _FAMILIES[fam][1] is not cls:
        raise ValueError(f"density family {fam!r} already registered by "
                         f"{_FAMILIES[fam][1].__name__}")
    if fam not in _FAMILIES:
        _FAMILIES[fam] = (len(_FAMILIES), cls)
    probe_params = getattr(cls, "_n_params", None)
    if probe_params is not None:
        _N_FAMILY_PARAMS = max(_N_FAMILY_PARAMS, int(probe_params))
    return cls


register_density_model(Uniform)
register_density_model(Banded)
register_density_model(BlockNM)


def family_code(family: str) -> int:
    """The traced integer code of a registered family."""
    return _FAMILIES[family][0]


def density_to_dict(d: DensityLike) -> Dict:
    """Wire form of a density description: the registered family name
    plus the model's dataclass fields (a plain float normalizes to
    :class:`Uniform` first).  Only registered families serialize — an
    unregistered custom model has no code the receiving side could
    rebuild a kernel row from."""
    m = as_density(d)
    if m.family not in _FAMILIES or _FAMILIES[m.family][1] is not type(m):
        raise ValueError(
            f"density model {type(m).__name__!r} (family {m.family!r}) is "
            f"not registered; registered families: {sorted(_FAMILIES)}")
    return {"family": m.family, "fields": dataclasses.asdict(m)}


def density_from_dict(d: Dict) -> DensityModel:
    """Inverse of :func:`density_to_dict`.  Unknown families raise
    ``ValueError`` naming the registered ones (a server surfaces this to
    the client instead of dying)."""
    fam = d["family"]
    if fam not in _FAMILIES:
        raise ValueError(f"unknown density family {fam!r}; registered "
                         f"families: {sorted(_FAMILIES)}")
    return _FAMILIES[fam][1](**d.get("fields", {}))


def registered_families() -> Tuple[str, ...]:
    """Registered family names in code order."""
    return tuple(_FAMILIES)


def registry_fingerprint() -> str:
    """Joined registered family names — part of the structured
    compilation signature, so registering a new family can never alias a
    stale structured kernel."""
    return "+".join(_FAMILIES)


def param_width() -> int:
    """Width of the traced per-tensor parameter row:
    ``[code, hit_rate, family params..., 0 pad]``."""
    return 2 + _N_FAMILY_PARAMS


def as_density(d: DensityLike) -> DensityModel:
    """Normalize a density description: floats/ints become
    :class:`Uniform`, models pass through."""
    if isinstance(d, DensityModel):
        return d
    return Uniform(float(d))


def param_row(model: DensityModel) -> Tuple[float, ...]:
    """The traced parameter row of one tensor's model."""
    if model.family not in _FAMILIES:
        raise KeyError(
            f"density family {model.family!r} is not registered; call "
            f"density.register_density_model first (COMPAT.md)")
    p = model.params()
    if len(p) > _N_FAMILY_PARAMS:
        raise ValueError(
            f"{model.family}: {len(p)} params exceed the registered "
            f"width {_N_FAMILY_PARAMS}; set a _n_params class attr and "
            f"re-register")
    pad = (0.0,) * (_N_FAMILY_PARAMS - len(p))
    return (float(family_code(model.family)), float(model.hit_rate())) \
        + tuple(float(x) for x in p) + pad
