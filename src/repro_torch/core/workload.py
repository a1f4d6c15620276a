"""Sparse tensor algebra workloads (SparseMap §II, Table III).

A workload is an einsum ``Z[m,n] += P[m,k] * Q[k,n]`` (SpMM) or a sparse
convolution lowered to implicit GEMM (SpConv).  SparseMap treats both as a
D-dimensional projective einsum: each tensor is indexed by a subset of the
iteration dimensions, and each operand carries a *density model*
(:mod:`repro_torch.core.density`): a plain float means uniform-random nonzeros
(the seed semantics), while :class:`~repro_torch.core.density.Banded` and
:class:`~repro_torch.core.density.BlockNM` describe clustered and
structured-pruned operands whose byte/intersection statistics differ.

Dimensions are named; the canonical GEMM order is ("M", "K", "N").  A batched
workload (§IV.G, Fig. 15) adds "B" and the genome widens automatically — the
encoding only ever sees ``dims`` / ``prime_factors`` / relevance sets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .density import (DensityLike, DensityModel, Uniform, as_density,
                      density_from_dict, density_to_dict)

WORD_BYTES = 2  # 16-bit operands throughout (paper uses 16-bit, DSTC 12nm)


def prime_factorize(n: int) -> List[int]:
    """Prime factors of ``n`` in non-decreasing order (1 -> [])."""
    if n < 1:
        raise ValueError(f"dimension must be >= 1, got {n}")
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def pad_to_composite(n: int, max_prime: int = 7) -> int:
    """Replace a dimension whose largest prime factor exceeds ``max_prime``
    with the nearest larger integer that factorizes into small primes
    (paper §IV.B: "if a dimension size is a large prime number, we replace it
    with the nearest larger composite number")."""
    m = n
    while max(prime_factorize(m), default=1) > max_prime:
        m += 1
    return m


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One tensor of the einsum.

    ``density`` accepts a plain float (fraction of nonzero elements in
    (0, 1], meaning uniform-random placement) or any
    :class:`~repro_torch.core.density.DensityModel`; ``density_model`` is the
    normalized view and ``mean_density`` the scalar mean."""

    name: str                 # "P" | "Q" | "Z"
    dims: Tuple[str, ...]     # iteration dims this tensor is indexed by
    density: DensityLike      # float (= Uniform) or a DensityModel
    is_output: bool = False

    @property
    def density_model(self) -> DensityModel:
        return as_density(self.density)

    @property
    def mean_density(self) -> float:
        return self.density_model.density

    def size(self, dim_sizes: Dict[str, int]) -> int:
        s = 1
        for d in self.dims:
            s *= dim_sizes[d]
        return s


@dataclasses.dataclass(frozen=True)
class Workload:
    """A sparse projective einsum plus densities.

    ``dim_sizes`` are the *padded* sizes actually searched over;
    ``orig_dim_sizes`` keeps the user-specified sizes for reporting.
    """

    name: str
    dim_order: Tuple[str, ...]            # canonical order, e.g. ("M","K","N")
    dim_sizes: Dict[str, int]
    tensors: Tuple[TensorSpec, TensorSpec, TensorSpec]
    orig_dim_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    # ---- derived -----------------------------------------------------
    def cache_key(self) -> Tuple:
        """Hashable content key.  Evaluator caches must key on this, NOT
        on ``id(workload)``: two content-equal workloads then share one
        cached evaluator/compilation, and — critically — a recycled object
        id can never alias a *different* workload after the original is
        garbage-collected."""
        return (self.name, self.dim_order,
                tuple(sorted(self.dim_sizes.items())),
                tuple((t.name, t.dims, t.density_model, t.is_output)
                      for t in self.tensors),
                tuple(sorted(self.orig_dim_sizes.items())))

    @property
    def ndims(self) -> int:
        return len(self.dim_order)

    @property
    def inputs(self) -> Tuple[TensorSpec, TensorSpec]:
        return tuple(t for t in self.tensors if not t.is_output)  # type: ignore

    @property
    def output(self) -> TensorSpec:
        return next(t for t in self.tensors if t.is_output)

    def tensor(self, name: str) -> TensorSpec:
        return next(t for t in self.tensors if t.name == name)

    @property
    def prime_factors(self) -> List[Tuple[str, int]]:
        """Flat list of (dim_name, prime) pairs — the tiling genome slots."""
        out: List[Tuple[str, int]] = []
        for d in self.dim_order:
            for p in prime_factorize(self.dim_sizes[d]):
                out.append((d, p))
        return out

    @property
    def macs(self) -> int:
        """Dense MAC count = product of all iteration dims."""
        s = 1
        for d in self.dim_order:
            s *= self.dim_sizes[d]
        return s

    def output_density(self) -> float:
        """P(z != 0) under independent nonzero placement: an output element
        is nonzero iff any of the K (contraction) products is nonzero.
        Mean-field over the input models (their mean densities); input
        structure correlating the products is not modeled here."""
        contraction = [d for d in self.dim_order
                       if d not in self.output.dims]
        k = 1
        for d in contraction:
            k *= self.dim_sizes[d]
        dp = 1.0
        for t in self.inputs:
            dp *= t.mean_density
        return float(1.0 - (1.0 - dp) ** k) if dp < 1.0 else 1.0

    def density_of(self, name: str) -> float:
        """Mean density of a tensor (the output's is derived)."""
        return self.density_model_of(name).density

    def density_model_of(self, name: str) -> DensityModel:
        """The tensor's density model.  The output keeps the seed
        semantics — its density is *derived* from the inputs
        (:meth:`output_density`, uniform placement) — unless a
        structured model was declared on it explicitly."""
        t = self.tensor(name)
        if t.is_output:
            m = t.density_model
            if m.family == "uniform":
                return Uniform(self.output_density())
            return m
        return t.density_model

    @property
    def structured_density(self) -> bool:
        """True when any tensor declares a non-uniform density model
        (selects the structured device evaluator variant)."""
        return any(t.density_model.family != "uniform"
                   for t in self.tensors)


def workload_to_dict(wl: Workload) -> Dict:
    """JSON-able wire form of a workload — exactly the
    :meth:`Workload.cache_key` fields, with density models serialized by
    registered family (:func:`~repro_torch.core.density.density_to_dict`).
    Round-trips through :func:`workload_from_dict` to a content-equal
    workload (same ``cache_key()``), so a deserialized server query
    shares the sender's evaluator cache entry and warm-start library
    key."""
    return {
        "name": wl.name,
        "dim_order": list(wl.dim_order),
        "dim_sizes": {d: int(v) for d, v in wl.dim_sizes.items()},
        "orig_dim_sizes": {d: int(v)
                           for d, v in wl.orig_dim_sizes.items()},
        "tensors": [
            {"name": t.name, "dims": list(t.dims),
             "density": density_to_dict(t.density),
             "is_output": bool(t.is_output)} for t in wl.tensors],
    }


def workload_from_dict(d: Dict) -> Workload:
    """Inverse of :func:`workload_to_dict`."""
    tensors = tuple(
        TensorSpec(name=t["name"], dims=tuple(t["dims"]),
                   density=density_from_dict(t["density"]),
                   is_output=bool(t.get("is_output", False)))
        for t in d["tensors"])
    if len(tensors) != 3:
        raise ValueError(f"workload needs exactly 3 tensors, "
                         f"got {len(tensors)}")
    return Workload(
        name=d["name"], dim_order=tuple(d["dim_order"]),
        dim_sizes={k: int(v) for k, v in d["dim_sizes"].items()},
        tensors=tensors,  # type: ignore[arg-type]
        orig_dim_sizes={k: int(v)
                        for k, v in d.get("orig_dim_sizes", {}).items()})


def spmm(name: str, m: int, k: int, n: int,
         density_p: DensityLike, density_q: DensityLike) -> Workload:
    """SpMM workload  P[M,K] x Q[K,N] = Z[M,N]  (paper Table III mm*)."""
    sizes = {"M": pad_to_composite(m), "K": pad_to_composite(k),
             "N": pad_to_composite(n)}
    return Workload(
        name=name,
        dim_order=("M", "K", "N"),
        dim_sizes=sizes,
        orig_dim_sizes={"M": m, "K": k, "N": n},
        tensors=(
            TensorSpec("P", ("M", "K"), density_p),
            TensorSpec("Q", ("K", "N"), density_q),
            TensorSpec("Z", ("M", "N"), 1.0, is_output=True),
        ),
    )


def batched_spmm(name: str, b: int, m: int, k: int, n: int,
                 density_p: DensityLike, density_q: DensityLike
                 ) -> Workload:
    """4-dim workload (paper Fig. 15): adds batch dim B shared by all
    tensors.  Exercises the multi-dimensional genome path (perm range A_4^4)."""
    sizes = {"B": pad_to_composite(b), "M": pad_to_composite(m),
             "K": pad_to_composite(k), "N": pad_to_composite(n)}
    return Workload(
        name=name,
        dim_order=("B", "M", "K", "N"),
        dim_sizes=sizes,
        orig_dim_sizes={"B": b, "M": m, "K": k, "N": n},
        tensors=(
            TensorSpec("P", ("B", "M", "K"), density_p),
            TensorSpec("Q", ("B", "K", "N"), density_q),
            TensorSpec("Z", ("B", "M", "N"), 1.0, is_output=True),
        ),
    )


def spconv(name: str, c: int, h: int, w: int, kout: int, r: int, s: int,
           density_i: DensityLike, density_w: DensityLike,
           stride: int = 1, pad: int | None = None) -> Workload:
    """SpConv lowered to implicit GEMM (paper Table III conv*).

    Input  I[C,H,W] (density_i), weights W[Kout,C,R,S] (density_w),
    output O[Kout,P,Q'].  im2col:  M=Kout, K=C*R*S, N=P*Q'.
    Operand1 of Table III is the input fmap, operand2 the weights.
    """
    if pad is None:
        pad = r // 2
    p_out = (h + 2 * pad - r) // stride + 1
    q_out = (w + 2 * pad - s) // stride + 1
    m = kout
    kk = c * r * s
    n = p_out * q_out
    wl = spmm(name, m, kk, n, density_w, density_i)
    # P holds weights (density_w), Q holds the im2col'd input (density_i).
    return wl


def from_gemm_shape(name: str, m: int, k: int, n: int,
                    density_p: DensityLike = 1.0, density_q: DensityLike = 1.0
                    ) -> Workload:
    return spmm(name, m, k, n, density_p, density_q)
