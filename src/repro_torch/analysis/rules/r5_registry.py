"""R5 — registry conformance: every registered plugin implements the
port's protocol surface (COMPAT.md), by runtime reflection over its
three extension registries:

* ``baselines.REQUEST_METHODS`` — each factory must accept
  ``(spec, platform, budget, seed, **kw)``; ``SEGMENT_METHODS`` must be
  a subset of the registered methods.
* ``density`` families (``register_density_model``) — frozen hashable
  dataclass subclassing ``DensityModel`` with a ``family`` tag matching
  its registry key, overriding ``density``/``block_nonempty``/
  ``params``, and paired with a torch occupancy function
  (``torch_cost.register_density_occ``) so the structured evaluator can
  run it.
* registered topologies (``arch.register_arch`` + the paper platforms)
  — ``param_vector()`` must be a 1-D float32 vector whose length
  exactly matches the evaluator's ``_topo_tables`` index layout (a
  mismatch silently misreads the numbers).

All registries are injectable for testing; defaults reflect over the
live ones.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List, Optional

from ..lint import Violation

RULE_ID = "R5"


def _v(where: str, msg: str) -> Violation:
    return Violation(RULE_ID, where, 0, msg)


def check_request_methods(request_methods: Dict,
                          segment_methods=None) -> List[Violation]:
    out: List[Violation] = []
    where = "registry:REQUEST_METHODS"
    for name, factory in request_methods.items():
        if not callable(factory):
            out.append(_v(where, f"{name!r}: factory is not callable"))
            continue
        try:
            sig = inspect.signature(factory)
        except (TypeError, ValueError):
            continue                    # uninspectable; give it a pass
        params = list(sig.parameters.values())
        n_pos = len([p for p in params
                     if p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)])
        has_varkw = any(p.kind == p.VAR_KEYWORD for p in params)
        if n_pos < 4:
            out.append(_v(
                where,
                f"{name!r}: factory must accept (spec, platform, "
                f"budget, seed, **kw); it takes only {n_pos} "
                f"positional parameters"))
        if not has_varkw:
            out.append(_v(
                where,
                f"{name!r}: factory must accept **kw (method_kw "
                f"passthrough; the request-generator protocol)"))
    if segment_methods is not None:
        for name in sorted(segment_methods):
            if name not in request_methods:
                out.append(_v(
                    "registry:SEGMENT_METHODS",
                    f"{name!r} is declared segment-foldable but has no "
                    f"REQUEST_METHODS factory"))
    return out


def check_density_families(families: Dict, torch_occ: Dict,
                           base_cls=None) -> List[Violation]:
    out: List[Violation] = []
    for fam, entry in families.items():
        where = f"registry:density[{fam}]"
        cls = entry[1] if isinstance(entry, tuple) else entry
        if base_cls is not None and not (isinstance(cls, type) and
                                         issubclass(cls, base_cls)):
            out.append(_v(where, "not a DensityModel subclass"))
            continue
        if getattr(cls, "family", None) != fam:
            out.append(_v(
                where,
                f"class attr family={getattr(cls, 'family', None)!r} "
                f"does not match its registry key"))
        if not dataclasses.is_dataclass(cls):
            out.append(_v(where, "must be a (frozen) dataclass"))
        elif not cls.__dataclass_params__.frozen:
            out.append(_v(
                where, "dataclass must be frozen=True (models key "
                       "evaluator caches and live inside TensorSpec)"))
        if getattr(cls, "__hash__", None) is None:
            out.append(_v(where, "not hashable (frozen dataclass "
                                 "required)"))
        if not isinstance(getattr(cls, "density", None), property):
            out.append(_v(where, "missing `density` property"))
        for meth in ("block_nonempty", "params"):
            fn = getattr(cls, meth, None)
            if not callable(fn):
                out.append(_v(where, f"missing `{meth}` method"))
            elif base_cls is not None and \
                    fn is getattr(base_cls, meth, None):
                out.append(_v(
                    where,
                    f"`{meth}` not overridden (base raises "
                    f"NotImplementedError)"))
        if not callable(getattr(cls, "hit_rate", None)):
            out.append(_v(where, "missing `hit_rate` method"))
        if fam not in torch_occ:
            out.append(_v(
                where,
                "no torch occupancy function registered — call "
                "torch_cost.register_density_occ(family, fn) (COMPAT.md "
                "\"Defining a custom DensityModel\")"))
    return out


def check_archs(archs: Dict) -> List[Violation]:
    import numpy as np

    from ...core.torch_cost import _topo_tables

    out: List[Violation] = []
    for name, spec in archs.items():
        where = f"registry:arch[{name}]"
        try:
            topo = spec.topology
            tt = _topo_tables(topo)
        except Exception as e:          # structurally broken spec
            out.append(_v(where, f"topology tables failed: {e!r}"))
            continue
        idxs = (list(tt.fanout_idx)
                + [i for _, i in tt.cap_checks]
                + [i for row in tt.energy_idx for i in row]
                + [i for _, i in tt.bw_checks]
                + [tt.mac_idx]
                + list(tt.word_idx)
                + [i for i in tt.noc_mc_idx if i is not None]
                + [i for i in tt.noc_red_idx if i is not None])
        expected = max(idxs) + 1
        try:
            vec = spec.param_vector()
        except Exception as e:
            out.append(_v(where, f"param_vector() failed: {e!r}"))
            continue
        if np.ndim(vec) != 1:
            out.append(_v(where, f"param_vector() must be 1-D, got "
                                 f"ndim={np.ndim(vec)}"))
        if np.asarray(vec).dtype != np.float32:
            out.append(_v(
                where,
                f"param_vector() must be float32 (the evaluator's row "
                f"dtype), got {np.asarray(vec).dtype}"))
        if len(vec) != expected:
            out.append(_v(
                where,
                f"param_vector() length {len(vec)} != evaluator layout "
                f"length {expected} — its numbers would be misread "
                f"(COMPAT.md \"Defining a custom ArchSpec\")"))
        fp = topo.fingerprint
        if not (isinstance(fp, str) and len(fp) == 8):
            out.append(_v(where, f"topology.fingerprint {fp!r} is not "
                                 f"an 8-hex tag"))
    return out


def registered_arch_specs() -> Dict:
    """Every registered arch, the paper platform's ``sparsemap`` among
    them."""
    from ...core.arch import ARCH_SPARSEMAP, registered_archs
    archs = dict(registered_archs())
    archs.setdefault("sparsemap", ARCH_SPARSEMAP)
    return archs


def check_registries(request_methods: Optional[Dict] = None,
                     segment_methods=None,
                     density_families: Optional[Dict] = None,
                     torch_occ: Optional[Dict] = None,
                     archs: Optional[Dict] = None) -> List[Violation]:
    """Run every registry-conformance check; any argument left ``None``
    reflects over the corresponding live registry."""
    from ...core import baselines, density, torch_cost

    if request_methods is None:
        request_methods = baselines.REQUEST_METHODS
        if segment_methods is None:
            segment_methods = baselines.SEGMENT_METHODS
    if density_families is None:
        density_families = density._FAMILIES
    if torch_occ is None:
        torch_occ = torch_cost._TORCH_OCC
    if archs is None:
        archs = registered_arch_specs()

    out = check_request_methods(request_methods, segment_methods)
    out += check_density_families(density_families, torch_occ,
                                  base_cls=density.DensityModel)
    out += check_archs(archs)
    return out
