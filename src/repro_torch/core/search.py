"""Public search facade: run any optimization method on (workload,
platform) under an evaluation budget.

    from repro_torch.core import search
    res = search.run("sparsemap", workload, "cloud", budget=20_000, seed=0)
    print(res.best_edp, res.valid_fraction)
    design = search.decode_best(workload, res)

The single-search surface of the JAX package's ``core/search.py``; the
fleet engine (``MultiSearch``, ``run_sweep``, ``run_method_sweep``, pad
policies) is not part of this package yet.

Every entry point takes ``device``: ``None`` means the GPU and raises
where there is none; ``device="cpu"`` runs on the CPU on purpose.

Evaluator instances are cached per (workload content, platform, device)
because building one uploads its tables; the key is
:meth:`Workload.cache_key`, so content-equal workloads share one evaluator
and a recycled object id can never alias a stale entry.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from . import accel
from .arch import ArchSpec, as_arch
from .baselines import METHODS
from .cost_model import CostReport, Design, evaluate
from .encoding import GenomeSpec
from .evolution import SearchResult
from .torch_cost import TorchCostModel
from .workload import Workload

#: anything that names hardware: a Platform/arch name, a Platform, or an
#: ArchSpec (see repro_torch.core.arch.as_arch)
PlatformLike = Union[str, accel.Platform, ArchSpec]

_CACHE: Dict[Tuple[Tuple, ArchSpec, Optional[int], bool, torch.device],
             Tuple[GenomeSpec, TorchCostModel]] = {}


def _platform(platform: PlatformLike) -> ArchSpec:
    """Resolve any hardware description to its ArchSpec."""
    return as_arch(platform)


def get_evaluator(workload: Workload, platform: PlatformLike,
                  n_pad: Optional[int] = None,
                  structured: bool = False,
                  device: DeviceLike = None
                  ) -> Tuple[GenomeSpec, TorchCostModel]:
    plat = _platform(platform)
    dev = resolve_device(device)
    # ``structured=True`` promotes an all-uniform workload onto the
    # structured-density evaluator so it can share a signature with
    # banded/N:M peers; a naturally structured workload is normalized to
    # its natural key so every caller shares one evaluator
    structured = bool(structured) and not workload.structured_density
    # the ArchSpec itself (content-hashable) keys the cache: two specs
    # that merely share a NAME must not alias one evaluator
    key = (workload.cache_key(), plat, n_pad, structured, dev)
    if key not in _CACHE:
        spec = GenomeSpec(workload, arch=plat)
        _CACHE[key] = (spec, TorchCostModel(spec, plat, n_pad=n_pad,
                                            structured=structured or None,
                                            device=dev))
    return _CACHE[key]


def clear_cache() -> None:
    """Drop cached evaluators."""
    _CACHE.clear()


def run(method: str, workload: Workload,
        platform: PlatformLike, budget: int = 20_000,
        seed: int = 0, **kw) -> SearchResult:
    if method not in METHODS:
        raise KeyError(f"unknown method {method!r}; have {list(METHODS)}")
    device = kw.pop("device", None)
    plat = _platform(platform)
    spec, ev = get_evaluator(workload, plat, device=device)
    res = METHODS[method](spec, ev, budget, seed, plat, **kw)
    res.extras.setdefault("arch", plat)
    return res


def decode_best(workload: Workload, result: SearchResult,
                platform: Optional[PlatformLike] = None) -> Optional[Design]:
    """Decode a result's best genome.  ``platform`` selects the arch the
    search ran on; when omitted, the arch recorded in the result's extras
    is used (falling back to the paper topology for results that predate
    the recording).  Any same-topology description works."""
    if result.best_genome is None:
        return None
    if platform is None:
        platform = result.extras.get("arch")
    spec = GenomeSpec(workload) if platform is None else \
        GenomeSpec(workload, arch=_platform(platform))
    return spec.decode(result.best_genome)


def report_best(workload: Workload, platform: PlatformLike,
                result: SearchResult) -> Optional[CostReport]:
    plat = _platform(platform)
    d = decode_best(workload, result, platform=plat)
    if d is None:
        return None
    return evaluate(d, plat)
