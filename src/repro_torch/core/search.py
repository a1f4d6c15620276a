"""Public search facade: run any optimization method on (workload,
platform) under an evaluation budget.

    from repro_torch.core import search
    res = search.run("sparsemap", workload, "cloud", budget=20_000, seed=0)
    print(res.best_edp, res.valid_fraction)
    design = search.decode_best(workload, res)

Concurrent sweeps use :class:`MultiSearch`, the method-agnostic search
runtime: every task — any (method, workload, platform) triple whose method
has a request generator in ``baselines.REQUEST_METHODS`` — is a generator
that yields genome batches, and each round every pending task's batch is
evaluated and its generator advanced.  With ``align_signatures=True`` each
workload's prime axis is padded up to the largest bucket among its
same-ndims peers so the group shares one signature; with
``stack_batches=True`` all same-signature pending batches become one
padded mega-batch per round (``torch_cost.eval_stacked``), and ES tasks
advance in k-generation device segments (``torch_cost.run_segments``):

    results = search.run_sweep([wl_a, wl_b], "cloud", budget=20_000)
    grid = search.run_method_sweep(["sparsemap", "pso", "random_mapper"],
                                   [wl_a, wl_b], "cloud", budget=20_000)

Every entry point takes ``device``: ``None`` means the GPU and raises
where there is none; ``device="cpu"`` runs on the CPU on purpose.  The
device is a keyword of the entry points, not a field of
:class:`FleetConfig`, which is the wire schema shared with the JAX
package.

Evaluator instances are cached per (workload content, platform, device)
because building one uploads its tables; the key is
:meth:`Workload.cache_key`, so content-equal workloads share one evaluator
and a recycled object id can never alias a stale entry.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import accel, torch_cost
from .arch import ArchSpec, as_arch
from .baselines import (METHODS, REQUEST_METHODS, SEGMENT_METHODS,
                        make_requests)
from .cost_model import CostReport, Design, evaluate
from .encoding import GenomeSpec
from .es_ops import DeviceSegment, segment_shape_key
from .evolution import SearchResult, _Budget
from .torch_cost import TorchCostModel, _bucket
from .workload import Workload, workload_from_dict, workload_to_dict

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
    """Drop cached evaluators and the stacked constants built from them,
    and zero the evaluator's counters (benchmark hook)."""
    _CACHE.clear()
    torch_cost.clear_stack_cache()
    torch_cost.reset_dispatch_count()
    torch_cost.reset_host_blocked_s()


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


# ---------------------------------------------------------------- multi


@dataclasses.dataclass(frozen=True)
class PadPolicy:
    """Mega-batch pad-watermark grow/decay constants for ONE topology.

    The watermark grows to the largest padded round immediately; it
    decays after ``decay_rounds`` consecutive rounds each needing at most
    ``decay_ratio`` of the current shape.  Register a policy with
    :func:`set_pad_policy` (keyed by ``Topology.fingerprint``) or pass
    ``pad_policies`` to :class:`MultiSearch` for a one-off override.

    ``source`` records where the constants came from: ``"default"``,
    ``"measured"`` (derived from a benchmark trajectory) or ``"seed"``
    (declared by a topology's author ahead of a measurement)."""

    decay_rounds: int = 3
    decay_ratio: float = 0.5
    source: str = "default"


#: The explicit policy :func:`pad_policy_for` returns for topologies with
#: no registered entry.
DEFAULT_PAD_POLICY = PadPolicy()


def derive_pad_policy(trajectory: Sequence[int],
                      source: str = "measured") -> PadPolicy:
    """Derive a per-topology :class:`PadPolicy` from a pad-watermark
    trajectory (``stats["pad_watermarks"]`` of a fleet run).

    A trajectory that steps down from its peak and never re-grows
    afterwards is a one-off spike (round-1 calibration probes /
    random_mapper chunks): such topologies decay earlier
    (``decay_rounds=2``) with ``decay_ratio`` tightened to the observed
    post-spike plateau.  A trajectory that re-grows after decaying, or
    never decays, keeps the default constants (stamped with ``source``)."""
    traj = list(trajectory)
    peak = max(traj, default=0)
    if peak <= 0 or traj[-1] >= peak:
        return PadPolicy(source=source)
    first_down = next(i for i, v in enumerate(traj) if v < peak
                      and max(traj[:i], default=0) == peak)
    regrew = any(b > a for a, b in zip(traj[first_down:],
                                       traj[first_down + 1:]))
    if regrew:
        return PadPolicy(source=source)
    plateau_ratio = max(traj[first_down:]) / peak
    return PadPolicy(decay_rounds=2,
                     decay_ratio=min(max(plateau_ratio, 1 / 32), 0.5),
                     source=source)


#: topology fingerprint -> PadPolicy.  Empty: the JAX package's measured
#: policies come from its own CPU trajectories, not from this port's
#: runs, so every topology starts on DEFAULT_PAD_POLICY here.
_PAD_POLICIES: Dict[str, PadPolicy] = {}


def set_pad_policy(topology_fingerprint: str, policy: PadPolicy) -> None:
    """Register the tuned pad-watermark policy for a topology."""
    _PAD_POLICIES[topology_fingerprint] = policy


def pad_policy_for(topology_fingerprint: str) -> PadPolicy:
    """The registered policy for a topology, or :data:`DEFAULT_PAD_POLICY`
    when none is registered."""
    return _PAD_POLICIES.get(topology_fingerprint, DEFAULT_PAD_POLICY)


#: per-backend default for ``MultiSearch(device_rounds=None)``, the JAX
#: package's table and keys: the CPU stays on the per-round path, a GPU
#: folds 4 generations per device segment (a TPU 8).
_DEFAULT_DEVICE_ROUNDS = {"cpu": 1, "gpu": 4, "tpu": 8}


def _backend(device: torch.device) -> str:
    """The backend name of a torch device, in the JAX package's terms."""
    return "gpu" if device.type == "cuda" else device.type


def default_device_rounds(backend: Optional[str] = None) -> int:
    """The fleet ``device_rounds`` default for a backend (``"cpu"``,
    ``"gpu"``, ...; the GPU when not given).  Unknown backends fall back
    to 1 — the always-correct per-round path."""
    if backend is None:
        backend = _backend(resolve_device(None))
    return _DEFAULT_DEVICE_ROUNDS.get(backend, 1)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The fleet runtime configuration — every knob :class:`MultiSearch`
    accepts, in one validated, frozen, serializable object.  It is the
    wire schema the JAX package's sweep server speaks, field for field:
    ``to_json()`` is byte-equal to the reference's for the same settings,
    and either package reads the other's.

    Two fields are kept for that schema only: ``compile_ahead`` does
    nothing here (eager PyTorch compiles nothing ahead of a dispatch, so
    ``stats["compile_ahead_hits"/"compile_ahead_misses"]`` are 0), and
    ``mesh`` must be ``None`` (sharding over several GPUs is not ported).

    ``device_rounds=None`` defers to the per-backend default
    (:func:`default_device_rounds`), resolved by
    :meth:`resolved_device_rounds` from the device the fleet runs on."""

    align_signatures: bool = True
    stack_batches: bool = False
    pad_policies: Dict[str, PadPolicy] = \
        dataclasses.field(default_factory=dict)
    device_rounds: Optional[int] = None
    mesh: object = None
    device_execute: bool = True
    pipeline: bool = True
    compile_ahead: bool = True

    def __post_init__(self):
        if self.mesh is not None:
            raise ValueError(
                "FleetConfig.mesh must be None: sharding a fleet over "
                "several GPUs is not ported yet")
        for flag in ("align_signatures", "stack_batches",
                     "device_execute", "pipeline", "compile_ahead"):
            object.__setattr__(self, flag, bool(getattr(self, flag)))
        if self.device_rounds is not None:
            if int(self.device_rounds) < 1:
                raise ValueError("device_rounds must be >= 1")
            object.__setattr__(self, "device_rounds",
                               int(self.device_rounds))
        pols = {}
        for fp, pol in (self.pad_policies or {}).items():
            if isinstance(pol, dict):
                pol = PadPolicy(**pol)
            if not isinstance(pol, PadPolicy):
                raise TypeError(f"pad_policies[{fp!r}] must be a "
                                f"PadPolicy or dict, got {type(pol)}")
            pols[str(fp)] = pol
        object.__setattr__(self, "pad_policies", pols)

    def resolved_device_rounds(self, device: DeviceLike = None
                               ) -> Tuple[int, str]:
        """``(value, provenance)``: the explicit value, or the default of
        ``device``'s backend (the GPU when not given) tagged
        ``"default:<backend>"`` — ``default:gpu`` on the card."""
        if self.device_rounds is None:
            backend = _backend(resolve_device(device))
            return default_device_rounds(backend), f"default:{backend}"
        return self.device_rounds, "explicit"

    def to_json_dict(self) -> Dict:
        return dict(
            version=1,
            align_signatures=self.align_signatures,
            stack_batches=self.stack_batches,
            pad_policies={fp: dataclasses.asdict(pol)
                          for fp, pol in sorted(self.pad_policies.items())},
            device_rounds=self.device_rounds,
            device_execute=self.device_execute,
            pipeline=self.pipeline,
            compile_ahead=self.compile_ahead)

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, data: Union[str, Dict]) -> "FleetConfig":
        d = dict(json.loads(data) if isinstance(data, str) else data)
        version = d.pop("version", 1)
        if version != 1:
            raise ValueError(f"unknown FleetConfig schema version "
                             f"{version!r}")
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown FleetConfig fields: "
                             f"{sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class SearchTask:
    """One (method, workload, platform) search in a :class:`MultiSearch`
    fleet.  ``method`` must have a request generator
    (``baselines.REQUEST_METHODS``); ``method_kw`` is forwarded to its
    factory.

    ``runtime_kw`` carries process-local factory extras the wire schema
    must not see (warm-start ``seeds`` rows, checkpoint hooks); it is
    excluded from ``to_json()``."""
    workload: Workload
    platform: PlatformLike = "cloud"
    budget: int = 20_000
    seed: int = 0
    name: Optional[str] = None
    method: str = "sparsemap"
    method_kw: Dict = dataclasses.field(default_factory=dict)
    runtime_kw: Dict = dataclasses.field(default_factory=dict,
                                         repr=False, compare=False)

    def __post_init__(self):
        if self.method not in REQUEST_METHODS:
            raise KeyError(
                f"method {self.method!r} has no request generator; "
                f"have {sorted(REQUEST_METHODS)}")

    def resolved_name(self) -> str:
        if self.name:
            return self.name
        base = f"{self.workload.name}@{_platform(self.platform).name}"
        return base if self.method == "sparsemap" else \
            f"{self.method}:{base}"

    def to_json_dict(self) -> Dict:
        """JSON-able wire form: the workload by its ``cache_key`` fields,
        the platform by registry name, and the method's factory kwargs
        (``runtime_kw`` excluded)."""
        return dict(
            version=1,
            workload=workload_to_dict(self.workload),
            platform=_platform(self.platform).name,
            budget=int(self.budget),
            seed=int(self.seed),
            name=self.name,
            method=self.method,
            method_kw=dict(self.method_kw))

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, data: Union[str, Dict]) -> "SearchTask":
        d = dict(json.loads(data) if isinstance(data, str) else data)
        version = d.pop("version", 1)
        if version != 1:
            raise ValueError(f"unknown SearchTask schema version "
                             f"{version!r}")
        unknown = set(d) - {"workload", "platform", "budget", "seed",
                            "name", "method", "method_kw"}
        if unknown:
            raise ValueError(f"unknown SearchTask fields: "
                             f"{sorted(unknown)}")
        return cls(
            workload=workload_from_dict(d["workload"]),
            platform=d.get("platform", "cloud"),
            budget=int(d.get("budget", 20_000)),
            seed=int(d.get("seed", 0)),
            name=d.get("name"),
            method=d.get("method", "sparsemap"),
            method_kw=dict(d.get("method_kw") or {}))


@dataclasses.dataclass
class _TaskState:
    name: str
    gen: object                      # the method's request generator
    tracker: _Budget
    ev: TorchCostModel
    natural: Tuple[int, int]         # (ndims, natural prime bucket)
    method: str
    req: Optional[np.ndarray] = None
    extras: Optional[Dict] = None

    @property
    def signature(self) -> Tuple[int, int, str, str]:
        return self.ev.signature


class MultiSearch:
    """Run a fleet of (method, workload, platform) searches concurrently
    on one device.

    Each task's engine is a request generator (``evolve_requests`` for
    SparseMap populations, ``baselines.*_requests`` for the baseline
    optimizers); every round, each pending task's next batch is evaluated
    and the generator advanced, tasks ordered by signature.

    With ``align_signatures=True`` (default) each workload's prime axis
    is padded up to the largest bucket among its same-ndims peers, and a
    group with any structured-density member runs on the structured
    evaluator, so the group shares ONE signature (the padding primes are
    1.0 and numerically inert).

    With ``stack_batches=True`` every round concatenates all
    same-signature pending batches into one padded mega-batch and issues
    a single dispatch per signature (``torch_cost.eval_stacked``),
    slicing the results back per task; rows run the same per-row
    arithmetic either way, so stacked and per-task dispatch give
    bit-identical results.

    With ``device_rounds=k > 1`` tasks whose method is segment-foldable
    (``baselines.SEGMENT_METHODS``) advance in k-generation device
    segments (``torch_cost.run_segments``: same-signature same-shape
    segments stacked into one dispatch), and the host syncs once per
    segment for ``_Budget`` accounting and history.  Other methods keep
    the per-round path and mixed fleets interleave both.
    ``device_rounds=None`` resolves from the device
    (:func:`default_device_rounds`: 4 on a GPU, 1 on the CPU); ``stats``
    record the value and its provenance.  ``device_execute=False`` forces
    the host-loop reference path: each segment is answered with ``None``
    and the generator replays the identical plan per round on the host
    (bit-identical trajectories).

    With ``pipeline=True`` (default) segment results come back deferred
    and are resolved one round late by the request generators, and
    stacked mega-batches are dispatched for ALL signature groups before
    any is finalized, so the host's conversions overlap the device's
    work; ``pipeline=False`` blocks earlier and is bit-identical by
    construction.  ``stats["host_blocked_s"]`` records the host time
    spent waiting for device results either way.

    ``device`` is the device every evaluator of the fleet runs on
    (``None`` means the GPU and raises where there is none).  After
    :meth:`run`, ``stats`` holds the weighted round count, host sync
    count, dispatch count, and the aligned and natural signature sets.
    Duplicate resolved task names get ``#k`` suffixes (``name#0``,
    ``name#1``, ...), so no two tasks ever share a results key.
    """

    def __init__(self, tasks: Iterable,
                 config: Optional[FleetConfig] = None, *,
                 device: DeviceLike = None):
        norm: List[SearchTask] = [self._as_task(t) for t in tasks]
        if not norm:
            raise ValueError("MultiSearch needs at least one task")
        if config is None:
            config = FleetConfig()
        self.device = resolve_device(device)
        self.tasks = norm
        self.config = config
        # resolved views (one resolution point: FleetConfig)
        self.align_signatures = config.align_signatures
        self.stack_batches = config.stack_batches
        self.pad_policies = dict(config.pad_policies)
        self.device_rounds, self.device_rounds_source = \
            config.resolved_device_rounds(self.device)
        self.device_execute = config.device_execute
        self.pipeline = config.pipeline
        self.compile_ahead = config.compile_ahead
        self.final_names: List[str] = self._resolve_names(norm)
        self.stats: Dict = {}
        self._started = False

    @staticmethod
    def _as_task(t) -> SearchTask:
        if isinstance(t, SearchTask):
            return t
        if isinstance(t, Workload):
            return SearchTask(t)
        return SearchTask(*t)

    def _pad_policy(self, topology_fingerprint: str) -> PadPolicy:
        if topology_fingerprint in self.pad_policies:
            return self.pad_policies[topology_fingerprint]
        return pad_policy_for(topology_fingerprint)

    @staticmethod
    def _resolve_names(tasks: Sequence[SearchTask]) -> List[str]:
        base = [t.resolved_name() for t in tasks]
        dup = {n for n, c in Counter(base).items() if c > 1}
        taken = set(base)       # every base name reserves its spot
        next_k: Dict[str, int] = {}
        names = []
        for n in base:
            if n not in dup:
                names.append(n)
                continue
            k = next_k.get(n, 0)
            while f"{n}#{k}" in taken:  # don't collide with explicit names
                k += 1
            next_k[n] = k + 1
            taken.add(f"{n}#{k}")
            names.append(f"{n}#{k}")
        return names

    @staticmethod
    def _advance(st: _TaskState, out) -> bool:
        """Send an evaluation to a task's generator; False when done."""
        try:
            st.req = st.gen.send(out)
            return True
        except StopIteration as stop:
            st.extras = stop.value or {}
            return False

    def _method_kw(self, task: SearchTask) -> Dict:
        kw = dict(task.method_kw)
        if self.device_rounds > 1 and task.method in SEGMENT_METHODS:
            # segment-foldable engines fold k generations per segment; an
            # explicit per-task device_rounds wins over the fleet's
            kw.setdefault("device_rounds", self.device_rounds)
        return kw

    def _task_infos(self) -> List[Tuple]:
        """One signature-aligned (task, method_kw, spec, evaluator) tuple
        per task; builds evaluators but starts no request generator."""
        naturals = [(t.workload.ndims,
                     _bucket(max(len(t.workload.prime_factors), 1)))
                    for t in self.tasks]
        pad_for: Dict[int, int] = {}
        # density-mode alignment, in the spirit of prime-axis padding: if
        # any same-ndims peer declares a structured density model, the
        # whole group runs on the structured evaluator, so a mixed
        # uniform/banded/N:M fleet still shares one signature
        structured_for: Dict[int, bool] = {}
        if self.align_signatures:
            for (d, bucket), t in zip(naturals, self.tasks):
                pad_for[d] = max(pad_for.get(d, 0), bucket)
                structured_for[d] = structured_for.get(d, False) or \
                    t.workload.structured_density
        # kept for mid-run admission: a task admitted later aligns UP to
        # the group's current bucket/density mode
        self._pad_for = pad_for
        self._structured_for = structured_for

        infos: List[Tuple] = []
        for task, natural in zip(self.tasks, naturals):
            n_pad = pad_for.get(natural[0]) if self.align_signatures \
                else None
            if n_pad == natural[1]:
                n_pad = None        # natural bucket: share the plain entry
            spec, ev = get_evaluator(
                task.workload, _platform(task.platform), n_pad=n_pad,
                structured=structured_for.get(natural[0], False),
                device=self.device)
            infos.append((task, self._method_kw(task), spec, ev))
        return infos

    def start(self) -> None:
        """Build evaluators and prime every task's request generator — the
        fleet is then live and :meth:`step` advances it one driver
        iteration at a time.  Idempotent; :meth:`run` is ``start(); while
        step(): pass; finish()``."""
        if self._started:
            return
        self._started = True
        infos = self._task_infos()
        states: List[_TaskState] = []
        for (task, kw, spec, ev), name in zip(infos, self.final_names):
            gen, tracker = make_requests(task.method, spec,
                                         _platform(task.platform),
                                         task.budget, task.seed,
                                         **{**kw, **task.runtime_kw})
            states.append(_TaskState(
                name=name, gen=gen, tracker=tracker, ev=ev,
                natural=(task.workload.ndims,
                         _bucket(max(len(task.workload.prime_factors),
                                     1))),
                method=task.method))
        self._blocked0 = torch_cost.host_blocked_s()
        # group same-signature tasks (and, when stacking, one mega-batch);
        # stable within a signature
        states.sort(key=lambda s: s.signature)
        self._states = states
        self._alive: List[_TaskState] = []
        self._done: List[str] = []
        for st in states:
            try:
                st.req = next(st.gen)
                self._alive.append(st)
            except StopIteration as stop:
                st.extras = stop.value or {}
                self._done.append(st.name)
        self._pad_hwm: Dict[Tuple, int] = {}
        self._pad_recent: Dict[Tuple, List[Tuple[int, int]]] = {}
        self._wm_hist: Dict[Tuple, List[int]] = {}
        self._rounds = 0     # weighted generation clock (k per segment)
        self._host_syncs = 0   # driver loop iterations (host roundtrips)
        self._seg_syncs = 0    # iterations that device-advanced segments
        self._seg_rounds = 0   # generation rounds covered by those
        self._dispatch0 = torch_cost.dispatch_count()

    def admit(self, task, name: Optional[str] = None) -> str:
        """Admit one more task into the RUNNING fleet: it aligns UP to its
        signature group's current prime bucket and density mode and joins
        the group's mega-batch on the next :meth:`step`.  Returns the
        resolved (collision-suffixed) task name."""
        task = self._as_task(task)
        self.start()
        wl = task.workload
        d = wl.ndims
        bucket = _bucket(max(len(wl.prime_factors), 1))
        n_pad = None
        structured = False
        if self.align_signatures:
            self._pad_for[d] = max(self._pad_for.get(d, 0), bucket)
            self._structured_for[d] = \
                self._structured_for.get(d, False) or \
                wl.structured_density
            n_pad = self._pad_for[d]
            structured = self._structured_for[d]
            if n_pad == bucket:
                n_pad = None
        plat = _platform(task.platform)
        spec, ev = get_evaluator(wl, plat, n_pad=n_pad,
                                 structured=structured, device=self.device)
        base = name or task.resolved_name()
        resolved, k = base, 0
        while resolved in self.final_names:
            resolved = f"{base}#{k}"
            k += 1
        gen, tracker = make_requests(task.method, spec, plat,
                                     task.budget, task.seed,
                                     **{**self._method_kw(task),
                                        **task.runtime_kw})
        st = _TaskState(name=resolved, gen=gen, tracker=tracker, ev=ev,
                        natural=(d, bucket), method=task.method)
        self.tasks.append(task)
        self.final_names.append(resolved)
        self._states.append(st)
        try:
            st.req = next(st.gen)
            self._alive.append(st)
        except StopIteration as stop:
            st.extras = stop.value or {}
            self._done.append(st.name)
        return resolved

    @property
    def done(self) -> bool:
        """True once every task (initial + admitted) has retired."""
        return self._started and not self._alive

    def pop_done(self) -> List[Tuple[str, SearchResult]]:
        """Drain the retirement queue: ``(name, result)`` for every task
        that finished since the last call."""
        out = [(n, self.result_of(n)) for n in self._done]
        self._done = []
        return out

    def result_of(self, name: str) -> SearchResult:
        """The (possibly in-flight) result of one task by resolved name —
        retired tasks get their final result, live tasks a best-so-far
        snapshot."""
        for st in self._states:
            if st.name == name:
                return self._result_for(st)
        raise KeyError(f"no task named {name!r}; have "
                       f"{self.final_names}")

    def step(self) -> bool:
        """One driver iteration: advance segmented tasks by k generations
        and per-round tasks by 1 (mega-batched per signature).  Retired
        tasks land in the :meth:`pop_done` queue.  Returns True while any
        task is still alive.

        The pad floor (mega-batch watermark) grows to the largest padded
        round immediately and decays to the recent maximum after
        ``decay_rounds`` consecutive rounds each needing at most
        ``decay_ratio`` of the current shape (a per-topology
        :class:`PadPolicy`); the trajectory lands in
        ``stats["pad_watermarks"]``.  Observations are weighted by the
        rounds the fleet clock advanced, so one observation per k-round
        segment counts as k quiet rounds."""
        self.start()
        alive = self._alive
        if not alive:
            return False
        pending: List[_TaskState] = []
        seg_states = [st for st in alive
                      if isinstance(st.req, DeviceSegment)]
        plain = [st for st in alive
                 if not isinstance(st.req, DeviceSegment)]
        # the fleet's round clock moves by the largest stride taken
        iter_weight = 0
        if seg_states and self.device_execute:
            seg_groups: Dict[Tuple, List[_TaskState]] = {}
            for st in seg_states:
                key = st.signature + segment_shape_key(st.req)
                seg_groups.setdefault(key, []).append(st)
            for key in sorted(seg_groups):
                grp = seg_groups[key]
                iter_weight = max(iter_weight, grp[0].req.rounds)
                # with pipeline=True the SegmentResults come back
                # unresolved: the generators stash them, yield the NEXT
                # segment from the device-resident carry, and only then
                # resolve this one
                segres = torch_cost.run_segments(
                    [s.ev for s in grp], [s.req for s in grp],
                    defer=self.pipeline)
                for st, res in zip(grp, segres):
                    if self._advance(st, res):
                        pending.append(st)
        elif seg_states:
            # host-loop reference path: the generator replays the
            # identical pre-drawn plan per round (its next yield is a
            # plain batch, so the task rejoins the per-round path)
            for st in seg_states:
                if self._advance(st, None):
                    pending.append(st)
        if seg_states and self.device_execute:
            self._seg_syncs += 1
            self._seg_rounds += iter_weight
        if plain:
            iter_weight = max(iter_weight, 1)
        if self.stack_batches:
            groups: Dict[Tuple, List[_TaskState]] = {}
            for st in plain:
                groups.setdefault(st.signature, []).append(st)
            # two phases: FIRST dispatch every signature group's
            # mega-batch (deferred with pipeline=True, so all groups'
            # work is queued together), THEN finalize + advance in the
            # same sorted order.  The watermark bookkeeping depends only
            # on row counts, so pipeline on/off cannot change a shape.
            dispatched: List[Tuple[List[_TaskState], object]] = []
            for sig in sorted(groups):
                grp = groups[sig]
                pol = self._pad_policy(sig[2])
                hwm = self._pad_hwm.get(sig, 0)
                outs = torch_cost.eval_stacked(
                    [s.ev for s in grp], [s.req for s in grp],
                    pad_floor=hwm, defer=self.pipeline)
                dispatched.append((grp, outs))
                target = torch_cost._pad_batch(
                    sum(len(s.req) for s in grp))
                hist = self._pad_recent.setdefault(sig, [])
                hist.append((target, max(iter_weight, 1)))
                wtot = sum(w for _, w in hist)
                while hist and wtot - hist[0][1] >= pol.decay_rounds:
                    wtot -= hist.pop(0)[1]
                if target > hwm:
                    self._pad_hwm[sig] = target
                    hist.clear()
                elif wtot >= pol.decay_rounds and \
                        all(t <= hwm * pol.decay_ratio for t, _ in hist):
                    self._pad_hwm[sig] = max(t for t, _ in hist)
                    hist.clear()
                self._wm_hist.setdefault(sig, []).append(
                    self._pad_hwm[sig])
            for grp, outs in dispatched:
                if isinstance(outs, torch_cost.StackedPending):
                    outs = outs.finalize()
                for st, out in zip(grp, outs):
                    if self._advance(st, out):
                        pending.append(st)
        else:
            for st in plain:
                if self._advance(st, st.ev(st.req)):
                    pending.append(st)
        live = {id(st) for st in pending}
        for st in alive:
            if id(st) not in live:
                self._done.append(st.name)
        self._alive = pending
        self._rounds += iter_weight
        self._host_syncs += 1
        return bool(self._alive)

    @staticmethod
    def _result_for(st: _TaskState) -> SearchResult:
        extras = dict(st.extras or {})
        extras["signature"] = st.signature
        extras["natural_signature"] = st.natural
        extras.setdefault("method", st.method)
        extras.setdefault("arch", st.ev.arch)
        return SearchResult(
            best_edp=st.tracker.best,
            best_genome=st.tracker.best_genome,
            history=np.asarray(st.tracker.hist),
            evals=st.tracker.evals,
            valid_evals=st.tracker.valid,
            extras=extras)

    def stats_snapshot(self) -> Dict:
        """The fleet stats as of now — same shape as the final ``stats``,
        computable mid-run."""
        self.start()
        # host_syncs_per_round: 1.0 for per-round fleets; for segmented
        # fleets the steady-state metric is over the segment phase (the
        # HSHI/calibration prologue is host-driven, so the whole-run ratio
        # can never reach 1/k)
        hspr = (self._seg_syncs / self._seg_rounds) if self._seg_rounds \
            else (self._host_syncs / self._rounds if self._rounds
                  else 1.0)
        return dict(
            rounds=self._rounds,
            host_syncs=self._host_syncs,
            host_syncs_per_round=hspr,
            device_rounds=self.device_rounds,
            device_rounds_source=self.device_rounds_source,
            pipeline=self.pipeline,
            compile_ahead=self.compile_ahead,
            compile_ahead_hits=0,
            compile_ahead_misses=0,
            host_blocked_s=torch_cost.host_blocked_s() - self._blocked0,
            devices=1,
            device=str(self.device),
            dispatches=torch_cost.dispatch_count() - self._dispatch0,
            signatures=sorted({s.signature for s in self._states}),
            natural_signatures=sorted({s.natural for s in self._states}),
            # per-signature mega-batch watermark trajectory + the policy
            # that produced it, keyed "d{ndims}_p{bucket}_{topology}"
            pad_watermarks={
                f"d{sig[0]}_p{sig[1]}_{sig[2]}": hist
                for sig, hist in self._wm_hist.items()},
            pad_policies={
                sig[2]: dataclasses.asdict(self._pad_policy(sig[2]))
                for sig in self._wm_hist})

    def finish(self) -> Dict[str, SearchResult]:
        """Freeze ``stats`` and return every task's result keyed by
        resolved name."""
        self.stats = self.stats_snapshot()
        return {st.name: self._result_for(st) for st in self._states}

    def run(self) -> Dict[str, SearchResult]:
        self.start()
        while self.step():
            pass
        return self.finish()


def run_sweep(workloads: Sequence[Workload],
              platform: PlatformLike = "cloud",
              budget: int = 20_000, seed: int = 0,
              align_signatures: bool = True, stack_batches: bool = False,
              device_rounds: Optional[int] = None, pipeline: bool = True,
              config: Optional[FleetConfig] = None,
              device: DeviceLike = None,
              **es_kw) -> Dict[str, SearchResult]:
    """One concurrent SparseMap search per workload (e.g. the paper's
    Table III list) on a shared platform, on ``device``.  An explicit
    ``config`` wins over the individual fleet kwargs."""
    if config is None:
        config = FleetConfig(
            align_signatures=align_signatures,
            stack_batches=stack_batches, device_rounds=device_rounds,
            pipeline=pipeline)
    ms = MultiSearch(
        [SearchTask(wl, platform, budget=budget, seed=seed,
                    method_kw=dict(es_kw)) for wl in workloads],
        config, device=device)
    return ms.run()


def run_method_sweep(methods: Sequence[str],
                     workloads: Sequence[Workload],
                     platform: PlatformLike = "cloud",
                     budget: int = 20_000, seed: int = 0,
                     align_signatures: bool = True,
                     stack_batches: bool = True,
                     method_kw: Optional[Dict[str, Dict]] = None,
                     stats_out: Optional[Dict] = None,
                     device_rounds: Optional[int] = None,
                     device_execute: bool = True, pipeline: bool = True,
                     config: Optional[FleetConfig] = None,
                     device: DeviceLike = None
                     ) -> Dict[str, Dict[str, SearchResult]]:
    """The full fig17-style grid — every method on every workload — as ONE
    concurrent :class:`MultiSearch` fleet on ``device``, mega-batched per
    signature by default.  Returns ``{method: {workload_name:
    SearchResult}}``; ``method_kw`` maps method name -> factory kwargs;
    ``stats_out``, if given, receives the fleet's ``MultiSearch.stats``."""
    method_kw = method_kw or {}
    dup_m = [m for m, c in Counter(methods).items() if c > 1]
    dup_w = [n for n, c in Counter(w.name for w in workloads).items()
             if c > 1]
    if dup_m or dup_w:
        # the returned {method: {workload_name: ...}} grid would silently
        # drop one of the colliding searches — refuse instead
        raise ValueError(
            f"run_method_sweep needs unique methods and workload names; "
            f"duplicated methods={dup_m}, workload names={dup_w}")
    tasks = [SearchTask(wl, platform, budget=budget, seed=seed, method=m,
                        method_kw=dict(method_kw.get(m, {})))
             for m in methods for wl in workloads]
    if config is None:
        config = FleetConfig(
            align_signatures=align_signatures,
            stack_batches=stack_batches, device_rounds=device_rounds,
            device_execute=device_execute, pipeline=pipeline)
    ms = MultiSearch(tasks, config, device=device)
    flat = ms.run()
    grid: Dict[str, Dict[str, SearchResult]] = {m: {} for m in methods}
    i = 0
    for m in methods:
        for wl in workloads:
            grid[m][wl.name] = flat[ms.final_names[i]]
            i += 1
    if stats_out is not None:
        stats_out.update(ms.stats)
    return grid
