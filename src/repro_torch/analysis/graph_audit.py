"""Layer 2 — the graph audit: run and trace every registered evaluator
family and one generation of a device segment, and assert the contracts
the AST linter cannot see.  The counterpart of the JAX package's R1 rule
and ``jaxpr_audit.py``, for eager PyTorch.

For each registered topology (uniform and structured-density evaluator
variants; fractional-NoC schemes and per-edge word widths ride in the
arch zoo's registered specs) and for the segment generation
(``torch_cost._SegmentBlock.step``: selection, crossover, mutation,
clip, evaluation; the structured, stagnation-restart and ``standard_es``
direct forms on one representative topology), it asserts:

* **no host sync** — the program runs eagerly on ``meta`` tensors (a
  device that, like a GPU, is not the host and, unlike it, has no
  data) under a dispatch mode that sees every aten op: an
  ``aten._local_scalar_dense`` (``.item()``, ``float()``, ``int()``,
  ``bool()`` of a device value), a copy to the CPU (``.cpu()``,
  ``.to("cpu")``), or any op that needs the data on the host
  (``.numpy()``, ``.tolist()``, boolean-mask indexing, ``nonzero``)
  fails there, and is a finding;
* **no float64** — no op of the program outputs float64, except inside
  the functions of :data:`FLOAT64_ALLOWED`, by name: ``torch_cost._pow``
  computes float32 ``pow`` in float64 on purpose, so a row's result does
  not depend on where it sits in the batch on the CPU;
* **one graph per family** — the same program traced on CPU tensors
  from two same-structure / different-numbers specs (every numeric field
  of the arch perturbed) must give the same canonical graph.  The trace
  is the one ``make_fx`` records — every aten op, its literal arguments,
  its constants by value, its data flow — taken by a dispatch mode
  during an eager run (:func:`trace`), at a fifth of ``make_fx``'s cost.
  A number baked into the program surfaces as a differing literal or
  constant and fails the comparison;
* **a hash per family** — the canonical graph's hash, recorded in
  ``BENCH_sweep_torch.json`` so drift across PRs shows in review.

Findings are :class:`repro_torch.analysis.lint.Violation` rows with rule
id ``GRAPH``, so both layers share one report format.  A family that
cannot be run or traced is a finding too, never dropped.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .lint import Violation

RULE_ID = "GRAPH"

#: (file suffix, function name) whose ops may output float64
FLOAT64_ALLOWED = (("repro_torch/core/torch_cost.py", "_pow"),)

#: batch rows and segment shape used for tracing (shapes only)
_TRACE_B = 8
_SEG = dict(k=2, n_parents=2, n_elite=1, genes_per=2)

_META = torch.device("meta")
_CPU = torch.device("cpu")


# ---------------------------------------------------------- the checks


def _in_allowed_frame() -> bool:
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        for suffix, name in FLOAT64_ALLOWED:
            if f.f_code.co_name == name and path.endswith(suffix):
                return True
        f = f.f_back
    return False


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class _AuditMode(TorchDispatchMode):
    """Sees every aten op of an eager run and notes host syncs and
    float64 outputs."""

    def __init__(self):
        super().__init__()
        self.found: List[str] = []

    def _note(self, msg: str) -> None:
        if msg not in self.found:
            self.found.append(msg)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = f"aten.{func.overloadpacket.__name__}"
        ins = _tensors(args) + _tensors(kwargs)
        off_host = any(t.device.type != "cpu" for t in ins)
        if func is torch.ops.aten._local_scalar_dense.default:
            self._note(f"host sync: {name} (`.item()`, `float()`, "
                       f"`int()` or `bool()` of a device value)")
        elif off_host and torch.device(kwargs.get("device") or
                                       "meta").type == "cpu":
            self._note(f"host sync: {name} copies a device value to "
                       f"the CPU (`.cpu()` / `.to('cpu')`)")
        elif func is torch.ops.aten.copy_.default and \
                args[0].device.type == "cpu" and off_host:
            self._note(f"host sync: {name} into a CPU tensor")
        out = func(*args, **kwargs)
        if any(t.dtype == torch.float64 for t in _tensors(out)) and \
                not _in_allowed_frame():
            self._note(f"float64 output of {name} outside "
                       f"{', '.join(n for _, n in FLOAT64_ALLOWED)} — "
                       f"the contract dtype is float32")
        return out


def audit_run(fn: Callable, args: Sequence, family: str
              ) -> List[Violation]:
    """Run ``fn(*args)`` (tensors on ``meta``) under the audit mode and
    report every host sync and stray float64 as a finding; an op that
    fails for want of data on the host is a host sync too."""
    mode = _AuditMode()
    try:
        with mode:
            fn(*args)
    except Exception as e:          # the program needed host data
        if not mode.found:
            mode.found.append(
                f"host sync: the program needs a device value on the "
                f"host ({type(e).__name__}: {str(e).splitlines()[0]})")
    return [Violation(RULE_ID, f"graph:{family}", 0, m) for m in mode.found]


class _TraceMode(TorchDispatchMode):
    """Records every aten op of an eager run as one line — the op, its
    arguments with each tensor named by where it came from (an input, an
    earlier op's output, or a constant given by shape, dtype and value),
    and the names of its outputs — which is the graph ``make_fx`` would
    record, without building one."""

    def __init__(self, inputs: Sequence[torch.Tensor]):
        super().__init__()
        self.names: Dict[int, str] = {id(t): f"in{i}"
                                      for i, t in enumerate(inputs)}
        self.keep: List[torch.Tensor] = list(inputs)   # ids stay unique
        self.lines: List[str] = []

    def _name(self, t: torch.Tensor) -> str:
        n = self.names.get(id(t))
        if n is None:           # neither an input nor made by an op
            n = self.names[id(t)] = f"c{len(self.names)}"
            self.keep.append(t)
            a = t.detach().contiguous().cpu()
            data = a.view(-1).view(torch.uint8).numpy().tobytes() \
                if a.numel() else b""
            self.lines.append(f"{n} = constant {tuple(a.shape)} {a.dtype} "
                              f"{hashlib.sha1(data).hexdigest()}")
        return n

    def _fmt(self, x) -> str:
        if isinstance(x, torch.Tensor):
            return self._name(x)
        if isinstance(x, (list, tuple)):
            return "[" + ", ".join(self._fmt(v) for v in x) + "]"
        return repr(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        call = ", ".join([self._fmt(a) for a in args] +
                         [f"{k}={self._fmt(v)}"
                          for k, v in sorted(kwargs.items())])
        out = func(*args, **kwargs)
        names = []
        for t in _tensors(out):
            if id(t) not in self.names:         # in place: same tensor
                self.names[id(t)] = f"v{len(self.names)}"
                self.keep.append(t)
            names.append(self.names[id(t)])
        self.lines.append(f"{', '.join(names)} = {func}({call})")
        return out


def trace(fn: Callable, args: Sequence[torch.Tensor]) -> List[str]:
    """The op-level graph of ``fn(*args)`` on CPU tensors, one line per
    aten op (:class:`_TraceMode`)."""
    mode = _TraceMode(args)
    with mode:
        fn(*args)
    return mode.lines


def canonical_hash(lines: Sequence[str]) -> str:
    """Canonical graph hash: tensors are named by trace order, literals
    are printed in place and constants by value, so same-structure /
    different-numbers traces collide iff nothing was baked."""
    h = hashlib.sha1()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


# ------------------------------------------------- family programs


def _base_workload():
    from ..configs.paper_workloads import mm_workloads
    for w in mm_workloads():
        if not w.structured_density:
            return w
    raise RuntimeError("no uniform-density paper workload found")


def _model_for(arch, structured: bool, device=_CPU):
    from ..core.encoding import GenomeSpec
    from ..core.torch_cost import TorchCostModel
    spec = GenomeSpec(_base_workload(), arch)
    return TorchCostModel(spec, arch, structured=True if structured
                          else None, device=device)


def _perturb(spec):
    """Same structure, different numbers: every numeric field of the arch
    scaled by a field-specific factor.  Structure (level count,
    spatial-ness, NoC schemes, energy-group layout, word-bytes
    uniformity) is preserved, so the topology fingerprint — and with it
    the evaluator signature — must not change."""
    from ..core.arch import ArchSpec

    levels = []
    for lv in spec.levels:
        noc = dataclasses.replace(
            lv.noc,
            multicast_fanout=(None if lv.noc.multicast_fanout is None
                              else lv.noc.multicast_fanout * 2),
            reduction_fanout=(None if lv.noc.reduction_fanout is None
                              else lv.noc.reduction_fanout * 2))
        levels.append(dataclasses.replace(
            lv,
            capacity_bytes=(None if lv.capacity_bytes is None
                            else lv.capacity_bytes * 2),
            fill_energy=tuple(
                (nm, tuple(e * 1.3 for e in comps))
                for nm, comps in lv.fill_energy),
            fill_bandwidth_bytes_per_cycle=(
                None if lv.fill_bandwidth_bytes_per_cycle is None
                else lv.fill_bandwidth_bytes_per_cycle * 1.5),
            word_bytes=(None if lv.word_bytes is None
                        else lv.word_bytes * 0.5),
            # the fanout VALUE is a number; spatial-ness (>1) is structure
            fanout=lv.fanout * 2 if lv.fanout > 1 else lv.fanout,
            noc=noc))
    return ArchSpec(spec.name + "+perturbed", tuple(levels),
                    e_mac=spec.e_mac * 1.7, clock_hz=spec.clock_hz)


#: one family's program on one model: a function of tensors only (every
#: number it reads is an input) and those tensors
Program = Tuple[Callable, Tuple[torch.Tensor, ...]]


def eval_program(model) -> Program:
    """The row evaluator as the stacked and segment paths call it: a
    batch of genome rows with per-row workload/arch constants."""
    B = _TRACE_B
    rows = torch.zeros((B, model.layout.Lp), dtype=torch.int64,
                       device=model.device)
    consts = tuple(c.expand(B, *c.shape[1:]).contiguous()
                   for c in model._consts)

    def run(rows, *consts):
        return model.eval_device(rows, consts)
    return run, (rows,) + consts


def _segment(model, kind: str = "es", restart: int = 0):
    from ..core.direct_encoding import DirectValueSpec
    from ..core.es_ops import DeviceSegment
    spec = model.spec
    B, k, gp = _TRACE_B, _SEG["k"], _SEG["genes_per"]
    C = B - _SEG["n_elite"]
    L = spec.length
    aux = None
    if kind == "direct":
        dspec = DirectValueSpec(spec)
        L = dspec.length
        aux = dict(scramble=np.asarray(dspec.scramble, dtype=np.int32),
                   dim_sizes=np.asarray(
                       [spec.workload.dim_sizes[d]
                        for d in spec.workload.dim_order], np.float32))
    draws = dict(ab=np.zeros((k, C, 2), np.int64),
                 cuts=np.ones((k, C), np.int64),
                 active=np.zeros((k, C), bool),
                 gene=np.zeros((k, C, gp), np.int64),
                 vals=np.zeros((k, C, gp), np.int64))
    if restart:
        draws["fresh"] = np.zeros((k, C, L), np.int64)
    return DeviceSegment(
        spec=spec, pop=np.zeros((B, L), np.int64),
        edp=np.ones(B, np.float32), rounds=k, gen0=0,
        n_parents=_SEG["n_parents"], n_elite=_SEG["n_elite"], genes_per=gp,
        draws=draws, kind=kind, aux=aux, restart=restart,
        state=(float("inf"), 0) if restart else None)


def segment_program(model, kind: str = "es", restart: int = 0
                    ) -> Program:
    """One generation of a one-task device segment
    (``torch_cost._SegmentBlock.step``), every tensor of the block an
    input."""
    from ..core import torch_cost
    from ..core.es_ops import segment_shape_key
    seg = _segment(model, kind, restart)
    block = torch_cost._SegmentBlock([model], [seg],
                                     segment_shape_key(seg), 0)
    names, flat = [], []
    for name, v in sorted(vars(block).items()):
        if isinstance(v, torch.Tensor):
            names.append((name, None))
            flat.append(v)
        elif isinstance(v, tuple) and v and \
                all(isinstance(t, torch.Tensor) for t in v):
            names.append((name, len(v)))
            flat.extend(v)

    def run(*tensors):
        b = copy.copy(block)
        it = iter(tensors)
        for name, n in names:
            setattr(b, name, next(it) if n is None else
                    tuple(next(it) for _ in range(n)))
        b.step(0)
        return b.outs()
    return run, tuple(flat)


# --------------------------------------------------------- family sweep


def registered_families() -> Dict[str, object]:
    """One registered arch per topology fingerprint (same-topology
    aliases run identical programs), by name."""
    from .rules.r5_registry import registered_arch_specs
    archs = registered_arch_specs()
    seen: Dict[str, str] = {}
    for name in sorted(archs):
        seen.setdefault(archs[name].topology.fingerprint, name)
    return {name: archs[name] for name in sorted(seen.values())}


def audit_families(archs: Optional[Dict[str, object]] = None,
                   include_scan: bool = True,
                   ) -> Tuple[List[Violation], Dict[str, str]]:
    """Audit every registered family; return ``(findings, hashes)``.
    ``hashes`` maps family label -> canonical graph hash of the base
    trace (recorded in ``BENCH_sweep_torch.json``)."""
    if archs is None:
        archs = registered_families()
    findings: List[Violation] = []
    hashes: Dict[str, str] = {}

    def run(label: str, arch, structured: bool, program) -> None:
        where = f"graph:{label}"
        try:
            base = _model_for(arch, structured)
            pert = _model_for(_perturb(arch), structured)
            findings.extend(audit_run(*program(base.twin(_META)), label))
            h_base = canonical_hash(trace(*program(base)))
            h_pert = canonical_hash(trace(*program(pert)))
        except Exception as e:      # a family that cannot be audited
            findings.append(Violation(
                RULE_ID, where, 0,
                f"could not run or trace the family: "
                f"{type(e).__name__}: {str(e).splitlines()[0]}"))
            return
        hashes[label] = h_base
        if base.signature != pert.signature:
            findings.append(Violation(
                RULE_ID, where, 0,
                f"numeric perturbation changed the evaluator signature "
                f"{base.signature} -> {pert.signature} — a number leaked "
                f"into the structural key"))
        elif h_base != h_pert:
            findings.append(Violation(
                RULE_ID, where, 0,
                f"family sharing violated: same-structure / "
                f"different-numbers traces hash {h_base} vs {h_pert} — "
                f"a spec number is baked into the program instead of "
                f"riding in the parameter vector"))

    for name, arch in archs.items():
        run(f"{name}/u/eval", arch, False, eval_program)
        run(f"{name}/s/eval", arch, True, eval_program)
        if include_scan:
            run(f"{name}/u/scan", arch, False, segment_program)
    if include_scan and archs:
        # the deeper segment forms on one representative topology, the
        # paper's: the structured fold, the stagnation-restart carry and
        # standard_es's translate-in-segment program
        name = "sparsemap" if "sparsemap" in archs else sorted(archs)[0]
        arch = archs[name]
        run(f"{name}/s/scan", arch, True, segment_program)
        run(f"{name}/u/scan_r8", arch, False,
            lambda m: segment_program(m, restart=8))
        run(f"{name}/u/dscan", arch, False,
            lambda m: segment_program(m, kind="direct"))
    return findings, hashes
