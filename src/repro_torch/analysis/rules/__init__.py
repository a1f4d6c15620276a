"""The port's contract rule set.  ``ALL_RULES`` lists the AST rules the
lint engine runs per file; R5 (registry conformance) is runtime
reflection — see
:func:`repro_torch.analysis.rules.r5_registry.check_registries`.  The
reference's R1 (traced-value baking) has no AST counterpart here: the
port's kernels are traced by :mod:`repro_torch.analysis.graph_audit`.
"""
from .r2_rng import RngDeterminismRule
from .r3_deferred_sync import DeferredSyncRule
from .r4_counter_lock import CounterLockRule
from .r5_registry import check_registries

ALL_RULES = [RngDeterminismRule, DeferredSyncRule, CounterLockRule]

__all__ = ["ALL_RULES", "RngDeterminismRule", "DeferredSyncRule",
           "CounterLockRule", "check_registries"]
