"""Helpers shared by the tests that hold the PyTorch port
(``repro_torch``) against the JAX package (``repro``)."""
import numpy as np

#: |dlog10_edp| <= LG_TOL * max(|log10_edp|, 1): the tolerance the
#: reference uses between its float64 numpy oracle and its float32
#: evaluator (tests/test_cost_agreement.py)
LG_TOL = 2e-3
#: validity may differ only within this relative capacity margin
CAP_MARGIN = 5e-3


class Recorder:
    """Wraps an evaluator and keeps every (request, output) pair.  It has
    no ``run_segment`` method, so device segments replay on the host."""

    def __init__(self, ev):
        self.ev = ev
        self.batches = []

    def __call__(self, genomes):
        out = self.ev(genomes)
        self.batches.append((np.array(genomes, copy=True),
                             {k: np.array(v, copy=True)
                              for k, v in out.items()}))
        return out


def lg_close(a, b):
    """Element-wise: log10-EDPs agree at the reference's tolerance."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) <= LG_TOL * np.maximum(np.abs(b), 1.0)


def within_capacity_margin(rep, arch) -> bool:
    """Whether an oracle report sits within the razor-thin relative
    margin of some capacity limit (float32 vs float64 may then disagree
    on validity, in either direction)."""
    margins = [1.0]
    for _, sname, cap in arch.capacity_stores:
        if sname in rep.occupancy_bytes:
            margins.append(abs(rep.occupancy_bytes[sname] - cap) / cap)
    return min(margins) < CAP_MARGIN
