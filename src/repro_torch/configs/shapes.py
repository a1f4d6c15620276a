"""Assigned input shapes and (arch x shape) applicability.

    train_4k     seq_len=4,096   global_batch=256   lowers train_step
    prefill_32k  seq_len=32,768  global_batch=32    lowers prefill
    decode_32k   seq_len=32,768  global_batch=128   lowers serve_step
    long_500k    seq_len=524,288 global_batch=1     lowers serve_step

``long_500k`` requires sub-quadratic attention: run for SSM/hybrid/
local-global archs (xlstm, zamba2, gemma3), skipped for pure
full-attention archs (DESIGN.md §4).  No encoder-only archs are assigned,
so decode shapes apply everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .archs import ARCHS, get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode" | "long_decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}

LONG_CONTEXT_ARCHS = {"xlstm-350m", "gemma3-12b", "zamba2-2.7b"}


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    get_config(arch)            # validates the arch name
    sh = SHAPES[shape]
    if sh.kind == "long_decode" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(needs sub-quadratic attention; DESIGN.md §4)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) cell with its applicability verdict."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, why = applicable(a, s)
            out.append((a, s, ok, why))
    return out
