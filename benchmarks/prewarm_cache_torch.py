"""Pre-build the port's CUDA kernels, the counterpart of
``benchmarks/prewarm_cache.py``.

The JAX package pre-warms XLA's persistent compilation cache; the port
compiles no XLA, and what it builds ahead of a timed run is its kernels:
every ``src/repro_torch/kernels/csrc/*.cu`` into
``kernels/_build/<hash>/`` (``kernels._build.build_all``, one ``nvcc``
process a source, all started together).  A kernel nobody pre-built is
still built at its first launch.

    PYTHONPATH=src python -m benchmarks.prewarm_cache_torch

Prints the build directory, the number of objects in it and the seconds
the build took; exits 0 when everything was already built.  Without
``nvcc`` it raises ``KernelBuildError``, which names the compiler.
"""
from __future__ import annotations

import time
from typing import Dict


def prewarm() -> Dict:
    """Build every kernel source not built yet: ``{"dir", "objects",
    "sources", "seconds", "cached"}`` (``cached``: nothing was built)."""
    from repro_torch.kernels import _build
    out = _build.build_dir()
    srcs = _build.sources()
    cached = all((out / f"lib{s.stem}.so").is_file() for s in srcs)
    t0 = time.perf_counter()
    out = _build.build_all()
    return dict(dir=str(out), objects=len(list(out.glob("lib*.so"))),
                sources=len(srcs), seconds=time.perf_counter() - t0,
                cached=cached)


def main() -> int:
    rep = prewarm()
    state = "already built" if rep["cached"] else "built"
    print(f"prewarmed {rep['objects']} kernel objects ({state}) into "
          f"{rep['dir']} in {rep['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
