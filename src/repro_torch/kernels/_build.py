"""Builds the CUDA sources under ``csrc/`` into shared libraries at first
use and loads them with ``ctypes``.

Every ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` takes seconds per file.  All sources are compiled together, one
``nvcc`` process each, into ``_build/<hash>/lib<name>.so``; the hash covers
every file under ``csrc/`` and the compiler flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built or looked for
when this module is imported: a machine without ``nvcc`` or a GPU can
import the whole package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the kernel routes, by the numbers the C entry points know them by
#: (``enum { ROUTE_FMA, ROUTE_WMMA, ROUTE_WGMMA }`` in every source)
ROUTES = {"fma": 0, "wmma": 1, "wgmma": 2}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """A CUDA source did not compile, or there is no compiler."""


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Path:
    """Compile every source that has no library yet, all at once; returns
    the build directory.  Raises :class:`KernelBuildError` with the
    compiler's output on failure."""
    out = build_dir()
    todo = [s for s in sources()
            if not (out / f"lib{s.stem}.so").is_file()]
    if not todo:
        return out
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.tmp{os.getpid()}"
        log = open(out / f"{src.stem}.log", "w")
        procs.append((src, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"lib{src.stem}.so")
        else:
            tmp.unlink(missing_ok=True)
            failed.append(
                f"{src.name} (exit {rc}):\n"
                + (out / f"{src.stem}.log").read_text()[-4000:])
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building every
    source first if needed."""
    with _LOCK:
        if name not in _LIBS:
            if not (CSRC / f"{name}.cu").is_file():
                raise KernelBuildError(f"no CUDA source csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        return _LIBS[name]
