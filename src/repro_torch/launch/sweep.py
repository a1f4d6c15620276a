"""The dry-run sweep, the counterpart of the JAX package's
``launch/sweep.py``: every (arch x shape x mesh) cell in its own
subprocess of ``python -m repro_torch.launch.dryrun``, one after another
(one pathological cell cannot take the sweep down), each appending its
JSONL record.  Resumable: a cell whose record in the file is ``ok`` or
``skipped`` is not run again.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --jsonl benchmarks/dryrun_torch.jsonl [--timeout 2400] \\
        [--only-mesh 16x16|2x16x16]

Cells run in sorted arch order, each arch's shapes in ``SHAPES`` order,
``16x16`` before ``2x16x16``.  A cell whose subprocess exits non-zero, or
outlives ``--timeout`` seconds, gets an ``error`` record (``rc=N`` or
``timeout Ns``, with the tail of its stderr).  One progress line a cell.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Set, Tuple

MESHES = (("16x16", []), ("2x16x16", ["--multi-pod"]))


def existing_keys(path: str) -> Set[Tuple[str, str, str]]:
    """The (arch, shape, mesh) cells of ``path`` whose record is ``ok`` or
    ``skipped``."""
    keys = set()
    if not os.path.exists(path):
        return keys
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") in ("ok", "skipped"):
                keys.add((r["arch"], r["shape"], r["mesh"]))
    return keys


def cells(only_mesh: Optional[str] = None) -> List[Tuple[str, str, str,
                                                         List[str]]]:
    """Every (arch, shape, mesh, dryrun flags) cell in the sweep's order."""
    from ..configs import ARCHS, SHAPES
    return [(a, s, mesh, flag) for a in sorted(ARCHS) for s in SHAPES
            for mesh, flag in MESHES if only_mesh in (None, mesh)]


def _tail(text: Optional[str]) -> str:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return (text or "")[-1500:]


def _append(path: str, rec: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--jsonl", required=True)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--only-mesh", choices=[m for m, _ in MESHES],
                    default=None)
    args = ap.parse_args(argv)

    done = existing_keys(args.jsonl)
    todo = [c for c in cells(args.only_mesh) if c[:3] not in done]
    print(f"{len(todo)} cells to run ({len(done)} already done)",
          flush=True)
    for i, (a, s, mesh, flag) in enumerate(todo):
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--jsonl", args.jsonl] + flag
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            status = "ok" if r.returncode == 0 else "err"
            if r.returncode != 0:
                _append(args.jsonl, dict(
                    arch=a, shape=s, mesh=mesh, status="error",
                    error=f"rc={r.returncode}", stderr=_tail(r.stderr)))
        except subprocess.TimeoutExpired as e:
            status = "timeout"
            _append(args.jsonl, dict(
                arch=a, shape=s, mesh=mesh, status="error",
                error=f"timeout {args.timeout}s", stderr=_tail(e.stderr)))
        print(f"[{i + 1}/{len(todo)}] {a} {s} {mesh}: {status} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
