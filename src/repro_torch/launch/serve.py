"""Serving entry point: sweep-serving now, decode-serving once the LM
substrate is ported.

Modes, dispatched on the first argument:

* ``sweep`` — the persistent sweep server
  (:mod:`repro_torch.launch.sweep_serve`): accepts streaming (workload,
  arch, density, method, budget) queries over a local socket, coalesces
  same-signature queries into shared mega-batch rounds, streams
  best-so-far results, checkpoints populations and survives crashes.

      PYTHONPATH=src python -m repro_torch.launch.serve sweep \\
          --port 7333 --checkpoint-dir /tmp/sweeps --device-rounds 1
      PYTHONPATH=src python -m repro_torch.launch.serve sweep --device cpu

* ``decode`` — the batched LLM serving loop of the JAX package
  (``repro.launch.serve decode``).  It runs the LM substrate, which this
  package does not have yet (ROADMAP Queue 1 item 9): ``decode``, and
  bare flags with no mode word (which mean decode in the reference), exit
  non-zero saying so.
"""
from __future__ import annotations

import sys

MODES = ("decode", "sweep")

_USAGE = """\
usage: python -m repro_torch.launch.serve <mode> [mode options]

modes:
  sweep    persistent accelerator-search sweep server (query coalescing,
           checkpointed populations, crash recovery); options: --host
           --port --checkpoint-dir --checkpoint-every --max-restarts
           --no-warm-start --device-rounds --no-stack --device
  decode   NOT PORTED YET: the batched LLM serving loop needs the LM
           substrate (ROADMAP Queue 1 item 9); use the JAX package's
           `python -m repro.launch.serve decode` meanwhile

`sweep --help` shows the sweep server's full options.
"""

_DECODE_NOT_PORTED = (
    "serve decode is not ported to repro_torch yet: it runs the LM "
    "substrate, ROADMAP Queue 1 item 9; the JAX package's "
    "`python -m repro.launch.serve decode` has it")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sweep"]:
        from . import sweep_serve
        return sweep_serve.main(argv[1:])
    if argv[:1] in (["-h"], ["--help"]):
        print(_USAGE)
        return 0
    # ``decode`` and bare legacy flags (which mean decode)
    print(_DECODE_NOT_PORTED, file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
