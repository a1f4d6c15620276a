"""The CPU's vector math, first called in fresh processes.

On the CPU ``torch.cos`` goes through MKL's vector math, whose first call
from several OpenMP threads at once can return low-accuracy values (torch
2.13 with MKL: the first ``cos`` of 4,160 fp32 angles up to 519 rad was
up to 1.5e-4 off in about 1 of 30–60 fresh processes, and accurate from
the second call on).  In a sharded parity run the rank it hit rotated its
queries otherwise than the world of one did, and the gradients of every
leaf moved 2e-5 to 6e-5 apart: the fault seen now and then in the
tensor-parallel and MoE parity cases.  Importing ``layers`` calls each of
its ``CPU_VECTOR_MATH`` functions once, on one element, on the importing
thread, which initialises the vector math for the process.

The first test checks that call in a fresh process, and fails without
it.  The second is a probe: ``PROCESSES`` fresh processes (8 threads
each, 2,048 positions: 16,384 angles, 8 chunks of the CPU's vectorised
loop) apply RoPE twice to the same queries, and the first result must be
the second's bit for bit; without the initialisation about 1 in 30 such
processes read the first ``cos`` wrong, so the probe alone shows the
fault only now and then.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from repro_torch.models import layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: fresh processes of the probe, 2 at a time
PROCESSES = 12

SPY = """
import json, threading
import torch
calls = []
for name in {names}:
    def spy(t, *a, _real=getattr(torch, name), _name=name, **k):
        calls.append([_name, t.numel(), t.device.type,
                      threading.current_thread() is threading.main_thread()])
        return _real(t, *a, **k)
    setattr(torch, name, spy)
from repro_torch.models import layers
print(json.dumps(calls))
"""

PROBE = """
import torch
torch.set_num_threads(8)
from repro_torch.models import layers
g = torch.Generator().manual_seed(0)
x = torch.randn((1, 2048, 1, 16), generator=g)
pos = torch.arange(2048)[None, :]
first = layers.{fn}(x, pos, 1e6)
second = layers.{fn}(x, pos, 1e6)
print(int((first != second).sum()), float((first - second).abs().max()))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300,
                          check=True).stdout


def _probe(fn):
    n, worst = _run(PROBE.format(fn=fn)).split()
    return int(n), float(worst)


def test_the_first_rope_in_a_fresh_process_is_the_second():
    """``apply_rope`` and ``apply_m_rope``, each the first RoPE of its
    process, give the same rotated queries as their second call, in
    every one of ``PROCESSES`` fresh processes."""
    fns = ["apply_rope", "apply_m_rope"] * (PROCESSES // 2)
    with ThreadPoolExecutor(max_workers=2) as pool:
        got = list(pool.map(_probe, fns))
    bad = [(fn, n, w) for fn, (n, w) in zip(fns, got) if n]
    assert bad == [], bad


def test_rope_initialises_the_cpu_trig_first():
    """In a fresh process, importing ``layers`` calls each of its vector
    math functions (RoPE's ``cos`` and ``sin`` among them) on one CPU
    element, on the importing thread, before any other call of it."""
    names = [f.__name__ for f in layers.CPU_VECTOR_MATH]
    assert {"cos", "sin"} <= set(names)
    calls = json.loads(_run(SPY.format(names=names)).splitlines()[-1])
    first = {}
    for name, n, device, main in calls:
        first.setdefault(name, (n, device, main))
    assert first == {name: (1, "cpu", True) for name in names}, calls
