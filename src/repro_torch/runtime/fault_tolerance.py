"""Fault tolerance + straggler mitigation for the training runtime and
the sweep server (the JAX package's ``repro.runtime.fault_tolerance``,
over this package's torch checkpoints).

Everything here is exercised by tests on a single host (failure
injection via exceptions):

* **StepMonitor** — per-step wall-time EWMA; flags stragglers when a step
  exceeds ``straggler_factor`` x the EWMA, and records slow-step history
  (the controller escalates: log -> re-shard data feed -> evict host).
* **Supervisor.run** — the crash-safe outer loop: catches step failures,
  restores the latest checkpoint, rebuilds the data iterator at the
  restored step (the deterministic pipeline makes this exact) and
  continues; gives up after ``max_restarts``.
* **ElasticPlan** — given a shrunken/grown device set, recompute the mesh
  shape and per-host data shards; leaves are stored whole, so a
  checkpoint restores onto any device set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint import checkpoint as ckpt_lib


@dataclasses.dataclass
class StepMonitor:
    ewma_alpha: float = 0.1
    straggler_factor: float = 2.5
    warmup_steps: int = 3
    ewma_s: float = 0.0
    n: int = 0
    stragglers: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        """Record a step duration; True if it was a straggler step."""
        self.n += 1
        if self.n <= self.warmup_steps:
            self.ewma_s = dt_s if self.ewma_s == 0.0 else \
                0.5 * (self.ewma_s + dt_s)
            return False
        is_slow = dt_s > self.straggler_factor * self.ewma_s
        if is_slow:
            self.stragglers.append((step, dt_s))
        else:
            self.ewma_s = (1 - self.ewma_alpha) * self.ewma_s + \
                self.ewma_alpha * dt_s
        return is_slow

    @property
    def straggler_rate(self) -> float:
        return len(self.stragglers) / max(self.n - self.warmup_steps, 1)


@dataclasses.dataclass
class ElasticPlan:
    """Mesh + data-shard plan for a given healthy-host count."""
    n_hosts: int
    data_parallel: int
    model_parallel: int

    @classmethod
    def plan(cls, n_devices: int, model_parallel: int = 16
             ) -> "ElasticPlan":
        """Largest (data x model) mesh fitting the healthy devices; model
        parallel degree is fixed by the model's sharding, data shrinks."""
        dp = n_devices // model_parallel
        if dp < 1:
            raise RuntimeError(
                f"{n_devices} devices cannot host model_parallel="
                f"{model_parallel}")
        return cls(n_hosts=dp * model_parallel, data_parallel=dp,
                   model_parallel=model_parallel)

    def host_shard(self, host_idx: int) -> Tuple[int, int]:
        return (host_idx % self.data_parallel, self.data_parallel)


class Supervisor:
    """Crash-safe training loop: checkpoint/restore + bounded restarts."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 100,
                 max_restarts: int = 3, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.keep_last = keep_last
        self.monitor = StepMonitor()
        self.restarts = 0

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int,
            restore_fn: Optional[Callable[[int, Any], Any]] = None
            ) -> Tuple[Any, Dict]:
        """Run ``n_steps`` of ``step_fn(state, step) -> state``.

        ``state`` is a torch state dict.  On exception: restore the
        latest checkpoint (via ``restore_fn``, or ``checkpoint.restore``
        into the current state's structure, devices and dtypes) and
        continue from there.  Returns (final_state, report).
        """
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is not None:
            state = (restore_fn or self._default_restore)(step, state)
            start = step + 1
        else:
            start = 0

        s = start
        while s < n_steps:
            try:
                t0 = time.time()
                state = step_fn(state, s)
                self.monitor.observe(s, time.time() - t0)
                if (s + 1) % self.ckpt_every == 0 or s == n_steps - 1:
                    ckpt_lib.save(self.ckpt_dir, s, state,
                                  keep_last=self.keep_last)
                s += 1
            except Exception as e:      # noqa: BLE001 — supervised retry
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"giving up after {self.max_restarts} restarts"
                    ) from e
                last = ckpt_lib.latest_step(self.ckpt_dir)
                if last is None:
                    s = 0               # restart from scratch
                    continue
                state = (restore_fn or self._default_restore)(last, state)
                s = last + 1
        report = dict(restarts=self.restarts,
                      straggler_rate=self.monitor.straggler_rate,
                      mean_step_s=self.monitor.ewma_s)
        return state, report

    def _default_restore(self, step: int, state: Any) -> Any:
        return ckpt_lib.restore(self.ckpt_dir, step, state)

    def run_loop(self, make_state: Callable[[Optional[int]], Any],
                 step_fn: Callable[[Any, int], bool],
                 save_fn: Callable[[Any, int], None]) -> Tuple[Any, Dict]:
        """The :meth:`run` shape generalized for open-ended supervised
        loops whose state is NOT a fixed-shape state dict — the sweep
        server's fleet, for example, whose populations/histories change
        shape every round and which finishes by its own predicate rather
        than a step count.

        ``make_state(step)`` builds (or rebuilds) the loop state — from
        scratch when ``step`` is None, else from that checkpoint;
        ``step_fn(state, step) -> done`` advances one step;
        ``save_fn(state, step)`` checkpoints (called every
        ``ckpt_every`` steps and once at completion).  On exception the
        state is REBUILT via ``make_state(latest_step)`` — bounded by
        ``max_restarts`` like :meth:`run`."""
        state = make_state(ckpt_lib.latest_step(self.ckpt_dir))
        s = 0
        while True:
            try:
                t0 = time.time()
                done = step_fn(state, s)
                self.monitor.observe(s, time.time() - t0)
                if done or (s + 1) % self.ckpt_every == 0:
                    save_fn(state, s)
                if done:
                    break
                s += 1
            except Exception as e:  # noqa: BLE001 — supervised retry
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"giving up after {self.max_restarts} restarts"
                    ) from e
                state = make_state(ckpt_lib.latest_step(self.ckpt_dir))
        report = dict(restarts=self.restarts,
                      straggler_rate=self.monitor.straggler_rate,
                      mean_step_s=self.monitor.ewma_s)
        return state, report
