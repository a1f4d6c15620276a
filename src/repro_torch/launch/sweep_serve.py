"""Search-as-a-service: the persistent sweep server, on PyTorch.

A long-lived process that accepts streaming (workload, arch, density,
method, budget) queries over a local TCP socket, admits them MID-FLIGHT
into one running ``MultiSearch`` fleet — same-signature queries from
different clients coalesce into one mega-batch round, so the marginal
cost of one more query is rows in an already-dispatched batch — and
streams best-so-far (genome, EDP, round) updates back per client.

    PYTHONPATH=src python -m repro_torch.launch.serve sweep --port 7333 \
        --checkpoint-dir /tmp/sweeps                  # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve sweep --device cpu
    PYTHONPATH=src python examples/sweep_client_torch.py --port 7333 \
        --arch cloud --m 256 --k 256 --n 256 --density 0.3,0.4

Wire protocol (JSON lines; COMPAT.md "Sweep server protocol", the JAX
package's ``repro.launch.sweep_serve`` speaks the same): a query is
exactly a serialized ``SearchTask`` (``SearchTask.to_json_dict``) plus an
optional ``FleetConfig`` fragment that must agree with the server's;
replies are ``{"ok": ...}`` then ``{"event": "update"|"done", ...}``
lines.  A client of either package talks to a server of either package.
Bad arch names come back with ``UnknownArchError``'s close-match hints
instead of killing the server.  Two fields of ``stats`` read differently
from the reference's: ``compilations`` is always 0 (eager PyTorch
compiles nothing), and the ``signature_groups`` keys join this package's
4-part signature (ndims, prime bucket, topology, density key).

The server runs every search on one device, resolved once at
construction (``device=None`` means the GPU and raises where there is
none).  CUDA work happens only on the worker thread that owns the fleet;
the TCP handler threads parse JSON, validate arch names and read host
counters.

Durability: with ``--checkpoint-dir``, live populations checkpoint every
k fleet rounds (``checkpoint.save_flat`` — atomic staging-dir commit)
from the ``state_out`` captures the ES generators refresh at the top of
every generation, and a crashed worker (or a fresh server process
pointed at the same directory) restores from the latest checkpoint with
BIT-IDENTICAL resume at fixed seeds: the resumed trajectory equals the
uninterrupted one.  Checkpointing requires the fleet to resolve
``device_rounds == 1`` — device segments keep populations on the device
with no generation-boundary capture — so on the GPU, where the default
is 4, a server with a checkpoint directory needs ``device_rounds=1``.

Completed queries feed a content-keyed :class:`GenomeLibrary` of best
genomes keyed on (workload cache-key, topology fingerprint, density
mode); a later query with the same key warm-starts from the library
winner as seeded initial-population rows.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import socketserver
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint import checkpoint as ckpt_lib
from ..core.arch import UnknownArchError, as_arch
from ..core.baselines import RESUMABLE_METHODS, WARM_START_METHODS
from ..core.evolution import snapshot_tracker_hist
from ..core.search import (FleetConfig, MultiSearch, SearchTask,
                           SearchResult)
from ..core.sensitivity import SensitivityResult
from ..device import DeviceLike, resolve_device
from ..runtime.fault_tolerance import Supervisor


# ---------------------------------------------------------------- library


def library_key(task: SearchTask) -> Tuple:
    """The warm-start content key: (workload cache-key, topology
    fingerprint, density mode).  Content-derived — two clients that
    serialize the same query land on the same key — and alignment-free,
    so a library entry recorded under one fleet composition warm-starts
    the same query under any other (genome length depends only on
    (workload, topology), never on fleet padding)."""
    arch = as_arch(task.platform)
    mode = "structured" if task.workload.structured_density else "uniform"
    return (task.workload.cache_key(), arch.topology.fingerprint, mode)


class GenomeLibrary:
    """Content-keyed best-genome store feeding warm starts.  Thread-safe;
    keeps the single lowest-EDP genome per key."""

    def __init__(self):
        self._best: Dict[Tuple, Tuple[float, np.ndarray]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def record(self, task: SearchTask, result: SearchResult) -> None:
        if result.best_genome is None or not np.isfinite(result.best_edp):
            return
        key = library_key(task)
        with self._lock:
            prev = self._best.get(key)
            if prev is None or result.best_edp < prev[0]:
                self._best[key] = (float(result.best_edp),
                                   np.asarray(result.best_genome,
                                              dtype=np.int64).copy())

    def lookup(self, task: SearchTask) -> Optional[np.ndarray]:
        """Warm rows for a query, or None.  Counts hit/miss (only called
        for warm-eligible methods, so the ratio is meaningful)."""
        key = library_key(task)
        with self._lock:
            entry = self._best.get(key)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            return entry[1][None, :].copy()

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        size=len(self._best))


# ------------------------------------------------- fleet state packing


def pack_fleet(ms: MultiSearch) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Flatten a running fleet into (arrays, meta) for
    ``checkpoint.save_flat``.  Live resumable tasks (ES family,
    ``state_out`` captured) pack their pre-draw generation state;
    everything else is recorded as task JSON only and restarts from
    scratch on restore — still bit-identical at fixed seeds, since every
    task's trajectory is row-deterministic regardless of fleet
    composition (mega-batch stacking is bit-exact per row)."""
    name2task = dict(zip(ms.final_names, ms.tasks))
    arrays: Dict[str, np.ndarray] = {}
    entries: List[Dict] = []
    for st in ms._states:
        if st.extras is not None:
            continue                    # retired: already streamed out
        task = name2task[st.name]
        entry = task.to_json_dict()
        entry["_name"] = st.name
        cap = None
        if task.method in RESUMABLE_METHODS:
            cap = task.runtime_kw.get("state_out", {}).get("resume")
        entry["_resumable"] = cap is not None
        if cap is not None:
            cap = snapshot_tracker_hist(st.tracker, cap)
            t = cap["tracker"]
            pfx = f"t{len(entries):03d}/"
            arrays[pfx + "pop"] = cap["pop"]
            arrays[pfx + "edp"] = cap["edp"]
            arrays[pfx + "ints"] = np.array(
                [cap["gen"], cap["since_improve"], cap["total_gens"],
                 t["evals"], t["valid"]], dtype=np.int64)
            arrays[pfx + "floats"] = np.array(
                [cap["last_best"], t["best"]], dtype=np.float64)
            arrays[pfx + "rng"] = np.frombuffer(
                json.dumps(cap["rng_state"]).encode(), dtype=np.uint8)
            arrays[pfx + "hist"] = np.asarray(t["hist"], dtype=np.float64)
            if t["best_genome"] is not None:
                arrays[pfx + "best_genome"] = t["best_genome"]
            sens = cap["sens"]
            entry["_sens"] = sens is not None
            if sens is not None:
                arrays[pfx + "sens_scores"] = np.asarray(sens.scores)
                arrays[pfx + "sens_mask"] = np.asarray(sens.high_mask)
                arrays[pfx + "sens_pool"] = np.asarray(sens.valid_pool)
                arrays[pfx + "sens_scalars"] = np.array(
                    [float(sens.threshold), float(sens.evals_used)],
                    dtype=np.float64)
        entries.append(entry)
    meta = {"config": ms.config.to_json_dict(), "tasks": entries,
            "round": ms._rounds}
    return arrays, meta


def restore_fleet(arrays: Dict[str, np.ndarray], meta: Dict,
                  device: DeviceLike = None) -> Optional[MultiSearch]:
    """Rebuild a fleet on ``device`` from a ``pack_fleet`` checkpoint.
    Returns None when every task had already retired (nothing to
    resume)."""
    if not meta["tasks"]:
        return None
    tasks = []
    for i, entry in enumerate(meta["tasks"]):
        entry = dict(entry)
        name = entry.pop("_name")
        resumable = entry.pop("_resumable", False)
        has_sens = entry.pop("_sens", False)
        task = SearchTask.from_json(entry)
        task.name = name                 # preserve collision suffixes
        task.runtime_kw["state_out"] = {}
        if resumable:
            pfx = f"t{i:03d}/"
            ints = arrays[pfx + "ints"]
            floats = arrays[pfx + "floats"]
            sens = None
            if has_sens:
                ss = arrays[pfx + "sens_scalars"]
                sens = SensitivityResult(
                    scores=arrays[pfx + "sens_scores"],
                    high_mask=arrays[pfx + "sens_mask"],
                    valid_pool=arrays[pfx + "sens_pool"],
                    threshold=float(ss[0]), evals_used=int(ss[1]))
            bg = arrays.get(pfx + "best_genome")
            task.runtime_kw["resume_state"] = dict(
                rng_state=json.loads(
                    arrays[pfx + "rng"].tobytes().decode()),
                pop=arrays[pfx + "pop"], edp=arrays[pfx + "edp"],
                gen=int(ints[0]), since_improve=int(ints[1]),
                total_gens=int(ints[2]), last_best=float(floats[0]),
                sens=sens,
                tracker=dict(
                    evals=int(ints[3]), valid=int(ints[4]),
                    best=float(floats[1]),
                    best_genome=None if bg is None else bg,
                    hist=arrays[pfx + "hist"].tolist()))
        tasks.append(task)
    config = FleetConfig.from_json(meta["config"])
    return MultiSearch(tasks, config, device=device)


# ---------------------------------------------------------------- server


class _Pending:
    """One admitted-but-unstarted query: the task plus its client's
    event queue (None for orphans resumed from a checkpoint)."""

    def __init__(self, task: SearchTask, events: Optional["deque"]):
        self.task = task
        self.events = events
        self.name: Optional[str] = None


class SweepServer:
    """The persistent sweep service: a worker thread owns the fleet and
    a ThreadingTCPServer feeds it queries.  ``device`` is where every
    fleet runs (``None``: the GPU, raising where there is none).  See the
    module docstring for the protocol and durability contract."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 config: Optional[FleetConfig] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 8,
                 max_restarts: int = 3, warm_start: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config if config is not None else \
            FleetConfig(stack_batches=True, device_rounds=1)
        if ckpt_dir is not None:
            resolved, _ = self.config.resolved_device_rounds(self.device)
            if resolved != 1:
                raise ValueError(
                    "checkpointing requires device_rounds == 1 (device "
                    "segments keep populations device-resident with no "
                    "generation-boundary capture); pass device_rounds=1 "
                    "or disable --checkpoint-dir")
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.max_restarts = int(max_restarts)
        self.warm_start = bool(warm_start)
        self.library = GenomeLibrary()
        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._shutdown = threading.Event()
        self._fleet_lock = threading.Lock()
        self._ms: Optional[MultiSearch] = None
        self._events: Dict[str, deque] = {}
        self._events_lock = threading.Lock()
        self._last_best: Dict[str, float] = {}
        self._stats = dict(queries=0, completed=0, rejected=0, epochs=0,
                           restarts=0, warm_started=0, checkpoints=0,
                           checkpoint_bytes=0, checkpoint_pack_s=0.0,
                           checkpoint_s=0.0)
        self._last_fleet_stats: Dict = {}
        self._round0 = 0
        self._last_groups: Dict[str, int] = {}
        self._epoch_groups: List[Dict[str, int]] = []

        srv = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                srv._handle(self)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _Server((host, port), _Handler)
        self.host, self.port = self._tcp.server_address[:2]
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="sweep-worker", daemon=True)

    # ------------------------------------------------------------ lifecycle

    def serve_forever(self) -> None:
        self._worker.start()
        try:
            self._tcp.serve_forever(poll_interval=0.1)
        finally:
            self.stop()

    def start_background(self) -> None:
        """Start worker + acceptor threads and return (tests)."""
        self._worker.start()
        threading.Thread(target=self._tcp.serve_forever,
                         kwargs=dict(poll_interval=0.1),
                         daemon=True).start()

    def stop(self) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        with self._cond:
            self._cond.notify_all()
        self._tcp.shutdown()
        self._tcp.server_close()
        self._worker.join(timeout=30)

    # ------------------------------------------------------------- protocol

    def _handle(self, h: socketserver.StreamRequestHandler) -> None:
        line = h.rfile.readline()
        if not line:
            return
        try:
            msg = json.loads(line.decode())
        except ValueError:
            self._reply(h, {"ok": False, "error": "malformed JSON line"})
            return
        op = msg.get("op")
        if op == "stats":
            self._reply(h, {"ok": True, "stats": self.stats()})
        elif op == "shutdown":
            self._reply(h, {"ok": True, "stopping": True})
            threading.Thread(target=self.stop, daemon=True).start()
        elif op == "submit":
            self._handle_submit(h, msg)
        else:
            self._reply(h, {"ok": False,
                            "error": f"unknown op {op!r}; have "
                                     f"submit / stats / shutdown"})

    def _handle_submit(self, h, msg: Dict) -> None:
        try:
            if "config" in msg and msg["config"] is not None:
                frag = FleetConfig.from_json(msg["config"])
                if frag != self.config:
                    raise ValueError(
                        f"query FleetConfig fragment disagrees with the "
                        f"server's: {frag.to_json()} != "
                        f"{self.config.to_json()}")
            task = SearchTask.from_json(msg["task"])
            as_arch(task.platform)      # validate NOW, not mid-fleet
        except UnknownArchError as e:
            # close-match hints travel to the client; the server lives on
            self._stats["rejected"] += 1
            self._reply(h, {"ok": False, "error": str(e),
                            "unknown_arch": True})
            return
        except (KeyError, ValueError, TypeError) as e:
            self._stats["rejected"] += 1
            self._reply(h, {"ok": False, "error": f"{e}"})
            return
        events: deque = deque()
        pend = _Pending(task, events)
        ready = threading.Event()
        pend.ready = ready
        with self._cond:
            self._stats["queries"] += 1
            self._pending.append(pend)
            self._cond.notify_all()
        ready.wait(timeout=300)
        self._reply(h, {"ok": True, "id": pend.name})
        # stream events until done
        while not self._shutdown.is_set():
            if events:
                ev = events.popleft()
                self._reply(h, ev)
                if ev.get("event") in ("done", "failed"):
                    return
            else:
                with self._cond:
                    self._cond.wait(timeout=0.05)

    @staticmethod
    def _reply(h, obj: Dict) -> None:
        try:
            h.wfile.write((json.dumps(obj) + "\n").encode())
            h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass                        # client went away; fleet lives on

    # --------------------------------------------------------------- worker

    def _worker_loop(self) -> None:
        # orphan recovery: a fresh server process pointed at the
        # checkpoint dir of a crashed one resumes its in-flight fleet
        # (results feed the library; the dead clients' streams are gone)
        if self.ckpt_dir is not None and \
                ckpt_lib.latest_step(self.ckpt_dir) is not None:
            self._run_epoch([])
        while not self._shutdown.is_set():
            with self._cond:
                while not self._pending and not self._shutdown.is_set():
                    self._cond.wait(timeout=0.1)
                if self._shutdown.is_set():
                    return
                batch = [self._pending.popleft()
                         for _ in range(len(self._pending))]
            self._run_epoch(batch)

    def _prepare(self, pend: _Pending) -> SearchTask:
        """Runtime-kw plumbing for one query, idempotent across crash
        re-admissions (the warm-start lookup is counted once; the
        state_out capture dict is always fresh)."""
        task = pend.task
        task.runtime_kw = dict(task.runtime_kw)
        task.runtime_kw.pop("resume_state", None)   # stale after crash
        if task.method in RESUMABLE_METHODS and self.ckpt_dir is not None:
            task.runtime_kw["state_out"] = {}
        if self.warm_start and task.method in WARM_START_METHODS and \
                not getattr(pend, "prepared", False):
            rows = self.library.lookup(task)
            if rows is not None:
                task.runtime_kw["warm_seeds"] = rows
                self._stats["warm_started"] += 1
        pend.prepared = True
        return task

    def _wipe_checkpoints(self) -> None:
        """A cleanly-finished epoch's checkpoints are spent — remove
        them so the next epoch (and the next server process) starts
        fresh instead of resuming ghosts."""
        if self.ckpt_dir is None or not os.path.isdir(self.ckpt_dir):
            return
        for d in os.listdir(self.ckpt_dir):
            if d.startswith("step_"):
                shutil.rmtree(os.path.join(self.ckpt_dir, d),
                              ignore_errors=True)

    def _run_epoch(self, batch: List[_Pending]) -> None:
        """One fleet lifetime: build (or restore) the fleet, drive it to
        completion under a crash supervisor, stream per-client events,
        checkpoint every k rounds."""
        self._stats["epochs"] += 1
        by_name: Dict[str, _Pending] = {}
        epoch_pends: List[_Pending] = list(batch)
        sup = Supervisor(self.ckpt_dir or "", ckpt_every=self.ckpt_every,
                         max_restarts=self.max_restarts)

        def wire(p: _Pending, name: str) -> None:
            p.name = name
            by_name[name] = p
            self._last_best.setdefault(name, float("inf"))
            if p.events is not None:
                with self._events_lock:
                    self._events[name] = p.events
            if getattr(p, "ready", None) is not None:
                p.ready.set()

        def admit_all(ms: Optional[MultiSearch],
                      pends: List[_Pending]) -> Optional[MultiSearch]:
            if ms is None and pends:
                # fresh epoch: one fleet from the whole batch — names
                # resolve at construction, so every client learns its id
                # before start() builds evaluators and primes the tasks
                tasks = [self._prepare(p) for p in pends]
                ms = MultiSearch(tasks, self.config, device=self.device)
                for p, name in zip(pends, ms.final_names):
                    wire(p, name)
                ms.start()
            elif ms is not None:
                for p in pends:
                    wire(p, ms.admit(self._prepare(p)))
            return ms

        def make_state(step: Optional[int]) -> MultiSearch:
            ms = None
            round0 = 0
            if step is not None and self.ckpt_dir is not None:
                arrays, meta = ckpt_lib.load_flat(self.ckpt_dir, step)
                ms = restore_fleet(arrays, meta, device=self.device)
                if ms is not None:
                    ms.start()
                    # a restored fleet's own round clock starts at 0: the
                    # epoch's rounds go on from the checkpoint's
                    round0 = int(meta["round"])
            with self._fleet_lock:
                self._round0 = round0
                # re-admit every epoch query the checkpoint doesn't
                # carry: on first build that is all of them; after a
                # crash, only those admitted since the last save (they
                # restart from scratch — deterministic, so the epoch's
                # final results are unchanged)
                have = set(ms.final_names) if ms is not None else set()
                missing = [p for p in epoch_pends
                           if p.name is None or p.name not in have]
                ms = admit_all(ms, missing)
                if ms is None:
                    raise RuntimeError("no tasks to run")
                self._ms = ms
            return ms

        def step_fn(ms: MultiSearch, s: int) -> bool:
            with self._cond:
                newcomers = [self._pending.popleft()
                             for _ in range(len(self._pending))]
            epoch_pends.extend(newcomers)
            with self._fleet_lock:
                admit_all(ms, newcomers)
                alive = ms.step()
                self._emit_updates(ms)
            return not alive

        def save_fn(ms: MultiSearch, s: int) -> None:
            if self.ckpt_dir is None or ms.done:
                return
            t0 = time.perf_counter()
            with self._fleet_lock:
                arrays, meta = pack_fleet(ms)
            self._stats["checkpoint_pack_s"] += time.perf_counter() - t0
            # numbered by the epoch's round, so a checkpoint written after
            # a restore is the newest one and is not pruned at once
            meta["round"] = self._epoch_round(ms)
            t0 = time.perf_counter()
            path = ckpt_lib.save_flat(self.ckpt_dir, meta["round"], arrays,
                                      extra_meta=meta)
            self._stats["checkpoint_s"] += time.perf_counter() - t0
            self._stats["checkpoints"] += 1
            self._stats["checkpoint_bytes"] += sum(
                e.stat().st_size for e in os.scandir(path))

        try:
            # first-build happens inside run_loop's make_state; on a
            # crash mid-epoch the supervisor rebuilds from the latest
            # checkpoint (bit-identical resume) up to max_restarts times
            ms, report = sup.run_loop(make_state, step_fn, save_fn)
            self._stats["restarts"] += report["restarts"]
        except Exception as e:          # noqa: BLE001 — surface to clients
            self._stats["restarts"] += sup.restarts
            for name, p in by_name.items():
                if p.events is not None:
                    p.events.append({"event": "failed", "id": name,
                                     "error": f"{e}"})
            with self._cond:
                self._cond.notify_all()
            self._ms = None
            return
        with self._fleet_lock:
            ms.finish()
            self._last_fleet_stats = dict(ms.stats)
            self._last_groups = self._signature_groups(ms)
            self._epoch_groups.append(dict(self._last_groups))
            # wipe BEFORE streaming the final events: a client that acts
            # on "done" (or a test that lists the directory) must never
            # see spent checkpoints from an epoch that completed cleanly
            self._wipe_checkpoints()
            self._emit_updates(ms)
            self._ms = None

    def _emit_updates(self, ms: MultiSearch) -> None:
        for name, res in ms.pop_done():
            self._stats["completed"] += 1
            task = dict(zip(ms.final_names, ms.tasks))[name]
            self.library.record(task, res)
            with self._events_lock:
                q = self._events.pop(name, None)
            if q is not None:
                q.append({
                    "event": "done", "id": name,
                    "best_edp": float(res.best_edp),
                    "best_genome": None if res.best_genome is None
                    else np.asarray(res.best_genome).tolist(),
                    "evals": int(res.evals),
                    "valid_evals": int(res.valid_evals),
                    "round": self._epoch_round(ms)})
        for st in ms._alive:
            best = float(st.tracker.best)
            if best < self._last_best.get(st.name, float("inf")):
                self._last_best[st.name] = best
                with self._events_lock:
                    q = self._events.get(st.name)
                if q is not None:
                    bg = st.tracker.best_genome
                    q.append({
                        "event": "update", "id": st.name,
                        "best_edp": best,
                        "best_genome": None if bg is None
                        else np.asarray(bg).tolist(),
                        "evals": int(st.tracker.evals),
                        "round": self._epoch_round(ms)})
        with self._cond:
            self._cond.notify_all()

    def _epoch_round(self, ms: MultiSearch) -> int:
        """The epoch's round: the fleet's own clock plus the round of the
        checkpoint it was restored from."""
        return self._round0 + int(ms._rounds)

    # ---------------------------------------------------------------- stats

    @staticmethod
    def _signature_groups(ms: MultiSearch) -> Dict[str, int]:
        groups: Dict[str, int] = {}
        for st in ms._states:
            sig = "_".join(str(x) for x in st.signature)
            groups[sig] = groups.get(sig, 0) + 1
        return groups

    def stats(self) -> Dict:
        out = dict(self._stats)
        out["library"] = self.library.snapshot()
        out["compilations"] = 0         # eager PyTorch compiles nothing
        with self._fleet_lock:
            ms = self._ms
            if ms is not None and ms._started:
                out["fleet"] = ms.stats_snapshot()
                out["signature_groups"] = self._signature_groups(ms)
            elif self._last_fleet_stats:
                # the most recent completed epoch's evidence: its stats
                # and how its tasks grouped by evaluator signature
                out["fleet"] = dict(self._last_fleet_stats)
                out["signature_groups"] = dict(self._last_groups)
        out["epoch_signature_groups"] = [dict(g)
                                         for g in self._epoch_groups]
        fleet = out.get("fleet")
        if fleet and fleet.get("rounds"):
            out["dispatches_per_round"] = \
                fleet["dispatches"] / fleet["rounds"]
        return out


# ---------------------------------------------------------------- client


def request(host: str, port: int, msg: Dict, timeout: float = 600.0):
    """Send one op and yield reply lines until the stream closes (a
    submit yields update events then the done event; stats/shutdown
    yield one line).  The examples client and the tests both drive the
    server through this."""
    with socket.create_connection((host, port), timeout=timeout) as sk:
        f = sk.makefile("rwb")
        f.write((json.dumps(msg) + "\n").encode())
        f.flush()
        for line in f:
            yield json.loads(line.decode())


def submit(host: str, port: int, task: SearchTask,
           config: Optional[FleetConfig] = None, timeout: float = 600.0):
    """Submit one query; yields its event stream."""
    msg = {"op": "submit", "task": task.to_json_dict()}
    if config is not None:
        msg["config"] = config.to_json_dict()
    return request(host, port, msg, timeout=timeout)


# ------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve sweep",
        description="Persistent sweep server: coalesces concurrent "
                    "(workload, arch, density, method, budget) queries "
                    "into one mega-batched MultiSearch fleet, streams "
                    "best-so-far results, checkpoints populations and "
                    "survives worker crashes.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on start)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="enable population checkpoints + crash "
                         "recovery (requires device_rounds=1)")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="fleet rounds between checkpoints")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--no-warm-start", action="store_true",
                    help="disable the best-genome warm-start library")
    ap.add_argument("--device-rounds", type=int, default=1)
    ap.add_argument("--no-stack", action="store_true",
                    help="disable mega-batch stacking (debug)")
    ap.add_argument("--device", default=None,
                    help="torch device every search runs on; default: "
                         "the GPU (required)")
    args = ap.parse_args(argv)

    config = FleetConfig(stack_batches=not args.no_stack,
                         device_rounds=args.device_rounds)
    server = SweepServer(args.host, args.port, config=config,
                         ckpt_dir=args.checkpoint_dir,
                         ckpt_every=args.checkpoint_every,
                         max_restarts=args.max_restarts,
                         warm_start=not args.no_warm_start,
                         device=args.device)
    print(f"sweep serve listening on {server.host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    print("sweep serve stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
