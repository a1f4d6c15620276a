"""The sweep server of the PyTorch port (``repro_torch.launch.sweep_serve``,
``repro_torch.launch.serve``), all with ``device="cpu"``: every case of the
JAX package's ``tests/test_sweep_serve.py`` re-aimed at the port —
mid-run admission, ``pop_done``, checkpoint round trip and crash
recovery bit for bit, the ``device_rounds`` refusal, the warm-start
library, protocol errors, the CLI over real sockets — plus the wire as
one protocol: the reference's client drives the port's server, and the
same query through both packages' fleets agrees."""
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port_util import lg_close
from repro.core.search import SearchTask as RefSearchTask
from repro.core.search import FleetConfig as RefFleetConfig
from repro.core.search import MultiSearch as RefMultiSearch
from repro.core.workload import spmm as ref_spmm
from repro.launch import sweep_serve as ref_sweep_serve
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import search as port_search
from repro_torch.core.search import FleetConfig, MultiSearch, SearchTask
from repro_torch.core.workload import spmm
from repro_torch.launch import sweep_serve
from repro_torch.launch.sweep_serve import (GenomeLibrary, SweepServer,
                                            library_key, pack_fleet,
                                            restore_fleet, submit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BUDGET = 800
CFG = FleetConfig(stack_batches=True, device_rounds=1)


def task(name="wa", m=16, seed=5, budget=BUDGET, method="sparsemap",
         platform="cloud"):
    return SearchTask(spmm(name, m, 16, 8, 0.5, 0.5), platform,
                      budget=budget, seed=seed, method=method)


def fleet(tasks, config=CFG):
    return MultiSearch(tasks, config, device=CPU)


def server(**kw):
    kw.setdefault("config", CFG)
    srv = SweepServer(port=0, device=CPU, **kw)
    srv.start_background()
    return srv


def stats_of(srv):
    return next(iter(sweep_serve.request(
        srv.host, srv.port, {"op": "stats"})))["stats"]


def _same_result(a, b, name=""):
    assert b.best_edp == a.best_edp, name
    assert np.array_equal(b.best_genome, a.best_genome), name
    assert np.array_equal(b.history, a.history), name
    assert (b.evals, b.valid_evals) == (a.evals, a.valid_evals), name


# ------------------------------------------------- mid-run admission


def test_admission_coalesces_into_shared_mega_batch():
    """Admit a same-signature task mid-run: from then on the fleet keeps
    issuing ONE dispatch per round (the shared mega-batch), the fleet
    spans one signature, and the admitted task's result equals its solo
    run.  (The reference also counts XLA compilations here; eager
    PyTorch compiles nothing.)"""
    ms = fleet([task("a1", seed=5)])
    ms.start()
    for _ in range(3):
        ms.step()
    d0 = ms.stats_snapshot()["dispatches"]
    r0 = ms.stats_snapshot()["rounds"]
    name = ms.admit(task("a2", seed=6))
    assert name == "a2@cloud"
    while ms.step():
        pass
    results = ms.finish()
    st = ms.stats
    # every post-admission round is one shared dispatch
    assert (st["dispatches"] - d0) == (st["rounds"] - r0), st
    assert len(st["signatures"]) == 1
    assert results["a2@cloud"].best_edp == \
        fleet([task("a2", seed=6)]).run()["a2@cloud"].best_edp


def test_admitted_task_result_matches_solo_run():
    """Coalescing must not perturb trajectories: a task admitted at
    round 3 finishes bit-identical to the same task run alone."""
    solo = fleet([task("adm", seed=9)]).run()["adm@cloud"]
    ms = fleet([task("host_t", seed=5)])
    ms.start()
    for _ in range(3):
        ms.step()
    ms.admit(task("adm", seed=9))
    while ms.step():
        pass
    joined = ms.finish()["adm@cloud"]
    assert joined.best_edp == solo.best_edp
    assert np.array_equal(joined.history, solo.history)


def test_pop_done_and_result_of():
    ms = fleet([task("pd1", budget=300)])
    ms.start()
    while ms.step():
        pass
    done = dict(ms.pop_done())
    assert "pd1@cloud" in done
    assert ms.pop_done() == []          # drained
    assert ms.result_of("pd1@cloud").best_edp == \
        done["pd1@cloud"].best_edp
    with pytest.raises(KeyError):
        ms.result_of("nope")


# --------------------------------------- checkpoint / crash recovery


def _run_tasks():
    out = []
    for nm, m in (("ck_a", 16), ("ck_b", 24)):
        t = task(nm, m=m, seed=5)
        t.runtime_kw["state_out"] = {}
        out.append(t)
    return out


def test_checkpoint_round_trip_is_bit_identical():
    """Save the in-flight fleet at round r, kill it, restore from disk:
    the resumed run's final results equal the uninterrupted run's
    bit-for-bit (best EDP, genome, full history, eval counts)."""
    ref = fleet(_run_tasks()).run()

    ms = fleet(_run_tasks())
    ms.start()
    for _ in range(6):
        ms.step()
    arrays, meta = pack_fleet(ms)
    assert any(e["_resumable"] for e in meta["tasks"])
    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save_flat(d, int(ms._rounds), arrays, extra_meta=meta)
        del ms                          # the "kill"
        arrays2, meta2 = ckpt_lib.load_flat(d, ckpt_lib.latest_step(d))
    resumed = restore_fleet(arrays2, meta2, device=CPU)
    assert resumed.device == torch.device(CPU)
    res = resumed.run()
    for name in ref:
        _same_result(ref[name], res[name], name)


def test_server_recovers_from_worker_crash(monkeypatch):
    """Kill the fleet mid-sweep (injected exception on step call 6,
    after the round-4 checkpoint): the supervisor restores from the
    latest checkpoint and the client still receives the bit-identical
    final best-EDP."""
    ref = fleet([task("cr", seed=5)]).run()["cr@cloud"]

    calls = {"n": 0}
    orig_step = MultiSearch.step

    def crashy(self):
        calls["n"] += 1
        if calls["n"] == 6:
            raise RuntimeError("injected worker crash")
        return orig_step(self)

    monkeypatch.setattr(MultiSearch, "step", crashy)
    with tempfile.TemporaryDirectory() as d:
        srv = server(ckpt_dir=d, ckpt_every=4)
        try:
            evs = list(submit(srv.host, srv.port, task("cr", seed=5)))
            done = [e for e in evs if e.get("event") == "done"]
            st = stats_of(srv)
            assert st["restarts"] == 1
            assert done[0]["best_edp"] == ref.best_edp
            assert done[0]["evals"] == ref.evals
            assert done[0]["best_genome"] == \
                np.asarray(ref.best_genome).tolist()
            assert st["checkpoints"] >= 1 and st["checkpoint_bytes"] > 0
            assert st["compilations"] == 0
            # clean completion wipes the spent checkpoints
            assert not any(x.startswith("step_") for x in os.listdir(d))
        finally:
            srv.stop()


def test_checkpoints_after_a_restore_go_on_from_its_round(monkeypatch):
    """After a restore, the epoch's rounds go on from the checkpoint's: the
    next checkpoint is the newest on disk (not pruned at once as an
    older-numbered one would be) and the ``done`` event's round equals
    the uninterrupted run's."""
    ms_ref = fleet([task("rr", seed=4)])
    ref = ms_ref.run()["rr@cloud"]
    seen = {"n": 0, "after": []}
    orig_step = MultiSearch.step

    def crashy(self):
        seen["n"] += 1
        if seen["n"] == 9:          # after the checkpoints of rounds 2-8
            seen["crashed_at"] = ckpt_lib.latest_step(d)
            raise RuntimeError("injected worker crash")
        alive = orig_step(self)
        if "crashed_at" in seen:
            seen["after"].append(ckpt_lib.latest_step(d))
        return alive

    monkeypatch.setattr(MultiSearch, "step", crashy)
    with tempfile.TemporaryDirectory() as d:
        srv = server(ckpt_dir=d, ckpt_every=2)
        try:
            evs = list(submit(srv.host, srv.port, task("rr", seed=4)))
            st = stats_of(srv)
        finally:
            srv.stop()
    (done,) = [e for e in evs if e.get("event") == "done"]
    assert st["restarts"] == 1 and seen["crashed_at"] == 8
    assert max(s for s in seen["after"] if s is not None) > 8
    assert done["round"] == ms_ref.stats["rounds"]
    assert done["best_edp"] == ref.best_edp


def test_orphaned_checkpoint_is_resumed_by_a_fresh_server():
    """A fresh server pointed at a dead server's checkpoint directory
    resumes the orphaned fleet with no client attached: the library
    ends with the uninterrupted run's best."""
    tasks = _run_tasks()
    ref = fleet(_run_tasks()).run()
    ms = fleet(tasks)
    ms.start()
    for _ in range(5):
        ms.step()
    arrays, meta = pack_fleet(ms)
    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save_flat(d, int(ms._rounds), arrays, extra_meta=meta)
        srv = server(ckpt_dir=d)
        try:
            deadline = time.monotonic() + 120
            while srv._stats["completed"] < 2 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert srv._stats["completed"] == 2
            for t in tasks:
                best = srv.library._best[library_key(t)][0]
                assert best == ref[t.resolved_name()].best_edp
        finally:
            srv.stop()


def test_checkpointing_requires_device_rounds_one():
    with pytest.raises(ValueError, match="device_rounds"):
        SweepServer(port=0, config=FleetConfig(device_rounds=4),
                    ckpt_dir="/tmp/nope", device=CPU)


def test_default_device_rounds_on_a_gpu_refuse_checkpoints(monkeypatch):
    """``device_rounds=None`` resolves from the server's device: 1 on the
    CPU (accepted), 4 on a GPU, where a checkpointing server must refuse
    to start (the GPU's backend is stood in for by name)."""
    cfg = FleetConfig(stack_batches=True)
    with tempfile.TemporaryDirectory() as d:
        server(config=cfg, ckpt_dir=d).stop()
        monkeypatch.setattr(port_search, "_backend", lambda dev: "gpu")
        with pytest.raises(ValueError, match="device_rounds"):
            SweepServer(port=0, config=cfg, ckpt_dir=d, device=CPU)


def test_server_without_a_device_raises_where_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepServer(port=0, config=CFG)


# ------------------------------------------------- warm-start library


def test_library_hit_miss_and_keying():
    lib = GenomeLibrary()
    ta, tb = task("lw", seed=1), task("lw", seed=2)
    assert library_key(ta) == library_key(tb)       # content, not seed
    assert library_key(task("lw", m=24)) != library_key(ta)
    assert lib.lookup(ta) is None and lib.misses == 1

    res = fleet([task("lw", seed=1)]).run()["lw@cloud"]
    assert np.isfinite(res.best_edp)        # budget finds a valid genome
    lib.record(ta, res)
    rows = lib.lookup(tb)
    assert lib.hits == 1
    assert rows.shape == (1, len(res.best_genome))
    assert np.array_equal(rows[0], res.best_genome)
    # worse result does not displace the stored best
    worse = type(res)(best_edp=res.best_edp * 10,
                      best_genome=np.zeros_like(res.best_genome),
                      history=res.history, evals=1, valid_evals=1,
                      extras={})
    lib.record(ta, worse)
    assert np.array_equal(lib.lookup(ta)[0], res.best_genome)


def test_server_warm_starts_repeat_queries():
    srv = server()
    try:
        list(submit(srv.host, srv.port, task("ws", budget=300)))
        list(submit(srv.host, srv.port, task("ws", budget=300)))
        st = stats_of(srv)
        assert st["library"]["hits"] == 1
        assert st["library"]["misses"] == 1
        assert st["warm_started"] == 1
    finally:
        srv.stop()


def test_standard_es_rejects_runtime_kwargs():
    t = task("se", method="standard_es", budget=300)
    t.runtime_kw["warm_seeds"] = np.zeros((1, 4), dtype=np.int64)
    with pytest.raises(ValueError, match="standard_es"):
        fleet([t]).run()


# --------------------------------------------------- protocol errors


def test_unknown_arch_rejected_with_hint_server_survives():
    srv = server()
    try:
        bad = task("ua").to_json_dict()
        bad["platform"] = "clodu"
        evs = list(sweep_serve.request(
            srv.host, srv.port, {"op": "submit", "task": bad}))
        assert not evs[0]["ok"] and evs[0]["unknown_arch"]
        assert "did you mean 'cloud'" in evs[0]["error"]
        # the server is still serving
        evs = list(submit(srv.host, srv.port, task("ua", budget=300)))
        assert any(e.get("event") == "done" for e in evs)
    finally:
        srv.stop()


def test_config_fragment_mismatch_rejected():
    srv = server()
    try:
        msg = {"op": "submit", "task": task("cf").to_json_dict(),
               "config": FleetConfig(stack_batches=False).to_json_dict()}
        evs = list(sweep_serve.request(srv.host, srv.port, msg))
        assert not evs[0]["ok"] and "disagrees" in evs[0]["error"]
    finally:
        srv.stop()


# ------------------------------------------- one wire, two packages


def test_reference_client_drives_the_port_server():
    """The JAX package's ``submit`` with its own ``SearchTask`` and
    ``FleetConfig`` fragment, against the port's server: accepted under
    the same name, and the ``done`` event is the port's own
    ``MultiSearch`` result, bit for bit."""
    want = fleet([task("wire", seed=3)]).run()["wire@cloud"]
    ref_task = RefSearchTask(ref_spmm("wire", 16, 16, 8, 0.5, 0.5), "cloud",
                             budget=BUDGET, seed=3)
    srv = server()
    try:
        evs = list(ref_sweep_serve.submit(
            srv.host, srv.port, ref_task,
            config=RefFleetConfig(stack_batches=True, device_rounds=1)))
    finally:
        srv.stop()
    assert evs[0] == {"ok": True, "id": "wire@cloud"}
    assert any(e.get("event") == "update" for e in evs)
    (done,) = [e for e in evs if e.get("event") == "done"]
    assert done["best_edp"] == want.best_edp
    assert done["best_genome"] == np.asarray(want.best_genome).tolist()
    assert (done["evals"], done["valid_evals"]) == \
        (want.evals, want.valid_evals)


def test_port_client_example_drives_the_port_server(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sweep_client_torch",
        os.path.join(ROOT, "examples", "sweep_client_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    srv = server()
    try:
        rc = mod.main(["--port", str(srv.port), "--m", "16", "--k", "16",
                       "--n", "8", "--density", "0.5,0.5",
                       "--budget", "400"])
        assert rc == 0
        assert mod.main(["--port", str(srv.port), "--stats"]) == 0
    finally:
        srv.stop()
    out = capsys.readouterr().out
    assert "accepted as 'client_query@cloud'" in out
    assert "done: best EDP" in out and '"completed": 1' in out


def test_both_packages_fleets_agree_on_the_same_query():
    """The same small query through both packages' fleets: equal eval
    counts and best log10 EDP within the reference's tolerance."""
    ref = RefMultiSearch(
        [RefSearchTask(ref_spmm("both", 32, 16, 8, 0.5, 0.5), "cloud",
                       budget=BUDGET, seed=7)],
        RefFleetConfig(stack_batches=True, device_rounds=1)).run()
    port = fleet([SearchTask(spmm("both", 32, 16, 8, 0.5, 0.5), "cloud",
                             budget=BUDGET, seed=7)]).run()
    a, b = ref["both@cloud"], port["both@cloud"]
    assert (a.evals, len(a.history)) == (b.evals, len(b.history))
    assert np.isfinite(a.best_edp) and np.isfinite(b.best_edp)
    assert lg_close(np.log10(b.best_edp), np.log10(a.best_edp))


# ------------------------------------------------- subprocess smoke


@pytest.mark.slow
def test_sweep_server_subprocess_smoke(subprocess_env):
    """The acceptance scenario end to end, over real sockets and
    processes: the port's server CLI on the CPU + two concurrent
    same-signature clients + one different-topology client.  The
    same-signature pair must coalesce (their shared signature group holds
    2 tasks; host syncs per round stay 1.0) and shutdown must be clean."""
    env = subprocess_env()
    srv = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "sweep",
         "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        line = srv.stdout.readline()
        assert "listening on" in line, line
        port = int(line.rsplit(":", 1)[1])

        results = {}

        def client(tag, t, delay=0.0):
            time.sleep(delay)
            results[tag] = list(submit("127.0.0.1", port, t))

        threads = [
            threading.Thread(target=client,
                             args=("a", task("sub_a", seed=1))),
            threading.Thread(target=client,
                             args=("b", task("sub_b", seed=2))),
            # different topology => its own signature group
            threading.Thread(target=client,
                             args=("c", task("sub_c", seed=3,
                                             platform="edge"), 0.5)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)

        for tag in ("a", "b", "c"):
            evs = results[tag]
            assert evs[0]["ok"], (tag, evs[0])
            assert any(e.get("event") == "done" for e in evs), (tag, evs)

        st = next(iter(sweep_serve.request(
            "127.0.0.1", port, {"op": "stats"})))["stats"]
        assert st["queries"] == 3 and st["completed"] == 3
        assert st["fleet"]["device"] == "cpu"
        assert any(max(g.values()) >= 2
                   for g in st["epoch_signature_groups"] if g), \
            f"same-signature queries never shared a group: " \
            f"{st['epoch_signature_groups']}"
        assert st["fleet"]["host_syncs_per_round"] == 1.0

        list(sweep_serve.request("127.0.0.1", port, {"op": "shutdown"}))
        assert srv.wait(timeout=60) == 0
        out = srv.stdout.read()
        assert "sweep serve stopped" in out
    finally:
        if srv.poll() is None:
            srv.kill()


@pytest.mark.slow
def test_serve_dispatch_help(subprocess_env):
    """Top-level serve --help names both modes and decode's flags; sweep
    --help is accurate to its flags; decode --help lists its own; decode
    and bare flags without --device, where no GPU is visible, exit
    non-zero saying so before building anything."""
    env = subprocess_env()
    no_gpu = dict(env, CUDA_VISIBLE_DEVICES="")

    def run(args, env=env):
        return subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.serve"] + args,
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=120)

    top = run(["--help"])
    assert top.returncode == 0
    assert "sweep" in top.stdout and "decode" in top.stdout
    assert "NOT PORTED" not in top.stdout
    for flag in ("--arch", "--smoke", "--batch", "--prompt-len", "--gen",
                 "--device"):
        assert flag in top.stdout
    sw = run(["sweep", "--help"])
    assert sw.returncode == 0
    assert "--checkpoint-dir" in sw.stdout and "--device" in sw.stdout
    assert "--batch" not in sw.stdout
    dh = run(["decode", "--help"])
    assert dh.returncode == 0
    for flag in ("--arch", "--smoke", "--batch", "--prompt-len", "--gen",
                 "--device"):
        assert flag in dh.stdout
    assert "--checkpoint-dir" not in dh.stdout
    for args in (["decode", "--smoke"], ["decode", "--arch", "gemma3-12b"],
                 ["--smoke"]):
        dec = run(args, env=no_gpu)
        assert dec.returncode != 0
        assert "no CUDA device" in dec.stderr
        assert "serve ok" not in dec.stdout
