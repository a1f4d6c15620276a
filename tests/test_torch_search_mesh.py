"""The fleet sharded over several devices in the PyTorch port
(``torch_cost.SearchMesh``, ``launch.mesh.make_search_mesh``,
``eval_stacked(..., mesh=)``, ``run_segments(..., mesh=)``,
``FleetConfig.mesh``), all on CPU shards (``device="cpu"``), the
counterpart of the reference's forced-host-device test
(``tests/test_device_rounds.py::test_forced_multi_device_sharding_matches_single_device``):

* a sharded mega-batch equals the unsharded one bit for bit, at shard
  counts and batch splits that put shard boundaries inside one model's
  rows;
* an 8-task segment fleet over 8 shards equals one device bit for bit and
  lands on the reference's fleet;
* the calls the reference does not shard (a task count the shards do
  not divide, ``standard_es``'s direct segments, restart segments) run
  unsharded;
* every shard's tensors sit on its shard's device (a ``meta`` shard
  stands in for a second card).
"""
import numpy as np
import pytest
import torch

from _torch_port_util import lg_close
from repro.configs.paper_workloads import by_name as ref_by_name
from repro.core import search as ref_search
from repro_torch.configs.paper_workloads import by_name
from repro_torch.core import search, torch_cost
from repro_torch.core.search import FleetConfig, MultiSearch, SearchTask
from repro_torch.core.torch_cost import SearchMesh, ndev
from repro_torch.launch.mesh import make_search_mesh

CPU = "cpu"
META = torch.device("meta")
SPLITS = (48, 50, 64, 7, 33)        # 202 rows: 256 padded, 258 at 3 shards


def _fleet_tasks(n, workload="mm1", **kw):
    return [SearchTask(by_name(workload), "cloud", budget=700, seed=s,
                       name=f"t{s}", **kw) for s in range(n)]


@pytest.fixture
def blocks(monkeypatch):
    """(task count, shard index) of every device block ``run_segments``
    made."""
    made = []
    block = torch_cost._SegmentBlock

    def recording(models, segs, shape_key, shard):
        made.append((len(segs), shard))
        return block(models, segs, shape_key, shard)

    monkeypatch.setattr(torch_cost, "_SegmentBlock", recording)
    return made


# ------------------------------------------------------- eval_stacked


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("wl", ["mm1", "mm9", "conv4"])
def test_sharded_eval_stacked_equals_unsharded_bit_for_bit(n, wl):
    """Uniform (mm1), 2:4 structured (mm9) and a 7-dim convolution
    (conv4), three shard counts; per-row blocks of 128, 86 and 32 rows
    cut through the batches of 48, 50, 64, 7 and 33 rows."""
    spec, ev = search.get_evaluator(by_name(wl), "cloud", device=CPU)
    rng = np.random.default_rng(0)
    batches = [spec.random_genomes(rng, m) for m in SPLITS]
    models = [ev] * len(batches)
    mesh = make_search_mesh(n, device=CPU)
    assert ndev(mesh) == n
    plain = torch_cost.eval_stacked(models, batches)
    for pad_floor in (0, 512):
        shard = torch_cost.eval_stacked(models, batches, mesh=mesh,
                                        pad_floor=pad_floor, defer=True)
        for p, s in zip(plain, shard.finalize()):
            assert p.keys() == s.keys()
            for k in p:
                np.testing.assert_array_equal(p[k], s[k], err_msg=k)


def test_sharded_eval_stacked_is_one_dispatch():
    spec, ev = search.get_evaluator(by_name("mm1"), "cloud", device=CPU)
    rng = np.random.default_rng(1)
    batches = [spec.random_genomes(rng, m) for m in SPLITS]
    torch_cost.reset_dispatch_count()
    torch_cost.eval_stacked([ev] * len(batches), batches,
                            mesh=make_search_mesh(8, device=CPU))
    assert torch_cost.dispatch_count() == 1


# -------------------------------------------------------- segments


def _run(mesh, tasks, **cfg):
    ms = MultiSearch(tasks, FleetConfig(stack_batches=True, mesh=mesh,
                                        **cfg), device=CPU)
    return ms.run(), ms.stats


def _same_results(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].best_edp == b[name].best_edp, name
        assert a[name].evals == b[name].evals, name
        np.testing.assert_array_equal(a[name].history, b[name].history,
                                      err_msg=name)


@pytest.fixture(scope="module")
def fleets():
    kw = dict(method_kw=dict(rng_backend="numpy"))
    one = _run(None, _fleet_tasks(8, **kw), device_rounds=4)
    eight = _run(make_search_mesh(8, device=CPU), _fleet_tasks(8, **kw),
                 device_rounds=4)
    return one, eight


def test_sharded_segment_fleet_equals_one_device_bit_for_bit(fleets):
    """The reference's check 2: 8 ``mm1`` tasks, budget 700, k 4."""
    (res1, st1), (res8, st8) = fleets
    assert st1["devices"] == 1 and st8["devices"] == 8
    assert st8["host_syncs_per_round"] <= 0.25
    assert st8["dispatches"] == st1["dispatches"]
    _same_results(res1, res8)


def test_sharded_segment_fleet_lands_on_the_reference(fleets):
    """The 8-shard fleet against the reference's unsharded fleet (its
    host replay: it compiles no scan), both on the numpy plan stream."""
    _, (res8, _) = fleets
    ref = ref_search.MultiSearch(
        [ref_search.SearchTask(ref_by_name("mm1"), "cloud", budget=700,
                               seed=s, name=f"t{s}",
                               method_kw=dict(rng_backend="numpy"))
         for s in range(8)],
        ref_search.FleetConfig(stack_batches=True, device_rounds=4,
                               device_execute=False)).run()
    for name, a in ref.items():
        b = res8[name]
        assert a.evals == b.evals == 700
        assert a.valid_evals == b.valid_evals
        np.testing.assert_array_equal(a.best_genome, b.best_genome)
        assert lg_close(np.log10(b.best_edp), np.log10(a.best_edp))


def test_segments_shard_in_contiguous_task_blocks(blocks):
    mesh = make_search_mesh(4, device=CPU)
    res, stats = _run(mesh, _fleet_tasks(8), device_rounds=4)
    assert stats["devices"] == 4
    # the segment phase ran as 4 blocks of 2 tasks a dispatch
    assert blocks and set(blocks) == {(2, 0), (2, 1), (2, 2), (2, 3)}
    _same_results(res, _run(None, _fleet_tasks(8), device_rounds=4)[0])


@pytest.mark.parametrize("case", ["six_tasks", "standard_es", "restart"])
def test_unshardable_segments_run_unsharded(case, blocks):
    """Where the reference does not shard: 6 tasks on 8 shards, a direct
    (``standard_es``) segment, a stagnation-restart segment."""
    if case == "six_tasks":
        tasks = _fleet_tasks(6)
    elif case == "standard_es":
        tasks = _fleet_tasks(8, method="standard_es")
    else:
        tasks = _fleet_tasks(
            8, method_kw=dict(stagnation_restart=2, rng_backend="numpy"))
    mesh = make_search_mesh(8, device=CPU)
    res, stats = _run(mesh, tasks, device_rounds=4)
    assert stats["devices"] == 8
    # one block per call, on shard 0: no call was split
    assert blocks and {i for _, i in blocks} == {0}
    assert max(t for t, _ in blocks) == len(tasks)
    blocks.clear()
    _same_results(res, _run(None, tasks, device_rounds=4)[0])


def test_a_carry_follows_its_task_to_another_device():
    """Segments whose carries sit on the CPU, sharded over (cpu, meta):
    the meta block's carries, tables, constants and outputs are on meta,
    the CPU block's on the CPU."""
    seen = {}
    run_segments = torch_cost.run_segments

    def keep(models, segs, **kw):
        if any(s.carry is not None for s in segs):
            seen.setdefault("seg", (list(models), list(segs)))
        return run_segments(models, segs, **kw)

    torch_cost.run_segments = keep
    try:
        ms = MultiSearch(_fleet_tasks(4), FleetConfig(
            stack_batches=True, device_rounds=4), device=CPU)
        ms.start()
        while "seg" not in seen and ms.step():
            pass
    finally:
        torch_cost.run_segments = run_segments
    models, segs = seen["seg"]
    mesh = SearchMesh((CPU, "meta"))
    torch_cost.clear_stack_cache()
    res = run_segments(models, segs, defer=True, mesh=mesh)
    for t, r in enumerate(res):
        want = mesh.devices[t // 2]
        assert {r.carry[0].device, r.carry[1].device} == {want}
    for slot, (_, task, rows) in torch_cost._STACK_CONSTS.items():
        dev = torch.device(slot[4])
        assert slot[6] == (0 if dev.type == "cpu" else 1)
        assert {c.device for c in task + rows} == {dev}
    twin = models[0].twin(META)
    assert twin is models[0].twin(META)
    assert {c.device for c in twin._consts} == {META}
    assert {getattr(twin._tb, f).device
            for f in twin._tb.__dataclass_fields__} == {META}


def test_every_shard_tensor_sits_on_its_shards_device():
    spec, ev = search.get_evaluator(by_name("mm9"), "cloud", device=CPU)
    rng = np.random.default_rng(2)
    batches = [spec.random_genomes(rng, m) for m in SPLITS]
    mesh = SearchMesh((CPU, "meta", "meta"))
    torch_cost.clear_stack_cache()
    pending = torch_cost.eval_stacked([ev] * len(batches), batches,
                                      mesh=mesh, defer=True)
    devs = [f._host[0].device for f in pending._fetches]
    assert devs == list(mesh.devices)
    slots = sorted((s[4], s[6]) for s in torch_cost._STACK_CONSTS)
    assert slots == [("cpu", 0), ("meta", 1), ("meta", 2)]
    for slot, (_, task, rows) in torch_cost._STACK_CONSTS.items():
        assert {c.device for c in task + rows} == {torch.device(slot[4])}


# ----------------------------------------------- mesh and FleetConfig


def test_make_search_mesh(monkeypatch):
    assert make_search_mesh(device=CPU) is None
    assert make_search_mesh(1, device=CPU) is None
    mesh = make_search_mesh(3, axis="tasks", device=CPU)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_names == ("tasks",)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_search_mesh() is None
    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        make_search_mesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
        make_search_mesh()
    with pytest.raises(ValueError, match="one axis"):
        SearchMesh((CPU, CPU), ("a", "b"))


def test_fleet_config_takes_a_mesh_and_will_not_serialize_it():
    mesh = make_search_mesh(2, device=CPU)
    cfg = FleetConfig(mesh=mesh, stack_batches=True)
    assert cfg.mesh is mesh
    ms = MultiSearch(_fleet_tasks(2), cfg, device=CPU)
    assert ms.mesh is mesh
    with pytest.raises(ValueError, match="FleetConfig.mesh is process-local"):
        cfg.to_json()
    ref = ref_search.FleetConfig(mesh=object())
    with pytest.raises(ValueError, match="FleetConfig.mesh is process-local"):
        ref.to_json()
    # every other setting still writes the reference's bytes
    assert FleetConfig(stack_batches=True).to_json() == \
        ref_search.FleetConfig(stack_batches=True).to_json()
