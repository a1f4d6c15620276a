"""Production-mesh dry-run: one rank's step of an (architecture x input
shape x mesh) cell at full size, with no device and no weight memory, and
its roofline terms against one H100; the counterpart of the JAX
package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m \\
        --shape decode_32k [--multi-pod] [--jsonl out.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jsonl ...]

The reference lowers and compiles each cell for 256 (512) forced host
devices and reads FLOPs, bytes and collectives from the optimised HLO.
The port has no compiler to ask, so it runs the program instead, once,
as one rank of the production mesh would:

* a fake process group of 256 (512) ranks
  (``torch.testing._internal.distributed.fake_pg``) in this process
  gives ``launch.mesh.make_production_mesh()`` its (16, 16) ("data",
  "model") or (2, 16, 16) mesh; the fake collectives move nothing;
* rank 0's model is built on ``meta`` on its shards (``Model(cfg,
  device="meta", tp=(0, 16), dp=(0, 16))``: its "model" shards and its
  slice of the experts' hidden width over "data"): every weight, moment
  and activation has a shape and a dtype and no storage;
* a train cell runs ``steps.build_sharded_train_step`` on the global
  batch; a prefill cell the tensor-parallel forward on the rank's rows,
  a decode cell one ``decode_step`` on the rank's rows against a full
  cache, both under ``inference_mode`` with the "model", batch and width
  axes declared (the experts' width goes over "data" in every cell);
* under ``sharding.pure_data_parallel()`` (the pure data-parallel
  mapping of ``launch.hillclimb``) the rows go over every dimension and
  nothing is tensor-parallel;
* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
  products it knows (matrix products, attention, convolutions); a
  ``TorchDispatchMode`` adds every other aten op's input and output bytes
  (views and allocations move none), with no fusion, so ``bytes`` is an
  upper bound of what the rank reads and writes; ``sharding.stats``
  gives the collectives' operand bytes by kind and by mesh axis.

On ``meta`` tensors ``attention_route`` takes the chunked route: the
FLOPs are those of fp32 scores over the whole key length, causal or not
(the flash kernel skips the causal half; it would do fewer), and the
bytes include the scores.

The record keeps the reference's JSONL keys (``flops_per_device``,
``bytes_per_device``, ``coll_<kind>``, ``coll_total``,
``state_bytes_per_device``, ``t_compute_s``, ``t_memory_s``,
``t_collective_s``, ``bottleneck``, ``model_flops_total``,
``useful_flops_ratio``), with the roofline terms against
``core.accel.H100_SXM``: a collective over a mesh axis whose ranks share
one 8-GPU node moves at NVLink's rate, one that spans nodes (both axes of
the production meshes) at the per-GPU inter-node rate.
``state_bytes_per_device`` is what the rank really allocated (parameters
and moments, or parameters and cache), beside ``state_bytes_by_specs``,
the specs' share (the reference's analytic figure: parameters and
moments by their specs, a decode cell's cache as the rank holds it);
``param_bytes_per_device`` / ``param_bytes_by_specs`` split out the
parameters.

``hlo_analysis.py`` and ``xla_compat.py`` have no counterpart: there is
no HLO to parse and no XLA version to bridge, and the eager run executes
every iteration of every Python loop, so no trip-count correction is
needed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict, Union

import torch

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")


class ByteCounter:
    """A ``TorchDispatchMode`` that adds each aten op's tensor inputs'
    and outputs' bytes (``bytes``), skipping views, allocations and the
    collectives (``ops``: the ops counted)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter._add(func, args, kwargs, out)
                return out

        self.bytes = 0
        self.ops = 0
        self.mode = _Mode()

    @staticmethod
    def _tensor_bytes(tree) -> int:
        from torch.utils._pytree import tree_leaves
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    def _add(self, func, args, kwargs, out) -> None:
        if func.is_view or func.namespace != "aten" or \
                func._schema.name.split("::")[-1] in _NO_BYTES:
            return
        self.ops += 1
        self.bytes += self._tensor_bytes((args, kwargs)) + \
            self._tensor_bytes(out)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process, rank 0,
    for the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _link_rate(mesh, axis: str, accel: Dict[str, float]) -> float:
    """Bytes/s of a collective over ``axis``: NVLink where this rank's
    peers along it sit in its node, the per-GPU inter-node rate where
    they span nodes; for a flattened axis ("pod_data"), its slowest
    dimension's."""
    names = mesh.mesh_dim_names
    if axis not in names:
        return min(_link_rate(mesh, a, accel) for a in axis.split("_"))
    coord = list(mesh.get_coordinate())
    ranks = []
    for i in range(mesh.shape[names.index(axis)]):
        coord[names.index(axis)] = i
        ranks.append(int(mesh.mesh[tuple(coord)]))
    per = int(accel["gpus_per_node"])
    if len({r // per for r in ranks}) == 1:
        return accel["ici_link_bw_bytes_per_s"]
    return accel["inter_node_bw_bytes_per_s"]


def run_cell(arch: str, shape: Union[str, Any], multi_pod: bool,
             arch_cfg=None, tag: str = "") -> Dict[str, Any]:
    """One cell's record (``shape``: a name of ``configs.SHAPES`` or a
    ``ShapeSpec``); ``status`` is ``ok``, ``skipped`` (the cell does not
    apply) or ``error`` (with the exception and its traceback)."""
    from ..configs import SHAPES, applicable, get_config
    from ..core.accel import H100_SXM
    from ..launch import specs as specs_lib
    from ..launch.mesh import make_production_mesh
    from ..launch.steps import build_sharded_train_step, mesh_places
    from ..models import sharding
    from ..models.model import Model
    from ..optim import optimizer as opt_lib
    from torch.utils.flop_counter import FlopCounterMode

    cfg = arch_cfg or get_config(arch)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    rec: Dict[str, Any] = dict(
        arch=arch, shape=sh.name, mesh="2x16x16" if multi_pod else "16x16",
        kind=sh.kind, seq_len=sh.seq_len, global_batch=sh.global_batch,
        tag=tag, backend="torch-meta")
    if isinstance(shape, str):
        ok, why = applicable(arch, shape)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec
    world = 512 if multi_pod else 256
    t0 = time.time()
    try:
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod)
            names = mesh.mesh_dim_names
            places = mesh_places(mesh)
            model_ax = sharding.mesh_axis(mesh, "model") \
                if places["tp"][1] > 1 else None
            width_ax = sharding.width_axis_of(mesh)
            rows_ax = sharding.rows_axis(mesh)
            rows = specs_lib.rows_per_rank(sh, rows_ax.size)
            if rows == sh.global_batch:
                rows_ax = None
            model = Model(cfg, device="meta", **places)
            mesh_shape = dict(zip(names, mesh.shape))
            ocfg = None
            if sh.kind == "train":
                ocfg = opt_lib.OptConfig(
                    moment_dtype=opt_lib.moment_dtype_for(cfg))
                model.requires_grad_(True)
                params = dict(model.named_parameters())
                ostate = opt_lib.init(params, ocfg)
                step = build_sharded_train_step(model, ocfg, ostate, mesh)
                inputs = specs_lib.batch_spec(cfg, sh)

                def run():
                    step(inputs)
                extra = [*(m.to_local() for m in ostate.mu.values()),
                         *(v.to_local() for v in ostate.nu.values())]
            elif sh.kind == "prefill":
                inputs = specs_lib.batch_spec(cfg, sh, rows)

                def run():
                    with torch.inference_mode(), sharding.parallel(
                            model=model_ax, data=rows_ax, width=width_ax):
                        model(inputs["tokens"], inputs.get("enc_embeds"),
                              frontend=inputs.get("frontend"))
                extra = []
            else:                               # decode / long_decode
                with sharding.parallel(model=model_ax, data=rows_ax,
                                       width=width_ax):
                    cache, tokens, pos = specs_lib.decode_inputs(
                        cfg, sh, model, rows)

                def run():
                    with torch.inference_mode(), sharding.parallel(
                            model=model_ax, data=rows_ax, width=width_ax):
                        model.decode_step(cache, tokens, pos)
                extra = [t for c in cache for t in c.values()]
            rec["rows_per_device"] = rows
            rec["build_s"] = round(time.time() - t0, 1)

            t1 = time.time()
            sharding.stats.reset()
            counter = ByteCounter()
            with FlopCounterMode(display=False) as flops, counter.mode:
                run()
            rec["run_s"] = round(time.time() - t1, 1)
            coll = sharding.stats.as_dict()

            rec["flops_per_device"] = float(flops.get_total_flops())
            rec["flops_by_op"] = {str(op): float(n) for op, n in
                                  flops.get_flop_counts()["Global"].items()}
            rec["bytes_per_device"] = float(counter.bytes)
            rec["bytes_are"] = ("an upper bound: every aten op's inputs "
                                "read and outputs written, no fusion")
            rec["aten_ops"] = counter.ops
            rec["attention_route"] = ("chunked (meta tensors): fp32 scores "
                                      "over the whole key length")
            for k in _COLLECTIVES:
                rec[f"coll_{k}"] = float(coll["bytes"].get(k, 0))
            rec["coll_count"] = sum(coll["calls"].values())
            rec["coll_total"] = sum(rec[f"coll_{k}"] for k in _COLLECTIVES)
            rec["coll_by_axis"] = coll["by_axis"]
            rec["leaf_gathers"] = {a: len(c) for a, c in
                                   coll["leaf_gathers"].items()}
            held = float(sum(p.numel() * p.element_size()
                             for p in model.parameters()))
            rest = float(sum(t.numel() * t.element_size() for t in extra))
            by_specs = specs_lib.state_bytes_by_specs(model, mesh_shape,
                                                      ocfg)
            rec["param_bytes_per_device"] = held
            rec["param_bytes_by_specs"] = by_specs[0]
            rec["state_bytes_per_device"] = held + rest
            # the specs' figure: parameters and moments by their specs,
            # a decode cell's cache as the rank holds it
            rec["state_bytes_by_specs"] = by_specs[0] + (
                by_specs[1] if ocfg is not None else rest)

            acc = H100_SXM
            rec["t_compute_s"] = rec["flops_per_device"] / \
                acc["peak_bf16_flops"]
            rec["t_memory_s"] = rec["bytes_per_device"] / \
                acc["hbm_bw_bytes_per_s"]
            rec["t_collective_s"] = sum(
                b / _link_rate(mesh, a, acc)
                for a, b in coll["by_axis"].items())
            terms = dict(compute=rec["t_compute_s"],
                         memory=rec["t_memory_s"],
                         collective=rec["t_collective_s"])
            rec["bottleneck"] = max(terms, key=terms.get)

            n_act = cfg.active_param_count()
            if sh.kind == "train":
                mf = 6.0 * n_act * sh.global_batch * sh.seq_len
            elif sh.kind == "prefill":
                mf = 2.0 * n_act * sh.global_batch * sh.seq_len
            else:
                mf = 2.0 * n_act * sh.global_batch
            rec["model_flops_total"] = mf
            total = rec["flops_per_device"] * world
            rec["useful_flops_ratio"] = mf / total if total else 0.0
            rec["status"] = "ok"
    except Exception as e:          # a cell's failure is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    from ..configs import ARCHS, SHAPES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell on both meshes")
    ap.add_argument("--jsonl", default=None, help="append records here")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in sorted(ARCHS):
            for s in sorted(SHAPES):
                cells += [(a, s, False), (a, s, True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    rc = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}), flush=True)
        if rec["status"] == "error":
            print(rec.get("traceback", ""), file=sys.stderr)
            rc = 1
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
