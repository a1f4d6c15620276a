"""Step builders shared by the trainer and the server, the counterparts
of the JAX package's ``build_train_step``, ``build_serve_step`` and
``build_prefill_step`` (``launch/steps.py``).

The model holds its weights and the :class:`~repro_torch.optim.optimizer.
OptState` its moments, so a step takes neither: the train step is
``(batch) -> metrics`` and updates both in place; the serve and prefill
steps run under ``torch.inference_mode()``.  :func:`build_sharded_train_step`
is the train step over a ``DeviceMesh``, one process per device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.model import Model
from ..optim import optimizer as opt_lib


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor],
                   n_microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {name: grad})`` of ``model.loss_fn`` over ``batch``, for
    every parameter that requires a gradient.

    With ``n_microbatches`` > 1 the batch is split along axis 0 and the
    microbatches run one after another; their gradients are summed into
    fp32 buffers and divided by the count, as the reference's ``lax.scan``
    does, so the gradients are then fp32.  With one microbatch they keep
    each parameter's dtype, as the reference's do."""
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    if n_microbatches == 1:
        loss, _ = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))
    b = next(iter(batch.values())).shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} is not divisible into "
                         f"{n_microbatches} microbatches")
    mb = b // n_microbatches
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
    lsum = torch.zeros((), dtype=torch.float32,
                       device=params[0].device)
    for i in range(n_microbatches):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, _ = model.loss_fn(part)
        for acc, g in zip(gsum, torch.autograd.grad(loss, params)):
            acc.add_(g)
        lsum = lsum + loss.detach()
    return lsum / n_microbatches, {n: g / n_microbatches
                                   for n, g in zip(names, gsum)}


def build_train_step(model: Model, ocfg: opt_lib.OptConfig,
                     opt_state: opt_lib.OptState,
                     n_microbatches: int = 1) -> Callable:
    """``(batch) -> {"loss", "grad_norm", "lr"}`` (device scalars): the
    gradients of :func:`loss_and_grads`, then one :func:`optimizer.apply
    <repro_torch.optim.optimizer.apply>` that updates the model's
    trainable parameters and ``opt_state`` in place."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if set(params) != set(opt_state.mu):
        raise ValueError("opt_state does not hold the model's trainable "
                         "parameters")

    def train_step(batch):
        loss, grads = loss_and_grads(model, batch, n_microbatches)
        stats = opt_lib.apply(params, grads, opt_state, ocfg)
        return dict(loss=loss, **stats)

    return train_step


def build_serve_step(model: Model) -> Callable:
    """(cache, tokens [B,1], pos int) -> logits [B,1,V]; the token's K/V
    are written into ``cache`` in place."""

    @torch.inference_mode()
    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return serve_step


def build_prefill_step(model: Model) -> Callable:
    """Prefill is the forward pass: batch ``{"tokens": [B,S]}`` (and an
    encoder-decoder's ``"enc_embeds"`` [B,S_enc,d], a vision-language
    model's ``"frontend"`` [B,nf,d]) -> logits over the whole prompt
    [B,nf+S,V]."""

    @torch.inference_mode()
    def prefill_step(batch):
        return model(batch["tokens"], batch.get("enc_embeds"),
                     frontend=batch.get("frontend"))

    return prefill_step


def _spec_of(ndim: int, dims: Dict[str, Optional[int]]) -> "P":
    from ..models.sharding import P
    parts = [None] * ndim
    for name, dim in dims.items():
        if dim is not None:
            parts[dim] = name
    return P(*parts)


def mesh_places(mesh) -> Dict[str, Tuple[int, int]]:
    """This rank's place on ``mesh`` as ``Model(cfg, **mesh_places(mesh))``
    takes it: ``tp=(rank, m)`` along "model" (``(0, 1)`` without one, or
    where the rows go over it: the pure data-parallel mapping) and
    ``dp=(rank, D)`` along "data", which the experts' hidden width is
    split over."""
    from ..models import sharding
    names = mesh.mesh_dim_names or ()
    tp = (0, 1)
    if "model" in names and "model" not in sharding.row_axis_names(mesh):
        ax = sharding.mesh_axis(mesh, "model")
        tp = (ax.rank, ax.size)
    ax = sharding.mesh_axis(mesh, "data")
    return dict(tp=tp, dp=(ax.rank, ax.size))


def build_sharded_train_step(model: Model, ocfg: opt_lib.OptConfig,
                             opt_state: opt_lib.OptState, mesh,
                             n_microbatches: int = 1) -> Callable:
    """The train step over a ``DeviceMesh`` with ("data", "model")
    dimensions (and "pod"), one process per device: ``(batch) ->
    {"loss", "grad_norm", "lr"}`` as :func:`build_train_step`'s, on the
    global batch, which every rank passes whole.

    * ``model`` holds this rank's shards (``Model(cfg,
      **mesh_places(mesh))``) and computes on them: Megatron tensor
      parallelism over "model" (:mod:`~repro_torch.models.blocks`), with
      the collectives of :mod:`~repro_torch.models.sharding` declared for
      the step.  The leaves that ``model.layout()`` names are the
      exceptions: the attention leaves whose heads do not split whole
      (gathered at use) and the recurrent blocks' (held whole, their
      updated slices gathered over "model" after each step).
    * The batch's rows go over "data" (and "pod" where the mesh has it,
      pod-major; over every dimension under
      ``sharding.pure_data_parallel``, and then nothing is
      tensor-parallel); a mixture-of-experts block sees the whole
      batch's balance statistics, capacity and slot positions
      (:mod:`~repro_torch.models.moe`), so its loss is the world of
      one's.
    * The experts' hidden width is split over "data", as the reference's
      specs split it: each rank holds and computes on its ``d_ff / D``
      slice of its experts (``Leaf.width_dim``), whose gradient has
      already seen every data rank's tokens (the width axis gathers
      them), so it is summed over the other row dimensions only, and its
      moments are that slice.
    * Every other gradient is summed over the row dimensions but "data"
      (over all of them at once where they are ("data", "model")) and
      reduce-scattered over "data" in fp32 into the ZeRO-1 slices of
      :func:`optimizer.opt_state_specs` (all-reduced where a leaf has no
      slice over "data"); the global norm sums the slices' squares, each
      replicated slice once, over the whole mesh; each rank updates its
      slice of every parameter and moment with
      :func:`optimizer.update_leaf` (the reduced slices kept in the
      gradients' own dtype until then, as a single rank's are), and the
      slices are gathered back
      over "data" (and over "model" for the leaves held whole).

    The moments are replaced by DTensors of the rank's slices;
    ``train_step.master`` holds each parameter as a DTensor over the
    rank's own storage (placed over "model" and "data" where it is
    sliced), which a checkpoint gathers whole and restores in place."""
    from torch.distributed.tensor import DTensor

    from ..models import sharding
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"the mesh has no 'data' dimension ({names})")
    data_ax = sharding.mesh_axis(mesh, "data")
    rows_names = sharding.row_axis_names(mesh)
    model_ax = sharding.mesh_axis(mesh, "model") \
        if "model" in names and "model" not in rows_names else None
    # the row dimensions but "data": every gradient is summed over them
    sum_axes = [sharding.mesh_axis(mesh, a) for a in rows_names
                if a != "data"]
    rows_ax = sharding.rows_axis(mesh)
    # the rows over ("data", "model"): nothing is tensor-parallel
    pure_dp = "model" in rows_names
    width_ax = sharding.width_axis_of(mesh)
    d, m = data_ax.size, (model_ax.size if model_ax else 1)
    n_rows = rows_ax.size
    mrank = model_ax.rank if model_ax else 0
    places = mesh_places(mesh)
    if tuple(model.tp) != places["tp"]:
        raise ValueError(f"the model holds the shards of tp={model.tp}; "
                         f"this rank is at tp={places['tp']} on the mesh "
                         f"(build it with Model(cfg, **mesh_places(mesh)))")
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if set(params) != set(opt_state.mu):
        raise ValueError("opt_state does not hold the model's trainable "
                         "parameters")
    layout = model.layout()
    if any(layout[n].data_dim is not None for n in params) and \
            tuple(model.dp) != (places["dp"] if d > 1 else (0, 1)):
        raise ValueError(f"the model holds the experts' width slice "
                         f"dp={model.dp}; this rank is at dp={places['dp']} "
                         f"on the mesh (build it with "
                         f"Model(cfg, **mesh_places(mesh)))")
    shapes = {n: s for n, s in model.whole_shapes().items() if n in params}
    ospecs = opt_lib.opt_state_specs(
        {n: layout[n].spec for n in params}, shapes, data_size=d)
    od = {n: sharding.data_dim(ospecs.mu[n]) for n in params}
    # a leaf held whole over "data" keeps a ZeRO-1 slice of it
    zd = {n: od[n] if layout[n].width_dim is None else None for n in params}
    # the dimension a leaf held whole is sliced along over "model"
    om = {n: sharding.model_dim(ospecs.mu[n])
          if layout[n].gather == "step" else None for n in params}

    def own(x: torch.Tensor, n: str) -> torch.Tensor:
        """This rank's ZeRO-1 slice (a view) of the stored leaf ``x``."""
        if om[n] is not None:
            x = sharding.shard_of(x, om[n], mrank, m)
        if zd[n] is not None:
            x = sharding.shard_of(x, zd[n], data_ax.rank, d)
        return x

    def counted(n: str) -> float:
        """1 on the one rank of each replicated copy of a slice."""
        once = od[n] is not None or data_ax.rank == 0
        sliced = om[n] is not None or layout[n].shard_dim is not None
        first = all(ax.rank == 0 for ax in sum_axes)
        return 1.0 if once and first and (sliced or mrank == 0) else 0.0

    master = {}
    for n, p in params.items():
        stored = _spec_of(p.dim(), {"model": layout[n].shard_dim,
                                    "data": layout[n].width_dim})
        master[n] = DTensor.from_local(
            p.detach(), mesh, sharding.placements(mesh, stored),
            run_check=False)
        for moments in (opt_state.mu, opt_state.nu):
            moments[n] = DTensor.from_local(
                own(moments[n], n).clone(), mesh,
                sharding.placements(mesh, ospecs.mu[n]), run_check=False)
    weight = {n: counted(n) for n in params}

    def train_step(batch):
        local = {k: sharding.shard_of(v, 0, rows_ax.rank, n_rows)
                 for k, v in batch.items()}
        with sharding.parallel(model=model_ax, data=rows_ax,
                               width=width_ax):
            loss, grads = loss_and_grads(model, local, n_microbatches)
        loss = sharding.all_reduce(loss.float(), rows_ax) / n_rows
        slices = {}
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for n in params:
            g = grads.pop(n)
            dtype = g.dtype
            g = g.float()                   # in place where fp32: no copy
            if om[n] is not None:           # the same on every model rank
                g = sharding.shard_of(g, om[n], mrank, m)
            if layout[n].width_dim is not None:     # saw every data rank
                for ax in sum_axes:
                    g = sharding.all_reduce(g, ax)
            elif pure_dp:                   # one sum over all the rows
                g = sharding.all_reduce(g, rows_ax)
                if zd[n] is not None:
                    g = sharding.shard_of(g, zd[n], data_ax.rank, d)
            else:
                for ax in sum_axes:
                    g = sharding.all_reduce(g, ax)
                if zd[n] is not None:
                    g = sharding.reduce_scatter(g, data_ax, zd[n])
                else:
                    g = sharding.all_reduce(g, data_ax)
            g = g.div_(n_rows) if g.is_contiguous() else g / n_rows
            if weight[n]:
                sq = sq + torch.sum(torch.square(g))
            slices[n] = g.to(dtype)         # the gradient's own dtype
        for ax in (rows_ax,) if pure_dp else (*sum_axes, data_ax):
            sq = sharding.all_reduce(sq, ax)
        gnorm = torch.sqrt(sharding.all_reduce(sq, model_ax))
        k = opt_lib.step_scalars(opt_state, gnorm, ocfg)
        with torch.no_grad():
            for n, p in params.items():
                mine = own(p, n)
                opt_lib.update_leaf(mine, slices.pop(n),
                                    opt_state.mu[n].to_local(),
                                    opt_state.nu[n].to_local(), k, ocfg)
                whole = p if om[n] is None else \
                    sharding.shard_of(p, om[n], mrank, m)
                if zd[n] is not None and d > 1:
                    whole.copy_(sharding.all_gather(mine, data_ax, zd[n],
                                                    n))
                if om[n] is not None and m > 1:
                    p.copy_(sharding.all_gather(whole, model_ax, om[n], n))
        return dict(loss=loss, grad_norm=gnorm, lr=k.lr)

    train_step.master = master
    return train_step
