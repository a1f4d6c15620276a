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


def build_sharded_train_step(model: Model, ocfg: opt_lib.OptConfig,
                             opt_state: opt_lib.OptState, mesh,
                             n_microbatches: int = 1) -> Callable:
    """The train step over a ``DeviceMesh`` with ("data", "model")
    dimensions, one process per device: ``(batch) -> {"loss",
    "grad_norm", "lr"}`` as :func:`build_train_step`'s, on the global
    batch, which every rank passes whole.

    * ``model`` holds this rank's shards (``Model(cfg, tp=(rank, m))``
      with ``rank`` its place along "model", ``m`` the dimension's size)
      and computes on them: Megatron tensor parallelism over "model"
      (:mod:`~repro_torch.models.blocks`), with the collectives of
      :mod:`~repro_torch.models.sharding` declared for the step.  The
      leaves that ``model.layout()`` names are the exceptions: the
      attention leaves whose heads do not split whole (gathered at use)
      and the recurrent blocks' (held whole, their updated slices
      gathered over "model" after each step).
    * The batch's rows go over "data" (and "pod" where the mesh has it,
      pod-major); a mixture-of-experts block sees
      the whole batch's balance statistics, capacity and slot positions
      (:mod:`~repro_torch.models.moe`), so its loss is the world of
      one's.
    * The gradients are summed over "pod" and reduce-scattered over
      "data" in fp32 into the ZeRO-1 slices of :func:`optimizer.opt_state_specs` (all-reduced
      where a leaf has no slice over "data"); the global norm sums the
      slices' squares, each replicated slice once, over the whole mesh;
      each rank updates its slice of every parameter and moment with
      :func:`optimizer.update_leaf`, and the slices are gathered back
      over "data" (and over "model" for the leaves held whole).  The
      experts' hidden width, which the reference shards over "data", is
      held whole over "data" here and updated as a ZeRO-1 slice.

    The moments are replaced by DTensors of the rank's slices;
    ``train_step.master`` holds each parameter as a DTensor over the
    rank's own storage (placed over "model" where it is sliced), which a
    checkpoint gathers whole and restores in place."""
    from torch.distributed.tensor import DTensor

    from ..models import sharding
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"the mesh has no 'data' dimension ({names})")
    data_ax = sharding.mesh_axis(mesh, "data")
    model_ax = sharding.mesh_axis(mesh, "model") if "model" in names \
        else None
    pod_ax = sharding.mesh_axis(mesh, "pod") if "pod" in names else None
    rows_ax = sharding.rows_axis(mesh)
    d, m = data_ax.size, (model_ax.size if model_ax else 1)
    n_rows = rows_ax.size
    mrank = model_ax.rank if model_ax else 0
    if tuple(model.tp) != (mrank if m > 1 else 0, m):
        raise ValueError(f"the model holds the shards of tp={model.tp}; "
                         f"this rank is {mrank} of the mesh's 'model' "
                         f"dimension of {m} (build it with "
                         f"Model(cfg, tp=({mrank}, {m})))")
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if set(params) != set(opt_state.mu):
        raise ValueError("opt_state does not hold the model's trainable "
                         "parameters")
    layout = model.layout()
    shapes = {n: s for n, s in model.whole_shapes().items() if n in params}
    ospecs = opt_lib.opt_state_specs(
        {n: layout[n].spec for n in params}, shapes, data_size=d)
    od = {n: sharding.data_dim(ospecs.mu[n]) for n in params}
    # the dimension a leaf held whole is sliced along over "model"
    om = {n: sharding.model_dim(ospecs.mu[n])
          if layout[n].gather == "step" else None for n in params}

    def own(x: torch.Tensor, n: str) -> torch.Tensor:
        """This rank's ZeRO-1 slice (a view) of the stored leaf ``x``."""
        if om[n] is not None:
            x = sharding.shard_of(x, om[n], mrank, m)
        if od[n] is not None:
            x = sharding.shard_of(x, od[n], data_ax.rank, d)
        return x

    def counted(n: str) -> float:
        """1 on the one rank of each replicated copy of a slice."""
        once = od[n] is not None or data_ax.rank == 0
        sliced = om[n] is not None or layout[n].shard_dim is not None
        first_pod = pod_ax is None or pod_ax.rank == 0
        return 1.0 if once and first_pod and (sliced or mrank == 0) \
            else 0.0

    master = {}
    for n, p in params.items():
        stored = _spec_of(p.dim(), {"model": layout[n].shard_dim})
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
        with sharding.parallel(model=model_ax, data=rows_ax):
            loss, grads = loss_and_grads(model, local, n_microbatches)
        loss = sharding.all_reduce(loss.float(), rows_ax) / n_rows
        slices = {}
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for n in params:
            g = grads.pop(n).float()        # in place where fp32: no copy
            if om[n] is not None:           # the same on every model rank
                g = sharding.shard_of(g, om[n], mrank, m)
            g = sharding.all_reduce(g, pod_ax)
            if od[n] is not None:
                g = sharding.reduce_scatter(g, data_ax, od[n])
            else:
                g = sharding.all_reduce(g, data_ax)
            g = g.div_(n_rows) if g.is_contiguous() else g / n_rows
            slices[n] = g
            if weight[n]:
                sq = sq + torch.sum(torch.square(g))
        for ax in (pod_ax, data_ax):
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
                if od[n] is not None and d > 1:
                    whole.copy_(sharding.all_gather(mine, data_ax, od[n],
                                                    n))
                if om[n] is not None and m > 1:
                    p.copy_(sharding.all_gather(whole, model_ax, om[n], n))
        return dict(loss=loss, grad_norm=gnorm, lr=k.lr)

    train_step.master = master
    return train_step
