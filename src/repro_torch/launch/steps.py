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

from typing import Callable, Dict, Tuple

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


def build_sharded_train_step(model: Model, ocfg: opt_lib.OptConfig,
                             opt_state: opt_lib.OptState, mesh,
                             n_microbatches: int = 1) -> Callable:
    """The train step over a ``DeviceMesh`` with ("data", "model")
    dimensions, one process per device: ``(batch) -> {"loss",
    "grad_norm", "lr"}`` as :func:`build_train_step`'s, on the global
    batch, which every rank passes whole.

    * The trainable parameters are held as DTensors placed by
      ``model.param_specs()`` (the reference's ``NamedSharding`` of each
      leaf); ``opt_state``'s moments are replaced by DTensors placed by
      :func:`optimizer.opt_state_specs` (ZeRO-1 over "data").
    * The batch goes on ``("data",)`` (``sharding.bspec``): each rank
      computes the loss and gradients of its rows on the model's own
      weights, all-gathered from their shards before the step (the op-level
      counterpart of ``constrain`` around the whole forward: the model's
      ops run on whole tensors, not DTensors, so the "model" dimension
      shards storage, not compute).
    * The gradients are averaged over "data" in fp32; their global norm is
      then the world-of-one norm, and each rank updates its ZeRO-1 slice
      of every parameter and moment with :func:`optimizer.update_leaf`;
      the slices are gathered back to the parameter's placement.

    A mixture-of-experts model is refused where "data" is larger than 1:
    its balance loss is a statistic of the whole batch, which a rank does
    not see."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor

    from ..models import sharding
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"the mesh has no 'data' dimension ({names})")
    data = mesh.shape[names.index("data")]
    if data > 1 and any(b.kind == "moe" for b in model.cfg.pattern):
        raise ValueError(f"{model.cfg.name}: a data-sharded step would "
                         f"change the MoE balance loss (a statistic of "
                         f"the whole batch)")
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if set(params) != set(opt_state.mu):
        raise ValueError("opt_state does not hold the model's trainable "
                         "parameters")
    specs = model.param_specs()
    ospecs = opt_lib.opt_state_specs(
        {n: specs[n] for n in params},
        {n: tuple(p.shape) for n, p in params.items()}, data_size=data)
    place = {n: sharding.placements(mesh, specs[n]) for n in params}
    oplace = {n: sharding.placements(mesh, ospecs.mu[n]) for n in params}
    master = {n: distribute_tensor(p.detach(), mesh, place[n],
                                   src_data_rank=None)
              for n, p in params.items()}
    for moments in (opt_state.mu, opt_state.nu):
        for n in params:
            moments[n] = distribute_tensor(moments[n], mesh, oplace[n],
                                           src_data_rank=None)
    group = mesh.get_group("data")
    replicated = [Replicate()] * mesh.ndim

    def rows(x: torch.Tensor) -> torch.Tensor:
        spec = sharding.bspec(*[None] * (x.dim() - 1))
        return distribute_tensor(x, mesh, sharding.placements(mesh, spec),
                                 src_data_rank=None).to_local()

    def train_step(batch):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(master[n].full_tensor())
        with sharding.batch_axes(("data",)):
            local = {k: rows(v) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, local, n_microbatches)
        loss = loss.float()
        dist.all_reduce(loss, group=group)
        loss = loss / data
        full = {}
        for n in params:                # in place where fp32: no copy
            g = grads.pop(n)
            g32 = g.float()
            dist.all_reduce(g32, group=group)
            full[n] = g32.div_(data).to(g.dtype)
            del g, g32
        gnorm = opt_lib.global_norm(full[n] for n in params)
        k = opt_lib.step_scalars(opt_state, gnorm, ocfg)
        with torch.no_grad():
            for n in params:
                g = DTensor.from_local(full.pop(n), mesh, replicated,
                                       run_check=False)
                g = g.redistribute(mesh, oplace[n]).to_local()
                p = master[n].redistribute(mesh, oplace[n])
                opt_lib.update_leaf(p.to_local(), g,
                                    opt_state.mu[n].to_local(),
                                    opt_state.nu[n].to_local(), k, ocfg)
                master[n] = p.redistribute(mesh, place[n])
        return dict(loss=loss, grad_norm=gnorm, lr=k.lr)

    train_step.master = master
    return train_step
