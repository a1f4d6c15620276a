"""Step builders shared by the trainer and the server, the counterparts
of the JAX package's ``build_train_step``, ``build_serve_step`` and
``build_prefill_step`` (``launch/steps.py``).

The model holds its weights and the :class:`~repro_torch.optim.optimizer.
OptState` its moments, so a step takes neither: the train step is
``(batch) -> metrics`` and updates both in place; the serve and prefill
steps run under ``torch.inference_mode()``.
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
    encoder-decoder's ``"enc_embeds"`` [B,S_enc,d]) -> logits over the
    whole prompt [B,S,V]."""

    @torch.inference_mode()
    def prefill_step(batch):
        return model(batch["tokens"], batch.get("enc_embeds"))

    return prefill_step
