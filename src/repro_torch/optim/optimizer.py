"""AdamW + schedule + clipping over a model's named parameters, the
counterpart of the JAX package's ``optim/optimizer.py``.

``params`` and ``grads`` are mappings of name -> tensor (the model's
``named_parameters()``); the moments ``mu`` / ``nu`` are mappings with
the same names.  The update is the reference's, op for op: fp32
arithmetic, the global-norm clip, weight decay on every leaf, bias
correction, then a cast back to each tensor's dtype.  Unlike the
reference, which returns new trees, :func:`apply` writes the parameters
and the moments in place under ``torch.no_grad()``, and the step counter
is a device tensor, so a step needs no host sync.

Moments are fp32, or bf16 under ``moment_dtype="bfloat16"`` (the
reference's low-memory mode).  Not here: ``zero1_spec`` and
``opt_state_specs``, which shard the state over a mesh's data axis and
mean nothing without a process group (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"      # "bfloat16" => low-memory mode


class OptState(NamedTuple):
    step: torch.Tensor                 # int32 scalar on the device
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> OptState:
    """Zero moments beside each parameter, on its device; step 0."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else \
        torch.float32
    dev = next(iter(params.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()})


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0.1·lr, in fp32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` of their fp32 sums of squares,
    summed in their order."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: OptState,
          cfg: OptConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params``, ``state.mu`` / ``state.nu`` and
    ``state.step`` are updated in place; returns ``{"grad_norm", "lr"}``
    as device scalars."""
    state.step.add_(1)
    step = state.step
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.betas
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for name, p in params.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].float() * scale
        m2 = b1 * m.float() + (1 - b1) * g
        v2 = b2 * v.float() + (1 - b2) * g * g
        del g
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        m.copy_(m2)
        v.copy_(v2)
        del m2, v2
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return dict(grad_norm=gnorm, lr=lr)
