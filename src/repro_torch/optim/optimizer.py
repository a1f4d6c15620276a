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
reference's low-memory mode), which :func:`moment_dtype_for` takes for
the architectures above :data:`BF16_MOMENTS_ABOVE` parameters.
:func:`zero1_spec` / :func:`opt_state_specs` are the reference's ZeRO-1
specs: each moment takes its parameter's spec with the largest
still-unsharded axis sharded over "data" where it divides;
``launch.steps.build_sharded_train_step`` places the moments by them and
updates each rank's slice with :func:`update_leaf`, the same arithmetic
:func:`apply` runs on a whole leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from ..models.sharding import P


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


#: an architecture above this many parameters keeps bf16 moments (the
#: reference's dry-run takes its low-memory mode there)
BF16_MOMENTS_ABOVE = 1e11


def moment_dtype_for(cfg) -> str:
    """The moments' dtype a model of ``cfg`` trains with: ``"bfloat16"``
    where its architecture's published size (the registered config of its
    name, else ``cfg`` itself) is above :data:`BF16_MOMENTS_ABOVE`, so a
    run that cuts the depth or the experts keeps the full model's mode;
    ``"float32"`` otherwise."""
    from ..configs import ARCHS
    full = ARCHS.get(cfg.name, cfg)
    return "bfloat16" if full.param_count() > BF16_MOMENTS_ABOVE \
        else "float32"


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


class StepScalars(NamedTuple):
    """What every leaf's update of one step shares (device scalars)."""
    scale: torch.Tensor     # the global-norm clip factor
    lr: torch.Tensor
    bc1: torch.Tensor       # bias corrections 1 - b**step
    bc2: torch.Tensor


@torch.no_grad()
def step_scalars(state: OptState, gnorm: torch.Tensor,
                 cfg: OptConfig) -> StepScalars:
    """Advance ``state.step`` by one and return the step's clip factor,
    lr and bias corrections for a gradient of global norm ``gnorm``."""
    state.step.add_(1)
    stepf = state.step.float()
    b1, b2 = cfg.betas
    return StepScalars(
        scale=torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0),
        lr=schedule(state.step, cfg), bc1=1 - b1 ** stepf,
        bc2=1 - b2 ** stepf)


#: elements a leaf's update takes at a time: its fp32 temporaries stay
#: within a few multiples of 1 GiB whatever the leaf's size
UPDATE_CHUNK = 1 << 28


@torch.no_grad()
def update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, k: StepScalars, cfg: OptConfig) -> None:
    """One AdamW update of a parameter ``p`` (or any slice of it) and its
    moments ``m``, ``v`` (the same slice) in place, in fp32; a leaf of
    more than ``UPDATE_CHUNK`` elements a block of its leading dimension
    at a time (elementwise: the same numbers)."""
    if p.dim() and p.numel() > UPDATE_CHUNK and p.shape[0] > 1:
        rows = max(1, UPDATE_CHUNK // (p.numel() // p.shape[0]))
        for i in range(0, p.shape[0], rows):
            part = slice(i, i + rows)
            _update(p[part], g[part], m[part], v[part], k, cfg)
        return
    _update(p, g, m, v, k, cfg)


def _update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor, k: StepScalars, cfg: OptConfig) -> None:
    b1, b2 = cfg.betas
    g = g.float() * k.scale
    m2 = b1 * m.float() + (1 - b1) * g
    v2 = b2 * v.float() + (1 - b2) * g * g
    del g
    delta = (m2 / k.bc1) / (torch.sqrt(v2 / k.bc2) + cfg.eps)
    m.copy_(m2)
    v.copy_(v2)
    del m2, v2
    delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - k.lr * delta)


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: OptState,
          cfg: OptConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params``, ``state.mu`` / ``state.nu`` and
    ``state.step`` are updated in place; returns ``{"grad_norm", "lr"}``
    as device scalars."""
    gnorm = global_norm(grads[n] for n in params)
    k = step_scalars(state, gnorm, cfg)
    for name, p in params.items():
        update_leaf(p, grads[name], state.mu[name], state.nu[name], k, cfg)
    return dict(grad_norm=gnorm, lr=k.lr)


# ---------------------------------------------------------------- sharding


def zero1_spec(spec: P, shape: Tuple[int, ...], data_axis: str = "data",
               data_size: int = 16) -> P:
    """ZeRO-1: shard the largest unsharded axis of an optimizer-state
    tensor over the data axis (if divisible and not already used)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for pt in parts:
        for ax in (pt if isinstance(pt, tuple) else (pt,)):
            if ax is not None:
                used.add(ax)
    if data_axis in used:
        return P(*parts)
    best, best_size = None, 0
    for i, (pt, sz) in enumerate(zip(parts, shape)):
        if pt is None and sz % data_size == 0 and sz > best_size:
            best, best_size = i, sz
    if best is not None:
        parts[best] = data_axis
    return P(*parts)


def opt_state_specs(param_specs: Mapping[str, P],
                    param_shapes: Mapping[str, Tuple[int, ...]],
                    data_size: int = 16) -> OptState:
    """Specs for an :class:`OptState` over the parameters' specs and
    shapes (mappings by name): ``step`` replicated, ``mu`` and ``nu``
    by :func:`zero1_spec`."""
    mu = {n: zero1_spec(s, tuple(param_shapes[n]), data_size=data_size)
          for n, s in param_specs.items()}
    return OptState(step=P(), mu=mu, nu=dict(mu))
