"""Gradient compression for the data-parallel reduction, the counterpart
of the JAX package's ``optim/compression.py``.

Two composable schemes:

* **int8 quantized all-reduce** — per-tensor symmetric scale, quantize to
  int8, sum in int32, dequantize.  :func:`compressed_psum` all-reduces the
  scales' maximum first, requantises against it, so that the int32 sum is
  exact, and moves the payload as int32 over a ``torch.distributed``
  process group (the reference's ``axis_name``: a ``DeviceMesh``
  dimension's group).  Stochastic rounding takes an explicit
  ``torch.Generator``.
* **top-k sparsification with error feedback** — keep the k largest-
  magnitude entries per tensor, accumulate the residual locally and add
  it back next step (Stich et al., 2018).  A gradient tree here is a
  mapping of name -> tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

# ------------------------------------------------------------- int8 AR


def quantize_int8(x: torch.Tensor, stochastic: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32)`` with ``x ≈ q · scale`` and |q| ≤ 127;
    with ``stochastic`` and a ``generator``, uniform noise in [-0.5, 0.5)
    is added before rounding."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    y = x.float() / scale
    if stochastic and generator is not None:
        y = y + (torch.rand(y.shape, generator=generator,
                            device=generator.device) - 0.5).to(y.device)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-quantized sum of ``x`` over the ranks of ``group`` (the
    default group when ``None``), in ``x``'s dtype: the scales' maximum is
    all-reduced in fp32, each rank requantises against it, and the int32
    payload is summed exactly."""
    import torch.distributed as dist
    _, scale = quantize_int8(x)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    q2 = torch.clamp(torch.round(x.float() / scale_max),
                     -127, 127).to(torch.int32)
    dist.all_reduce(q2, op=dist.ReduceOp.SUM, group=group)
    return (q2.float() * scale_max).to(x.dtype)


# ------------------------------------------------------------- top-k EF


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Dict[str, torch.Tensor]     # fp32, by gradient name


def init_error_feedback(grads_like: Mapping[str, torch.Tensor]
                        ) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual={
        n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for n, g in grads_like.items()})


def topk_sparsify(x: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``frac`` largest-|.| entries (every entry tied with the
    k-th largest too); returns ``(sparse_x, mask)`` in fp32."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (flat.abs() >= thresh).float()
    return (flat * mask).reshape(x.shape), mask.reshape(x.shape)


def topk_ef_step(grads: Mapping[str, torch.Tensor], ef: ErrorFeedbackState,
                 frac: float = 0.01
                 ) -> Tuple[Dict[str, torch.Tensor], ErrorFeedbackState]:
    """Error-feedback top-k compression of a gradient mapping: returns
    (the compressed gradients to all-reduce, in each gradient's dtype;
    the new residual state)."""
    comp, res = {}, {}
    for n, g in grads.items():
        acc = g.float() + ef.residual[n]
        sparse, _ = topk_sparsify(acc, frac)
        res[n] = acc - sparse
        comp[n] = sparse.to(g.dtype)
    return comp, ErrorFeedbackState(residual=res)
