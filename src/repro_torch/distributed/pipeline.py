"""GPipe-style pipeline parallelism over a ``DeviceMesh`` dimension, the
counterpart of the JAX package's ``distributed/pipeline.py``.

Each rank along the ``pipe`` dimension holds ONE stage's weights;
microbatches stream through the stages, each tick's output hopping to
the next rank of the dimension by a send/receive pair
(``batch_isend_irecv``), where the reference uses ``ppermute``.

The schedule is the classic GPipe fill-drain: T = n_micro + n_stages - 1
ticks; rank s computes microbatch m at tick t = m + s.  Bubble fraction
= (n_stages-1)/T, so callers should use n_micro >> n_stages.  Every rank
computes at every tick, as the reference's ``fori_loop`` does; the
outputs of ticks outside a rank's microbatches are dropped.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through ``n_stages`` pipelined applications of
    ``stage_fn``, ``n_stages`` the size of ``mesh``'s ``axis``.

    stage_params: a tree of tensors with leading axis n_stages (each rank
    uses its own stage's slice); x: [n_micro, mb, ...] microbatched input,
    the same on every rank.  Returns the LAST stage's outputs
    [n_micro, mb, ...] on every rank of the dimension."""
    import torch.distributed as dist
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.shape[dim]
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    params = pytree.tree_map(lambda t: t[stage], stage_params)
    n_micro = x.shape[0]
    carry = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        inp = x[min(t, n_micro - 1)] if stage == 0 else carry
        out = stage_fn(params, inp)
        m_out = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= m_out < n_micro:
            outs[m_out] = out
        ops = []
        if stage + 1 < n_stages:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  ranks[stage + 1], group))
        if stage > 0:
            carry = torch.empty_like(out)
            ops.append(dist.P2POp(dist.irecv, carry, ranks[stage - 1],
                                  group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    # the last stage's outputs to every rank of the dimension
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs
