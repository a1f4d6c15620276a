"""Abstract inputs and per-device state for every (arch x shape) cell, the
counterpart of the JAX package's ``launch/specs.py``.

The reference builds ``jax.ShapeDtypeStruct`` stand-ins that are never
allocated; here the stand-ins are ``meta`` tensors, which carry a shape
and a dtype and no storage, so a rank's step runs on them op by op (the
dry-run, :mod:`repro_torch.launch.dryrun`) without a byte of weight or
activation memory.  The placements come from ``Model.param_specs()``,
:func:`optimizer.opt_state_specs` and the mesh's batch axes, as the
reference's shardings do.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.shapes import ShapeSpec
from ..models.config import ModelConfig
from ..models.sharding import P, _names
from ..optim import optimizer as opt_lib

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_spec(cfg: ModelConfig, sh: ShapeSpec, rows: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """The training / prefill batch of one cell on ``meta``: the global
    batch, or ``rows`` of it (a rank's share)."""
    b, s = (sh.global_batch if rows is None else rows), sh.seq_len
    s_text = s - (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    out = dict(tokens=_meta((b, s_text), torch.int32),
               labels=_meta((b, s_text), torch.int32))
    if cfg.frontend == "vision":
        out["frontend"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                torch.bfloat16)
    if cfg.frontend == "audio":
        out["enc_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return out


def rows_per_rank(sh: ShapeSpec, n_batch_ranks: int) -> int:
    """A rank's share of the batch's rows: the global batch over the
    ranks of the batch axes where it divides, all of it otherwise (the
    reference then replicates the batch, as for ``long_500k``'s one
    sequence)."""
    b = sh.global_batch
    return b // n_batch_ranks if b % n_batch_ranks == 0 else b


def decode_inputs(cfg: ModelConfig, sh: ShapeSpec, model, rows: int
                  ) -> Tuple[list, torch.Tensor, int]:
    """``(cache, tokens [rows, 1], pos)`` of a decode cell on ``meta``:
    ``model``'s cache of ``rows`` sequences of ``seq_len`` positions (this
    rank's heads; an encoder-decoder's cross K/V from ``min(seq_len,
    4096)`` frames, as the reference's), and the last position, so the
    step attends to a full cache."""
    s = sh.seq_len
    enc = None
    if cfg.n_enc_layers:
        enc = _meta((rows, min(s, 4096), cfg.d_model), torch.bfloat16)
    with torch.inference_mode():
        cache = model.init_cache(rows, s, enc_embeds=enc)
    return cache, _meta((rows, 1), torch.int32), s - 1


def spec_share(shape: Tuple[int, ...], spec: P,
               mesh_shape: Mapping[str, int]) -> float:
    """The share of a leaf of ``shape`` one device holds under ``spec``:
    its elements over the sizes of the mesh dimensions ``spec`` names
    (the reference's ``_tree_device_bytes``)."""
    n = 1
    for d in shape:
        n *= d
    div = 1
    for part in spec:
        for ax in _names(part):
            div *= mesh_shape[ax]
    return n / div


def state_bytes_by_specs(model, mesh_shape: Mapping[str, int],
                         ocfg: Optional[opt_lib.OptConfig] = None
                         ) -> Tuple[float, float]:
    """Per-device bytes of the parameters and of the optimizer's moments
    (0 without ``ocfg``) as the specs place them: the reference's
    analytic ``state_bytes_per_device``.  ``model`` may hold shards; the
    whole shapes are taken from its layout."""
    layout = model.layout()
    shapes = model.whole_shapes()
    params = 0.0
    for n, p in model.named_parameters():
        params += spec_share(shapes[n], layout[n].spec, mesh_shape) * \
            p.element_size()
    moments = 0.0
    if ocfg is not None:
        mdt = 2 if ocfg.moment_dtype == "bfloat16" else 4
        ospecs = opt_lib.opt_state_specs(
            {n: layout[n].spec for n in shapes}, shapes,
            data_size=mesh_shape["data"])
        for n, shape in shapes.items():
            moments += 2 * spec_share(shape, ospecs.mu[n], mesh_shape) * mdt
    return params, moments
