"""Carry the JAX package's model weights into a :class:`Model`.

The input is the reference's ``Model.init`` parameter tree with numpy
leaves (what ``jax.tree.map(np.asarray, params)`` gives): ``embed``,
``unembed`` (untied configs), ``final_ln`` and one ``g{i}`` per pattern
entry whose leaves stack the layers ``[n_super, repeat, ...]``.  bf16
leaves cross as their raw bits (numpy has no bf16 of its own).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .model import Model


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)                 # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _copy(dst: torch.Tensor, arr: np.ndarray, name: str) -> None:
    src = _tensor(arr)
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"{name}: the tree holds {tuple(src.shape)} "
                         f"{src.dtype}, the model {tuple(dst.shape)} "
                         f"{dst.dtype}")
    dst.copy_(src)


def _leaf(tree: Mapping[str, Any], path: str) -> np.ndarray:
    for key in path.split("."):
        tree = tree[key]
    return tree


@torch.no_grad()
def load_jax_params(model: Model, tree: Mapping[str, Any]) -> Model:
    """Copy every weight of ``tree`` into ``model`` (shapes and dtypes
    must match) and return ``model``."""
    cfg = model.cfg
    _copy(model.embed, tree["embed"], "embed")
    if model.unembed is not None:
        _copy(model.unembed, tree["unembed"], "unembed")
    _copy(model.final_ln, tree["final_ln"], "final_ln")
    blocks = iter(model.blocks)
    for s in range(cfg.n_super):
        for i, b in enumerate(cfg.pattern):
            for r in range(b.repeat):
                blk = next(blocks)
                for name, p in blk.named_parameters():
                    _copy(p, _leaf(tree[f"g{i}"], name)[s, r],
                          f"g{i}.{name}[{s}, {r}]")
    return model
