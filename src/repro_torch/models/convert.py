"""Carry the JAX package's model weights, gradients and optimizer state
into the port.

The input is a tree shaped like the reference's ``Model.init`` parameter
tree, with numpy leaves (what ``jax.tree.map(np.asarray, tree)`` gives):
``embed``, ``unembed`` (untied configs), ``final_ln`` and one ``g{i}`` per
pattern entry whose leaves stack the layers ``[n_super, repeat, ...]``
(nested for a block's parts: ``attn.wq``, ``moe.w1``, ``xattn.wk``, ...),
except for a shared entry (``SHARED_KINDS``), whose ``g{i}`` holds its
one copy unstacked; an encoder-decoder's ``enc`` stacks the encoder
blocks ``[n_enc_layers, ...]`` beside ``enc_ln``.
The reference's gradients and its ``OptState.mu`` / ``nu`` have that
shape too.  bf16 leaves cross as their raw bits (numpy has no bf16 of
its own).  Every function visits the leaves in one order
(:func:`_named_slots`): the model's parameters, the blocks in the order
of the reference's scan, a shared block at its first position only,
then the encoder's blocks (the order of ``model.named_parameters()``).
:func:`specs_from_jax` reads the reference's ``param_specs()`` tree the
same way.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..optim.optimizer import OptState
from .model import SHARED_KINDS, Model


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


def _named_slots(model: Model, tree: Mapping[str, Any]
                 ) -> Iterator[Tuple[str, torch.Tensor, Any, str,
                                     Tuple[int, ...]]]:
    """``(port name, port parameter, tree leaf, tree path, index)`` for
    every parameter of ``model``, once each (the names of
    ``model.named_parameters()``): ``leaf[index]`` is the parameter's
    slice of a stacked leaf (``index`` is ``()`` for an unstacked one)."""
    cfg = model.cfg
    for name in ("embed", "unembed", "final_ln", "enc_ln"):
        p = getattr(model, name)
        if p is not None:
            yield name, p, tree[name], name, ()
    blocks = iter(enumerate(model.blocks))
    for s in range(cfg.n_super):
        for i, b in enumerate(cfg.pattern):
            for r in range(b.repeat):
                n, blk = next(blocks)
                shared = b.kind in SHARED_KINDS
                if shared and (s, r) != (0, 0):
                    continue                # yielded at its first use
                for name, p in blk.named_parameters():
                    leaf, path = _leaf(tree[f"g{i}"], name), f"g{i}.{name}"
                    idx = () if shared else (s, r)
                    yield f"blocks.{n}.{name}", p, leaf, path, idx
    for n, blk in enumerate(model.enc):
        for name, p in blk.named_parameters():
            yield (f"enc.{n}.{name}", p, _leaf(tree["enc"], name),
                   f"enc.{name}", (n,))


def _named_leaves(model: Model, tree: Mapping[str, Any]
                  ) -> Iterator[Tuple[str, torch.Tensor, np.ndarray, str]]:
    """``(port name, port parameter, tree leaf, tree path)`` for every
    parameter of ``model``, the leaf sliced to the parameter's layer and
    its path naming the slice (``g0.attn.wq[1, 0]``); for a model built
    on shards (``Model(cfg, tp=(rank, m), dp=(rank, D))``) each leaf the
    rank holds sliced is sliced as the build slices it."""
    layout = model.layout()
    for name, p, leaf, path, idx in _named_slots(model, tree):
        if idx:
            leaf, path = leaf[idx], f"{path}{list(idx)}"
        for axis, (rank, m), dim in (
                ("model", model.tp, layout[name].shard_dim),
                ("data", model.dp, layout[name].width_dim)):
            if dim is None:
                continue
            n = np.shape(leaf)[dim] // m
            leaf = np.take(leaf, np.arange(rank * n, (rank + 1) * n),
                           axis=dim)
            path = f"{path}<{axis} {rank}/{m}>"
        yield name, p, leaf, path


@torch.no_grad()
def load_jax_params(model: Model, tree: Mapping[str, Any]) -> Model:
    """Copy every weight of ``tree`` into ``model`` (shapes and dtypes
    must match) and return ``model``."""
    for _, p, arr, path in _named_leaves(model, tree):
        _copy(p, arr, path)
    return model


def named_from_jax(model: Model, tree: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """A tree shaped like the reference's parameters (its gradients, say)
    as ``{port parameter name: tensor}`` on the model's device, each leaf
    in its own dtype, its shape checked against the parameter's."""
    out = {}
    for name, p, arr, path in _named_leaves(model, tree):
        t = _tensor(arr)
        if t.shape != p.shape:
            raise ValueError(f"{path}: the tree holds {tuple(t.shape)}, "
                             f"the model {tuple(p.shape)}")
        out[name] = t.to(p.device)
    return out


def opt_state_from_jax(model: Model, state: Any) -> OptState:
    """The reference's ``OptState`` (``step``, ``mu``, ``nu`` with numpy
    leaves, the moments stacked per ``g{i}`` as the parameters are) as
    the port's, on the model's device."""
    dev = model.embed.device
    step = torch.from_numpy(np.array(state.step, dtype=np.int32)).to(dev)
    return OptState(step=step, mu=named_from_jax(model, state.mu),
                    nu=named_from_jax(model, state.nu))


def specs_from_jax(model: Model, specs: Mapping[str, Any]
                   ) -> Dict[str, Tuple]:
    """The reference's ``param_specs()`` tree as ``{port parameter name:
    tuple}``, each spec without the leading entries of the axes the
    reference stacks its layers on (which the port's parameters do not
    have)."""
    return {name: tuple(leaf)[len(idx):]
            for name, _, leaf, _, idx in _named_slots(model, specs)}
