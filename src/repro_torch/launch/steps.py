"""Step builders of the server, the counterparts of the JAX package's
``build_serve_step`` and ``build_prefill_step`` (``launch/steps.py``).

The model holds its weights, so a step takes no ``params``; both run
under ``torch.inference_mode()``.  ``build_train_step`` waits for the
port's optimizer (the training slice of ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model


def build_serve_step(model: Model) -> Callable:
    """(cache, tokens [B,1], pos int) -> logits [B,1,V]; the token's K/V
    are written into ``cache`` in place."""

    @torch.inference_mode()
    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return serve_step


def build_prefill_step(model: Model) -> Callable:
    """Prefill is the forward pass: batch ``{"tokens": [B,S]}`` -> logits
    over the whole prompt [B,S,V]."""

    @torch.inference_mode()
    def prefill_step(batch):
        return model(batch["tokens"])

    return prefill_step
