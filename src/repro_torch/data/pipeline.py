"""Deterministic synthetic token pipeline with sharded host feeding.

A copy of the JAX package's ``data/pipeline.py`` (numpy only): batches are
bit-equal to the reference's for the same config, step and shard.

Production layering without external data deps: an infinite, seekable
stream of language-modeling batches derived from a counter-based PRNG —
``batch_at(step)`` is a pure function, so restarts resume EXACTLY at the
failed step (checkpoint stores only the step counter) and any host can
materialize any shard of any batch (elastic re-sharding is trivial).

A Zipf-ish marginal over the vocabulary plus a deterministic n-gram-like
mixing makes the loss non-trivial (models actually learn on it — see
tests/test_archs_smoke.py::test_loss_decreases_on_fixed_batch, and the
port's tests/test_torch_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    frontend: Optional[str] = None       # None | vision | audio
    n_frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Counter-based deterministic batch source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self._probs = probs / probs.sum()
        # fixed token-mixing matrix for pseudo-ngram structure
        self._mix = rng.integers(1, cfg.vocab_size,
                                 size=4096).astype(np.int64)

    def batch_at(self, step: int,
                 shard: Tuple[int, int] = (0, 1)) -> Dict[str, np.ndarray]:
        """Batch for ``step``; ``shard=(i, n)`` returns the i-th of n
        equal slices along the batch axis (per-host feeding)."""
        cfg = self.cfg
        i, n = shard
        assert cfg.global_batch % n == 0
        b = cfg.global_batch // n
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, i]))
        base = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1),
                          p=self._probs)
        # deterministic structure: x[t+1] correlates with mix[x[t] % 4096]
        structured = self._mix[base[:, :-1] % 4096] % cfg.vocab_size
        use = rng.random((b, cfg.seq_len)) < 0.5
        tokens = np.where(use, structured, base[:, 1:]).astype(np.int32)
        prev = base[:, :-1].astype(np.int32)
        out = {"tokens": prev, "labels": tokens}
        if cfg.frontend == "vision":
            out["frontend"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
            out["tokens"] = out["tokens"][:, :cfg.seq_len -
                                          cfg.n_frontend_tokens]
            out["labels"] = out["labels"][:, :cfg.seq_len -
                                          cfg.n_frontend_tokens]
        if cfg.frontend == "audio":
            out["enc_embeds"] = rng.standard_normal(
                (b, cfg.seq_len, cfg.d_model)).astype(np.float32) * 0.02
        return out

    def iterate(self, start_step: int = 0,
                shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step, shard)
            step += 1


def make_data(model_cfg, shape) -> SyntheticLM:
    """Build a pipeline matched to a model config + shape cell."""
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        frontend=model_cfg.frontend,
        n_frontend_tokens=model_cfg.n_frontend_tokens,
        d_model=model_cfg.d_model,
    ))
