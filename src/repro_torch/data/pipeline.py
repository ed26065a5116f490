"""Deterministic synthetic data pipelines, copied from
``src/repro/data/pipeline.py`` (numpy only).

Determinism contract: every batch is a pure function of (seed, step), so
the JAX package and the port draw the same batches. Only the recsys batches
have come across; the token and graph streams wait for their slices.
"""
from __future__ import annotations

import numpy as np


def recsys_batches(n_items: int, batch: int, seq_len: int, seed: int = 0):
    """SASRec batches: (seq, pos, neg) with id 0 reserved for padding."""

    def batch_at(step: int) -> dict:
        rng = np.random.default_rng((seed, step))
        seq = rng.integers(1, n_items, (batch, seq_len + 1)).astype(np.int32)
        lengths = rng.integers(seq_len // 2, seq_len + 1, batch)
        pad = np.arange(seq_len + 1)[None, :] >= lengths[:, None]
        seq[pad] = 0
        neg = rng.integers(1, n_items, (batch, seq_len)).astype(np.int32)
        return {
            "seq": seq[:, :-1],
            "pos": seq[:, 1:],
            "neg": np.where(seq[:, 1:] != 0, neg, 0),
        }

    return batch_at
