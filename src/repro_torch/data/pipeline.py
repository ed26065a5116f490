"""Deterministic synthetic data pipelines, copied from
``src/repro/data/pipeline.py`` (numpy only).

Determinism contract: every batch is a pure function of (seed, step), so
the JAX package and the port draw the same batches, and a restarted run
resumes at the exact batch it stopped on with no loader state beyond the
step counter. Host-side numpy with a double-buffered prefetch thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    """LM batches: Zipf-ish token stream with local structure (so the loss
    has signal to minimize: token t+1 correlates with token t)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # Markov-ish stream: next = (cur * a + noise) % vocab
        base = rng.integers(0, self.vocab, (self.batch, 1))
        steps = rng.integers(0, 7, (self.batch, self.seq))
        toks = (base + np.cumsum(steps, axis=1)) % self.vocab
        toks = np.concatenate([base % self.vocab, toks], axis=1)
        return {"tokens": toks.astype(np.int32)}  # [B, S+1]

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class GraphBatches:
    """Full-graph data: one fixed graph + synthetic node labels."""

    def __init__(self, n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 seed: int = 0):
        from repro_torch.graph import generators as gen

        rng = np.random.default_rng(seed)
        src, dst = gen.random_graph(n_nodes, n_edges, seed=seed)
        self.graph = {
            "src": src,
            "dst": dst,
            "mask": np.ones(len(src), bool),
            "feats": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
            "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
            "label_mask": (rng.random(n_nodes) < 0.5),
        }

    def batch_at(self, step: int) -> dict:
        return self.graph


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


class Prefetcher:
    """Double-buffered host prefetch: overlaps batch synthesis/IO with step
    execution (the CPU-side analogue of an infeed queue). Yields
    ``(step, batch)`` from ``start_step`` on; ``close`` stops the thread."""

    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch_fn(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
