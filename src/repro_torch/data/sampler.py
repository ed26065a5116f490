"""Uniform fan-out neighbour sampler (GraphSAGE minibatch training), copied
from ``src/repro/data/sampler.py`` (numpy only).

A real sampler over a CSR adjacency (the port's ``graph/datastructs.py::
build_csr``): per hop it samples ``fanout`` neighbours of each node,
without replacement when the degree reaches the fan-out and with
replacement below it, masks the slots of a node with no neighbour, and
gathers the features of every frontier. A batch is a pure function of
``(seed, step)`` and equal, bit for bit, to the JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.datastructs import build_csr


class NeighborSampler:
    def __init__(self, src, dst, n_nodes: int, feats: np.ndarray, seed: int = 0):
        self.indptr, self.indices, _ = build_csr(
            np.asarray(src), np.asarray(dst), n_nodes
        )
        self.n = n_nodes
        self.feats = feats
        self.seed = seed

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int, rng) -> tuple:
        """nodes: [B] -> (nbrs [B, fanout], mask [B, fanout])."""
        b = len(nodes)
        nbrs = np.zeros((b, fanout), np.int64)
        mask = np.zeros((b, fanout), bool)
        for i, v in enumerate(nodes):
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if deg >= fanout:
                sel = rng.choice(deg, size=fanout, replace=False)
            else:
                sel = rng.integers(0, deg, size=fanout)  # sample w/ replacement
            nbrs[i] = self.indices[lo + sel]
            mask[i] = True
            if deg < fanout:
                mask[i, deg:] = mask[i, deg:]  # all sampled slots valid
        return nbrs, mask

    def batch_at(self, step: int, batch_nodes: int, fanouts: tuple[int, int],
                 labels: np.ndarray) -> dict:
        """2-hop GraphSAGE batch: {x0, x1, x2, m1, m2, labels} (fixed shapes)."""
        rng = np.random.default_rng((self.seed, step))
        f1, f2 = fanouts
        seeds = rng.integers(0, self.n, batch_nodes)
        n1, m1 = self._sample_neighbors(seeds, f1, rng)
        n2_flat, m2_flat = self._sample_neighbors(n1.reshape(-1), f2, rng)
        return {
            "x0": self.feats[seeds],
            "x1": self.feats[n1.reshape(-1)].reshape(batch_nodes, f1, -1),
            "x2": self.feats[n2_flat.reshape(-1)].reshape(batch_nodes, f1, f2, -1),
            "m1": m1,
            "m2": m2_flat.reshape(batch_nodes, f1, f2) & m1[:, :, None],
            "labels": labels[seeds].astype(np.int32),
        }
