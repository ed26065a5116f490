"""Edge partitioning (paper §III: E = U_0 ∪ U_1 ∪ … ∪ U_{M-1};
``repro.core.partition``, copied: it is numpy-only host code).

Host-side: random permutation, then equal fixed-capacity shards with
padding, so the stacked ``[M, cap]`` buffers hold one machine per row. The
same ``seed`` gives the same partition as the JAX package, bit for bit
(``np.random.default_rng(seed).permutation``).
"""
from __future__ import annotations

import numpy as np


def partition_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int, m: int, seed: int = 0):
    """Return (src[m, cap], dst[m, cap], mask[m, cap]) numpy shards."""
    e = len(src)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(e)
    src, dst = np.asarray(src)[perm], np.asarray(dst)[perm]
    cap = max((e + m - 1) // m, 1)
    psrc = np.zeros((m, cap), np.int32)
    pdst = np.zeros((m, cap), np.int32)
    pmask = np.zeros((m, cap), bool)
    flat_mask = np.zeros(m * cap, bool)
    flat_mask[:e] = True
    psrc.reshape(-1)[:e] = src
    pdst.reshape(-1)[:e] = dst
    pmask[:] = flat_mask.reshape(m, cap)
    return psrc, pdst, pmask


def shard_capacity(n_edges: int, m: int) -> int:
    return max((n_edges + m - 1) // m, 1)
