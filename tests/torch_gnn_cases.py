"""The graph networks' card-against-CPU cases, shared by ``chip_smoke.py``'s
``gnn_check`` phase and the ``gpu`` tests of ``test_torch_cuda.py``: the
(arch, mode) pairs, their tolerances and a seeded numpy batch of each mode.
It imports numpy only."""
from __future__ import annotations

import numpy as np

#: (config id, mode): every arch's full-graph step, egnn's batched step and
#: GraphSAGE's sampled one
GNN_CHECK_CASES = (("graphsage_reddit", "full"), ("pna", "full"),
                   ("egnn", "full"), ("gatedgcn", "full"),
                   ("egnn", "batched"), ("graphsage_reddit", "sampled"))
#: max |card - CPU| over the CPU leaf's largest magnitude (the scalars
#: relative): 1e-4 in float32, since the card's segment sums add by
#: atomics in another order and a ReLU (GraphSAGE, PNA, GatedGCN) input
#: within rounding of 0 flips a unit's gradient on one device; PNA 1e-3,
#: its std aggregator sqrt(sq - mean^2 + 1e-6) amplifying a rounding by up
#: to 500
GNN_CHECK_TOL = {"graphsage": 1e-4, "pna": 1e-3, "egnn": 1e-4,
                 "gatedgcn": 1e-4}


def gnn_batch(cfg, mode: str, seed: int, n: int = 40, m: int = 120,
              graphs: int = 3) -> dict:
    """A batch of ``mode`` for ``cfg``, numpy: a multigraph of ``n`` nodes
    and ``m`` edges with 8 masked slots of ids -1 and ``n`` (full);
    ``graphs`` such graphs stacked, 3 masked slots each (batched); 8 seeds
    of ``cfg.sample_sizes`` (sampled)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_feat
    if mode == "sampled":
        f1, f2 = cfg.sample_sizes
        m1 = rng.random((8, f1)) < 0.8
        return {"x0": rng.standard_normal((8, d), np.float32),
                "x1": rng.standard_normal((8, f1, d), np.float32),
                "x2": rng.standard_normal((8, f1, f2, d), np.float32),
                "m1": m1,
                "m2": (rng.random((8, f1, f2)) < 0.7) & m1[:, :, None],
                "labels": rng.integers(0, cfg.n_classes, 8).astype(np.int32)}
    if mode == "batched":
        src = rng.integers(0, n, (graphs, m)).astype(np.int32)
        dst = rng.integers(0, n, (graphs, m)).astype(np.int32)
        src[:, -3:], dst[:, -3:] = -1, n
        gs = {"src": src, "dst": dst,
              "mask": np.broadcast_to(np.arange(m) < m - 3,
                                      (graphs, m)).copy(),
              "h": rng.standard_normal((graphs, n, d), np.float32),
              "x": rng.standard_normal((graphs, n, 3), np.float32)}
        return {"graphs": gs,
                "targets": rng.standard_normal(graphs, np.float32)}
    src = np.concatenate([rng.integers(0, n, m), np.full(8, -1)])
    dst = np.concatenate([rng.integers(0, n, m), np.full(8, n)])
    g = {"src": src.astype(np.int32), "dst": dst.astype(np.int32),
         "mask": np.arange(m + 8) < m}
    if cfg.arch == "egnn":
        g.update(h=rng.standard_normal((n, d), np.float32),
                 x=rng.standard_normal((n, 3), np.float32),
                 target=np.full((1,), 0.5, np.float32))
    else:
        g.update(feats=rng.standard_normal((n, d), np.float32),
                 labels=rng.integers(0, cfg.n_classes, n).astype(np.int32),
                 label_mask=rng.random(n) < 0.7)
    return g
