"""Public API for the paper's algorithm on one device (``repro.core.api``
with ``mesh=None``).

    from repro_torch import find_bridges
    bridges = find_bridges(src, dst, n_nodes)                  # on the card
    bridges = find_bridges(src, dst, n_nodes, device="cpu")    # on the CPU
"""
from __future__ import annotations

import numpy as np

from repro_torch.connectivity.registry import _pair_set
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph.datastructs import EdgeList, admission_capacity

#: smallest shape bucket, as ``BridgeEngine(min_bucket=16)``
MIN_BUCKET = 16


def pad_graph(src, dst, n_nodes: int, device=None) -> EdgeList:
    """The padded buffer ``BridgeEngine.analyze`` builds: the vertex count
    and the edge capacity each rounded up to a power of two (at least 16)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    n_bucket = admission_capacity(n_nodes, MIN_BUCKET)
    cap = admission_capacity(max(len(src), 1), MIN_BUCKET)
    return EdgeList.from_arrays(src, dst, n_bucket, capacity=cap,
                                device=device)


def masked_arrays(out):
    """(src, dst, mask) buffers -> host (src[mask], dst[mask])."""
    s, d, m = (x.cpu().numpy() for x in out)
    return s[m], d[m]


def find_bridges(src, dst, n_nodes: int, *, final: str = "host",
                 device=None) -> set[tuple[int, int]]:
    """Find all bridges of the undirected graph (src[i], dst[i]).

    Sparse 2-edge certificate, then the final stage: host Tarjan DFS on the
    certificate (``final="host"``) or the device Euler-tour bridge mask
    (``final="device"``). Runs on the card unless ``device`` names another;
    without a card and without ``device`` it raises.
    """
    el = pad_graph(src, dst, n_nodes, device=device)
    out = make_analysis_fn(el.n_nodes, final)(el.src, el.dst, el.mask)
    if final == "host":
        return bridges_dfs(*masked_arrays(out), n_nodes)
    return _pair_set(out, n_nodes)
