"""Host references for the connectivity query kinds, in the spirit of
``core/bridges_host.py``: sequential Tarjan low-link DFS in numpy, iterative
(explicit stack) so large graphs don't hit Python recursion limits. A copy
of ``repro.connectivity.host``: the port imports nothing of the JAX package.

Parallel edges are handled by skipping only the *edge id* used to enter a
vertex, so a doubled edge correctly acts as a back edge. Vertex connectivity
ignores edge multiplicity, so a parallel edge to the parent still counts
toward the low value — which is exactly what the eid skip yields.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.graph.datastructs import build_csr


def articulation_points_dfs(src: np.ndarray, dst: np.ndarray,
                            n_nodes: int) -> set[int]:
    """Cut vertices: non-root v with a child c where low(c) >= disc(v);
    a DFS root iff it has >= 2 tree children."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = src != dst  # self loops never matter for connectivity
    src, dst = src[keep], dst[keep]
    indptr, indices, eids = build_csr(src, dst, n_nodes)

    disc = np.full(n_nodes, -1, np.int64)
    low = np.zeros(n_nodes, np.int64)
    ptr = indptr[:-1].copy()
    out: set[int] = set()
    timer = 0
    for root in range(n_nodes):
        if disc[root] != -1:
            continue
        stack = [(root, -1)]  # (vertex, entering edge id)
        disc[root] = low[root] = timer
        timer += 1
        root_children = 0
        while stack:
            v, in_eid = stack[-1]
            if ptr[v] < indptr[v + 1]:
                w = int(indices[ptr[v]])
                eid = int(eids[ptr[v]])
                ptr[v] += 1
                if eid == in_eid:
                    continue  # don't reuse the entering edge instance
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    if v == root:
                        root_children += 1
                    stack.append((w, eid))
                else:
                    low[v] = min(low[v], disc[w])
            else:
                stack.pop()
                if stack:
                    p, _ = stack[-1]
                    low[p] = min(low[p], low[v])
                    if p != root and low[v] >= disc[p]:
                        out.add(p)
        if root_children >= 2:
            out.add(root)
    return out


def host_bcc_labels(src: np.ndarray, dst: np.ndarray,
                    n_nodes: int) -> set[frozenset[int]]:
    """Biconnected blocks as canonical vertex sets — iterative Tarjan BCC
    with an explicit edge stack (matches ``networkx.biconnected_components``
    up to set equality).

    Works on the SIMPLE support: self loops never join a block and a
    parallel copy changes which EDGES are biconnected but never a block's
    vertex set, so multigraph inputs are deduplicated up front — the same
    semantics the device analysis produces.
    """
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = np.minimum(src, dst) * n_nodes + np.maximum(src, dst)
    _, first = np.unique(key, return_index=True)
    src, dst = src[first], dst[first]
    indptr, indices, eids = build_csr(src, dst, n_nodes)

    disc = np.full(n_nodes, -1, np.int64)
    low = np.zeros(n_nodes, np.int64)
    ptr = indptr[:-1].copy()
    blocks: set[frozenset[int]] = set()
    estack: list[tuple[int, int]] = []
    timer = 0
    for root in range(n_nodes):
        if disc[root] != -1:
            continue
        stack = [(root, -1)]  # (vertex, entering edge id)
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            v, in_eid = stack[-1]
            if ptr[v] < indptr[v + 1]:
                w = int(indices[ptr[v]])
                eid = int(eids[ptr[v]])
                ptr[v] += 1
                if eid == in_eid:
                    continue  # don't reuse the entering edge instance
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    estack.append((v, w))
                    stack.append((w, eid))
                elif disc[w] < disc[v]:  # back edge (once, not from below)
                    estack.append((v, w))
                    low[v] = min(low[v], disc[w])
            else:
                stack.pop()
                if stack:
                    p, _ = stack[-1]
                    low[p] = min(low[p], low[v])
                    if low[v] >= disc[p]:
                        # (p, v) closes a block: pop its edges off the stack
                        block: set[int] = set()
                        while estack:
                            a, b = estack.pop()
                            block.add(a)
                            block.add(b)
                            if (a, b) == (p, v):
                                break
                        blocks.add(frozenset(block))
    return blocks


def two_ecc_labels_dfs(src: np.ndarray, dst: np.ndarray,
                       n_nodes: int) -> np.ndarray:
    """int64[n] canonical 2ECC labels: union-find over non-bridge edges,
    labels canonicalized to each class's minimum member vertex id."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    br = bridges_dfs(src, dst, n_nodes)
    parent = np.arange(n_nodes)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(src.tolist(), dst.tolist()):
        if u == v or (min(u, v), max(u, v)) in br:
            continue
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)  # min-id root => canonical
    return np.array([find(v) for v in range(n_nodes)])


def bridge_tree_dfs(src: np.ndarray, dst: np.ndarray,
                    n_nodes: int) -> set[tuple[int, int]]:
    """Bridge tree edges as (min, max) pairs of canonical 2ECC labels."""
    labels = two_ecc_labels_dfs(src, dst, n_nodes)
    out = set()
    for u, v in bridges_dfs(src, dst, n_nodes):
        a, b = int(labels[u]), int(labels[v])
        out.add((min(a, b), max(a, b)))
    return out
