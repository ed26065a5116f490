"""Graph generators (host-side numpy; deterministic by seed).

A copy of ``repro.graph.generators``: the port imports nothing of the JAX
package.

Simple graphs (no self loops / parallel edges) are used for oracle
comparisons against networkx; the engine itself also handles multigraphs
(tested separately).
"""
from __future__ import annotations

import numpy as np


def random_graph(n: int, m: int, seed: int = 0, simple: bool = True):
    """m undirected edges over n vertices. Dense-friendly (m up to n*(n-1)/2)."""
    rng = np.random.default_rng(seed)
    max_m = n * (n - 1) // 2
    if simple:
        m = min(m, max_m)
        # Sample edge ranks without replacement from the upper triangle.
        ranks = rng.choice(max_m, size=m, replace=False)
        # rank -> (u, v): u = row via triangular-number inversion
        u = (np.floor((1 + np.sqrt(1 + 8 * ranks.astype(np.float64))) / 2)).astype(np.int64)
        # fix float rounding
        tri = u * (u - 1) // 2
        too_big = tri > ranks
        u = u - too_big.astype(np.int64)
        tri = u * (u - 1) // 2
        v = ranks - tri
        src, dst = v.astype(np.int32), u.astype(np.int32)
    else:
        src = rng.integers(0, n, size=m).astype(np.int32)
        dst = rng.integers(0, n, size=m).astype(np.int32)
    return src, dst


def planted_bridge_graph(n: int, m: int, n_bridges: int, seed: int = 0):
    """Connected graph = chain of (n_bridges+1) dense random blobs joined by
    single edges (the planted bridges). Returns (src, dst, bridges_set)."""
    rng = np.random.default_rng(seed)
    k = n_bridges + 1
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    srcs, dsts = [], []
    m_inner = max(m - n_bridges, 0)
    for b in range(k):
        nb, s0 = int(sizes[b]), int(starts[b])
        mb = m_inner // k
        if nb >= 2:
            # spanning path to guarantee blob connectivity (path edges are NOT
            # bridges of G only if extra edges cover them; add a cycle to be safe)
            perm = rng.permutation(nb) + s0
            srcs.append(perm[:-1]); dsts.append(perm[1:])
            srcs.append(perm[-1:]); dsts.append(perm[:1])  # close the cycle
            if nb >= 3 and mb > 0:
                u = rng.integers(0, nb, mb) + s0
                v = rng.integers(0, nb, mb) + s0
                keep = u != v
                srcs.append(u[keep]); dsts.append(v[keep])
    bridges = set()
    for b in range(k - 1):
        u = int(starts[b] + rng.integers(0, sizes[b]))
        v = int(starts[b + 1] + rng.integers(0, sizes[b + 1]))
        srcs.append(np.array([u])); dsts.append(np.array([v]))
        bridges.add((min(u, v), max(u, v)))
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    # dedup to a simple graph (keeps planted bridges: they are unique by constr.)
    key = np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst)
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx], bridges


def barbell(n_side: int, path_len: int):
    """Two cliques joined by a path: every path edge is a bridge."""
    src, dst = [], []
    for off in (0, n_side + path_len):
        for i in range(n_side):
            for j in range(i + 1, n_side):
                src.append(off + i); dst.append(off + j)
    prev = n_side - 1
    bridges = set()
    for p in range(path_len):
        nxt = n_side + p
        src.append(prev); dst.append(nxt)
        bridges.add((min(prev, nxt), max(prev, nxt)))
        prev = nxt
    nxt = n_side + path_len  # first vertex of second clique
    src.append(prev); dst.append(nxt)
    bridges.add((min(prev, nxt), max(prev, nxt)))
    n = 2 * n_side + path_len
    return np.array(src, np.int32), np.array(dst, np.int32), bridges, n


def _clique(start: int, size: int):
    """All size*(size-1)/2 edges of a clique on [start, start+size)."""
    i, j = np.triu_indices(size, k=1)
    return (start + i).astype(np.int32), (start + j).astype(np.int32)


def barbell_scenario(n_side: int, path_len: int) -> dict:
    """Barbell with full failure-point ground truth.

    Two ``n_side``-cliques joined by a ``path_len``-vertex path: every path
    edge is a bridge, every path vertex and both attach vertices are
    articulation points, and each path vertex is its own 2ECC.
    """
    assert n_side >= 3, "n_side < 3 makes clique edges bridges too"
    src, dst, bridges, n = barbell(n_side, path_len)
    cuts = set(range(n_side - 1, n_side + path_len + 1))
    return {
        "name": f"barbell({n_side},{path_len})",
        "src": src, "dst": dst, "n": n,
        "bridges": bridges, "cuts": cuts, "n_2ecc": path_len + 2,
    }


def chain_of_cliques(k: int, clique_size: int) -> dict:
    """k cliques in a chain, consecutive ones joined by a single bridge
    (last vertex of clique i -> first vertex of clique i+1).

    Ground truth: k-1 bridges, 2(k-1) articulation points (every bridge
    endpoint), k 2ECCs (one per clique).
    """
    assert k >= 2 and clique_size >= 3
    srcs, dsts, bridges, cuts = [], [], set(), set()
    for b in range(k):
        s, d = _clique(b * clique_size, clique_size)
        srcs.append(s)
        dsts.append(d)
        if b + 1 < k:
            u, v = (b + 1) * clique_size - 1, (b + 1) * clique_size
            srcs.append(np.array([u], np.int32))
            dsts.append(np.array([v], np.int32))
            bridges.add((u, v))
            cuts.update((u, v))
    return {
        "name": f"chain({k}x{clique_size})",
        "src": np.concatenate(srcs), "dst": np.concatenate(dsts),
        "n": k * clique_size,
        "bridges": bridges, "cuts": cuts, "n_2ecc": k,
    }


def star_of_cliques(k: int, clique_size: int) -> dict:
    """A hub vertex joined by one bridge to each of k cliques.

    Ground truth: k bridges, articulation points = hub (for k >= 2) plus
    each clique's attach vertex, k+1 2ECCs (the hub is its own).
    """
    assert k >= 1 and clique_size >= 3
    srcs, dsts, bridges, cuts = [], [], set(), set()
    for b in range(k):
        start = 1 + b * clique_size
        s, d = _clique(start, clique_size)
        srcs.append(np.concatenate([s, np.array([0], np.int32)]))
        dsts.append(np.concatenate([d, np.array([start], np.int32)]))
        bridges.add((0, start))
        cuts.add(start)
    if k >= 2:
        cuts.add(0)
    return {
        "name": f"star({k}x{clique_size})",
        "src": np.concatenate(srcs), "dst": np.concatenate(dsts),
        "n": 1 + k * clique_size,
        "bridges": bridges, "cuts": cuts, "n_2ecc": k + 1,
    }


def failure_scenarios(scale: int = 1) -> list[dict]:
    """The planted failure-point benchmark/test suite at a given scale.

    Every scenario dict carries ``src/dst/n`` plus exact ground truth:
    ``bridges`` (pair set), ``cuts`` (vertex set), ``n_2ecc`` (class count).
    """
    s = max(int(scale), 1)
    return [
        barbell_scenario(4 * s, 3 * s),
        chain_of_cliques(3 * s, 4),
        star_of_cliques(2 * s, 4),
    ]


def tree_graph(n: int, seed: int = 0):
    """Random tree: every edge is a bridge."""
    rng = np.random.default_rng(seed)
    dst = np.arange(1, n, dtype=np.int32)
    src = np.array([rng.integers(0, i) for i in range(1, n)], np.int32)
    return src, dst
