"""Sparse 2-edge-connectivity certificates (paper §III, Lemma 1).

``S = F1 ∪ F2`` where F1 is a spanning forest of G and F2 a spanning forest
of G − F1 (Nagamochi–Ibaraki / Cheriyan–Kao–Thurimella, k = 2).
|S| ≤ 2(n−1), and for any extra edge set Y,
bridges(G(V, E ∪ Y)) == bridges(G(V, S ∪ Y)).

The scan-first-search pair (``sfs_certificate``) and its chain-contracted
variant (``hybrid_certificate``) also preserve vertex connectivity up to 2.

The output lives in a fixed ``2(n−1)``-slot buffer so certificates from
different machines/phases always have identical shapes.
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import (
    scan_first_forest_ex,
    spanning_forest,
    spanning_forest_ex,
)
from repro_torch.graph.datastructs import (
    INT,
    EdgeList,
    compact_edges,
    concat_edges,
    take,
)


def certificate_capacity(n_nodes: int) -> int:
    return max(2 * (n_nodes - 1), 1)


def certificate_mask(edges: EdgeList):
    """(bool[E] selecting F1 ∪ F2 inside the input buffer, F1's mask)."""
    f1, _ = spanning_forest(edges)
    rest = EdgeList(edges.src, edges.dst, edges.mask & ~f1, edges.n_nodes)
    f2, _ = spanning_forest(rest)
    return f1 | f2, f1


def sparse_certificate(edges: EdgeList, capacity: int | None = None) -> EdgeList:
    """Compute the certificate and compact it into a 2(n−1)-slot buffer."""
    cap = certificate_capacity(edges.n_nodes) if capacity is None else capacity
    cert, _ = certificate_mask(edges)
    return compact_edges(edges, cap, keep=cert)


def merge_certificates(a: EdgeList, b: EdgeList) -> EdgeList:
    """One paper merge step: union two certificates, re-certify to 2(n−1)."""
    both = concat_edges(a, b)
    return sparse_certificate(both, capacity=certificate_capacity(a.n_nodes))


def sparse_certificate_ex(edges: EdgeList, capacity: int | None = None):
    """Certificate + the component labels of its two forests + the Borůvka
    round count of each pass: ``(cert, labels1, labels2, (r1, r2))``."""
    cap = certificate_capacity(edges.n_nodes) if capacity is None else capacity
    f1, lab1, r1 = spanning_forest_ex(edges)
    rest = EdgeList(edges.src, edges.dst, edges.mask & ~f1, edges.n_nodes)
    f2, lab2, r2 = spanning_forest_ex(rest)
    cert = compact_edges(edges, cap, keep=f1 | f2)
    return cert, lab1, lab2, (r1, r2)


def sfs_certificate(edges: EdgeList, capacity: int | None = None) -> EdgeList:
    """Scan-first-search certificate: S = F1 ∪ F2 with F1 a BFS-layer
    (scan-first) forest of G and F2 one of G − F1 (Cheriyan–Kao–Thurimella,
    k = 2). Same 2(n−1) size bound as the Borůvka certificate; the layered
    forests also preserve VERTEX connectivity up to 2."""
    cert, _, _, _ = sfs_certificate_ex(edges, capacity=capacity)
    return cert


def sfs_certificate_ex(edges: EdgeList, capacity: int | None = None):
    """SFS certificate + F1's (parent, level) pair + the BFS rounds of each
    pass: ``(cert, parent, level, (r1, r2))``."""
    cap = certificate_capacity(edges.n_nodes) if capacity is None else capacity
    f1, parent, level, _, r1 = scan_first_forest_ex(edges)
    # F2 scans the SIMPLE complement of F1: a slot duplicating an F1 pair
    # {v, parent(v)} adds nothing to vertex connectivity and would waste an
    # F2 forest slot that a genuinely new edge needs.
    dup = ((take(parent, edges.src) == edges.dst)
           | (take(parent, edges.dst) == edges.src))
    rest = EdgeList(edges.src, edges.dst, edges.mask & ~f1 & ~dup,
                    edges.n_nodes)
    f2, _, _, _, r2 = scan_first_forest_ex(rest)
    cert = compact_edges(edges, cap, keep=f1 | f2)
    return cert, parent, level, (r1, r2)


def _degree(src, dst, valid, n: int) -> torch.Tensor:
    """int32[n] multiplicity-counted degree over the ``valid`` slots
    (``jax.ops.segment_sum`` of ones over both endpoints): out-of-range
    endpoints go to a dump slot and are dropped."""
    ones = valid.to(INT)
    deg = torch.zeros(n + 1, dtype=INT, device=src.device)
    for ids in (src, dst):
        deg.index_add_(0, torch.where((ids >= 0) & (ids < n), ids, n), ones)
    return deg[:n]


def hybrid_certificate(edges: EdgeList, capacity: int | None = None) -> EdgeList:
    """Hybrid Borůvka⊕SFS certificate for sparse, path-like worlds.

    1. every edge incident to a vertex of degree ≤ 2 (a chain edge) goes
       into the certificate verbatim;
    2. the edges whose both endpoints have degree ≤ 2 (chain interiors)
       are Borůvka-hooked and each chain collapses to one label;
    3. the scan-first pair F1 ∪ F2 is built on the relabeled buffer, whose
       BFS depth is that of the contracted graph;
    4. the selection maps back slot for slot: chain ∪ F1 ∪ F2, compacted.

    Same contract as ``sfs_certificate``: vertex connectivity up to 2,
    edge connectivity up to 2 on simple inputs.
    """
    cert, _ = hybrid_certificate_ex(edges, capacity=capacity)
    return cert


def hybrid_certificate_ex(edges: EdgeList, capacity: int | None = None):
    """Hybrid certificate + per-pass round counts:
    ``(cert, (rounds_chain, rounds_f1, rounds_f2))``, the Borůvka rounds of
    the chain contraction and the BFS rounds of the two scan passes."""
    cap = certificate_capacity(edges.n_nodes) if capacity is None else capacity
    n = edges.n_nodes
    src, dst, mask = edges.src, edges.dst, edges.mask
    valid = mask & (src != dst)
    low = _degree(src, dst, valid, n) <= 2
    low_s, low_d = take(low, src), take(low, dst)
    interior = valid & low_s & low_d
    chain = valid & (low_s | low_d)
    _, labels, r_chain = spanning_forest_ex(EdgeList(src, dst, interior, n))
    csrc, cdst = take(labels, src), take(labels, dst)
    contracted = valid & ~interior
    f1, parent, _, _, r1 = scan_first_forest_ex(
        EdgeList(csrc, cdst, contracted, n))
    # F2 scans the simple complement of F1 in the CONTRACTED graph (the
    # multigraph rule of sfs_certificate_ex)
    dup = (take(parent, csrc) == cdst) | (take(parent, cdst) == csrc)
    f2, _, _, _, r2 = scan_first_forest_ex(
        EdgeList(csrc, cdst, contracted & ~f1 & ~dup, n))
    cert = compact_edges(edges, cap, keep=chain | f1 | f2)
    return cert, (r_chain, r1, r2)


def merge_certificates_incremental(own: EdgeList, f1_labels, f2_labels,
                                   recv: EdgeList):
    """Warm-start merge: fold ``recv`` into ``own`` = F1 ∪ F2 whose forests'
    component labels are ``f1_labels``/``f2_labels``.

      F1_new = F1 ∪ forest(recv          | warm-start labels_1)
      F2_new = F2 ∪ forest(recv − F1_delta | warm-start labels_2)

    Each delta pass scans only ``recv`` and starts hooking from the
    existing partition. Returns ``(merged_cert, f1_labels', f2_labels',
    (rounds_f1, rounds_f2))``.
    """
    cap = certificate_capacity(own.n_nodes)
    f1d, f1_labels, r1 = spanning_forest_ex(recv, init_labels=f1_labels)
    rest = EdgeList(recv.src, recv.dst, recv.mask & ~f1d, recv.n_nodes)
    f2d, f2_labels, r2 = spanning_forest_ex(rest, init_labels=f2_labels)
    keep_recv = EdgeList(recv.src, recv.dst, recv.mask & (f1d | f2d),
                         recv.n_nodes)
    cert = compact_edges(concat_edges(own, keep_recv), cap)
    return cert, f1_labels, f2_labels, (r1, r2)
