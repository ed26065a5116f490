"""Sparse 2-edge-connectivity certificates (paper §III, Lemma 1).

``S = F1 ∪ F2`` where F1 is a spanning forest of G and F2 a spanning forest
of G − F1 (Nagamochi–Ibaraki / Cheriyan–Kao–Thurimella, k = 2).
|S| ≤ 2(n−1), and for any extra edge set Y,
bridges(G(V, E ∪ Y)) == bridges(G(V, S ∪ Y)).

The output lives in a fixed ``2(n−1)``-slot buffer so certificates from
different machines/phases always have identical shapes.
"""
from __future__ import annotations

from repro_torch.core.forest import spanning_forest, spanning_forest_ex
from repro_torch.graph.datastructs import EdgeList, compact_edges, concat_edges


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
