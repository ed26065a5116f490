"""Device (PRAM) failure-point analyses on the shared tour state
(``repro.connectivity.device``), each on fixed-capacity masked buffers and
built from ``common.tour_state``:

* **bridges** — tree edge whose child subtree no non-tree edge escapes.
* **articulation points** — Tarjan–Vishkin block decomposition on an
  arbitrary rooted spanning tree: an auxiliary graph on the tree edges
  (identified by their child vertices) connects two tree edges iff they lie
  on a common cycle; its connected components (the Borůvka hooking of
  ``core/forest.py``) are the biconnected blocks, and a vertex is an
  articulation point iff its incident tree edges span >= 2 blocks.
* **2ECC labels** — components after bridge contraction, canonicalized to
  the smallest member vertex id.
* **bridge tree** — each bridge, relabeled by the 2ECC labels of its
  endpoints, in a fixed (n-1)-slot buffer.
* **bcc blocks** — the aux components as canonical per-tree-edge block
  labels (block name = min child vertex id).

Articulation points and bcc blocks are VERTEX connectivity, which the
arbitrary-forest 2-edge certificate does not preserve: run them on the full
buffer or on a scan-first-search certificate (``sfs``/``hybrid``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.connectivity.common import _segment_reduce, tour_state
from repro_torch.core.forest import connected_components
from repro_torch.graph.datastructs import (
    INF32,
    INT,
    INT32_MIN,
    EdgeList,
    compact_edges,
    take,
    to_host,
)


# ---------------------------------------------------------- state analyses
def block_labels_from_state(src, dst, mask, n: int, st: dict) -> torch.Tensor:
    """int32[C] biconnected-block label per tree edge (Tarjan–Vishkin aux
    components) — the shared core of ``cuts`` and ``bcc``.

    Aux graph on child-vertex ids (tree edge (p(v), v) <-> aux vertex v):
      rule 1: each non-tree edge (u, w) with u, w unrelated in the tree
              joins aux u and aux w;
      rule 2: each tree edge (v, w), w child, v non-root, joins aux w and
              aux v iff subtree(w) has a non-tree edge escaping subtree(v).
    The label is meaningful only where ``st["tree_mask"]``.
    """
    disc, vhi = st["disc"], st["vhi"]
    parent, child, tree_mask = st["parent"], st["child"], st["tree_mask"]

    # rule 1 — neither subtree interval contains the other's discovery
    disc_s, disc_d = take(disc, src), take(disc, dst)
    anc_sd = (disc_s <= disc_d) & (disc_d <= take(vhi, src))
    anc_ds = (disc_d <= disc_s) & (disc_s <= take(vhi, dst))
    rule1 = st["nt_mask"] & ~anc_sd & ~anc_ds

    # rule 2 — child subtree escapes the parent's subtree
    esc = (st["smin"] < take(disc, parent)) | (st["smax"] > take(vhi, parent))
    rule2 = tree_mask & ~take(st["is_root"], parent) & esc

    aux_src = torch.where(rule1, src, torch.where(rule2, child, 0))
    aux_dst = torch.where(rule1, dst, torch.where(rule2, parent, 0))
    aux_labels = connected_components(
        EdgeList(aux_src, aux_dst, rule1 | rule2, n))
    return take(aux_labels, child)


def articulation_from_state(src, dst, mask, n: int, st: dict) -> torch.Tensor:
    """bool[n] articulation-point mask: a vertex whose incident tree edges
    span >= 2 distinct biconnected blocks."""
    parent, child, tree_mask = st["parent"], st["child"], st["tree_mask"]
    blk = block_labels_from_state(src, dst, mask, n, st)
    ends = torch.cat([parent, child])
    labs = torch.cat([blk, blk])
    tm2 = torch.cat([tree_mask, tree_mask])
    ids = torch.where(tm2, ends, 0)
    mn = _segment_reduce(torch.where(tm2, labs, INF32), ids, n, "amin", INF32)
    mx = _segment_reduce(torch.where(tm2, labs, -1), ids, n, "amax",
                         INT32_MIN)
    return (mn < INF32) & (mx > mn)


def bcc_from_state(src, dst, mask, n: int, st: dict):
    """Per-tree-edge canonical biconnected block labels:
    ``(parent int32[C], child int32[C], block int32[C], tree_mask bool[C])``,
    each block named by its minimum CHILD vertex id (unique per block,
    unlike the minimum member, which two blocks can share at a cut vertex).
    A block's vertex set is the endpoint set of its tree edges."""
    parent, child, tree_mask = st["parent"], st["child"], st["tree_mask"]
    blk = block_labels_from_state(src, dst, mask, n, st)
    bmin = _segment_reduce(torch.where(tree_mask, child, INF32),
                           torch.where(tree_mask, blk, 0), n, "amin", INF32)
    cblk = take(bmin, blk)
    return (torch.where(tree_mask, parent, 0),
            torch.where(tree_mask, child, 0),
            torch.where(tree_mask, cblk, 0), tree_mask)


def two_ecc_from_state(src, dst, mask, n: int, bridge) -> torch.Tensor:
    """int32[n] canonical 2ECC labels: components after bridge
    contraction, canonicalized to the minimum member vertex id (isolated
    vertices label themselves)."""
    labels = connected_components(EdgeList(src, dst, mask & ~bridge, n))
    vs = torch.arange(n, dtype=INT, device=src.device)
    minid = _segment_reduce(vs, labels, n, "amin", INF32)
    return take(minid, labels)


def bridge_tree_from_state(src, dst, mask, n: int, bridge, ecc,
                           capacity: int) -> EdgeList:
    """Bridge tree: 2ECC supernodes joined by the bridges, compacted into a
    fixed ``capacity``-slot buffer (bridges form a forest => < n of them)."""
    bt = EdgeList(take(ecc, src), take(ecc, dst), mask & bridge, n)
    return compact_edges(bt, capacity)


# ---------------------------------------------------------------- public API
def _state(edges: EdgeList) -> dict:
    return tour_state(edges.src, edges.dst, edges.mask, edges.n_nodes)


def bridge_mask(edges: EdgeList) -> torch.Tensor:
    """bool[E] bridge indicator over the input buffer slots."""
    return _state(edges)["bridge"]


def bridges(edges: EdgeList, out_capacity: int | None = None) -> EdgeList:
    """Bridges of the (certificate) graph, compacted into an (n-1)-slot buffer."""
    bm = bridge_mask(edges)
    cap = out_capacity if out_capacity is not None else max(edges.n_nodes - 1, 1)
    return compact_edges(edges, cap, keep=bm)


def articulation_mask(edges: EdgeList) -> torch.Tensor:
    """bool[n] articulation-point (cut vertex) indicator. Run it on the
    full buffer or an SFS certificate, never the 2-edge certificate."""
    return articulation_from_state(edges.src, edges.dst, edges.mask,
                                   edges.n_nodes, _state(edges))


def articulation_points(edges: EdgeList) -> set[int]:
    """Host-facing articulation point set."""
    m = articulation_mask(edges).cpu().numpy()
    return set(int(v) for v in np.nonzero(m)[0])


def bcc_blocks(edges: EdgeList) -> set[frozenset[int]]:
    """Biconnected blocks as canonical vertex sets (host-facing); like
    ``articulation_mask``, on the full buffer or an SFS certificate."""
    return blocks_to_sets(bcc_from_state(edges.src, edges.dst, edges.mask,
                                         edges.n_nodes, _state(edges)))


def blocks_to_sets(out) -> set[frozenset[int]]:
    """(parent, child, block, tree_mask) buffers -> blocks as canonical
    frozensets of vertex ids."""
    p, c, lab, tm = (to_host(x) for x in out)
    by_label: dict[int, set[int]] = {}
    for i in np.nonzero(tm)[0]:
        b = by_label.setdefault(int(lab[i]), set())
        b.add(int(p[i]))
        b.add(int(c[i]))
    return set(frozenset(b) for b in by_label.values())


def two_ecc_labels(edges: EdgeList) -> torch.Tensor:
    """int32[n] canonical 2ECC label per vertex (min member id)."""
    return two_ecc_from_state(edges.src, edges.dst, edges.mask, edges.n_nodes,
                              bridge_mask(edges))


def bridge_tree(edges: EdgeList, out_capacity: int | None = None) -> EdgeList:
    """Bridge tree as an EdgeList over canonical 2ECC supernode labels."""
    cap = out_capacity if out_capacity is not None else max(edges.n_nodes - 1, 1)
    bridge = bridge_mask(edges)
    ecc = two_ecc_from_state(edges.src, edges.dst, edges.mask, edges.n_nodes,
                             bridge)
    return bridge_tree_from_state(edges.src, edges.dst, edges.mask,
                                  edges.n_nodes, bridge, ecc, cap)
