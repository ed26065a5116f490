"""Spanning forests on torch tensors (``repro.core.forest``): Borůvka
hooking, and the scan-first-search (BFS-layer) forest further down.

Borůvka-style minimum-edge hooking with pointer-doubling contraction:

  repeat until nothing hooks (at most ceil(log2 n) + 2 rounds):
    1. every component picks its minimum-index incident cross edge
       (the ``boruvka_round`` op: one pass over the edge buffer)
    2. components hook along the picked edge; mutual 2-cycles (the only
       possible cycles under distinct edge keys) are broken by id order
    3. labels are flattened by pointer doubling

Both round loops are Python ``while`` loops: reading ``changed`` costs one
host sync per round, so a forest pass of r rounds syncs r times.

While tracing is on, each pass of ``spanning_forest_ex`` and
``scan_first_forest_ex`` runs under a ``kernel/forest/<which>`` span
(``edges``, ``path``, ``rounds``) with one ``kernel/round/<which>`` child per
round (``round``, ``model_bytes``). The reference runs its rounds inside one
XLA ``while_loop`` and divides the parent evenly among them; here each
round ends at its own readback, so each child is timed for real, at no
extra sync per round.
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.datastructs import INF32, INT, EdgeList, take
from repro_torch.kernels.boruvka_round.ops import (
    boruvka_round,
    boruvka_round_bytes,
    frontier_round,
    frontier_round_bytes,
)
from repro_torch.kernels.segment_min.ops import kernel_path, segment_min
from repro_torch.obs import get_tracer


def _kernel_span(which: str, edges: EdgeList, impl):
    """Run a hooking pass ``impl(mark)`` under a ``kernel/forest/<which>``
    span and attach one ``kernel/round/<which>`` child per round. ``mark``
    stamps the tracer's clock before the first round and after each
    round's readback; the children span consecutive stamps and carry the
    round's byte model (``kernels.boruvka_round.ops``) as ``model_bytes``.
    Nothing is emitted, and ``mark`` is ``None``, while tracing is off."""
    tr = get_tracer()
    if not tr.enabled:
        return impl(None)
    e, n = edges.capacity, edges.n_nodes
    # the byte model's live slots: one readback, made only while tracing
    live = int((edges.mask & (edges.src != edges.dst)).sum())
    bytes_fn = (boruvka_round_bytes if which == "boruvka"
                else frontier_round_bytes)
    stamps: list[float] = []
    with tr.span(f"kernel/forest/{which}", edges=e,
                 path=kernel_path(edges.device)) as sp:
        out = impl(lambda: stamps.append(tr._clock()))
        sp.attrs["rounds"] = out[-1]
        sp.sync(out)
    for i in range(out[-1]):
        tr.add(f"kernel/round/{which}", stamps[i], stamps[i + 1] - stamps[i],
               parent=sp.index, round=i, model_bytes=bytes_fn(e, n, live))
    return out


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _shortcut(parent: torch.Tensor, steps: int) -> torch.Tensor:
    """Full pointer-doubling path compression."""
    for _ in range(steps):
        parent = parent[parent]
    return parent


def hook_round(src, dst, valid, labels, n: int):
    """One Borůvka round on path-compressed ``labels``.

    Returns ``(labels', chosen, hooked)``: the new labels, int32[n] edge
    slots that join the forest (``E``, one past the buffer, where a
    component did not hook) and bool[n] which components hooked.
    """
    E = src.shape[0]
    best = boruvka_round(src, dst, valid, labels, n)
    has = best < INF32
    e = torch.where(has, best, 0)
    # O(n) gathers of the chosen edges' endpoint labels
    cu = take(labels, take(src, e))
    cv = take(labels, take(dst, e))
    comp = torch.arange(n, dtype=INT, device=src.device)
    other = torch.where(cu == comp, cv, cu)
    prop = torch.where(has, other, comp)
    # distinct edge keys => only 2-cycles possible; break them by id order
    mutual = prop[prop] == comp
    hook = has & (~mutual | (comp < prop))
    parent = torch.where(hook, prop, comp)
    chosen = torch.where(hook, e, E)
    parent = _shortcut(parent, _ceil_log2(n))
    return parent[labels], chosen, hook


def _forest_impl(src, dst, mask, n: int, init_labels=None, mark=None):
    """Borůvka hooking. ``init_labels`` warm-starts from an existing
    partition (path-compressed component labels): the returned forest then
    contains only edges that merge ACROSS the initial components. ``mark``
    (``_kernel_span``) is called before the first round and after each.
    Returns ``(forest bool[E], labels int32[n], rounds)``."""
    E = src.shape[0]
    log_n = _ceil_log2(n)
    # Self-loops are never cross edges; masked slots never participate.
    valid = mask & (src != dst)
    labels = (torch.arange(n, dtype=INT, device=src.device)
              if init_labels is None else init_labels.to(INT))
    forest = torch.zeros(E + 1, dtype=torch.bool, device=src.device)
    changed, rounds = True, 0
    if mark is not None:
        mark()
    while changed and rounds < log_n + 2:
        labels, chosen, hook = hook_round(src, dst, valid, labels, n)
        forest[chosen] = True  # slot E is the dump slot, sliced off below
        changed = bool(hook.any())  # the round's one host sync
        rounds += 1
        if mark is not None:
            mark()
    return forest[:E], labels, rounds


def spanning_forest(edges: EdgeList):
    """Returns (forest_mask bool[E], labels int32[n]).

    ``forest_mask`` selects a spanning forest of the masked subgraph;
    ``labels`` maps each vertex to its connected-component representative.
    """
    forest, labels, _ = spanning_forest_ex(edges)
    return forest, labels


def spanning_forest_ex(edges: EdgeList, init_labels=None):
    """(forest_mask, labels, rounds_used); optional warm-start labels.

    With ``init_labels`` the forest spans only the *contraction* of the
    initial partition by the edge set (edges internal to an initial
    component are never selected)."""
    return _kernel_span(
        "boruvka", edges,
        lambda mark: _forest_impl(edges.src, edges.dst, edges.mask,
                                  edges.n_nodes, init_labels=init_labels,
                                  mark=mark))


def connected_components(edges: EdgeList):
    """Component labels only (same hooking machinery)."""
    _, labels, _ = spanning_forest_ex(edges)
    return labels


# --------------------------------------------------------- scan-first search
def _sfs_impl(src, dst, mask, n: int, comp_labels, round_fn=frontier_round,
              mark=None):
    """Level-synchronous frontier hooking: a scan-first-search (BFS-layer)
    spanning forest, rooted at each component's minimum vertex id.

    Per round every frontier vertex scans its incident edges at once and
    each newly reached vertex hooks to its MINIMUM-id frontier neighbour
    (ties on parallel edges broken by minimum edge slot): the ``round_fn``
    op, by default ``frontier_round`` (the plain ``frontier_round_ref``
    gives a run that launches no kernel). That parent choice is realizable
    by a sequential scan-first search that scans each BFS layer in
    increasing vertex id, so the result is a genuine SFS forest — the
    property that makes the F1 ∪ F2 pair a 2-vertex-connectivity
    certificate.

    One round per BFS layer, at most ``n + 1``, one host sync each;
    ``mark`` as in ``_forest_impl``. Returns (forest bool[E], parent int32[n], level int32[n], root
    int32[n], rounds).
    """
    E = src.shape[0]
    vs = torch.arange(n, dtype=INT, device=src.device)
    valid = mask & (src != dst)

    # roots: each component's minimum vertex id
    minid = segment_min(vs, comp_labels, n)
    root = take(minid, comp_labels)
    is_root = root == vs

    visited, frontier = is_root, is_root
    level = torch.where(is_root, 0, INF32).to(INT)
    parent = vs
    forest = torch.zeros(E + 1, dtype=torch.bool, device=src.device)
    changed, rounds = True, 0
    if mark is not None:
        mark()
    while changed and rounds < n + 1:
        best_p, best_e = round_fn(src, dst, valid, frontier, visited, n)
        newly = best_p < INF32
        parent = torch.where(newly, best_p, parent)
        level = torch.where(newly, rounds + 1, level)
        # slot E is the dump slot, sliced off below
        forest[torch.where(newly, best_e, E)] = True
        visited, frontier = visited | newly, newly
        changed = bool(newly.any())  # the round's one host sync
        rounds += 1
        if mark is not None:
            mark()
    return forest[:E], parent, level, root, rounds


def scan_first_forest(edges: EdgeList):
    """Returns (forest_mask bool[E], parent int32[n], level int32[n]).

    A BFS-layer scan-first search forest of the masked subgraph.
    ``level[v]`` is v's BFS layer (roots at 0), ``parent[v]`` the hooked
    predecessor (roots and isolated vertices point at themselves).
    Component structure matches ``spanning_forest``; only the tree shape
    differs."""
    f, p, lvl, _, _ = scan_first_forest_ex(edges)
    return f, p, lvl


def scan_first_forest_ex(edges: EdgeList):
    """(forest_mask, parent, level, root_labels, rounds_used).

    ``root_labels[v]`` is the component's canonical minimum vertex id — the
    same partition as ``connected_components``, canonicalized."""
    _, labels, _ = spanning_forest_ex(edges)
    return _kernel_span(
        "sfs", edges,
        lambda mark: _sfs_impl(edges.src, edges.dst, edges.mask,
                               edges.n_nodes, labels, mark=mark))
