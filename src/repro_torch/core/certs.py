"""Certificate registry: the certificate stage of the pipeline as data
(``repro.core.certs``).

Each ``Certificate`` declares:

* ``build`` — ``(EdgeList, capacity=...) ->`` the certificate pair in a
  fixed 2(n−1)-slot buffer.
* ``load_state`` — ``(EdgeList, capacity) -> state``: a flat tuple whose
  first three leaves are the pair's ``(src, dst, mask)`` buffers and whose
  remaining leaves are what the fold-in needs (warm-start labels for
  ``2ec``; nothing for the rescan certificates).
* ``fold_state`` — ``(state, recv EdgeList, capacity) -> state``: the
  fold-in of an edge delta (or a received certificate) into the state.
* ``lazy`` — materialized only on the first query that needs it.
* ``warm_merge`` — merge phases may carry ``load_state``/``fold_state``
  across phases; the others re-certify the union each phase.
* ``preserves`` — ``"lambda2"`` (min(λ, 2): bridges / 2ECC / bridge tree)
  and/or ``"kappa2"`` (vertex cuts and blocks). A per-kind override must
  preserve at least what the kind's default does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.certificate import (
    hybrid_certificate,
    merge_certificates_incremental,
    sfs_certificate,
    sparse_certificate,
    sparse_certificate_ex,
)
from repro_torch.graph.datastructs import EdgeList, concat_edges

#: the structure tokens ``preserves`` may declare
PRESERVABLE = frozenset({"lambda2", "kappa2"})


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Descriptor for one sparse-certificate type (see module docstring).

    build      : (EdgeList, capacity=...) -> EdgeList
    load_state : (EdgeList, capacity) -> (src, dst, mask, *aux)
    fold_state : ((src, dst, mask, *aux), recv EdgeList, capacity) -> state
    """

    name: str
    summary: str
    preserves: frozenset
    build: Callable
    load_state: Callable
    fold_state: Callable
    lazy: bool = False
    warm_merge: bool = False

    def stream_load(self, chunks, capacity: int) -> tuple:
        """Fold an iterable of edge chunks into one state:
        ``load_state(chunk0)`` then ``fold_state`` per remaining chunk.
        The chunks partition the edge multiset and certificate union is
        valid over disjoint unions, so this certifies what one-shot
        ``load_state`` of the whole buffer does. An empty iterable raises
        (all chunks must share ``n_nodes``; pass one all-masked chunk for
        an edgeless world)."""
        state = None
        for chunk in chunks:
            if state is None:
                state = self.load_state(chunk, capacity)
            else:
                state = self.fold_state(state, chunk, capacity)
        if state is None:
            raise ValueError(
                f"stream_load({self.name!r}): no chunks; stream at least "
                "one (possibly all-masked) chunk to fix n_nodes")
        return state


_REGISTRY: dict[str, Certificate] = {}


def register_certificate(cert: Certificate) -> Certificate:
    """Add (or replace) a certificate type; returns it for chaining."""
    if not cert.name:
        raise ValueError("certificate name must be non-empty")
    unknown = frozenset(cert.preserves) - PRESERVABLE
    if unknown:
        raise ValueError(
            f"certificate {cert.name!r} declares unknown structure "
            f"tokens {sorted(unknown)}; choose from {sorted(PRESERVABLE)}")
    _REGISTRY[cert.name] = cert
    return cert


def certificate_names() -> tuple[str, ...]:
    """Every registered certificate name, in registration order."""
    return tuple(_REGISTRY)


def get_certificate(name: str) -> Certificate:
    """Look up a descriptor; ValueError names the registered choices."""
    cert = _REGISTRY.get(str(name))
    if cert is None:
        raise ValueError(
            f"unknown certificate {name!r}; choose from {certificate_names()}")
    return cert


def certificate_builder(name: str) -> Callable:
    """The plain builder view: (EdgeList, capacity=...) -> EdgeList."""
    return get_certificate(name).build


def primary_certificate() -> str:
    """The first eagerly-materialized certificate."""
    for name, cert in _REGISTRY.items():
        if not cert.lazy:
            return name
    raise ValueError("no eager certificate registered")


# -------------------------------------------------------------- state glue
def _pair_state(cert: EdgeList) -> tuple:
    return cert.src, cert.dst, cert.mask


def _state_pair(state: tuple, n_nodes: int) -> EdgeList:
    return EdgeList(state[0], state[1], state[2], n_nodes)


def _warm_load(edges: EdgeList, capacity: int) -> tuple:
    cert, lab1, lab2, _ = sparse_certificate_ex(edges, capacity=capacity)
    return (*_pair_state(cert), lab1, lab2)


def _warm_fold(state: tuple, recv: EdgeList, capacity: int) -> tuple:
    cs, cd, cm, lab1, lab2 = state
    cert, lab1, lab2, _ = merge_certificates_incremental(
        EdgeList(cs, cd, cm, recv.n_nodes), lab1, lab2, recv)
    return (*_pair_state(cert), lab1, lab2)


def _rescan_load(build: Callable) -> Callable:
    def load(edges: EdgeList, capacity: int) -> tuple:
        return _pair_state(build(edges, capacity=capacity))

    return load


def _rescan_fold(build: Callable) -> Callable:
    """Fold-in by re-certifying the bounded cert ∪ delta union: O(n + Δ)
    per update, never O(E) — for certificates whose layered structure does
    not warm-start (BFS layers shift globally)."""

    def fold(state: tuple, recv: EdgeList, capacity: int) -> tuple:
        own = _state_pair(state, recv.n_nodes)
        return _pair_state(build(concat_edges(own, recv), capacity=capacity))

    return fold


# ---------------------------------------------------------- built-in types
register_certificate(Certificate(
    name="2ec",
    summary="Borůvka forest pair F1 ∪ F2 (Nagamochi–Ibaraki, k=2): "
            "preserves min(λ, 2); warm-start labels make deltas cheap",
    preserves=frozenset({"lambda2"}),
    build=sparse_certificate,
    load_state=_warm_load,
    fold_state=_warm_fold,
    lazy=False,
    warm_merge=True,
))

register_certificate(Certificate(
    name="sfs",
    summary="scan-first-search BFS-layer pair (Cheriyan–Kao–Thurimella): "
            "preserves vertex cuts and blocks; O(diameter) rounds",
    preserves=frozenset({"kappa2"}),
    build=sfs_certificate,
    load_state=_rescan_load(sfs_certificate),
    fold_state=_rescan_fold(sfs_certificate),
    lazy=True,
))

register_certificate(Certificate(
    name="hybrid",
    summary="Borůvka-contracted chains + scan-first pair on the contracted "
            "graph: same guarantees as sfs with BFS rounds bounded by the "
            "contracted diameter (sparse/path-like worlds)",
    preserves=frozenset({"kappa2"}),
    build=hybrid_certificate,
    load_state=_rescan_load(hybrid_certificate),
    fold_state=_rescan_fold(hybrid_certificate),
    lazy=True,
))

#: import-time snapshot of the built-in names; ``certificate_names()`` reads
#: the live registry (runtime registrations included).
CERTIFICATE_NAMES = certificate_names()
