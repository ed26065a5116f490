"""Analysis registry: the pipeline's final stage as pluggable data
(``repro.connectivity.registry``).

Each ``Analysis`` declares:

* ``certificate`` — the kind's default sparse certificate, named into the
  certificate registry (``core.certs``): ``"2ec"`` for bridges / 2ECC /
  bridge tree, ``"sfs"`` for articulation points / biconnected blocks
  (vertex connectivity). A caller may override it with any registered
  certificate that preserves at least what the default does.
* ``device_fn`` — the final stage over the shared ``tour_state``.
* ``host_fn`` — the sequential host reference (also the ``final='host'``
  answering stage, run on the certificate's edges).
* ``to_result`` — device buffers → host-facing result.
* ``out_struct`` — the declared result-buffer shapes, as
  ``(shape, torch.dtype)`` pairs.
* ``device_input`` — the buffer a device query runs on: ``"certificate"``
  (the 2-edge kinds) or ``"full"`` (the vertex kinds, whose certificate
  costs O(diameter) BFS rounds and is built only for ``final='host'``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.connectivity.device import (
    articulation_from_state,
    bcc_from_state,
    blocks_to_sets,
    bridge_tree_from_state,
    two_ecc_from_state,
)
from repro_torch.connectivity.host import (
    articulation_points_dfs,
    bridge_tree_dfs,
    host_bcc_labels,
    two_ecc_labels_dfs,
)
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.core.certs import certificate_names, get_certificate
from repro_torch.graph.datastructs import INT, EdgeList, compact_edges, to_host


@dataclasses.dataclass(frozen=True)
class Analysis:
    """Descriptor for one connectivity query kind.

    device_fn : (src, dst, mask, n, tour_state, out_cap) -> device buffers
    host_fn   : (src, dst, n_nodes) -> host-facing reference result
    to_result : (device buffers, n_nodes) -> host-facing result
    out_struct: (n_nodes, capacity) -> (shape, dtype) pair or tuple of them
                (capacity = the buffer the final stage ran on)
    """

    kind: str
    result: str
    certificate: str
    incremental: bool
    device_fn: Callable
    host_fn: Callable
    to_result: Callable
    out_struct: Callable
    device_input: str = "certificate"
    decremental: bool = True


_REGISTRY: dict[str, Analysis] = {}

_ALIASES = {"two_ecc": "2ecc", "blocks": "bcc"}


def register(analysis: Analysis) -> Analysis:
    """Add (or replace) a kind; returns the descriptor for chaining.
    ``analysis.certificate`` must name a registered certificate."""
    if analysis.certificate not in certificate_names():
        raise ValueError(
            f"unknown certificate type {analysis.certificate!r}; choose "
            f"from {certificate_names()}")
    _REGISTRY[analysis.kind] = analysis
    return analysis


def analysis_kinds() -> tuple[str, ...]:
    """Canonical names of every registered kind, in registration order."""
    return tuple(_REGISTRY)


def normalize_kind(kind: str) -> str:
    k = str(kind).replace("-", "_").lower()
    k = _ALIASES.get(k, k)
    if k not in _REGISTRY:
        raise ValueError(
            f"unknown analysis kind {kind!r}; choose from {analysis_kinds()}")
    return k


def get_analysis(kind: str) -> Analysis:
    """Look up a descriptor by (normalized) kind name."""
    return _REGISTRY[normalize_kind(kind)]


def certificate_fn(certificate: str) -> Callable:
    """The certificate builder an analysis runs on: (EdgeList, capacity) ->
    EdgeList in a fixed 2(n−1)-slot buffer (resolved via ``core.certs``)."""
    return get_certificate(certificate).build


def resolve_certificate(kind: str, override: str | None = None) -> str:
    """The certificate serving ``kind``: its declared default, or a
    per-call ``override``, which must preserve at least what the default
    does (ValueError otherwise)."""
    analysis = get_analysis(kind)
    default = get_certificate(analysis.certificate)
    if override is None:
        return default.name
    cert = get_certificate(override)
    if not cert.preserves >= default.preserves:
        raise ValueError(
            f"certificate {cert.name!r} does not preserve "
            f"{sorted(default.preserves - cert.preserves)} required "
            f"by kind {analysis.kind!r} (declared certificate "
            f"{default.name!r})")
    return cert.name


# ------------------------------------------------------- shared result glue
def _pair_set(out, n_nodes: int) -> set[tuple[int, int]]:
    s, d, m = (to_host(x) for x in out)
    s, d = s[m], d[m]
    return set((int(min(a, b)), int(max(a, b))) for a, b in zip(s, d))


def _edge_buffer_struct(n: int, cap: int):
    oc = max(n - 1, 1)
    return (((oc,), INT), ((oc,), INT), ((oc,), torch.bool))


# ------------------------------------------------------------ built-in kinds
def _bridges_device(src, dst, mask, n, st, out_cap):
    out = compact_edges(EdgeList(src, dst, mask, n), out_cap,
                        keep=st["bridge"])
    return out.src, out.dst, out.mask


def _cuts_device(src, dst, mask, n, st, out_cap):
    return articulation_from_state(src, dst, mask, n, st)


def _two_ecc_device(src, dst, mask, n, st, out_cap):
    return two_ecc_from_state(src, dst, mask, n, st["bridge"])


def _bridge_tree_device(src, dst, mask, n, st, out_cap):
    ecc = two_ecc_from_state(src, dst, mask, n, st["bridge"])
    out = bridge_tree_from_state(src, dst, mask, n, st["bridge"], ecc,
                                 out_cap)
    return out.src, out.dst, out.mask


def _bcc_device(src, dst, mask, n, st, out_cap):
    return bcc_from_state(src, dst, mask, n, st)


register(Analysis(
    kind="bridges",
    result="set[(u, v)] bridge pairs",
    certificate="2ec",
    incremental=True,
    decremental=True,
    device_fn=_bridges_device,
    host_fn=bridges_dfs,
    to_result=_pair_set,
    out_struct=_edge_buffer_struct,
))

register(Analysis(
    kind="cuts",
    result="set[int] articulation points",
    certificate="sfs",
    incremental=True,
    decremental=True,
    device_fn=_cuts_device,
    host_fn=articulation_points_dfs,
    to_result=lambda out, n: set(
        int(v) for v in np.nonzero(to_host(out)[:n])[0]),
    out_struct=lambda n, cap: ((n,), torch.bool),
    device_input="full",
))

register(Analysis(
    kind="2ecc",
    result="int array[n_nodes] canonical 2ECC labels",
    certificate="2ec",
    incremental=True,
    decremental=True,
    device_fn=_two_ecc_device,
    host_fn=two_ecc_labels_dfs,
    # padding vertices are isolated singletons, so trimming is exact
    to_result=lambda out, n: to_host(out)[:n].copy(),
    out_struct=lambda n, cap: ((n,), INT),
))

register(Analysis(
    kind="bridge_tree",
    result="set[(a, b)] 2ECC supernode pairs",
    certificate="2ec",
    incremental=True,
    decremental=True,
    device_fn=_bridge_tree_device,
    host_fn=bridge_tree_dfs,
    to_result=_pair_set,
    out_struct=_edge_buffer_struct,
))

register(Analysis(
    kind="bcc",
    result="set[frozenset[int]] biconnected blocks as vertex sets",
    certificate="sfs",
    incremental=True,
    decremental=True,
    device_fn=_bcc_device,
    host_fn=host_bcc_labels,
    to_result=lambda out, n: blocks_to_sets(out),
    out_struct=lambda n, cap: (((cap,), INT), ((cap,), INT), ((cap,), INT),
                               ((cap,), torch.bool)),
    device_input="full",
))

#: import-time snapshot of the built-in kind names; ``analysis_kinds()``
#: reads the live registry.
ANALYSIS_KINDS = analysis_kinds()
