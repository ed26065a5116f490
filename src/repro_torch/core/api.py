"""Public API for the paper's algorithm and its failure-point analyses on
one device (``repro.core.api`` with ``mesh=None``, and the single-device
branch of ``BridgeEngine.analyze`` and its ``find_*`` methods).

    from repro_torch import analyze, find_bridges
    bridges = find_bridges(src, dst, n_nodes)                  # on the card
    bridges = find_bridges(src, dst, n_nodes, device="cpu")    # on the CPU
    cuts = analyze(src, dst, n_nodes, kind="cuts", final="host")
"""
from __future__ import annotations

import numpy as np

from repro_torch.connectivity.registry import get_analysis
from repro_torch.core.certs import get_certificate
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


def analyze(src, dst, n_nodes: int, *, kind: str = "bridges",
            final: str = "device", certificate: str | None = None,
            device=None):
    """One graph, one analysis kind.

    kind='bridges'     -> set[(u, v)] bridge pairs
    kind='cuts'        -> set[int] articulation points
    kind='2ecc'        -> int array[n_nodes] canonical 2ECC labels
    kind='bridge_tree' -> set[(a, b)] 2ECC supernode pairs
    kind='bcc'         -> set[frozenset[int]] biconnected blocks

    ``final='host'`` answers with the kind's sequential host reference run
    on the kind's sparse certificate instead of the device final stage.
    ``certificate`` overrides the kind's declared certificate type with any
    registered type that preserves what the kind needs. Runs on the card
    unless ``device`` names another; without a card and without
    ``device`` it raises.
    """
    analysis = get_analysis(kind)
    cert_name = resolve_certificate(analysis.kind, certificate)
    el = pad_graph(src, dst, n_nodes, device=device)
    fn = make_analysis_fn(el.n_nodes, analysis.kind, final,
                          certificate=cert_name)
    out = fn(el.src, el.dst, el.mask)
    if final == "host":
        return analysis.host_fn(*masked_arrays(out), n_nodes)
    return analysis.to_result(out, n_nodes)


def find_bridges(src, dst, n_nodes: int, *, final: str = "host",
                 device=None) -> set[tuple[int, int]]:
    """Find all bridges of the undirected graph (src[i], dst[i]).

    Sparse 2-edge certificate, then the final stage: host Tarjan DFS on the
    certificate (``final="host"``) or the device Euler-tour bridge mask
    (``final="device"``). Runs on the card unless ``device`` names another;
    without a card and without ``device`` it raises.
    """
    return analyze(src, dst, n_nodes, kind="bridges", final=final,
                   device=device)


def find_cuts(src, dst, n_nodes: int, *, device=None) -> set[int]:
    """Articulation points (cut vertices) of one graph."""
    return analyze(src, dst, n_nodes, kind="cuts", device=device)


def find_two_ecc(src, dst, n_nodes: int, *, device=None) -> np.ndarray:
    """Canonical 2-edge-connected-component label per vertex."""
    return analyze(src, dst, n_nodes, kind="2ecc", device=device)


def find_bridge_tree(src, dst, n_nodes: int, *,
                     device=None) -> set[tuple[int, int]]:
    """Bridge tree edges as pairs of canonical 2ECC labels."""
    return analyze(src, dst, n_nodes, kind="bridge_tree", device=device)


def find_bcc(src, dst, n_nodes: int, *, device=None) -> set[frozenset[int]]:
    """Biconnected blocks as canonical vertex sets."""
    return analyze(src, dst, n_nodes, kind="bcc", device=device)
