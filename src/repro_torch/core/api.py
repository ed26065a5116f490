"""Public API for the paper's algorithm and its failure-point analyses
(``repro.core.api``, and ``BridgeEngine.analyze`` and its ``find_*``
methods, single-device and distributed branches).

    from repro_torch import analyze, find_bridges
    bridges = find_bridges(src, dst, n_nodes)                  # on the card
    bridges = find_bridges(src, dst, n_nodes, device="cpu")    # on the CPU
    cuts = analyze(src, dst, n_nodes, kind="cuts", final="host")
    bridges = find_bridges(src, dst, n_nodes, mesh=mesh,       # every rank
                           machine_axes=("data", "model"),
                           schedule="paper", final="host")
"""
from __future__ import annotations

import numpy as np
import torch

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
            device=None, mesh=None, machine_axes=None,
            schedule: str = "paper", merge: str = "recertify",
            seed: int = 0):
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

    With a ``DeviceMesh`` (``mesh``) every rank calls it with the same
    graph and gets the same answer: the edges are partitioned over the
    machines of ``machine_axes`` (default: every dim of the mesh) with
    ``seed``, each rank certifies its shard, the certificates merge under
    ``schedule`` (``paper``, ``xor`` or ``hierarchical``; ``merge``
    ``recertify`` or ``incremental``) and machine 0's answer is broadcast.
    The buffers live on the mesh's device type; a ``device`` of another
    type raises.
    """
    analysis = get_analysis(kind)
    cert_name = resolve_certificate(analysis.kind, certificate)
    if mesh is not None:
        return _analyze_distributed(src, dst, n_nodes, analysis, final,
                                    cert_name, device, mesh, machine_axes,
                                    schedule, merge, seed)
    el = pad_graph(src, dst, n_nodes, device=device)
    fn = make_analysis_fn(el.n_nodes, analysis.kind, final,
                          certificate=cert_name)
    out = fn(el.src, el.dst, el.mask)
    if final == "host":
        return analysis.host_fn(*masked_arrays(out), n_nodes)
    return analysis.to_result(out, n_nodes)


def mesh_device(mesh, device=None) -> torch.device:
    """The device a mesh's buffers live on: ``device`` if given, which must
    be of the mesh's device type (ValueError otherwise), else the mesh's
    type (the current card for a ``cuda`` mesh)."""
    kind = mesh.device_type
    if device is None:
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)
    dev = torch.device(device)
    if dev.type != kind:
        raise ValueError(f"device {dev} is not of the mesh's device type "
                         f"{kind!r}")
    return dev


def _analyze_distributed(src, dst, n_nodes: int, analysis, final: str,
                         cert_name: str, device, mesh, machine_axes,
                         schedule: str, merge: str, seed: int):
    """``BridgeEngine._analyze_distributed`` on this rank: partition with
    ``seed``, pad the shard capacity (not ``n_nodes``: the distributed path
    runs at the graph's own n) to its power-of-two bucket, run the
    program on this rank's row, convert machine 0's result."""
    from repro_torch.core.merge import (
        build_distributed_analysis_fn,
        machine_axes_of,
        machine_group,
        result_shard_zero,
    )
    from repro_torch.core.partition import partition_edges

    dev = mesh_device(mesh, device)
    axes = machine_axes_of(mesh, machine_axes)
    fn = build_distributed_analysis_fn(
        mesh, axes, n_nodes, schedule=schedule, final=final, merge=merge,
        kind=analysis.kind, certificate=cert_name)
    mg = machine_group(mesh, axes)
    psrc, pdst, pmask = partition_edges(np.asarray(src, np.int32),
                                        np.asarray(dst, np.int32), n_nodes,
                                        mg.size, seed=seed)
    pad = admission_capacity(psrc.shape[1], MIN_BUCKET) - psrc.shape[1]
    row = [torch.tensor(np.pad(a[mg.index], (0, pad)), device=dev)
           for a in (psrc, pdst, pmask)]
    out = result_shard_zero(fn(*row), mesh, axes)
    if final == "host":
        return analysis.host_fn(*masked_arrays(out), n_nodes)
    return analysis.to_result(out, n_nodes)


def find_bridges(src, dst, n_nodes: int, *, final: str = "host",
                 device=None, mesh=None, machine_axes=None,
                 schedule: str = "paper", merge: str = "recertify",
                 seed: int = 0) -> set[tuple[int, int]]:
    """Find all bridges of the undirected graph (src[i], dst[i]).

    Sparse 2-edge certificate, then the final stage: host Tarjan DFS on the
    certificate (``final="host"``) or the device Euler-tour bridge mask
    (``final="device"``). Runs on the card unless ``device`` names another;
    without a card and without ``device`` it raises. With ``mesh``, the
    paper's distributed pipeline on every rank (see ``analyze``).
    """
    return analyze(src, dst, n_nodes, kind="bridges", final=final,
                   device=device, mesh=mesh, machine_axes=machine_axes,
                   schedule=schedule, merge=merge, seed=seed)


def find_cuts(src, dst, n_nodes: int, *, device=None,
              **distributed) -> set[int]:
    """Articulation points (cut vertices) of one graph. ``distributed``:
    ``analyze``'s ``mesh``, ``machine_axes``, ``schedule``, ``merge`` and
    ``seed``."""
    return analyze(src, dst, n_nodes, kind="cuts", device=device,
                   **distributed)


def find_two_ecc(src, dst, n_nodes: int, *, device=None,
                 **distributed) -> np.ndarray:
    """Canonical 2-edge-connected-component label per vertex."""
    return analyze(src, dst, n_nodes, kind="2ecc", device=device,
                   **distributed)


def find_bridge_tree(src, dst, n_nodes: int, *, device=None,
                     **distributed) -> set[tuple[int, int]]:
    """Bridge tree edges as pairs of canonical 2ECC labels."""
    return analyze(src, dst, n_nodes, kind="bridge_tree", device=device,
                   **distributed)


def find_bcc(src, dst, n_nodes: int, *, device=None,
             **distributed) -> set[frozenset[int]]:
    """Biconnected blocks as canonical vertex sets."""
    return analyze(src, dst, n_nodes, kind="bcc", device=device,
                   **distributed)
