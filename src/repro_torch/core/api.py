"""Public API for the paper's algorithm and its failure-point analyses
(``repro.core.api``): thin wrappers over a shared ``BridgeEngine``
(``repro_torch.engine``) per configuration, so calls are padded to
power-of-two shape buckets and served by cached programs.

    from repro_torch import analyze, find_bridges
    bridges = find_bridges(src, dst, n_nodes)                  # on the card
    bridges = find_bridges(src, dst, n_nodes, device="cpu")    # on the CPU
    cuts = analyze(src, dst, n_nodes, kind="cuts", final="host")
    bridges = find_bridges(src, dst, n_nodes, mesh=mesh,       # every rank
                           machine_axes=("data", "model"),
                           schedule="paper", final="host")

Construct a ``BridgeEngine`` of your own for batched dispatch
(``analyze_batch``) or a live graph (``load``/``insert_edges``/
``delete_edges``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.connectivity.registry import (  # noqa: F401  (re-export)
    resolve_certificate,
)
from repro_torch.core.merge import mesh_device  # noqa: F401  (re-export)
from repro_torch.engine.state import masked_arrays  # noqa: F401  (re-export)
from repro_torch.graph.datastructs import EdgeList, admission_capacity

#: smallest shape bucket, as ``BridgeEngine(min_bucket=16)``
MIN_BUCKET = 16

# Distributed engines, one per (mesh, axes, schedule, merge, device)
# configuration, keyed by id(mesh): meshes are long-lived objects in every
# caller. Bounded: engines pin their mesh and programs, so a process that
# sweeps over transient meshes must not accumulate them without limit.
_DIST_ENGINES: dict[tuple, object] = {}
_DIST_ENGINES_MAX = 8


def engine_for(device=None, mesh=None, machine_axes=None,
               schedule: str = "paper", merge: str = "recertify"):
    """The shared engine serving this configuration (created on first use):
    the default engine of ``device`` without a mesh."""
    # Imported here: the engine builds on core's pipeline stages, so a
    # module-level import would be circular.
    from repro_torch.engine.engine import BridgeEngine, get_default_engine

    if mesh is None:
        return get_default_engine(device)
    if machine_axes is not None and not isinstance(machine_axes, str):
        machine_axes = tuple(machine_axes)
    key = (id(mesh), machine_axes, schedule, merge,
           None if device is None else str(device))
    eng = _DIST_ENGINES.get(key)
    if eng is None:
        while len(_DIST_ENGINES) >= _DIST_ENGINES_MAX:  # evict oldest
            _DIST_ENGINES.pop(next(iter(_DIST_ENGINES)))
        eng = _DIST_ENGINES[key] = BridgeEngine(
            device=device, mesh=mesh, machine_axes=machine_axes,
            schedule=schedule, merge=merge)
    return eng


def pad_graph(src, dst, n_nodes: int, device=None) -> EdgeList:
    """The padded buffer ``BridgeEngine.analyze`` builds: the vertex count
    and the edge capacity each rounded up to a power of two (at least 16)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    n_bucket = admission_capacity(n_nodes, MIN_BUCKET)
    cap = admission_capacity(max(len(src), 1), MIN_BUCKET)
    return EdgeList.from_arrays(src, dst, n_bucket, capacity=cap,
                                device=device)


def analyze(src, dst, n_nodes: int, *, kind: str = "bridges",
            final: str = "device", certificate: str | None = None,
            device=None, mesh=None, machine_axes=None,
            schedule: str = "paper", merge: str = "recertify",
            seed: int = 0, delete=None):
    """One graph, one analysis kind (``BridgeEngine.analyze``).

    kind='bridges'     -> set[(u, v)] bridge pairs
    kind='cuts'        -> set[int] articulation points
    kind='2ecc'        -> int array[n_nodes] canonical 2ECC labels
    kind='bridge_tree' -> set[(a, b)] 2ECC supernode pairs
    kind='bcc'         -> set[frozenset[int]] biconnected blocks

    ``final='host'`` answers with the kind's sequential host reference run
    on the kind's sparse certificate instead of the device final stage.
    ``certificate`` overrides the kind's declared certificate type with any
    registered type that preserves what the kind needs. ``delete=(ksrc,
    kdst)`` answers on the graph minus every copy of those endpoint pairs.
    Runs on the card unless ``device`` names another; without a card and
    without ``device`` it raises.

    With a ``DeviceMesh`` (``mesh``) every rank calls it with the same
    graph and gets the same answer: the edges are partitioned over the
    machines of ``machine_axes`` (default: every dim of the mesh) with
    ``seed``, each rank certifies its shard, the certificates merge under
    ``schedule`` (``paper``, ``xor`` or ``hierarchical``; ``merge``
    ``recertify`` or ``incremental``) and machine 0's answer is broadcast.
    The buffers live on the mesh's device type; a ``device`` of another
    type raises.
    """
    eng = engine_for(device, mesh, machine_axes, schedule, merge)
    return eng.analyze(src, dst, n_nodes, kind=kind, final=final, seed=seed,
                       delete=delete, certificate=certificate)


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
