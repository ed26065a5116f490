"""The one-graph analysis pipeline (``repro.engine.batched``'s
``make_analysis_fn``, ``kind="bridges"`` only).

certificate -> host Tarjan on its valid edges (``final="host"``), or
certificate -> ``connectivity.device.bridges`` (``final="device"``).
"""
from __future__ import annotations

from repro_torch.connectivity.device import bridges
from repro_torch.core.certificate import certificate_capacity, sparse_certificate
from repro_torch.graph.datastructs import EdgeList


def make_analysis_fn(n_nodes: int, final: str = "device"):
    """``(src, dst, mask) ->`` the bridge buffer ``(src, dst, mask)`` in
    ``n_nodes - 1`` slots (``final="device"``), or the 2-edge certificate in
    ``2(n_nodes - 1)`` slots, on which the caller runs the host Tarjan
    (``final="host"``)."""
    if final not in ("device", "host"):
        raise ValueError(f"unknown final stage {final!r}")
    cert_cap = certificate_capacity(n_nodes)
    out_cap = max(n_nodes - 1, 1)

    def one(src, dst, mask):
        buf = sparse_certificate(EdgeList(src, dst, mask, n_nodes),
                                 capacity=cert_cap)
        if final == "device":
            buf = bridges(buf, out_cap)
        return buf.src, buf.dst, buf.mask

    return one
