"""The one-graph analysis pipeline (``repro.engine.batched``'s
``make_analysis_fn``), registry-driven."""
from __future__ import annotations

from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import certificate_fn, get_analysis
from repro_torch.core.certificate import certificate_capacity
from repro_torch.graph.datastructs import EdgeList


def make_analysis_fn(n_nodes: int, kind: str = "bridges",
                     final: str = "device", certificate: str | None = None):
    """The query core for one analysis kind.

    ``(src, dst, mask) ->`` the kind's declared device buffers (see
    ``Analysis.out_struct``), or — with ``final='host'`` — the kind's
    sparse certificate ``(src, dst, mask)`` in ``2(n_nodes - 1)`` slots, on
    which the caller runs the kind's host reference.

    The certificate is built only where it is needed: for ``final='host'``
    and for the kinds whose ``device_input`` is ``"certificate"``; the
    vertex kinds run the device final on the full buffer. ``certificate``
    overrides the kind's declared certificate (validate it first with
    ``core.api.resolve_certificate``).
    """
    analysis = get_analysis(kind)
    if final not in ("device", "host"):
        raise ValueError(f"unknown final stage {final!r}")
    cert_cap = certificate_capacity(n_nodes)
    out_cap = max(n_nodes - 1, 1)
    certify = certificate_fn(certificate if certificate is not None
                             else analysis.certificate)

    def one(src, dst, mask):
        buf = EdgeList(src, dst, mask, n_nodes)
        if final == "host" or analysis.device_input == "certificate":
            buf = certify(buf, capacity=cert_cap)
        if final == "host":
            return buf.src, buf.dst, buf.mask
        st = tour_state(buf.src, buf.dst, buf.mask, n_nodes)
        return analysis.device_fn(buf.src, buf.dst, buf.mask, n_nodes, st,
                                  out_cap)

    return one
