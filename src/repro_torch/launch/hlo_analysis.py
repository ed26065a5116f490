"""Roofline terms of one traced step, ported from
``src/repro/launch/hlo_analysis.py``.

The port has no HLO. The reference parses the collectives out of the
compiled module's text (``_shape_bytes`` and its regex); here the dry run
(``launch/dryrun.py``) records each collective as PyTorch dispatches it on
a rank's local tensors, one record per op: its name, its operand bytes and
its result bytes. ``collective_bytes`` sums them under the reference's
kinds and payload convention: per op, max(operand bytes, result bytes),
within 2x of a ring algorithm's wire traffic.

``HW`` holds the card's datasheet figures, not measurements: an NVIDIA
H100 80GB HBM3 (SXM, 700 W) gives 989e12 dense bf16 FLOP/s and 3.35e12 B/s
of HBM3; ``link_bw`` is one 400 Gb/s NDR InfiniBand port per card (50e9
B/s), as in a DGX H100. On the (16, 16) production mesh every axis spans
two or more eight-card nodes, so the slowest link sets the collective
term.
"""
from __future__ import annotations

HW = {
    "peak_flops": 989e12,  # dense bf16 per card (datasheet)
    "hbm_bw": 3.35e12,  # bytes/s per card (datasheet)
    "link_bw": 50e9,  # bytes/s per card: one 400 Gb/s NDR port
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: PyTorch collective ops (``namespace.name``, without the overload) and
#: the reference's kind of each. A broadcast is an all-reduce of a masked
#: operand to GSPMD; a send or a receive is half of a collective-permute.
KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "_c10d_functional.broadcast": "all-reduce",
    "c10d.broadcast_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "send",
    "c10d.recv_": "recv",
}


def collective_bytes(records) -> dict:
    """Payload bytes per collective kind of one step's records ``(op,
    operand_bytes, result_bytes)``: the reference's ``{"bytes", "counts",
    "total_bytes"}``. A rank's sends and receives pair up in order into
    collective-permutes (the i-th send with the i-th receive), each pair's
    payload the larger of the two, as one HLO collective-permute's."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    sends, recvs = [], []
    for op, operand, result in records:
        kind = KINDS[op]
        if kind == "send":
            sends.append(operand)
        elif kind == "recv":
            recvs.append(result)
        else:
            out[kind] += max(operand, result)
            counts[kind] += 1
    for i in range(max(len(sends), len(recvs))):
        pair = (sends[i] if i < len(sends) else 0,
                recvs[i] if i < len(recvs) else 0)
        out["collective-permute"] += max(pair)
        counts["collective-permute"] += 1
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


def roofline_terms(cost: dict, coll: dict, n_chips: int) -> dict:
    """Three roofline terms in seconds (per-device quantities in, seconds
    out): the per-device flops over the peak, the bytes accessed over HBM
    bandwidth, the collective bytes over one link."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
    cbytes = float(coll["total_bytes"])
    t_compute = flops / HW["peak_flops"]
    t_memory = bytes_accessed / HW["hbm_bw"]
    t_collective = cbytes / HW["link_bw"]
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": cbytes,
        "n_chips": n_chips,
    }
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_collective), key=lambda kv: kv[1])
    terms["dominant"] = dom[0]
    bound = max(t_compute, t_memory, t_collective)
    terms["roofline_fraction"] = (t_compute / bound) if bound > 0 else 0.0
    return terms
