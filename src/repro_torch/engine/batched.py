"""Batched graph containers and the batched analysis pipeline
(``repro.engine.batched``).

``BatchedEdgeList`` stacks B same-capacity edge buffers so B independent
graphs resolve in one dispatch. The reference lifts its one-graph pipeline
with ``jax.jit(jax.vmap(...))``; the port's rounds are kernel launches
whose loops read a flag back each round, which ``torch.func.vmap`` cannot
follow. So the batch runs as ONE DISJOINT-UNION PASS
(``make_batched_pipeline``):

1. row b's vertex ids are offset by ``b * n_nodes`` and its slots laid out
   row-major: one ``EdgeList`` of ``B * capacity`` slots over
   ``B * n_nodes`` vertices (``union_edges``); deletion keys are offset
   the same way and tombstoned in one pass;
2. the union is certified once, so each forest round is one kernel launch
   for the whole batch;
3. the union certificate splits back into rows by vertex range, slot order
   kept, each row zero-padded to ``certificate_capacity(n_nodes)``
   (``split_certificate``);
4. the kind's final runs per row through the one-graph functions (the
   ``device_input="full"`` kinds on the row's own buffer).

The three stages run in the spans ``stage/union``,
``stage/certificate_build/<name>`` and ``stage/final/<kind>``.

This equals the vmapped reference slot for slot: compaction is stable in
slot order; a Borůvka round picks each component's minimum slot and breaks
2-cycles by id order, and a frontier round each vertex's minimum
(parent, slot), all orders the offset keeps within a row; scan-first roots
are component minima; and a row whose forest has converged is left alone by
the rounds the other rows still need (nothing hooks, no frontier). The
union's larger round cap never binds: components at least halve each
round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import (  # noqa: F401  (re-exports)
    ANALYSIS_KINDS,
    certificate_fn,
    get_analysis,
    normalize_kind,
)
from repro_torch.core.certificate import certificate_capacity
from repro_torch.graph.datastructs import (
    INT,
    EdgeList,
    admission_capacity,
    resolve_device,
    tombstone_mask,
)
from repro_torch.kernels.segment_min.kernel import check_key_space
from repro_torch.obs import get_tracer


@dataclasses.dataclass(frozen=True)
class BatchedEdgeList:
    """B stacked padded edge lists with a shared vertex count.

    src, dst : int32[B, capacity]
    mask     : bool[B, capacity]
    n_nodes  : int   vertex-count bucket shared by the whole batch
    """

    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor
    n_nodes: int

    @property
    def batch_size(self) -> int:
        return self.src.shape[0]

    @property
    def capacity(self) -> int:
        return self.src.shape[1]

    def __getitem__(self, i: int) -> EdgeList:
        return EdgeList(self.src[i], self.dst[i], self.mask[i], self.n_nodes)

    @staticmethod
    def from_graphs(graphs, n_nodes: int, capacity: int | None = None,
                    batch_pad: int | None = None,
                    device=None) -> "BatchedEdgeList":
        """Stack ``[(src, dst), ...]`` into one batched buffer on
        ``device`` (the card unless named).

        Each graph is padded to the shared ``capacity`` (default: the max
        raw edge count). ``batch_pad`` optionally pads the batch dimension
        with empty graphs so nearby batch sizes share one program too.
        """
        graphs = [(np.asarray(s, np.int32), np.asarray(d, np.int32))
                  for s, d in graphs]
        if capacity is None:
            capacity = max(max((len(s) for s, _ in graphs), default=1), 1)
        for s, _ in graphs:
            if len(s) > capacity:
                raise ValueError(f"graph with {len(s)} edges exceeds batch "
                                 f"capacity {capacity}")
        total = max(batch_pad if batch_pad is not None else len(graphs),
                    len(graphs))
        dev = resolve_device(device)
        # zeros made on the device; only each row's real edges are copied
        src = torch.zeros((total, capacity), dtype=INT, device=dev)
        dst = torch.zeros((total, capacity), dtype=INT, device=dev)
        mask = torch.zeros((total, capacity), dtype=torch.bool, device=dev)
        for i, (s, d) in enumerate(graphs):
            src[i, :len(s)].copy_(torch.from_numpy(np.ascontiguousarray(s)))
            dst[i, :len(d)].copy_(torch.from_numpy(np.ascontiguousarray(d)))
            mask[i, :len(s)] = True
        return BatchedEdgeList(src, dst, mask, n_nodes)

    def delete_edges(self, deletions) -> "BatchedEdgeList":
        """Tombstone per-graph deletion keys out of the batch in one pass
        over the union.

        ``deletions``: iterable of per-graph ``(ksrc, kdst)`` endpoint-pair
        arrays (or ``None`` for no deletions in that row), at most one entry
        per batch row. Every live copy of a matched pair is masked out; the
        buffers keep their shapes.
        """
        dels = list(deletions)
        if len(dels) > self.batch_size:
            raise ValueError(
                f"{len(dels)} deletion lists for a batch of {self.batch_size}")
        keys = batch_keys(dels, self.n_nodes, self.batch_size,
                          admission_capacity(
                              max((len(np.asarray(sd[0])) for sd in dels
                                   if sd is not None), default=1), 1),
                          self.src.device)
        union = union_tombstone(self.src, self.dst, self.mask, *keys,
                                self.n_nodes)
        return BatchedEdgeList(self.src, self.dst,
                               union.mask.reshape(self.mask.shape),
                               self.n_nodes)


def batch_keys(deletions, n_nodes: int, batch: int, kcap: int,
               device) -> tuple:
    """Per-graph deletion keys (``(ksrc, kdst)`` or ``None`` per row) as
    ``[batch, kcap]`` key buffers, as the reference's ``from_graphs`` of the
    key lists lays them out."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    kel = BatchedEdgeList.from_graphs(
        [empty if sd is None else sd for sd in deletions], n_nodes,
        capacity=kcap, batch_pad=batch, device=device)
    return kel.src, kel.dst, kel.mask


def union_edges(src, dst, mask, n_nodes: int) -> EdgeList:
    """``[B, cap]`` buffers -> their disjoint union: one ``EdgeList`` of
    ``B * cap`` slots over ``B * n_nodes`` vertices, row b's ids offset by
    ``b * n_nodes``, slots row-major, masked slots zero. Raises where the
    union exceeds the kernels' int32 key space (``check_key_space``):
    there is no per-row fallback.

    The rows are clean by contract: every endpoint of a masked-in slot lies
    in ``[0, n_nodes)``, since an id outside would name a vertex of another
    row once offset. ``BridgeEngine.analyze_batch`` holds the contract by
    sending such rows through the one-graph program before upload, at no
    device sync; a range check here, on the device tensors, would cost a
    sync per batch."""
    b, cap = src.shape
    check_key_space(b * cap, b * n_nodes)
    off = (torch.arange(b, dtype=INT, device=src.device) * n_nodes)[:, None]
    return EdgeList(torch.where(mask, src + off, 0).reshape(-1),
                    torch.where(mask, dst + off, 0).reshape(-1),
                    mask.reshape(-1), b * n_nodes)


def union_keys(ksrc, kdst, kmask, n_nodes: int) -> EdgeList:
    """``[B, K]`` deletion keys offset like their rows (``union_edges``).
    A key naming a vertex outside ``[0, n_nodes)`` matches no edge of its
    row, so it is masked: offset, it could name one of another row."""
    inside = ((ksrc >= 0) & (ksrc < n_nodes) & (kdst >= 0)
              & (kdst < n_nodes))
    return union_edges(ksrc, kdst, kmask & inside, n_nodes)


def union_tombstone(src, dst, mask, ksrc, kdst, kmask,
                    n_nodes: int) -> EdgeList:
    """The union of ``[B, cap]`` buffers (``union_edges``) with each row's
    ``[B, K]`` deletion keys tombstoned in one pass (keys offset like the
    rows, so a key only matches its own row)."""
    u = union_edges(src, dst, mask, n_nodes)
    k = union_keys(ksrc, kdst, kmask, n_nodes)
    umask, _ = tombstone_mask(u.src, u.dst, u.mask, k.src, k.dst, k.mask)
    return EdgeList(u.src, u.dst, umask, u.n_nodes)


def split_certificate(cert: EdgeList, batch: int, n_nodes: int) -> tuple:
    """A union certificate -> ``[batch, certificate_capacity(n_nodes)]``
    rows ``(src, dst, mask)``: row b holds the edges whose endpoints lie in
    ``[b * n_nodes, (b + 1) * n_nodes)``, offset removed, in the union's
    slot order, then zeros. The union is compacted in slot order, so each
    row's edges form one run and runs come in row order."""
    dev = cert.src.device
    row_cap = certificate_capacity(n_nodes)
    row = torch.where(cert.mask, torch.div(cert.src, n_nodes,
                                           rounding_mode="floor"), batch)
    counts = torch.bincount(row, minlength=batch + 1)[:batch]
    start = torch.cumsum(counts, 0) - counts
    rowc = row.clamp(max=batch - 1).long()
    slot = torch.arange(cert.capacity, device=dev) - start[rowc]
    idx = torch.where(cert.mask, rowc * row_cap + slot, batch * row_cap)
    off = rowc.to(INT) * n_nodes
    out = []
    for values, fill in ((cert.src - off, 0), (cert.dst - off, 0),
                         (cert.mask, False)):
        buf = torch.full((batch * row_cap + 1,), fill, dtype=values.dtype,
                         device=dev)
        buf[idx] = values
        out.append(buf[:-1].reshape(batch, row_cap))
    return tuple(out)


def first_run(on_trace):
    """``on_trace`` made to tick on the first call only: a program's
    counterpart of a JAX trace (``EngineStats.traces``)."""
    if on_trace is None:
        return lambda: None
    ran = []

    def tick():
        if not ran:
            ran.append(True)
            on_trace()

    return tick


def make_analysis_fn(n_nodes: int, kind: str = "bridges",
                     final: str = "device", on_trace=None,
                     with_delete: bool = False,
                     certificate: str | None = None):
    """The query core for one analysis kind.

    ``(src, dst, mask) ->`` the kind's declared device buffers (see
    ``Analysis.out_struct``), or — with ``final='host'`` — the kind's
    sparse certificate ``(src, dst, mask)`` in ``2(n_nodes - 1)`` slots, on
    which the caller runs the kind's host reference.

    The certificate is built only where it is needed: for ``final='host'``
    and for the kinds whose ``device_input`` is ``"certificate"``; the
    vertex kinds run the device final on the full buffer.

    ``with_delete=True`` prepends a tombstone pass: the function takes
    three extra ``(ksrc, kdst, kmask)`` deletion-key buffers and answers on
    the graph minus every matched pair. ``on_trace`` ticks on the first
    call only (``first_run``). ``certificate`` overrides the kind's
    declared certificate (callers validate it first, as ``BridgeEngine``
    does).
    """
    analysis = get_analysis(kind)
    if final not in ("device", "host"):
        raise ValueError(f"unknown final stage {final!r}")
    cert_cap = certificate_capacity(n_nodes)
    out_cap = max(n_nodes - 1, 1)
    certify = certificate_fn(certificate if certificate is not None
                             else analysis.certificate)
    tick = first_run(on_trace)

    def one(src, dst, mask, *keys):
        tick()
        if with_delete:
            mask, _ = tombstone_mask(src, dst, mask, *keys)
        buf = EdgeList(src, dst, mask, n_nodes)
        if final == "host" or analysis.device_input == "certificate":
            buf = certify(buf, capacity=cert_cap)
        if final == "host":
            return buf.src, buf.dst, buf.mask
        st = tour_state(buf.src, buf.dst, buf.mask, n_nodes)
        return analysis.device_fn(buf.src, buf.dst, buf.mask, n_nodes, st,
                                  out_cap)

    return one


def make_query_fn(n_nodes: int, final: str = "device", on_trace=None):
    """Backward-compatible alias: the kind='bridges' analysis core."""
    return make_analysis_fn(n_nodes, "bridges", final, on_trace)


def _stack_rows(rows: list):
    """Per-row outputs (a tensor or a tuple of them) -> stacked ``[B, ...]``
    outputs, as ``vmap`` returns them."""
    if isinstance(rows[0], torch.Tensor):
        return torch.stack(rows)
    return tuple(torch.stack(leaf) for leaf in zip(*rows))


def make_batched_pipeline(n_nodes: int, final: str = "device", on_trace=None,
                          kind: str = "bridges", with_delete: bool = False,
                          certificate: str | None = None):
    """The batched pipeline over ``[B, cap]`` buffers (and ``[B, K]`` keys
    with ``with_delete``) as one disjoint-union pass (module docstring):
    the outputs of ``make_analysis_fn`` stacked along a leading batch axis,
    slot for slot what the reference's ``vmap`` returns."""
    analysis = get_analysis(kind)
    if final not in ("device", "host"):
        raise ValueError(f"unknown final stage {final!r}")
    out_cap = max(n_nodes - 1, 1)
    cert_name = (certificate if certificate is not None
                 else analysis.certificate)
    certify = certificate_fn(cert_name)
    tick = first_run(on_trace)

    def batched(src, dst, mask, *keys):
        tick()
        tr = get_tracer()
        b = src.shape[0]
        with tr.span("stage/union", batch=b) as sp:
            union = sp.sync(union_tombstone(src, dst, mask, *keys, n_nodes)
                            if with_delete
                            else union_edges(src, dst, mask, n_nodes))
        if final == "device" and analysis.device_input != "certificate":
            # the vertex kinds' device final runs on each row's own buffer
            rows = (src, dst, union.mask.reshape(mask.shape))
        else:
            with tr.span(f"stage/certificate_build/{cert_name}",
                         batch=b) as sp:
                rows = sp.sync(split_certificate(
                    certify(union,
                            capacity=certificate_capacity(union.n_nodes)),
                    b, n_nodes))
            if final == "host":
                return rows
        with tr.span(f"stage/final/{analysis.kind}", batch=b) as sp:
            out = []
            for s, d, m in zip(*rows):
                st = tour_state(s, d, m, n_nodes)
                out.append(analysis.device_fn(s, d, m, n_nodes, st, out_cap))
            return sp.sync(_stack_rows(out))

    return batched
