"""Engine state layer: program-cache counters and the live-graph state
(``repro.engine.state``).

This module owns the mutable state the engine carries between calls: the
``EngineStats`` counters that back the no-rebuild serving assertion, and
the ``LiveState`` holding the resident full edge buffer plus the
per-certificate live states for incremental and decremental serving. The
dispatch layer (``dispatch.py``) owns the programs; the engine
(``engine.py``) composes the two.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EngineStats:
    """Program-cache counters.

    ``hits``/``misses`` count program-cache lookups. ``traces`` counts the
    first run of each built program: the port's counterpart of a JAX
    trace, which the reference ticks inside the traced body, so once per
    program key. A program ticks when it first runs and never again: a
    program that is called again does not tick (``dispatch.first_run``).
    """

    hits: int = 0
    misses: int = 0
    traces: int = 0

    def reset(self) -> None:
        self.hits = self.misses = self.traces = 0

    def count_trace(self) -> None:
        """A program's first run (its ``on_trace``). Programs hold this
        bound method, not the engine, so an engine that is dropped frees
        its device buffers at once (no cycle through its cache)."""
        self.traces += 1

    def snapshot(self) -> dict:
        """Counter dict plus the derived hit rate: the one rollup serving
        code consumes (``BridgeEngine.snapshot`` merges it with the
        live-state counters)."""
        lookups = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "traces": self.traces,
            "hit_rate": self.hits / lookups if lookups else None,
        }


@dataclasses.dataclass
class SchedStats:
    """Continuous-batching scheduler counters (``engine/scheduler.py``).

    ``coalesced`` counts real queries served through coalesced batched
    dispatches, ``dispatches`` the device dispatches that served them —
    their ratio is the batch occupancy — and ``padded_slots`` the
    masked-off batch rows the power-of-two batch bucket added.
    """

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    drains: int = 0
    dispatches: int = 0
    coalesced: int = 0
    padded_slots: int = 0
    writes: int = 0

    @property
    def occupancy(self) -> float | None:
        """Mean real queries per coalesced dispatch (> 1 == amortizing)."""
        return self.coalesced / self.dispatches if self.dispatches else None

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "drains": self.drains,
            "dispatches": self.dispatches,
            "coalesced": self.coalesced,
            "padded_slots": self.padded_slots,
            "writes": self.writes,
            "occupancy": self.occupancy,
        }


@dataclasses.dataclass
class LiveState:
    """The engine's live graph (``load``/``insert_edges``/``delete_edges``).

    certs    : per-certificate live state tuples (``None`` = lazy,
               not materialized yet — see ``core.certs``)
    rebuilds : per-certificate certificate-hit rebuild counters, one entry
               per MATERIALIZED certificate
    full     : the resident (src, dst, mask) full edge buffer — the
               tombstone target and the rebuild source; ``None`` when
               streamed
    count    : live edge count (inserts minus deletions), tracked on the
               host so bucket growth is a shape decision with no sync
    stream   : the ``graph.datastructs.ChunkedEdgeStream`` behind a
               streamed live graph (chunk bucket, host spill ring, ingest
               counters); ``None`` after a one-shot ``load``
    """

    certs: dict
    rebuilds: dict
    full: tuple | None
    count: int
    n_nodes: int
    n_bucket: int
    stream: object = None

    def __getitem__(self, key: str):
        # dict-style access, as the reference allows (``_live["n_bucket"]``)
        return getattr(self, key)


def masked_arrays(out):
    """(src, dst, mask) buffers -> host (src[mask], dst[mask])."""
    s, d, m = (x.cpu().numpy() for x in out)
    return s[m], d[m]


def live_state_tree(live: LiveState) -> dict:
    """``LiveState`` -> a checkpointable dict tree: ``full/<i>`` for the
    full-buffer triplet, ``certs/<name>/<i>`` per MATERIALIZED certificate
    state slot (lazy certificates not yet materialized are absent: they
    materialize from the restored full buffer on first query),
    ``rebuilds/<name>`` and ``meta/*`` as ints. ``live_state_from_flat``
    is the inverse of its flattening to ``/``-joined paths. A streamed
    live state (``full is None``) has no full buffer to checkpoint: its
    host spill ring is its recovery log."""
    if live.full is None:
        raise ValueError(
            "streamed live state has no full buffer to checkpoint; replay "
            "the spill ring instead (ChunkedEdgeStream)")
    return {
        "full": list(live.full),
        "certs": {name: list(state)
                  for name, state in live.certs.items() if state is not None},
        "rebuilds": {name: int(v) for name, v in live.rebuilds.items()},
        "meta": {"count": int(live.count), "n_nodes": int(live.n_nodes),
                 "n_bucket": int(live.n_bucket)},
    }


def live_state_from_flat(flat: dict) -> LiveState:
    """Rebuild a ``LiveState`` from ``/``-joined paths to host arrays (the
    caller moves them to the device and re-registers the lazy
    certificates)."""
    full: dict = {}
    certs: dict = {}
    rebuilds: dict = {}
    meta: dict = {}
    for path, arr in flat.items():
        head, _, rest = path.partition("/")
        if head == "full":
            full[int(rest)] = arr
        elif head == "certs":
            name, _, slot = rest.partition("/")
            certs.setdefault(name, {})[int(slot)] = arr
        elif head == "rebuilds":
            rebuilds[rest] = int(arr)
        elif head == "meta":
            meta[rest] = int(arr)
        else:
            raise ValueError(f"unknown live-state checkpoint path {path!r}")
    return LiveState(
        certs={name: tuple(slots[i] for i in range(len(slots)))
               for name, slots in certs.items()},
        rebuilds=rebuilds,
        full=tuple(full[i] for i in range(len(full))),
        count=meta["count"],
        n_nodes=meta["n_nodes"],
        n_bucket=meta["n_bucket"],
    )


__all__ = ["EngineStats", "LiveState", "SchedStats", "live_state_from_flat",
           "live_state_tree", "masked_arrays"]
