"""Engine dispatch layer: the build-once program cache and the program
builders (``repro.engine.dispatch``).

``ProgramCache`` is the keyed build-once store (its hit and miss counters
feed ``EngineStats``); the ``build_*_program`` functions are the engine's
program factories. A program here is a closure built once per cache key
for one (shape bucket, kind, certificate) configuration, which ticks
``on_trace`` on its first run (``batched.first_run``) — the counterpart of
the reference's ``jax.jit`` program and its trace. It is neither a
captured CUDA graph nor ``torch.compile``: every forest pass is a Python
loop that reads a flag back each round (``core/forest.py``), and capture
cannot follow a loop whose length depends on the data.

Each program runs its stages under ``torch.profiler.record_function``
labels that match the host span names (``stage/certificate_build/<name>``,
``stage/merge/<name>``, ``stage/append``, ``stage/tombstone``,
``stage/final/<kind>``), so a profiler capture lines up with the spans the
engine records around each dispatch, as the reference's
``jax.named_scope`` labels do.
"""
from __future__ import annotations

from torch.profiler import record_function

from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import get_analysis
from repro_torch.core.certificate import certificate_capacity
from repro_torch.core.certs import get_certificate
from repro_torch.engine.batched import (
    first_run,
    make_analysis_fn,
    make_batched_pipeline,
)
from repro_torch.graph.datastructs import (
    EdgeList,
    admission_capacity,
    compact_edges,
    concat_edges,
    tombstone_mask,
)


def admission_bucket(n_nodes: int, n_edges: int,
                     min_bucket: int = 16) -> tuple[int, int]:
    """The power-of-two ``(n_bucket, capacity_bucket)`` shape bucket a
    request is admitted under — the bucket components of every
    ``ProgramCache`` key, so two requests with equal admission buckets
    share one program."""
    return (admission_capacity(int(n_nodes), min_bucket),
            admission_capacity(max(int(n_edges), 1), min_bucket))


class ProgramCache:
    """Build-once store: ``get(key, build)`` builds on first use and counts
    hits afterwards (into the shared ``EngineStats``)."""

    def __init__(self, stats):
        self.stats = stats
        self._programs: dict[tuple, object] = {}

    def get(self, key: tuple, build):
        fn = self._programs.get(key)
        if fn is None:
            self.stats.misses += 1
            fn = self._programs[key] = build()
        else:
            self.stats.hits += 1
        return fn

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key: tuple) -> bool:
        return key in self._programs

    def keys(self):
        """The cached program keys (read-only view)."""
        return self._programs.keys()


# ------------------------------------------------------------ one-shot
def build_analysis_program(n_bucket: int, kind: str, final: str, on_trace,
                           with_delete: bool = False,
                           certificate: str | None = None):
    """Single-graph one-shot pipeline (certificate + final); the host span
    around its dispatch is ``stage/pipeline/<kind>``."""
    return make_analysis_fn(n_bucket, kind, final, on_trace,
                            with_delete=with_delete, certificate=certificate)


def build_batched_program(n_bucket: int, kind: str, final: str, on_trace,
                          with_delete: bool = False,
                          certificate: str | None = None):
    """The batched pipeline: one disjoint-union pass over the batch."""
    return make_batched_pipeline(n_bucket, final=final, on_trace=on_trace,
                                 kind=kind, with_delete=with_delete,
                                 certificate=certificate)


# ---------------------------------------------------------- live-state
def build_cert_load_program(name: str, n_bucket: int, on_trace):
    """Program for one certificate type's ``load_state``: (src, dst, mask)
    buffer -> live state tuple. One program per (certificate, buffer
    bucket) serves the initial load, the lazy materialization and the
    decremental certificate-hit rebuild."""
    desc = get_certificate(name)
    cert_cap = certificate_capacity(n_bucket)
    tick = first_run(on_trace)

    def run(src, dst, mask):
        tick()
        with record_function(f"stage/certificate_build/{name}"):
            return desc.load_state(EdgeList(src, dst, mask, n_bucket),
                                   cert_cap)

    return run


def build_cert_insert_program(name: str, n_bucket: int, on_trace):
    """Program for one certificate type's ``fold_state``: live state +
    delta buffer -> updated state. The warm-start Borůvka pair scans only
    the delta; the rescan certificates (sfs, hybrid) re-certify the
    bounded cert ∪ delta union — O(n + Δ) either way, never O(E)."""
    desc = get_certificate(name)
    cert_cap = certificate_capacity(n_bucket)
    tick = first_run(on_trace)

    def run(*args):
        tick()
        state, (rs, rd, rm) = args[:-3], args[-3:]
        with record_function(f"stage/merge/{name}"):
            return desc.fold_state(state, EdgeList(rs, rd, rm, n_bucket),
                                   cert_cap)

    return run


def build_append_program(n_bucket: int, out_cap: int, on_trace):
    """Compact-append the delta into the live full buffer: tombstoned holes
    are reclaimed, real edges land at the front, and the output capacity is
    a host-chosen bucket (the input's, unless the live edge count crosses
    it)."""
    tick = first_run(on_trace)

    def run(fs, fd, fm, rs, rd, rm):
        tick()
        with record_function("stage/append"):
            out = compact_edges(
                concat_edges(EdgeList(fs, fd, fm, n_bucket),
                             EdgeList(rs, rd, rm, n_bucket)), out_cap)
            return out.src, out.dst, out.mask

    return run


def build_delete_program(on_trace):
    """Tombstone pass: mask matched (min, max) keys out of a buffer and
    count the kills. Shared by the full-buffer deletion and the
    certificate-hit probe (one program per (capacity, key bucket))."""
    tick = first_run(on_trace)

    def run(s, d, m, ks, kd, km):
        tick()
        with record_function("stage/tombstone"):
            return tombstone_mask(s, d, m, ks, kd, km)

    return run


def build_final_program(n_bucket: int, kind: str, on_trace):
    """Final analysis stage over the kind's live certificate."""
    analysis = get_analysis(kind)
    out_cap = max(n_bucket - 1, 1)
    tick = first_run(on_trace)

    def run(cs, cd, cm):
        tick()
        with record_function(f"stage/final/{kind}"):
            st = tour_state(cs, cd, cm, n_bucket)
            return analysis.device_fn(cs, cd, cm, n_bucket, st, out_cap)

    return run


# ---------------------------------------------------------- distributed
def build_distributed_program(mesh, machine_axes, n_nodes: int, kind: str,
                              final: str, schedule: str, merge: str,
                              with_delete: bool = False,
                              certificate: str | None = None):
    """The paper's full distributed pipeline as one process-group program
    (``core.merge.build_distributed_analysis_fn``). As in the reference it
    ticks no trace counter."""
    from repro_torch.core.merge import build_distributed_analysis_fn

    return build_distributed_analysis_fn(
        mesh, machine_axes, n_nodes, schedule=schedule, final=final,
        merge=merge, kind=kind, with_deletions=with_delete,
        certificate=certificate)
