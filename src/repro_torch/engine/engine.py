"""BridgeEngine: the build-once, shape-bucketed, batched and incrementally
updatable query engine (``repro.engine.engine``).

* **build-once** — programs are cached in the engine keyed by
  ``(kind, n_nodes bucket, capacity bucket, device type, ...)``. Inputs
  are padded to power-of-two buckets (``admission_capacity``), so nearby
  graph sizes share one program; ``stats`` counts cache hits, misses and
  first runs (``traces``) so serving code can assert that nothing new was
  built.
* **batched** — ``analyze_batch`` and the ``find_*_batch`` methods pack B
  graphs into a ``BatchedEdgeList`` and resolve them in one disjoint-union
  pass (``engine/batched.py``): each forest round is one kernel launch for
  the whole batch.
* **multi-kind, multi-certificate** — every kind of the analysis registry
  and every certificate of the certificate registry is served through the
  same cache with no kind-specific engine code.
* **incremental / decremental** — ``load`` + ``insert_edges`` +
  ``delete_edges`` serve edge churn from the resident live state, through
  the warm-start fold-in and the certificate-hit rebuild rule, without
  re-running the full pipeline.
* **streaming** — ``load_stream`` + ``ingest_chunk`` serve graphs whose
  edge buffer should not live on the device: edges flow through fixed-size
  chunk buffers folded straight into the live certificates, the full
  buffer is never built, and peak device memory is O(chunk + certificate).
  A host spill ring (``ChunkedEdgeStream``) is the tombstone target and
  the replay source.
* **observable** — every dispatch sits in a tracer span named for its
  stage (``stage/pad``, ``stage/pipeline/<kind>``,
  ``stage/certificate_build/<name>``, ``stage/merge/<name>``,
  ``stage/ingest``, ``stage/append``, ``stage/tombstone``,
  ``stage/final/<kind>``, ``stage/convert``) with a device-sync boundary,
  through ``repro_torch.obs`` (off by default). ``snapshot()`` is the one
  rollup dict.

Bucketing the vertex count is sound because every stage treats the extra
vertices as isolated; bucketing the edge capacity because all device code
is mask-aware.

* **scheduled** — ``submit``/``drain``/``drain_all`` queue tenant-tagged
  requests on a lazily built ``BridgeScheduler`` (``engine/scheduler.py``):
  same-bucket reads coalesce into one ``analyze_batch`` union pass, writes
  run between read waves.
* **checkpointed** — ``enable_checkpoints`` attaches an every-K-write-ops
  ``CheckpointPolicy``: each applied ``insert_edges``/``delete_edges``/
  ``ingest_chunk`` advances the checkpoint clock, and every K-th one
  snapshots the live state (atomic manifest + CRC, ``checkpoint/``).
  ``checkpoint_now`` snapshots at once; ``restore_live`` puts the newest
  verified snapshot back on the device and runs no program.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.connectivity.registry import get_analysis, resolve_certificate
from repro_torch.core.certs import (
    certificate_names,
    get_certificate,
    primary_certificate,
)
from repro_torch.core.merge import (
    machine_group,
    mesh_device,
    result_shard_zero,
)
from repro_torch.core.partition import partition_edges
from repro_torch.engine.batched import (
    BatchedEdgeList,
    batch_keys,
    normalize_kind,
)
from repro_torch.engine.dispatch import (
    ProgramCache,
    build_analysis_program,
    build_append_program,
    build_batched_program,
    build_cert_insert_program,
    build_cert_load_program,
    build_delete_program,
    build_distributed_program,
    build_final_program,
)
from repro_torch.engine.state import (
    EngineStats,
    LiveState,
    live_state_from_flat,
    live_state_tree,
    masked_arrays,
)
from repro_torch.graph.datastructs import (
    INT,
    ChunkedEdgeStream,
    EdgeList,
    admission_capacity,
    resolve_device,
)
from repro_torch.obs import get_metrics, get_tracer

__all__ = ["BridgeEngine", "EngineStats", "analyze_batch",
           "find_bridges_batch", "get_default_engine"]


class BridgeEngine:
    """Persistent connectivity-query engine (single-device or distributed).

    Single-device (``mesh=None``): certificate + final stage, cached per
    shape bucket, with batched and incremental entry points. Runs on the
    card unless ``device`` names another; without a card and without
    ``device`` it raises.

    Distributed (``mesh=``, a ``torch.distributed`` ``DeviceMesh``): the
    paper's full pipeline (partition, per-machine certificates, merge
    schedule, final stage) with the process-group program cached per
    (kind, n_nodes, shard-capacity bucket, ...). Every rank calls it with
    the same graph and gets the same answer.
    """

    def __init__(self, *, device=None, mesh=None, machine_axes=None,
                 schedule: str = "paper", merge: str = "recertify",
                 min_bucket: int = 16, certificate: str | None = None):
        self.mesh = mesh
        self.device = (mesh_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        # None: every dim of the mesh (``core.merge.machine_axes_of``)
        if isinstance(machine_axes, str):
            machine_axes = (machine_axes,)
        self.machine_axes = tuple(machine_axes) if machine_axes else None
        self.schedule = schedule
        self.merge = merge
        self.min_bucket = min_bucket
        # engine-wide certificate preference: None/"auto" = each kind's
        # default; a name = use it wherever it preserves what the kind
        # needs (per-call overrides are strict: ``_resolve_certificate``)
        if certificate in (None, "auto"):
            self.certificate = None
        else:
            self.certificate = get_certificate(certificate).name
        self.backend = self.device.type
        self.stats = EngineStats()
        self._cache = ProgramCache(self.stats)
        self._live: LiveState | None = None
        self._scheduler = None  # lazy BridgeScheduler (see .scheduler)
        self._ckpt = None       # CheckpointPolicy (see enable_checkpoints)
        self._write_ops = 0     # applied write ops = checkpoint step clock
        self._peak_live_bytes = 0  # high-water device bytes since load

    @property
    def _programs(self) -> dict:
        return self._cache._programs

    def _resolve_certificate(self, analysis,
                             override: str | None = None) -> str:
        """The certificate serving ``analysis``: its declared default,
        unless a per-call ``override`` (strict — ValueError if it does not
        preserve what the kind's default does) or the engine-wide
        preference (permissive — falls back to the default where the kind
        cannot ride it) picks another registered type."""
        if override is not None or self.certificate is None:
            return resolve_certificate(analysis.kind, override)
        default = get_certificate(analysis.certificate)
        cert = get_certificate(self.certificate)
        return cert.name if cert.preserves >= default.preserves \
            else default.name

    def certificate_for(self, kind: str) -> str:
        """The certificate name queries for ``kind`` resolve to under this
        engine's configuration."""
        return self._resolve_certificate(get_analysis(kind))

    def _program_certificate(self, analysis, final: str,
                             override: str | None) -> str | None:
        """Certificate component of a one-shot program's cache key: the
        resolved name where the program builds a certificate (final='host'
        or a ``device_input='certificate'`` kind), else None so programs
        that never build one are shared across certificate choices.
        Overrides are validated either way."""
        cert_name = self._resolve_certificate(analysis, override)
        if final != "host" and analysis.device_input != "certificate":
            return None
        return cert_name

    # ------------------------------------------------------------------ cache
    def _program(self, key: tuple, build):
        """Build once: build on first use, count hits afterwards."""
        return self._cache.get(key, build)

    def cache_info(self) -> dict:
        return {
            "programs": len(self._cache),
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "traces": self.stats.traces,
        }

    def snapshot(self) -> dict:
        """The engine rollup: program-cache counters and hit rate, (when a
        live graph is loaded) the per-certificate rebuild counters with
        their total, the live edge count and the live bytes, and the
        scheduler's and the checkpoint policy's rollups once they exist."""
        snap = {"programs": len(self._cache), **self.stats.snapshot()}
        if self._live is not None:
            rebuilds = dict(self._live.rebuilds)
            snap["rebuilds"] = rebuilds
            snap["rebuilds_total"] = sum(rebuilds.values())
            snap["live_graph_edges"] = self._live.count
            snap["live_bytes"] = self._account_live_bytes()
            snap["peak_live_bytes"] = self._peak_live_bytes
            if self._live.stream is not None:
                st = self._live.stream
                snap["ingest"] = {
                    "chunks": st.chunks_in, "folds": st.folds,
                    "spilled": st.spilled_edges, "replays": st.replays,
                    "chunk_bucket": st.chunk_bucket,
                }
        if self._scheduler is not None:
            snap["scheduler"] = self._scheduler.snapshot()
        if self._ckpt is not None:
            snap["checkpoint"] = self._ckpt.snapshot()
        return snap

    # ------------------------------------------------------------- checkpoint
    def enable_checkpoints(self, directory, *, every: int = 8, keep: int = 3):
        """Attach an every-K-write-ops ``CheckpointPolicy``: from now on
        each applied write op counts one, and every ``every``-th write
        snapshots the live state (full buffer, materialized certificate
        states, counters) through an atomic manifest+CRC
        ``CheckpointManager`` under ``directory``. Returns the policy
        (counters in ``snapshot()``)."""
        from repro_torch.checkpoint.manager import (
            CheckpointManager,
            CheckpointPolicy,
        )

        self._ckpt = CheckpointPolicy(
            CheckpointManager(directory, keep=keep), every=every)
        return self._ckpt

    def _after_write(self):
        """One write op applied: advance the checkpoint clock and let the
        policy decide whether this step snapshots (the tree is only built
        when it does)."""
        self._write_ops += 1
        if self._ckpt is None or self._live is None:
            return
        if self._live.full is None:
            # a streamed live state does not checkpoint: there is no full
            # buffer to snapshot, and the host spill ring is the recovery
            # log (replay rebuilds everything)
            return
        with get_tracer().span("engine/checkpoint_maybe",
                               step=self._write_ops):
            self._ckpt.on_write(self._write_ops,
                                lambda: live_state_tree(self._live))

    def checkpoint_now(self):
        """Snapshot the live state immediately, regardless of cadence;
        returns the checkpoint's directory."""
        if self._ckpt is None:
            raise RuntimeError("checkpointing not enabled: call "
                               "enable_checkpoints() first")
        if self._live is None:
            raise RuntimeError("no live graph: call load() first")
        if self._live.full is None:
            raise RuntimeError(
                "streamed live state does not checkpoint: the spill ring "
                "is the recovery log (re-ingest replays it)")
        with get_tracer().span("engine/checkpoint", step=self._write_ops):
            return self._ckpt.checkpoint(self._write_ops,
                                         live_state_tree(self._live))

    def restore_live(self, step: int | None = None) -> int:
        """Restore the live state from the newest (or ``step``'s) verified
        checkpoint: the serving-side recovery path.

        Restore runs NO program: every array goes from the verified host
        copy straight onto ``self.device``; lazy certificates that were not
        materialized at save time come back as ``None`` (they materialize
        from the restored full buffer on first query, through the already
        cached ``cert_load`` program), and the program cache is untouched,
        so an engine that served a bucket before the restore serves it
        after with nothing new built. Ticks ``failures/recovered``.
        Returns the restored checkpoint step."""
        if self._ckpt is None:
            raise RuntimeError("checkpointing not enabled: call "
                               "enable_checkpoints() first")
        tr = get_tracer()
        with tr.span("recover/restore_live", step=step) as sp:
            found, flat = self._ckpt.manager.restore_flat(step)
            if found is None:
                raise RuntimeError(
                    f"no verified checkpoint to restore under "
                    f"{self._ckpt.manager.dir}")
            live = live_state_from_flat(flat)
            live.full = tuple(torch.from_numpy(x).to(self.device)
                              for x in live.full)
            live.certs = {name: tuple(torch.from_numpy(x).to(self.device)
                                      for x in state)
                          for name, state in live.certs.items()}
            for name in certificate_names():
                live.certs.setdefault(name, None)
            sp.sync(live.full)
            self._live = live
            self._write_ops = found
            self._ckpt.restores += 1
            get_metrics().counter("failures/recovered").inc()
            if getattr(sp, "attrs", None) is not None:
                # programs cached across the restore (unchanged: the warm
                # cache serves at once)
                sp.attrs.update(warm_programs=len(self._cache),
                                n_bucket=live.n_bucket, restored_step=found)
        return found

    # -------------------------------------------------------------- scheduler
    @property
    def scheduler(self):
        """The engine's continuous-batching request path, created on first
        use (``engine/scheduler.py``). For a custom coalescing window or an
        isolated metrics registry, construct ``BridgeScheduler(engine,
        ...)`` directly and drive it instead."""
        if self._scheduler is None:
            from repro_torch.engine.scheduler import BridgeScheduler

            self._scheduler = BridgeScheduler(self)
        return self._scheduler

    def submit(self, tenant: str, src, dst, n_nodes: int | None = None,
               *, op: str = "analyze", kind: str = "bridges",
               final: str = "device", certificate: str | None = None):
        """Queue a tenant-tagged request on the engine's scheduler; the
        returned ``Ticket`` resolves on a later ``drain``."""
        return self.scheduler.submit(tenant, src, dst, n_nodes, op=op,
                                     kind=kind, final=final,
                                     certificate=certificate)

    def drain(self) -> int:
        """One scheduler step: a coalesced read wave, then the write turn."""
        return self.scheduler.drain()

    def drain_all(self) -> int:
        """Drain the scheduler queue to empty."""
        return self.scheduler.drain_all()

    def _bucket(self, m: int) -> int:
        return admission_capacity(m, self.min_bucket)

    def _delete_keys(self, delete, n_nodes: int):
        """One-shot deletion keys -> (padded key EdgeList, key bucket).
        Shared by the single-graph and distributed ``delete=`` paths."""
        ks = np.asarray(delete[0], np.int32)
        kd = np.asarray(delete[1], np.int32)
        kcap = self._bucket(max(len(ks), 1))
        return EdgeList.from_arrays(ks, kd, n_nodes, capacity=kcap,
                                    device=self.device), kcap

    # ---------------------------------------------------------- single device
    def analyze(self, src, dst, n_nodes: int, *, kind: str = "bridges",
                final: str = "device", seed: int = 0, delete=None,
                certificate: str | None = None):
        """One graph, one analysis kind; one program per shape bucket.

        kind='bridges'     -> set[(u, v)] bridge pairs
        kind='cuts'        -> set[int] articulation points
        kind='2ecc'        -> int array[n_nodes] canonical 2ECC labels
        kind='bridge_tree' -> set[(a, b)] 2ECC supernode pairs
        kind='bcc'         -> set[frozenset[int]] biconnected blocks

        ``final='host'`` answers with the kind's sequential host reference
        run on the kind's sparse certificate instead of the device final
        stage. ``seed`` only affects the distributed edge partition.

        ``delete=(ksrc, kdst)`` answers on the graph MINUS every live copy
        of the given unordered endpoint pairs, served by the same cached
        program family (a tombstone pass prepended to the pipeline; key
        buffers shape-bucketed like the edges). Works on the distributed
        substrate too: keys are replicated and each machine tombstones its
        own shard before the certificate and merge phases.

        ``certificate`` overrides the kind's declared certificate type with
        any registered type that preserves what the kind needs (ValueError
        otherwise). One-shot device queries of the ``device_input='full'``
        kinds never build a certificate.
        """
        analysis = get_analysis(kind)
        kind = analysis.kind
        if self.mesh is not None:
            return self._analyze_distributed(src, dst, n_nodes, kind=kind,
                                             final=final, seed=seed,
                                             delete=delete,
                                             certificate=certificate)
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        with get_tracer().span(f"engine/analyze/{kind}", substrate="single",
                               final=final):
            return self._single_pass(
                src, dst, n_nodes, self._bucket(n_nodes),
                self._bucket(max(len(src), 1)), analysis, final=final,
                delete=delete, certificate=certificate)

    def _single_pass(self, src, dst, n_nodes: int, n_bucket: int, cap: int,
                     analysis, *, final: str, delete, certificate):
        """One graph through the cached one-graph program of shape bucket
        ``(n_bucket, cap)``: ``analyze``'s body, and ``analyze_batch``'s
        path for a row with an id outside ``[0, n_bucket)``."""
        kind = analysis.kind
        tr = get_tracer()
        with tr.span("stage/pad"):
            # int32 src and dst: 8 B an edge, straight into the bucket
            with tr.span("stage/pad/h2d", bytes=8 * len(src), staged_bytes=0):
                el = EdgeList.from_arrays(src, dst, n_bucket, capacity=cap,
                                          device=self.device)
            args = (el.src, el.dst, el.mask)
            kcap = None
            if delete is not None:
                kel, kcap = self._delete_keys(delete, n_bucket)
                args += (kel.src, kel.dst, kel.mask)
        cert_name = self._program_certificate(analysis, final, certificate)
        key = ("single", kind, final, n_bucket, cap, kcap, self.backend,
               cert_name)
        fn = self._program(
            key, lambda: build_analysis_program(
                n_bucket, kind, final, self.stats.count_trace,
                with_delete=kcap is not None, certificate=cert_name))
        with tr.span(f"stage/pipeline/{kind}", stream=el.src.device,
                     n_bucket=n_bucket, cap=cap, certificate=cert_name) as sp:
            out = sp.sync(fn(*args))
        with tr.span("stage/convert"):
            if final == "host":
                return analysis.host_fn(*masked_arrays(out), n_nodes)
            return analysis.to_result(out, n_nodes)

    def find_bridges(self, src, dst, n_nodes: int, *, final: str = "device",
                     seed: int = 0) -> set[tuple[int, int]]:
        """Bridges of one graph."""
        return self.analyze(src, dst, n_nodes, kind="bridges", final=final,
                            seed=seed)

    def find_cuts(self, src, dst, n_nodes: int) -> set[int]:
        """Articulation points (cut vertices) of one graph."""
        return self.analyze(src, dst, n_nodes, kind="cuts")

    def find_two_ecc(self, src, dst, n_nodes: int) -> np.ndarray:
        """Canonical 2-edge-connected-component label per vertex."""
        return self.analyze(src, dst, n_nodes, kind="2ecc")

    def find_bridge_tree(self, src, dst, n_nodes: int) -> set[tuple[int, int]]:
        """Bridge tree edges as pairs of canonical 2ECC labels."""
        return self.analyze(src, dst, n_nodes, kind="bridge_tree")

    def find_bcc(self, src, dst, n_nodes: int) -> set[frozenset[int]]:
        """Biconnected blocks as canonical vertex sets."""
        return self.analyze(src, dst, n_nodes, kind="bcc")

    # ----------------------------------------------------------------- batched
    def analyze_batch(self, graphs, n_nodes, *, kind: str = "bridges",
                      final: str = "device", delete=None,
                      certificate: str | None = None) -> list:
        """Resolve B independent graphs in one disjoint-union pass.

        ``graphs``: iterable of (src, dst) pairs. ``n_nodes``: shared vertex
        count, or a per-graph sequence (bucketed to the max). Returns the
        per-graph results in order, typed per ``analyze``'s kind table.

        ``delete``: optional per-graph deletion-key lists — ``(ksrc, kdst)``
        or ``None`` per graph — tombstoned in the same pass (each graph
        answers minus its own failed links).

        ``certificate``: as in ``analyze``. A batch whose union exceeds the
        kernels' int32 key space raises (``batched.union_edges``).

        A row with an edge endpoint outside ``[0, n_bucket)`` is answered
        alone by the one-graph program of the batch's shape bucket, as the
        reference's vmapped row would be: offset into the union, its ids
        would name vertices of another row.
        """
        analysis = get_analysis(kind)
        kind = analysis.kind
        if self.mesh is not None:
            raise NotImplementedError(
                "batched dispatch is single-device; use mesh=None")
        graphs = [(np.asarray(s, np.int32), np.asarray(d, np.int32))
                  for s, d in graphs]
        if not graphs:
            return []
        ns = ([int(n_nodes)] * len(graphs)
              if np.ndim(n_nodes) == 0 else [int(x) for x in n_nodes])
        if len(ns) != len(graphs):
            raise ValueError(
                f"{len(graphs)} graphs but {len(ns)} vertex counts")
        if delete is not None:
            delete = list(delete)
            if len(delete) != len(graphs):
                raise ValueError(f"{len(graphs)} graphs but "
                                 f"{len(delete)} deletion lists")
        tr = get_tracer()
        with tr.span(f"engine/analyze_batch/{kind}", substrate="batched",
                     batch=len(graphs), final=final):
            n_bucket = self._bucket(max(ns))
            cap = self._bucket(
                max(max((len(s) for s, _ in graphs), default=1), 1))
            # A row naming a vertex outside [0, n_bucket) would name one of
            # another row once offset into the union: it runs alone through
            # the one-graph program instead. The graphs are still numpy, so
            # this costs no device sync.
            alone = [_out_of_bucket(s, d, n_bucket) for s, d in graphs]
            union = [i for i, a in enumerate(alone) if not a]
            rows = (self._union_pass(
                [graphs[i] for i in union], n_bucket, cap, analysis,
                final=final, certificate=certificate,
                delete=None if delete is None else [delete[i] for i in union])
                if union else None)
            # rows convert in order, so a row that raises does so where the
            # reference's would; a run of union rows shares one span
            out, j = [], 0
            for is_alone, run in itertools.groupby(range(len(graphs)),
                                                   alone.__getitem__):
                if is_alone:
                    out.extend(self._single_pass(
                        *graphs[i], ns[i], n_bucket, cap, analysis,
                        final=final, certificate=certificate,
                        delete=None if delete is None else delete[i])
                        for i in run)
                    continue
                with tr.span("stage/convert"):
                    for i in run:
                        row = tuple(x[j] for x in rows)
                        j += 1
                        if final == "host":
                            out.append(analysis.host_fn(
                                *masked_arrays(row), ns[i]))
                        else:
                            out.append(analysis.to_result(
                                row if len(row) > 1 else row[0], ns[i]))
            return out

    def _union_pass(self, graphs, n_bucket: int, cap: int, analysis, *,
                    final: str, delete, certificate) -> tuple:
        """Rows whose ids all lie in ``[0, n_bucket)`` through the cached
        batched program as one disjoint-union pass; returns the stacked
        outputs on the host, one row per graph."""
        kind = analysis.kind
        tr = get_tracer()
        with tr.span("stage/pad"):
            b_bucket = admission_capacity(len(graphs), 1)
            bel = BatchedEdgeList.from_graphs(graphs, n_bucket, capacity=cap,
                                              batch_pad=b_bucket,
                                              device=self.device)
            args = (bel.src, bel.dst, bel.mask)
            kcap = None
            if delete is not None:
                kcap = self._bucket(
                    max((len(np.asarray(sd[0])) for sd in delete
                         if sd is not None), default=0))
                args += batch_keys(delete, n_bucket, b_bucket, kcap,
                                   self.device)
        cert_name = self._program_certificate(analysis, final, certificate)
        key = ("batch", kind, final, n_bucket, cap, b_bucket, kcap,
               self.backend, cert_name)
        fn = self._program(
            key, lambda: build_batched_program(
                n_bucket, kind, final, self.stats.count_trace,
                with_delete=kcap is not None, certificate=cert_name))
        with tr.span(f"stage/pipeline/{kind}", n_bucket=n_bucket, cap=cap,
                     batch=b_bucket, rows=len(graphs),
                     certificate=cert_name) as sp:
            out_dev = sp.sync(fn(*args))
        return (tuple(x.cpu() for x in out_dev)
                if isinstance(out_dev, (tuple, list)) else (out_dev.cpu(),))

    def find_bridges_batch(self, graphs, n_nodes, *, final: str = "device",
                           ) -> list[set[tuple[int, int]]]:
        """Batched bridges: B graphs, one union pass."""
        return self.analyze_batch(graphs, n_nodes, kind="bridges",
                                  final=final)

    def find_cuts_batch(self, graphs, n_nodes) -> list[set[int]]:
        """Batched articulation points: B graphs, one union pass."""
        return self.analyze_batch(graphs, n_nodes, kind="cuts")

    def find_two_ecc_batch(self, graphs, n_nodes) -> list[np.ndarray]:
        """Batched canonical 2ECC labels: B graphs, one union pass."""
        return self.analyze_batch(graphs, n_nodes, kind="2ecc")

    def find_bridge_tree_batch(self, graphs, n_nodes,
                               ) -> list[set[tuple[int, int]]]:
        """Batched bridge trees: B graphs, one union pass."""
        return self.analyze_batch(graphs, n_nodes, kind="bridge_tree")

    def find_bcc_batch(self, graphs, n_nodes) -> list[set[frozenset[int]]]:
        """Batched biconnected blocks: B graphs, one union pass."""
        return self.analyze_batch(graphs, n_nodes, kind="bcc")

    # ------------------------------------------------------------- incremental
    def _cert_load(self, name: str, n_bucket: int, buffers) -> tuple:
        """Run the cached load/rebuild program for ``name`` on an edge
        buffer's shape bucket; returns the live state tuple. Span:
        ``stage/certificate_build/<name>`` (initial load, lazy
        materialization and decremental rebuild all land here)."""
        s, d, m = buffers
        key = ("cert_load", name, n_bucket, s.shape[0], self.backend, None)
        fn = self._program(
            key, lambda: build_cert_load_program(name, n_bucket,
                                                 self.stats.count_trace))
        with get_tracer().span(f"stage/certificate_build/{name}",
                               n_bucket=n_bucket) as sp:
            return tuple(sp.sync(fn(s, d, m)))

    def _delete_pass(self, buffers, keys, target: str):
        """Run the cached tombstone program for ``buffers``' shape bucket.
        Returns (new_mask, removed-count device scalar). Span:
        ``stage/tombstone`` with the probed buffer named in ``target``."""
        s, d, m = buffers
        key = ("delete", s.shape[0], keys.capacity, self.backend, None)
        fn = self._program(
            key, lambda: build_delete_program(self.stats.count_trace))
        with get_tracer().span("stage/tombstone", target=target) as sp:
            return sp.sync(fn(s, d, m, keys.src, keys.dst, keys.mask))

    def _materialize(self, name: str) -> tuple:
        """Lazy certificates (``Certificate.lazy``: the scan-first and
        hybrid pairs) are computed — from the live full buffer, or,
        streamed, by spill-ring replay — on the FIRST query that resolves
        to them, so workloads that never ask never pay their passes. Once
        live, a state is maintained per delta (and rebuilt when a deletion
        kills one of its edges)."""
        live = self._live
        state = live.certs.get(name)
        if state is None:
            if live.full is None:
                state = live.certs[name] = self._replay_state(name)
            else:
                state = live.certs[name] = self._cert_load(
                    name, live.n_bucket, live.full)
            live.rebuilds.setdefault(name, 0)
            self._account_live_bytes()
        return state

    def load(self, src, dst, n_nodes: int) -> "BridgeEngine":
        """Set the engine's live graph: every EAGER certificate of the
        registry (the warm-start Borůvka pair) is computed now; lazy ones
        (sfs, hybrid) wait for the first query that resolves to them. The
        full edge buffer stays resident: it is the tombstone target of
        ``delete_edges`` and the rebuild source when a deletion kills a
        certificate edge."""
        if self.mesh is not None:
            raise NotImplementedError(
                "incremental updates are single-device; use mesh=None")
        with get_tracer().span("engine/load"):
            src = np.asarray(src, np.int32)
            dst = np.asarray(dst, np.int32)
            n_bucket = self._bucket(n_nodes)
            cap = self._bucket(max(len(src), 1))
            el = EdgeList.from_arrays(src, dst, n_bucket, capacity=cap,
                                      device=self.device)
            self._live = LiveState(
                certs={}, rebuilds={}, full=(el.src, el.dst, el.mask),
                count=len(src), n_nodes=int(n_nodes), n_bucket=n_bucket)
            self._peak_live_bytes = 0
            for name in certificate_names():
                if get_certificate(name).lazy:
                    self._live.certs[name] = None
                else:
                    self._materialize(name)
            self._account_live_bytes()
        return self

    # --------------------------------------------------------------- streaming
    def load_stream(self, src, dst, n_nodes: int, *,
                    chunk_edges: int = 1024) -> "BridgeEngine":
        """Set the engine's live graph WITHOUT building its edge buffer:
        the streaming counterpart of ``load``.

        The initial edges — and every later ``ingest_chunk`` delta — flow
        through fixed ``chunk_edges``-sized device chunks folded straight
        into the live certificate states through the registry's
        ``load_state``/``fold_state`` programs, so peak device memory is
        O(chunk + certificate) instead of O(E). A host spill ring
        (``ChunkedEdgeStream``) keeps numpy copies of every chunk: the
        tombstone target of ``delete_edges`` and the replay source of
        certificate-hit rebuilds and lazy materialization. All chunks share
        ONE power-of-two ``chunk_bucket``, so steady-state ingest reuses
        one cached program per certificate whatever the delta sizes."""
        if self.mesh is not None:
            raise NotImplementedError(
                "streaming ingest is single-device; shard with "
                "core.merge.stream_shard_states and merge per-shard results")
        with get_tracer().span("engine/load_stream", chunk_edges=chunk_edges):
            n_bucket = self._bucket(n_nodes)
            stream = ChunkedEdgeStream(n_nodes, chunk_edges,
                                       minimum=self.min_bucket,
                                       device=self.device)
            self._live = LiveState(
                certs={name: None for name in certificate_names()},
                rebuilds={}, full=None, count=0, n_nodes=int(n_nodes),
                n_bucket=n_bucket, stream=stream)
            self._peak_live_bytes = 0
            self.ingest_chunk(src, dst)
        return self

    def ingest_chunk(self, src, dst, *, final: str = "device",
                     kind: str | None = None, certificate: str | None = None):
        """Stream an edge delta into the streamed live graph.

        The delta is split into ``chunk_bucket``-padded device chunks, one
        on the device at a time (``ChunkedEdgeStream.admit_each``, which
        also spills host copies into the ring), and each chunk folds into
        every certificate the engine
        tracks: eager certificates start from the first chunk through the
        cached ``cert_load`` program and fold the rest through the cached
        ``cert_insert`` program; lazy certificates wait for the first query
        that resolves to them (then replay the ring), and fold along once
        materialized. ``mem/live_bytes`` is updated at every chunk-fold
        boundary, which makes the O(chunk + certificate) peak observable.

        With ``kind=None`` returns the engine; with a kind, that analysis
        of the updated live graph."""
        live = self._live
        if live is None or live.stream is None:
            raise RuntimeError(
                "no streamed live graph: call load_stream() first")
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        with get_tracer().span("stage/ingest", edges=len(src),
                               chunk_bucket=live.stream.chunk_bucket):
            for chunk in live.stream.admit_each(src, dst):
                self._fold_chunk(chunk)
                self._account_live_bytes()
            live.count = live.stream.count
        self._after_write()
        if kind is None:
            return self
        return self.current_analysis(kind=kind, final=final,
                                     certificate=certificate)

    def _fold_into(self, name: str, state, chunk: EdgeList) -> tuple:
        """Fold one chunk into ``name``'s state: its cached ``load_state``
        program where there is no state yet, else its ``cert_insert``
        program keyed by the chunk bucket."""
        n_bucket = self._live.n_bucket
        if state is None:
            return self._cert_load(name, n_bucket,
                                   (chunk.src, chunk.dst, chunk.mask))
        key = ("cert_insert", name, n_bucket, chunk.capacity, self.backend,
               None)
        fn = self._program(
            key, lambda: build_cert_insert_program(name, n_bucket,
                                                   self.stats.count_trace))
        with get_tracer().span(f"stage/merge/{name}",
                               delta=chunk.capacity) as sp:
            return tuple(sp.sync(fn(*state, chunk.src, chunk.dst,
                                    chunk.mask)))

    def _fold_chunk(self, chunk: EdgeList) -> None:
        """Fold ONE admitted chunk into every tracked certificate state
        (eager ones, and lazy ones already materialized)."""
        live = self._live
        for name in list(live.certs):
            state = live.certs[name]
            if state is None and get_certificate(name).lazy:
                continue  # materializes by ring replay on first query
            live.certs[name] = self._fold_into(name, state, chunk)
            live.rebuilds.setdefault(name, 0)
            live.stream.folds += 1

    def _empty_chunk(self) -> EdgeList:
        """All-masked chunk-bucket buffer: the streamed spelling of an
        edgeless graph (its shape keeps the cached programs applicable)."""
        cb = self._live.stream.chunk_bucket
        z = torch.zeros(cb, dtype=INT, device=self.device)
        return EdgeList(z, z, torch.zeros(cb, dtype=torch.bool,
                                          device=self.device),
                        self._live.n_bucket)

    def _replay_state(self, name: str) -> tuple:
        """Rebuild ``name``'s live state by replaying the spill ring's
        surviving chunks (tombstone, then replay). Replay chunks carry the
        ingest ``chunk_bucket``, so this reuses the cached programs."""
        live = self._live
        state = None
        for chunk in live.stream.replay():
            state = self._fold_into(name, state, chunk)
            live.stream.folds += 1
        if state is None:  # empty ring: certify the edgeless world
            state = self._fold_into(name, None, self._empty_chunk())
            live.stream.folds += 1
        return state

    # ---------------------------------------------------------- memory gauges
    def _account_live_bytes(self) -> int:
        """Device bytes of the live state — certificate states plus the
        edge buffer (the full one, or one streamed chunk) — published to
        the ``mem/live_bytes`` and ``mem/peak_live_bytes`` gauges. Called
        at load and at every chunk-fold and churn boundary (the peak resets
        on ``load``/``load_stream``)."""
        live = self._live
        if live is None:
            return 0
        total = 0
        for state in live.certs.values():
            if state is None:
                continue
            for x in state:
                total += x.numel() * x.element_size()
        if live.full is not None:
            for x in live.full:
                total += x.numel() * x.element_size()
        else:
            total += live.stream.device_chunk_bytes
        m = get_metrics()
        m.gauge("mem/live_bytes").set(total)
        if total > self._peak_live_bytes:
            self._peak_live_bytes = total
        m.gauge("mem/peak_live_bytes").set(self._peak_live_bytes)
        return total

    @property
    def live_bytes(self) -> int:
        """Current device bytes of the live state."""
        return self._account_live_bytes()

    @property
    def peak_live_bytes(self) -> int:
        """High-water ``live_bytes`` since the last ``load`` or
        ``load_stream``."""
        self._account_live_bytes()
        return self._peak_live_bytes

    def _require_live(self) -> LiveState:
        if self._live is None:
            raise RuntimeError("no live graph: call load() first")
        return self._live

    @property
    def num_live_edges(self) -> int:
        """Edge count of the live primary certificate — the eager 2-edge
        pair (<= 2(n-1), Lemma 1)."""
        self._require_live()
        return int(self._materialize(primary_certificate())[2].sum())

    @property
    def num_live_graph_edges(self) -> int:
        """Edge count of the live FULL graph (inserts minus deletions),
        tracked on the host — no device sync."""
        return self._require_live().count

    @property
    def live_rebuilds(self) -> dict:
        """Per-certificate rebuild counts caused by certificate-hit
        deletions, one entry per MATERIALIZED certificate (e.g.
        ``{'2ec': 0, 'sfs': 1}``)."""
        return dict(self._require_live().rebuilds)

    def insert_edges(self, src, dst, *, final: str = "device",
                     kind: str = "bridges", certificate: str | None = None):
        """Fold an edge delta into the live certificates and return the
        updated analysis for ANY registry kind (``current_analysis``).

        The delta folds into every MATERIALIZED certificate state through
        its registered ``fold_state`` program: the 2-edge pair's warm-start
        labels scan only the delta buffer, the rescan certificates (sfs,
        hybrid) re-certify the bounded cert ∪ delta union. The delta is
        also compact-appended into the resident full buffer, whose output
        bucket is chosen on the host from the tracked edge count. On a
        streamed live graph an insert IS an ingest (``ingest_chunk``).
        """
        kind = normalize_kind(kind)
        live = self._require_live()
        if live.full is None:
            return self.ingest_chunk(src, dst, final=final, kind=kind,
                                     certificate=certificate)
        n_bucket = live.n_bucket
        tr = get_tracer()
        with tr.span("engine/insert_edges", kind=kind):
            src = np.asarray(src, np.int32)
            dst = np.asarray(dst, np.int32)
            delta_cap = self._bucket(max(len(src), 1))
            recv = EdgeList.from_arrays(src, dst, n_bucket,
                                        capacity=delta_cap,
                                        device=self.device)
            for name, state in live.certs.items():
                if state is None:
                    continue
                key = ("cert_insert", name, n_bucket, delta_cap,
                       self.backend, None)
                fn = self._program(
                    key, lambda name=name: build_cert_insert_program(
                        name, n_bucket, self.stats.count_trace))
                with tr.span(f"stage/merge/{name}", delta=delta_cap) as sp:
                    live.certs[name] = tuple(sp.sync(
                        fn(*state, recv.src, recv.dst, recv.mask)))
            fs, fd, fm = live.full
            needed = live.count + len(src)
            out_cap = (fs.shape[0] if needed <= fs.shape[0]
                       else admission_capacity(needed, self.min_bucket))
            akey = ("append", n_bucket, fs.shape[0], delta_cap, out_cap,
                    self.backend)
            afn = self._program(
                akey, lambda: build_append_program(n_bucket, out_cap,
                                                   self.stats.count_trace))
            with tr.span("stage/append") as sp:
                live.full = tuple(sp.sync(
                    afn(fs, fd, fm, recv.src, recv.dst, recv.mask)))
            live.count = needed
            self._after_write()
            return self.current_analysis(kind=kind, final=final,
                                         certificate=certificate)

    def delete_edges(self, src, dst, *, final: str = "device",
                     kind: str = "bridges", certificate: str | None = None):
        """Serve edge DELETIONS (link failures) from the live state and
        return the updated analysis for ANY registry kind.

        Each ``(src[i], dst[i])`` names a link by unordered endpoint pair;
        every live copy of a matched pair dies.

        1. **Tombstone** the live full buffer: one cached program per
           (buffer bucket, key bucket) masks the matches out; the buffer
           keeps its shape.
        2. **Certificate-hit rule**, over the MATERIALIZED certificates:
           probe each live pair with the same tombstone program. A
           certificate whose edges all survive is still a certificate of
           the smaller graph (deleting a non-forest edge disconnects
           nothing the forests connect), so serving continues warm; one
           that lost an edge is rebuilt from the surviving full buffer
           through its cached ``load_state`` program, and
           ``live_rebuilds`` counts it.

        On a streamed live graph the host spill ring is tombstoned instead
        of the full buffer, and a hit certificate is rebuilt by ring replay.

        The removed count and each certificate's hit count are the only
        host syncs of the delete path: one scalar readback per probed
        buffer.
        """
        analysis = get_analysis(kind)
        kind = analysis.kind
        if not analysis.decremental:
            raise NotImplementedError(
                f"kind {kind!r} is not registered as decremental")
        if self.mesh is not None:
            raise NotImplementedError(
                "live deletions are single-device; use mesh=None (one-shot "
                "distributed deletion: analyze(..., delete=...))")
        live = self._require_live()
        n_bucket = live.n_bucket
        with get_tracer().span("engine/delete_edges", kind=kind,
                               streamed=live.full is None):
            src = np.asarray(src, np.int32)
            dst = np.asarray(dst, np.int32)
            kcap = self._bucket(max(len(src), 1))
            keys = EdgeList.from_arrays(src, dst, n_bucket, capacity=kcap,
                                        device=self.device)
            if live.full is None:
                live.stream.tombstone(src, dst)
                live.count = live.stream.count
            else:
                fs, fd, fm = live.full
                fm, removed = self._delete_pass((fs, fd, fm), keys, "full")
                live.full = (fs, fd, fm)
                live.count -= int(removed)
            for name, state in live.certs.items():
                if state is None:
                    continue
                _, hits = self._delete_pass(state[:3], keys, name)
                if int(hits):
                    live.rebuilds[name] += 1
                    live.certs[name] = (
                        self._replay_state(name) if live.full is None
                        else self._cert_load(name, n_bucket, live.full))
            self._account_live_bytes()
            self._after_write()
            return self.current_analysis(kind=kind, final=final,
                                         certificate=certificate)

    def current_analysis(self, kind: str = "bridges", *,
                         final: str = "device",
                         certificate: str | None = None):
        """Analysis of the live graph (final stage only; no certificate
        recomputation), off the live state of the certificate the kind
        resolves to — its declared default, or any registered override that
        preserves what the kind needs (``certificate='hybrid'`` for
        cuts/bcc). The resolved certificate is materialized from the live
        full buffer, or by ring replay, on first use.
        """
        analysis = get_analysis(kind)
        kind = analysis.kind
        live = self._require_live()
        tr = get_tracer()
        with tr.span(f"engine/current/{kind}", final=final):
            cert = self._materialize(
                self._resolve_certificate(analysis, certificate))[:3]
            if final == "host":
                with tr.span("stage/convert"):
                    return analysis.host_fn(*masked_arrays(cert),
                                            live.n_nodes)
            key = ("final", kind, live.n_bucket, self.backend, None)
            fn = self._program(
                key, lambda: build_final_program(live.n_bucket, kind,
                                                 self.stats.count_trace))
            with tr.span(f"stage/final/{kind}") as sp:
                out = sp.sync(fn(*cert))
            with tr.span("stage/convert"):
                return analysis.to_result(out, live.n_nodes)

    def current_bridges(self, *,
                        final: str = "device") -> set[tuple[int, int]]:
        """Bridges of the live graph (final stage only)."""
        return self.current_analysis("bridges", final=final)

    # ------------------------------------------------------------- distributed
    def _analyze_distributed(self, src, dst, n_nodes: int, *, kind: str,
                             final: str, seed: int, delete=None,
                             certificate: str | None = None):
        """This rank's part of the distributed pipeline: partition with
        ``seed``, pad the shard capacity (not ``n_nodes``: the distributed
        path runs at the graph's own n) to its power-of-two bucket, run the
        cached program on this rank's row, convert machine 0's result."""
        analysis = get_analysis(kind)
        cert_name = self._resolve_certificate(analysis, certificate)
        tr = get_tracer()
        with tr.span(f"engine/analyze/{kind}", substrate="distributed",
                     schedule=self.schedule, final=final):
            mg = machine_group(self.mesh, self.machine_axes)
            with tr.span("stage/partition", machines=mg.size):
                psrc, pdst, pmask = partition_edges(
                    np.asarray(src, np.int32), np.asarray(dst, np.int32),
                    n_nodes, mg.size, seed=seed)
                shard_cap = self._bucket(psrc.shape[1])
                pad = shard_cap - psrc.shape[1]
                args = tuple(torch.tensor(np.pad(a[mg.index], (0, pad)),
                                          device=self.device)
                             for a in (psrc, pdst, pmask))
                kcap = None
                if delete is not None:
                    # deletion keys are global: replicated on every
                    # machine, each tombstones its own shard first
                    kel, kcap = self._delete_keys(delete, n_nodes)
                    args += (kel.src, kel.dst, kel.mask)
            key = ("dist", kind, n_nodes, shard_cap, kcap, self.backend,
                   self.schedule, final, self.merge, cert_name)
            fn = self._program(
                key, lambda: build_distributed_program(
                    self.mesh, self.machine_axes, n_nodes, kind, final,
                    self.schedule, self.merge, with_delete=kcap is not None,
                    certificate=cert_name))
            with tr.span(f"stage/pipeline/{kind}", substrate="distributed",
                         schedule=self.schedule, machines=mg.size,
                         certificate=cert_name) as sp:
                out = sp.sync(result_shard_zero(fn(*args), self.mesh,
                                                self.machine_axes))
            with tr.span("stage/convert"):
                # machine 0 (paper) — or any machine under xor/hierarchical
                # — answers
                if final == "host":
                    return analysis.host_fn(*masked_arrays(out), n_nodes)
                return analysis.to_result(out, n_nodes)


def _out_of_bucket(src: np.ndarray, dst: np.ndarray, n_bucket: int) -> bool:
    """Whether an edge of the host arrays names a vertex outside
    ``[0, n_bucket)``."""
    return bool(len(src)) and (min(src.min(), dst.min()) < 0
                               or max(src.max(), dst.max()) >= n_bucket)


#: the default single-device engine of each device
_DEFAULT_ENGINES: dict[torch.device, BridgeEngine] = {}


def get_default_engine(device=None) -> BridgeEngine:
    """Process-wide single-device engine of ``device`` (the card unless
    named) behind ``repro_torch.find_bridges`` and ``analyze``."""
    dev = resolve_device(device)
    eng = _DEFAULT_ENGINES.get(dev)
    if eng is None:
        eng = _DEFAULT_ENGINES[dev] = BridgeEngine(device=dev)
    return eng


def find_bridges_batch(graphs, n_nodes, *, final: str = "device",
                       engine: BridgeEngine | None = None, device=None):
    """Module-level batched entry point over the default engine."""
    eng = engine if engine is not None else get_default_engine(device)
    return eng.find_bridges_batch(graphs, n_nodes, final=final)


def analyze_batch(graphs, n_nodes, *, kind: str = "bridges",
                  engine: BridgeEngine | None = None, device=None):
    """Module-level batched analysis (any kind) over the default engine."""
    eng = engine if engine is not None else get_default_engine(device)
    return eng.analyze_batch(graphs, n_nodes, kind=kind)
