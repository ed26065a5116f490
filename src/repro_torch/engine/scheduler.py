"""Continuous-batching scheduler: the multi-tenant request path
(``repro.engine.scheduler``).

Tenants ``submit`` tenant-tagged requests into a queue and a ``drain`` loop
turns the queue into the fewest engine dispatches. Three rules:

* **Admission by shape bucket.** A read is admitted under the power-of-two
  ``(n_bucket, capacity_bucket)`` shape bucket of its graph
  (``dispatch.admission_bucket``: the bucket components of the
  ``ProgramCache`` key), plus its (kind, final, certificate) program
  coordinates. Two requests in the same bucket share one built program,
  so admission never builds a new program beyond the first touch of a
  bucket, which warmup pays once.

* **Coalesced dispatch.** Each drain takes up to ``max_batch`` same-bucket
  reads per bucket queue — FIFO, so no tenant starves — and resolves them
  in ONE ``analyze_batch`` disjoint-union pass, padding the short batch up
  to the power-of-two batch bucket (masked-off rows). The batch pad bounds
  the program count at log2(max_batch)+1 per shape bucket. ``SchedStats``
  counts dispatches, coalesced queries and padded slots; batch occupancy
  (queries per dispatch) is what explains the throughput over the
  sequential loop.

* **Writes between read waves.** ``insert_edges`` / ``delete_edges`` /
  ``ingest_chunk`` requests (churn against the engine's live graph) run
  BETWEEN read waves, in submission order: each drain serves one read
  wave, then applies every queued write. Deletions ride the
  certificate-hit rule, so the live state stays warm and resident; writes
  never make the reads' programs rebuild (their buffers are bucketed
  independently).

Observability: every drain runs under a ``sched/drain`` span with
``sched/dispatch/<kind>`` / ``sched/write/<op>`` children (container spans
like ``engine/*``: the engine's ``stage/*`` spans inside them carry the
cost); queue depth and batch occupancy land in gauges, per-tenant latency
in histograms and completion counters, all through ``MetricsRegistry``.
Each non-empty drain also heartbeats a ``StepWatchdog`` (gauge
``sched/step_s``): a wedged drain shows up as ``last_beat`` staleness and
a straggling one ticks the straggle counter.

Single-threaded by design: ``submit`` and ``drain`` are called from one
thread, and fairness comes from FIFO admission and bounded per-bucket
waves rather than from preemption.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch.engine.batched import normalize_kind
from repro_torch.engine.dispatch import admission_bucket
from repro_torch.engine.state import SchedStats
from repro_torch.graph.datastructs import admission_capacity
from repro_torch.obs import MetricsRegistry, get_metrics, get_tracer
from repro_torch.runtime.watchdog import StepWatchdog

__all__ = ["BridgeScheduler", "Ticket"]

#: request operations: one read (coalescable) + the live-state writes
#: (``ingest_chunk`` is the streamed-mode insert — chunked edge arrivals
#: admitted between read waves like any other write)
READ_OPS = ("analyze",)
WRITE_OPS = ("insert_edges", "delete_edges", "ingest_chunk")


@dataclasses.dataclass
class Ticket:
    """One submitted request: the tenant-tagged unit of scheduling.

    The scheduler fills ``result``/``error`` when a drain serves the
    ticket; ``result()`` is the caller's accessor (raises the captured
    error, or ``RuntimeError`` while still queued). ``t_submit``/
    ``t_done`` are ``time.perf_counter`` stamps — their difference is the
    queueing+service latency the per-tenant histograms record.
    """

    tenant: str
    op: str
    kind: str
    bucket: tuple
    seq: int
    t_submit: float
    t_done: float | None = None
    done: bool = False
    _result: Any = None
    _error: Exception | None = None

    def result(self):
        if not self.done:
            raise RuntimeError(
                f"request #{self.seq} ({self.tenant}/{self.op}) still "
                f"queued: drain the scheduler first")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclasses.dataclass
class _Pending:
    """A ticket plus its payload (kept off the Ticket so results don't
    pin request buffers alive)."""

    ticket: Ticket
    src: Any
    dst: Any
    n_nodes: int | None
    final: str
    certificate: str | None


class BridgeScheduler:
    """Continuous-batching request path over one ``BridgeEngine``.

    ``metrics`` defaults to the process-global registry (so serving
    dashboards read one ``obs.snapshot()``); pass a fresh
    ``MetricsRegistry`` for isolation (tests, benchmarks). ``max_batch``
    caps the coalescing window per bucket per drain — with pow-2 batch
    padding it bounds the batched-program variants at
    ``log2(max_batch) + 1`` per shape bucket.
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 metrics: MetricsRegistry | None = None,
                 straggle_threshold: float = 20.0, name: str = "sched",
                 monitor=None, machine=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.metrics = metrics if metrics is not None else get_metrics()
        self.stats = SchedStats()
        #: per-bucket FIFO read queues, keyed by the admission bucket
        self._reads: dict[tuple, list[_Pending]] = {}
        #: FIFO write queue (order is live-state semantics, never reordered)
        self._writes: list[_Pending] = []
        self._seq = 0
        self._tenants: set[str] = set()
        # the drain-loop heartbeat: gauge <name>/step_s + EWMA + straggle
        # counter in the GLOBAL registry (watchdog metrics are fleet-level
        # by design — runtime/watchdog.py). ``name`` keeps per-engine loops
        # distinct when several schedulers serve one fleet; ``monitor``/
        # ``machine`` additionally beat a HeartbeatMonitor per non-empty
        # drain, which is how a scheduler's silence marks its machine dead.
        self._watchdog = StepWatchdog(threshold=straggle_threshold,
                                      name=name)
        self._monitor = monitor
        self._machine = machine if machine is not None else name
        self._depth_gauge = self.metrics.gauge("sched/queue_depth")
        self._occ_gauge = self.metrics.gauge("sched/batch_occupancy")

    # ------------------------------------------------------------- admission
    def submit(self, tenant: str, src, dst, n_nodes: int | None = None, *,
               op: str = "analyze", kind: str = "bridges",
               final: str = "device",
               certificate: str | None = None) -> Ticket:
        """Admit one request; returns its ``Ticket`` (resolved by a later
        ``drain``).

        Reads (``op='analyze'``) carry their own graph and are admitted
        under its pow-2 shape bucket — the coalescing key. Writes
        (``op='insert_edges'|'delete_edges'``) target the engine's LIVE
        graph (``engine.load``): ``src``/``dst`` are the delta / failed
        endpoint pairs and ``n_nodes`` is ignored; they queue FIFO and
        run between read waves.
        """
        if op not in READ_OPS + WRITE_OPS:
            raise ValueError(f"unknown op {op!r}; choose from "
                             f"{READ_OPS + WRITE_OPS}")
        kind = normalize_kind(kind)
        if op in READ_OPS:
            if n_nodes is None:
                raise ValueError("op='analyze' requires n_nodes")
            n_bucket, cap = admission_bucket(int(n_nodes), len(src),
                                             self.engine.min_bucket)
            bucket = (kind, final, certificate, n_bucket, cap)
        else:
            # writes are keyed to the live graph, not a request shape;
            # their delta buffers bucket independently inside the engine
            bucket = ("write", op, kind)
        t = Ticket(tenant=str(tenant), op=op, kind=kind, bucket=bucket,
                   seq=self._seq, t_submit=time.perf_counter())
        self._seq += 1
        p = _Pending(t, src, dst,
                     None if n_nodes is None else int(n_nodes),
                     final, certificate)
        if op in READ_OPS:
            self._reads.setdefault(bucket, []).append(p)
        else:
            self._writes.append(p)
        self._tenants.add(t.tenant)
        self.stats.submitted += 1
        self._depth_gauge.set(self.pending)
        return t

    @property
    def pending(self) -> int:
        """Queued (not yet served) request count."""
        return sum(len(q) for q in self._reads.values()) + len(self._writes)

    def tenants(self) -> tuple[str, ...]:
        return tuple(sorted(self._tenants))

    # --------------------------------------------------------------- serving
    def _finish(self, p: _Pending, result=None, error=None) -> None:
        t = p.ticket
        t._result, t._error = result, error
        t.done = True
        t.t_done = time.perf_counter()
        self.stats.completed += 1
        if error is not None:
            self.stats.failed += 1
        self.metrics.histogram(
            f"sched/tenant/{t.tenant}/latency_s").observe(t.latency_s)
        self.metrics.counter(f"sched/tenant/{t.tenant}/completed").inc()

    def _dispatch_reads(self, bucket: tuple, chunk: list[_Pending],
                        tr) -> None:
        """ONE coalesced union-pass dispatch for a same-bucket chunk."""
        kind, final, certificate = bucket[0], bucket[1], bucket[2]
        b_bucket = admission_capacity(len(chunk), 1)
        self.stats.dispatches += 1
        self.stats.coalesced += len(chunk)
        self.stats.padded_slots += b_bucket - len(chunk)
        with tr.span(f"sched/dispatch/{kind}", batch=len(chunk),
                     batch_bucket=b_bucket, bucket=str(bucket[3:])):
            try:
                results = self.engine.analyze_batch(
                    [(p.src, p.dst) for p in chunk],
                    [p.n_nodes for p in chunk],
                    kind=kind, final=final, certificate=certificate)
            except Exception as e:  # noqa: BLE001 — per-request fault wall
                for p in chunk:
                    self._finish(p, error=e)
                return
        for p, res in zip(chunk, results):
            self._finish(p, result=res)

    def _apply_writes(self, writes: list[_Pending], tr) -> None:
        """The write turn: queued churn in submission order, each through
        the engine's live-state path (certificate-hit rule keeps warm
        state warm; a failing write fails only its own ticket)."""
        for p in writes:
            fn = getattr(self.engine, p.ticket.op)
            self.stats.writes += 1
            with tr.span(f"sched/write/{p.ticket.op}",
                         kind=p.ticket.kind, tenant=p.ticket.tenant):
                try:
                    res = fn(p.src, p.dst, kind=p.ticket.kind,
                             final=p.final, certificate=p.certificate)
                except Exception as e:  # noqa: BLE001
                    self._finish(p, error=e)
                else:
                    self._finish(p, result=res)

    def drain(self) -> int:
        """One scheduler step: a read wave (one coalesced dispatch per
        non-empty bucket, up to ``max_batch`` requests each) followed by
        the write turn (every queued write). Returns the number of
        requests completed; 0 for an empty queue (no heartbeat — liveness
        is ``last_beat`` staleness, and empty ticks must not drag the
        straggle EWMA toward zero)."""
        if self.pending == 0:
            return 0
        done_before = self.stats.completed
        self._watchdog.start()
        tr = get_tracer()
        with tr.span("sched/drain", step=self.stats.drains,
                     pending=self.pending):
            wave_queries = wave_slots = 0
            # oldest-bucket-first round-robin: list(dict) preserves the
            # insertion order of first admission, FIFO within each queue
            for bucket in list(self._reads):
                queue = self._reads[bucket]
                chunk, self._reads[bucket] = (queue[:self.max_batch],
                                              queue[self.max_batch:])
                if not self._reads[bucket]:
                    del self._reads[bucket]
                if chunk:
                    self._dispatch_reads(bucket, chunk, tr)
                    wave_queries += len(chunk)
                    wave_slots += admission_capacity(len(chunk), 1)
            writes, self._writes = self._writes, []
            if writes:
                self._apply_writes(writes, tr)
            if wave_slots:
                self._occ_gauge.set(wave_queries / wave_slots)
            self._depth_gauge.set(self.pending)
        self.stats.drains += 1
        self._watchdog.stop(self.stats.drains)
        if self._monitor is not None:
            self._monitor.beat(self._machine)
        return self.stats.completed - done_before

    def drain_all(self, max_steps: int = 10_000) -> int:
        """Drain until the queue is empty; returns requests completed."""
        done = 0
        for _ in range(max_steps):
            step = self.drain()
            if step == 0:
                return done
            done += step
        raise RuntimeError(f"queue not empty after {max_steps} drains "
                           f"({self.pending} pending)")

    # ---------------------------------------------------------------- rollup
    def snapshot(self) -> dict:
        """THE scheduler rollup: ``SchedStats`` counters + derived batch
        occupancy + per-tenant {completed, latency percentiles} — the
        dict serving reports consume."""
        snap = self.stats.snapshot()
        snap["pending"] = self.pending
        snap["tenants"] = {
            t: {
                "completed":
                    self.metrics.counter(
                        f"sched/tenant/{t}/completed").snapshot(),
                "latency":
                    self.metrics.histogram(
                        f"sched/tenant/{t}/latency_s").snapshot(),
            }
            for t in self.tenants()
        }
        return snap
