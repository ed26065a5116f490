"""Port parity of the continuous-batching scheduler
(``repro_torch.engine.scheduler``) against ``repro.engine.scheduler`` (JAX
on the CPU), mirroring ``tests/test_scheduler.py``: the same submissions
through both packages give every ticket the same answer and fields
(``seq``, ``bucket``, ``op``, ``kind``, ``tenant``), the same
``SchedStats``, the same ``snapshot()`` counters and the same span names;
and ``benchmarks/fig10_serving.py``'s smoke script gives the counters
pinned in ``BENCH_baseline_fig10.json`` in both.

Tolerance: exact equality (answers, buffers and counters are integers,
booleans or sets of them). Latencies and clocks are never compared. One
engine pair serves the file (n in (32, 64] -> bucket 64, E -> bucket 512),
so the JAX side builds each program once; every row stays inside its
bucket, where the two packages build the same programs (a row outside its
bucket builds one more program in the port: its own test checks answers
only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as j_obs
from repro.engine import BridgeEngine as JaxEngine
from repro.engine import BridgeScheduler as JaxScheduler
from repro.graph import generators as gen
from repro.obs import MetricsRegistry as JaxMetrics
from repro_torch import obs
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.engine import BridgeEngine, BridgeScheduler, SchedStats, Ticket
from repro_torch.engine.scheduler import READ_OPS, WRITE_OPS
from repro_torch.obs import MetricsRegistry, get_metrics

from torch_engine_pair import EnginePair, same

N_A, N_B, E_N = 50, 60, 400

PAIR = EnginePair()  # one pair: each JAX program compiles once


def graph(seed, n=N_A, e=E_N):
    src, dst, _ = gen.planted_bridge_graph(n, e, n_bridges=3, seed=seed)
    return src, dst


class SchedulerPair:
    """A scheduler on each engine of an ``EnginePair``, each with a fresh
    metrics registry; ``submit`` queues on both, ``drain``/``drain_all``
    drain both and hold every served ticket, the stats and the engines'
    live state and counters equal."""

    def __init__(self, pair=PAIR, **kw):
        self.pair = pair
        self.jax = JaxScheduler(pair.jax, metrics=JaxMetrics(), **kw)
        self.torch = BridgeScheduler(pair.torch, metrics=MetricsRegistry(),
                                     **kw)
        self.tickets: list[tuple] = []

    def submit(self, *args, **kw):
        pair = (self.jax.submit(*args, **kw), self.torch.submit(*args, **kw))
        self.tickets.append(pair)
        return pair

    def _step(self, method: str) -> int:
        want = getattr(self.jax, method)()
        got = getattr(self.torch, method)()
        assert got == want
        self.check()
        return got

    def drain(self) -> int:
        return self._step("drain")

    def drain_all(self) -> int:
        return self._step("drain_all")

    def check(self) -> None:
        for jt, tt in self.tickets:
            for key in ("tenant", "op", "kind", "bucket", "seq", "done"):
                assert getattr(tt, key) == getattr(jt, key), key
            if jt.done:
                assert (tt._error is None) == (jt._error is None)
                if jt._error is None:
                    assert same(tt.result(), jt.result()), tt.seq
                else:
                    assert type(tt._error) is type(jt._error)
        assert self.torch.stats.snapshot() == self.jax.stats.snapshot()
        assert self.torch.pending == self.jax.pending
        assert self.torch.tenants() == self.jax.tenants()
        self.pair.check_state()


def test_exports_and_ops_match_reference():
    from repro.engine import scheduler as js

    assert (READ_OPS, WRITE_OPS) == (js.READ_OPS, js.WRITE_OPS)
    assert BridgeScheduler.__name__ == "BridgeScheduler"
    assert Ticket.__dataclass_fields__.keys() == \
        js.Ticket.__dataclass_fields__.keys()
    assert SchedStats().snapshot() == js.SchedStats().snapshot()


def test_ragged_coalescing_matches_reference():
    """Mixed live-edge counts and mixed n in ONE admission bucket: one
    coalesced dispatch in both packages, the same answers."""
    sp = SchedulerPair(max_batch=8)
    cases = [(*graph(s, n=N_A if s % 2 else N_B, e=260 + 6 * s),
              N_A if s % 2 else N_B) for s in range(7)]
    pairs = [sp.submit(f"t{i % 3}", s, d, n)
             for i, (s, d, n) in enumerate(cases)]
    assert len({t.bucket for _, t in pairs}) == 1
    assert sp.drain_all() == 7
    for (_, t), (s, d, n) in zip(pairs, cases):
        assert t.result() == bridges_dfs(s, d, n)
        assert t.latency_s > 0
    st = sp.torch.stats
    assert (st.dispatches, st.coalesced, st.padded_slots) == (1, 7, 1)


@pytest.mark.parametrize("kind,final", [("bridges", "host"),
                                        ("cuts", "device"),
                                        ("2ecc", "device"),
                                        ("bcc", "host")])
def test_kinds_and_finals_coalesce_alike(kind, final):
    """Every read's (kind, final) is part of its admission bucket: two
    kinds in one queue make two dispatches, in admission order."""
    sp = SchedulerPair(max_batch=4)
    for i in range(3):
        sp.submit(f"t{i}", *graph(30 + i), N_A, kind=kind, final=final)
    sp.submit("t9", *graph(40), N_A)
    assert sp.drain() == 4
    assert sp.torch.stats.dispatches == 2


def test_no_new_program_across_varying_occupancy():
    """After warming the power-of-two batch buckets, drains of any
    occupancy reuse the built programs in both packages."""
    sp = SchedulerPair(max_batch=8)
    b = 1
    while b <= 8:
        for _ in range(b):
            sp.submit("warm", *graph(0), N_A)
        sp.drain_all()
        b *= 2
    warm = (PAIR.torch.stats.traces, PAIR.torch.stats.misses)
    for wave in (3, 5, 8, 1):
        for i in range(wave):
            sp.submit(f"t{i}", *graph(10 + i), N_A)
        assert sp.drain() == wave
    assert (PAIR.torch.stats.traces, PAIR.torch.stats.misses) == warm


def test_writes_interleave_with_reads():
    """Reads coalesce, queued churn lands between read waves in submission
    order, and the live answer equals a host recompute of the same edge
    history, in both packages."""
    sp = SchedulerPair(max_batch=4)
    src, dst = graph(1)
    PAIR.call("load", src, dst, N_A)
    ins, ind = gen.random_graph(N_A, 16, seed=7)
    sp.submit("reader", *graph(2), N_A)
    sp.submit("churner", ins, ind, op="insert_edges")
    sp.submit("churner", src[:8], dst[:8], op="delete_edges",
              kind="cuts", final="host")
    assert sp.drain() == 3
    keys = {(min(a, b), max(a, b)) for a, b in zip(src[:8], dst[:8])}
    ss, dd = np.concatenate([src, ins]), np.concatenate([dst, ind])
    keep = [(min(a, b), max(a, b)) not in keys for a, b in zip(ss, dd)]
    assert PAIR.call("current_bridges") == bridges_dfs(ss[keep], dd[keep],
                                                       N_A)
    assert sp.torch.stats.writes == 2


def test_ingest_chunk_through_the_scheduler_on_a_streamed_engine():
    """``op='ingest_chunk'`` (and an insert, which on a streamed graph IS
    an ingest) on a streamed engine: chunk folds between read waves, the
    same answers, rings and counters; the checkpoint clock counts each
    ingest once."""
    pair = EnginePair()
    sp = SchedulerPair(pair, max_batch=2)
    src, dst = graph(3)
    pair.call("load_stream", src[:200], dst[:200], N_A, chunk_edges=128)
    sp.submit("r", *graph(4), N_A)
    sp.submit("w", src[200:], dst[200:], op="ingest_chunk")
    sp.submit("w", *gen.random_graph(N_A, 20, seed=5), op="insert_edges",
              kind="cuts")
    sp.submit("w", src[:4], dst[:4], op="delete_edges")
    assert sp.drain_all() == 4
    # load_stream's ingest, the ingest, the insert (an ingest) and the
    # deletion
    assert pair.torch._write_ops == 4
    assert pair.call("current_bridges") == pair.jax.current_bridges()


def test_engine_surface_and_snapshot_rollup():
    """``engine.submit``/``drain`` go through a lazily built scheduler
    whose rollup rides ``engine.snapshot()``, as in the reference."""
    eng = BridgeEngine(device="cpu")
    assert eng._scheduler is None and "scheduler" not in eng.snapshot()
    t = eng.submit("a", *graph(3), N_A)
    assert eng.drain_all() == 1 and eng.drain() == 0
    assert t.result() == bridges_dfs(*graph(3), N_A)
    snap = eng.snapshot()["scheduler"]
    assert snap["completed"] == 1 and snap["pending"] == 0
    assert snap["tenants"]["a"]["completed"] == 1
    assert isinstance(eng.scheduler, BridgeScheduler)


def test_metrics_and_watchdog_heartbeat():
    """Queue depth, occupancy, per-tenant histograms and counters in the
    scheduler's registry, equal to the reference's; every non-empty drain
    beats ``sched/step_s`` in the global registry, an empty one does not."""
    beat = get_metrics().gauge("sched/step_s")
    before = beat.updated_at
    sp = SchedulerPair(max_batch=8)
    for i in range(3):
        sp.submit("t0" if i else "t1", *graph(i), N_A)
    regs = (sp.jax.metrics, sp.torch.metrics)
    for m in regs:
        assert m.gauge("sched/queue_depth").value == 3
    assert sp.drain_all() == 3
    for m in regs:
        assert m.gauge("sched/queue_depth").value == 0
        assert m.gauge("sched/batch_occupancy").value == 3 / 4
        assert m.histogram("sched/tenant/t0/latency_s").count == 2
        assert m.counter("sched/tenant/t1/completed").snapshot() == 1
    assert sorted(sp.torch.metrics.names()) == sorted(sp.jax.metrics.names())
    assert beat.updated_at is not None and beat.updated_at != before
    stamped = beat.updated_at
    assert sp.drain() == 0
    assert beat.updated_at == stamped
    js, ts = sp.jax.snapshot(), sp.torch.snapshot()
    assert {k: v for k, v in ts.items() if k != "tenants"} == \
        {k: v for k, v in js.items() if k != "tenants"}
    assert {t: v["completed"] for t, v in ts["tenants"].items()} == \
        {t: v["completed"] for t, v in js["tenants"].items()}


def test_monitor_beats_once_per_drain():
    """``monitor=``/``machine=``: each non-empty drain beats the fleet
    monitor under the scheduler's machine id."""
    from repro_torch.runtime import HeartbeatMonitor

    mon = HeartbeatMonitor(machines=("m0",), name="tsched_fleet")
    sched = BridgeScheduler(BridgeEngine(device="cpu"),
                            metrics=MetricsRegistry(),
                            monitor=mon, machine="m0")
    assert mon.last["m0"] is None
    sched.submit("t", *graph(5), N_A)
    sched.drain_all()
    assert mon.last["m0"] is not None


def test_ticket_errors_are_isolated():
    """A failing request fails only its own ticket, with the reference's
    error type; the others in the same drain complete."""
    sp = SchedulerPair(EnginePair())
    bad_j, bad_t = sp.submit("w", *gen.random_graph(N_A, 8, seed=0),
                             op="insert_edges")  # no live graph loaded
    sp.submit("r", *graph(4), N_A)
    with pytest.raises(RuntimeError, match="still"):
        bad_t.result()
    sp.drain_all()
    with pytest.raises(RuntimeError, match="load"):
        bad_t.result()
    assert sp.torch.stats.failed == 1 and sp.torch.stats.completed == 2
    assert sp.pair.torch._write_ops == 0  # a refused write does not count


def test_submit_validates_ops():
    sched = BridgeScheduler(PAIR.torch, metrics=MetricsRegistry())
    with pytest.raises(ValueError, match="unknown op"):
        sched.submit("t", *graph(0), N_A, op="compact")
    with pytest.raises(ValueError, match="n_nodes"):
        sched.submit("t", *graph(0))
    with pytest.raises(ValueError, match="max_batch"):
        BridgeScheduler(PAIR.torch, max_batch=0)


def test_row_outside_its_bucket_answers_like_the_reference():
    """A read naming a vertex outside its bucket: the port answers that
    row through the one-graph program (one more program than the
    reference builds, by design), the answers equal."""
    jax_sched = JaxScheduler(JaxEngine(), metrics=JaxMetrics())
    sched = BridgeScheduler(BridgeEngine(device="cpu"),
                            metrics=MetricsRegistry())
    rows = [([0, 1, 16], [1, 2, 3]), ([0, 1, 2], [1, 2, 3])]
    tickets = [(jax_sched.submit("t", s, d, 16), sched.submit("t", s, d, 16))
               for s, d in rows]
    jax_sched.drain_all()
    sched.drain_all()
    for jt, tt in tickets:
        assert tt.result() == jt.result()
    assert sched.stats.snapshot() == jax_sched.stats.snapshot()


def test_scheduler_spans_match_reference():
    """The scheduler's spans and the engine calls inside them, with their
    depths and attributes, equal under both tracers (the stage spans below
    them differ by design: the port's union pass has its own stages)."""
    sp = SchedulerPair(max_batch=4)
    PAIR.call("load", *graph(6), N_A)
    jtr, ttr = j_obs.enable_tracing(), obs.enable_tracing()
    try:
        for i in range(3):
            sp.submit(f"t{i}", *graph(20 + i), N_A)
        sp.submit("w", *gen.random_graph(N_A, 16, seed=8), op="insert_edges")
        sp.drain_all()
    finally:
        j_obs.disable_tracing()
        obs.disable_tracing()

    def containers(tr):
        return [(x["name"], x["depth"], x["attrs"]) for x in tr.spans()
                if x["name"].startswith(("sched/", "engine/"))]

    got = containers(ttr)
    assert got == containers(jtr)
    assert {"sched/drain", "sched/dispatch/bridges",
            "sched/write/insert_edges"} <= {name for name, _, _ in got}


# ---------------------------------------------- fig10's submission script
#: ``BENCH_baseline_fig10.json``'s pinned scheduler counters
FIG10_PINNED = {"dispatches": 12, "coalesced": 59, "padded_slots": 5,
                "writes": 4, "occupancy_x100": 492}


def fig10_script(engine, sched, v=96, e=800, tenants=4, per_tenant=6,
                 n_keys=16):
    """``benchmarks/fig10_serving.py``'s fixed submission script at its
    smoke size, minus the clocks: the power-of-two warmup, the sequential
    loop, everything submitted then drained, the ragged waves 5, 3, 1, 7
    and a churn turn of ``tenants`` reads and 4 writes. Returns every
    answer in order, the counters and the programs built after warmup."""
    def query(seed):
        n = v - (seed % 7)
        src, dst, _ = gen.planted_bridge_graph(n, e, n_bridges=3, seed=seed)
        return src, dst, n

    total = tenants * per_tenant
    requests = [(f"t{i % tenants}", *query(i)) for i in range(total)]
    _, s0, d0, n0 = requests[0]
    answers = [engine.analyze(s0, d0, n0)]
    b = 1
    while b <= 8:
        tickets = [sched.submit("_warm", s0, d0, n0) for _ in range(b)]
        sched.drain_all()
        answers += [t.result() for t in tickets]
        b *= 2
    engine.load(s0, d0, n0)
    deltas = [gen.random_graph(n0, n_keys, seed=1000 + k) for k in range(8)]
    answers.append(engine.insert_edges(*deltas[0]))
    answers.append(engine.delete_edges(s0[:n_keys], d0[:n_keys]))
    warm = engine.stats.traces
    answers += [engine.analyze(s, d, n) for _, s, d, n in requests]
    tickets = [sched.submit(t, s, d, n) for t, s, d, n in requests]
    sched.drain_all()
    ragged = iter(requests)
    for wave in (5, 3, 1, 7):
        tickets += [sched.submit(t, s, d, n)
                    for t, s, d, n in (next(ragged) for _ in range(wave))]
        sched.drain()
    tickets += [sched.submit(t, s, d, n) for t, s, d, n in requests[:tenants]]
    for k in range(4):
        if k % 2 == 0:
            tickets.append(sched.submit("t0", *deltas[1 + k // 2],
                                        op="insert_edges"))
        else:
            ds, dd = deltas[5 + k // 2]
            tickets.append(sched.submit("t0", ds[:n_keys], dd[:n_keys],
                                        op="delete_edges"))
    sched.drain_all()
    answers += [t.result() for t in tickets]
    st = sched.stats
    counters = {"dispatches": st.dispatches, "coalesced": st.coalesced,
                "padded_slots": st.padded_slots, "writes": st.writes,
                "occupancy_x100": round(100 * st.occupancy)}
    return answers, counters, engine.stats.traces - warm, requests


def test_fig10_script_gives_the_pinned_counters_in_both_packages():
    jax_engine, engine = JaxEngine(), BridgeEngine(device="cpu")
    want, jc, jretraces, requests = fig10_script(
        jax_engine, JaxScheduler(jax_engine, metrics=JaxMetrics()))
    got, tc, retraces, _ = fig10_script(
        engine, BridgeScheduler(engine, metrics=MetricsRegistry()))
    assert same(got, want)
    assert tc == jc == FIG10_PINNED
    assert retraces == jretraces == 0
    assert engine.cache_info() == jax_engine.cache_info()
    assert engine.cache_info()["programs"] == 11  # the baseline's count
    # the sequential loop's answers: after the one-shot, the 15 warmup
    # tickets and the live insert and deletion
    for (_, s, d, n), ans in zip(requests, got[18:18 + len(requests)]):
        assert ans == bridges_dfs(s, d, n)
