"""Batched connectivity-query serving driver over the BridgeEngine
(``repro.launch.serve_bridges``), on the card unless the caller names
another device.

Simulates heavy query traffic: a stream of independent queries with jittered
graph sizes (all landing in one shape bucket) is grouped into batches of B
and resolved one device dispatch per batch by the compile-once engine.
``--analysis`` picks the query kind(s) — any kind in the analysis registry
(bridges, cuts, 2ecc, bridge-tree, bcc) or ``all`` — and the driver reports
per-kind queries/sec for cold (first batch pays the trace+compile),
steady-state batched, single-query, and incremental serving. Every kind is
served on every substrate now (DESIGN.md §Analysis registry); the report
carries each kind's substrate row — which certificate it merges over and
whether single/batched/incremental/distributed serving applies — so
dashboards can track the substrate matrix. ``--json`` writes the per-kind
rates plus the engine's ``snapshot()`` rollup (programs/hits/misses/
traces/hit_rate — one dict, never re-derived here); each kind's row
also carries ``kernel_path`` — the backend (``cuda`` | ``ref``) the
certificate's fused per-round edge scan resolved to for the served
requests (DESIGN.md §Kernels).

Every request is also timed into fixed-bucket latency HISTOGRAMS — per
kind and per served certificate, one histogram per serving phase — and
the report/JSON carry their p50/p95/p99 (``repro_torch.obs.metrics``; DESIGN.md
§Observability). The warm single-query phase asserts no-retrace from the
engine's ``traces`` counter, and the assertion holds with tracing
enabled: ``--trace-out PATH`` turns on the span tracer for the whole run
and writes the Chrome-trace JSON (open in Perfetto/chrome://tracing)
plus a per-stage rollup; ``--profile-dir DIR`` additionally captures a
``torch.profiler`` trace whose ``record_function`` ranges carry the span
names (``repro_torch.obs.profile``).

``--workload ingest`` is the streaming-ingest drill (DESIGN.md §Streaming
ingest): the same dense world is loaded twice — one-shot (``load``, full
edge buffer resident) and streamed (``load_stream`` + ``ingest_chunk``
arrivals flowing through fixed ``--chunk-edges`` device chunks) — and the
report compares ingest throughput (edges/s), peak live device bytes
(``mem/peak_live_bytes``: the streamed path holds O(chunk + certificate)
instead of O(E)), and asserts bit-identical analyses for every registry
kind plus zero retraces after warmup (chunk buckets are ProgramCache
currency).

``--workload churn`` makes the incremental phase interleave link FAILURES
(``delete_edges``, at ``--delete-ratio``) with the inserts — the paper's
serving story end to end; the report then also carries the deletion count
and per-certificate rebuild counters (most deletions never touch a
certificate and are free, DESIGN.md §Decremental).

``--workload multitenant --tenants N`` is the continuous-batching request
path (DESIGN.md §Serving): N tenants' requests arrive on an open-loop
process (``--arrival-qps``; 0 = all at once, maximum pressure) and the
SAME arrival schedule is served twice — first by the sequential
one-query-at-a-time loop, then through the engine's ``BridgeScheduler``
(shape-bucket admission, coalesced vmapped dispatch, write churn
interleaved between read waves). The report compares aggregate qps and
per-tenant arrival-to-completion p50/p95/p99 at equal offered load,
carries the scheduler rollup (batch occupancy, dispatches, padded slots)
that explains the win, a fairness section (Jain index over per-tenant
throughput + p99 spread), and asserts ZERO retraces after warmup — the
admission bucket is the ``ProgramCache`` currency, so coalescing never
recompiles. With ``--deltas > 0`` the last tenant is churn-heavy
(inserts + link failures against the shared live graph) while the rest
are read-heavy.

``--certificate {2ec,sfs,hybrid,auto}`` picks the certificate preference:
each kind is served from the requested type wherever it preserves what the
kind needs (e.g. ``hybrid`` serves cuts/bcc; bridges falls back to its
declared ``2ec``), and the report/JSON carry per-kind served certificates
plus a per-CERTIFICATE qps + rebuild-counter rollup (DESIGN.md
§Certificate registry).

    PYTHONPATH=src python -m repro_torch.launch.serve_bridges --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_bridges \
        --analysis all --batch 8 --queries 64 --n 512 --edges 8192 \
        --workload churn --delete-ratio 0.3 --json SERVE.json

From Python, ``main([...], device="cpu")`` runs the same driver on the
CPU (the kernels' plain versions); ``main([...])`` runs on the card and
raises without one. ``--workload failover`` builds ``serve_failover``'s
namespace here and runs the drill on the same device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.connectivity.registry import analysis_kinds, get_analysis
from repro_torch.core.certs import certificate_names
from repro_torch.engine import BridgeEngine, BridgeScheduler
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import admission_capacity
from repro_torch.kernels.boruvka_round import kernel_path
from repro_torch.launch.failover import serve_failover
from repro_torch.obs import MetricsRegistry, profiler_trace

#: CLI spellings: canonical kinds, with '-' aliases for the shell
KINDS = tuple(k.replace("_", "-") for k in analysis_kinds())

#: certificate choices: every registered type plus 'auto' (kind defaults)
CERTS = tuple(certificate_names()) + ("auto",)

#: the per-kind serving phases each latency histogram family covers
PHASES = ("batched", "single", "update")


def phase_histograms(metrics: MetricsRegistry, prefix: str,
                     phases=PHASES) -> dict:
    """One latency histogram per serving phase under ``prefix`` —
    get-or-create through the registry, so the recording path and every
    report path share the same objects instead of re-walking
    ``metrics.histogram(...)`` name construction independently."""
    return {phase: metrics.histogram(f"{prefix}/{phase}_s")
            for phase in phases}


def latency_rollup(metrics: MetricsRegistry, prefix: str,
                   phases=PHASES) -> dict:
    """{phase: percentile snapshot} for the non-empty phases of one
    histogram family — THE shared latency-aggregation helper behind the
    per-kind, per-certificate, and per-tenant report sections."""
    return {phase: h.snapshot()
            for phase, h in phase_histograms(metrics, prefix, phases).items()
            if h.count}


def substrates(kind: str, engine: BridgeEngine | None = None) -> dict:
    """The kind's row of the substrate matrix (DESIGN.md §Analysis
    registry): every registry kind serves single/batched/distributed; the
    incremental column and the declared certificate come from the
    descriptor. With an ``engine``, also the certificate the engine's
    ``--certificate`` preference actually resolves this kind to."""
    a = get_analysis(kind)
    row = {
        "certificate": a.certificate,
        "single": True,
        "batched": True,
        "incremental": a.incremental,
        "decremental": a.decremental,
        "distributed": True,
    }
    if engine is not None:
        row["served_certificate"] = engine.certificate_for(kind)
    return row


def _drop_pairs(all_s, all_d, ks, kd):
    """Host mirror of a deletion: remove every copy of the keyed pairs."""
    kset = set(zip(np.minimum(ks, kd).tolist(), np.maximum(ks, kd).tolist()))
    lo, hi = np.minimum(all_s, all_d), np.maximum(all_s, all_d)
    keep = np.array([(a, b) not in kset for a, b in
                     zip(lo.tolist(), hi.tolist())], bool)
    return all_s[keep], all_d[keep]


def make_queries(num: int, n: int, edges: int, seed: int = 0):
    """Query stream: planted-bridge graphs with sizes jittered inside one
    power-of-two bucket (the serving sweet spot the engine is built for)."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(num):
        nq = int(n - rng.integers(0, max(n // 8, 1)))
        mq = int(edges - rng.integers(0, max(edges // 8, 1)))
        src, dst, _ = gen.planted_bridge_graph(
            nq, mq, n_bridges=int(rng.integers(1, 6)), seed=seed + i)
        qs.append((src, dst, nq))
    return qs


def _same(kind: str, got, want) -> bool:
    if get_analysis(kind).kind == "2ecc":
        return bool(np.array_equal(np.asarray(got), np.asarray(want)))
    return got == want


def serve_kind(engine: BridgeEngine, kind: str, queries, args,
               metrics: MetricsRegistry) -> dict:
    """Batched + single + incremental serving for one analysis kind.

    Every dispatch lands in a latency histogram — per kind AND per served
    certificate, one per serving phase — from which the report's
    p50/p95/p99 come. The warm single-query phase (everything after its
    first, program-compiling request) asserts NO retraces off the
    engine's ``traces`` counter; the assertion must hold with the span
    tracer enabled (spans never enter a cache key).
    """
    analysis = get_analysis(kind)
    host_ref = analysis.host_fn
    # which backend the certificate's per-round edge scan resolves to for
    # every request served below (cuda | ref) — perf numbers in the JSON
    # report are attributable to a kernel code path
    cert = engine.certificate_for(kind)
    stats: dict = {"kind": kind, "substrates": substrates(kind, engine),
                   "certificate": cert,
                   "kernel_path": kernel_path(engine.device)}
    hists = phase_histograms(metrics, f"serve/{kind}")
    cert_hists = phase_histograms(metrics, f"serve/cert/{cert}")

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        dt = time.perf_counter() - t0
        hists[phase].observe(dt)
        cert_hists[phase].observe(dt)
        return out

    # ---- batched serving -------------------------------------------------
    t_cold = None
    t0 = time.perf_counter()
    served = 0
    for start in range(0, len(queries), args.batch):
        chunk = queries[start:start + args.batch]
        got = timed("batched", engine.analyze_batch,
                    [(s, d) for s, d, _ in chunk], [nq for _, _, nq in chunk],
                    kind=kind)
        if args.verify:
            s, d, nq = chunk[0]
            want = host_ref(s, d, nq)
            assert _same(kind, got[0], want), f"{kind} batch@{start} mismatch"
        served += len(chunk)
        if t_cold is None:
            t_cold = time.perf_counter() - t0
    t_total = time.perf_counter() - t0
    t_warm = t_total - t_cold
    warm_q = served - min(args.batch, served)
    steady_qps = warm_q / max(t_warm, 1e-9) if warm_q > 0 else None
    steady = (f"{steady_qps:.1f} queries/s" if steady_qps is not None
              else "n/a (all queries fit in the first batch)")
    print(f"[{kind:11s}] batched  : {served} queries, batch={args.batch} | "
          f"cold first batch {t_cold * 1e3:.0f}ms | steady {steady}",
          flush=True)
    stats["batched"] = {"queries": served, "batch": args.batch,
                        "cold_first_batch_s": t_cold,
                        "steady_qps": steady_qps}

    # ---- single-query serving (same engine: programs already cached) -----
    t0 = time.perf_counter()
    warm_traces = None
    for i, (s, d, nq) in enumerate(queries):
        timed("single", engine.analyze, s, d, nq, kind=kind)
        if i == 0:
            # the first single query may compile this kind's single-graph
            # program; every request after it must be retrace-free
            warm_traces = engine.stats.traces
    dt = time.perf_counter() - t0
    retraces = engine.stats.traces - warm_traces
    assert retraces == 0, (
        f"{kind}: {retraces} retrace(s) during warm single-query serving")
    single_qps = len(queries) / max(dt, 1e-9)
    print(f"[{kind:11s}] single   : {len(queries)} queries | "
          f"{single_qps:.1f} queries/s | warm retraces {retraces}",
          flush=True)
    stats["single"] = {"queries": len(queries), "qps": single_qps,
                       "warm_retraces": retraces}

    # ---- incremental serving (every registry kind rides the live state:
    # 2-edge kinds off the warm-start Borůvka pair, cuts/bcc off the live
    # scan-first-search pair — DESIGN.md §Analysis registry). Workload
    # 'insert' is insert-only; 'churn' interleaves link failures
    # (delete_edges) at --delete-ratio, the paper's serving story ---------
    if args.deltas > 0 and analysis.incremental:
        s0, d0, nq0 = queries[0]
        engine.load(s0, d0, nq0)
        all_s, all_d = s0, d0
        rng = np.random.default_rng(args.seed + 17)
        deletions = 0
        t0 = time.perf_counter()
        for k in range(args.deltas):
            churn_del = (args.workload == "churn"
                         and rng.random() < args.delete_ratio
                         and len(all_s) > args.delta_edges)
            if churn_del:
                # fail delta_edges live links (same key bucket as inserts)
                idx = rng.choice(len(all_s), args.delta_edges, replace=False)
                ks, kd = all_s[idx], all_d[idx]
                got = timed("update", engine.delete_edges, ks, kd, kind=kind)
                all_s, all_d = _drop_pairs(all_s, all_d, ks, kd)
                deletions += 1
            else:
                ds, dd = gen.random_graph(nq0, args.delta_edges,
                                          seed=args.seed + 500 + k)
                got = timed("update", engine.insert_edges, ds, dd, kind=kind)
                all_s = np.concatenate([all_s, ds])
                all_d = np.concatenate([all_d, dd])
        dt = time.perf_counter() - t0
        if args.verify:
            want = host_ref(all_s, all_d, nq0)
            assert _same(kind, got, want), f"{kind} incremental mismatch"
        ups = args.deltas / max(dt, 1e-9)
        rebuilds = engine.live_rebuilds
        print(f"[{kind:11s}] increment: {args.deltas} deltas x "
              f"{args.delta_edges} edges ({deletions} deletions) | "
              f"{ups:.1f} updates/s | live cert edges "
              f"{engine.num_live_edges} | rebuilds {rebuilds}", flush=True)
        stats["incremental"] = {"deltas": args.deltas,
                                "delta_edges": args.delta_edges,
                                "workload": args.workload,
                                "deletions": deletions,
                                "cert_rebuilds": rebuilds,
                                "updates_per_s": ups,
                                "live_cert_edges": engine.num_live_edges}
    stats["latency"] = latency_rollup(metrics, f"serve/{kind}")
    print(f"[{kind:11s}] latency  : " + " | ".join(
        f"{phase} {_pctl_str(snap)}"
        for phase, snap in stats["latency"].items()), flush=True)
    return stats


def _pctl_str(snap: dict) -> str:
    """'p50 1.2ms p95 3.4ms p99 5.6ms' from a histogram snapshot."""
    return " ".join(f"{p} {snap[p] * 1e3:.2f}ms" for p in ("p50", "p95", "p99"))


def certificate_report(per_kind: list, metrics: MetricsRegistry | None = None,
                       ) -> dict:
    """Fold the per-kind rows into per-CERTIFICATE serving rates: for each
    certificate actually served, which kinds rode it, their summed
    steady-state batched + single qps, and the live rebuild counters —
    the ``--certificate`` comparison view of the same data. Rebuilds are
    credited to the certificate that rebuilt (every live pair is probed on
    a deletion, not just the served one), so a certificate can carry a
    rebuild count without serving any kind directly."""
    def agg_for(by_cert, cert):
        return by_cert.setdefault(
            cert, {"kinds": [], "batched_steady_qps": 0.0, "single_qps": 0.0,
                   "rebuilds": 0})

    by_cert: dict = {}
    for row in per_kind:
        agg = agg_for(by_cert, row["certificate"])
        agg["kinds"].append(row["kind"])
        if row["batched"]["steady_qps"]:
            agg["batched_steady_qps"] += row["batched"]["steady_qps"]
        agg["single_qps"] += row["single"]["qps"]
    for row in per_kind:
        inc = row.get("incremental")
        if inc:
            for cert, count in inc["cert_rebuilds"].items():
                agg_for(by_cert, cert)["rebuilds"] += count
    if metrics is not None:
        # the per-CERTIFICATE latency histograms accumulated across every
        # kind that rode the certificate (true cross-kind percentiles —
        # NOT derivable from the per-kind snapshots)
        for cert, agg in by_cert.items():
            agg["latency"] = latency_rollup(metrics, f"serve/cert/{cert}")
    return by_cert


def jain_index(xs) -> float | None:
    """Jain's fairness index over per-tenant rates: 1.0 = perfectly even,
    1/N = one tenant got everything."""
    xs = [x for x in xs if x]
    if not xs:
        return None
    s, s2 = sum(xs), sum(x * x for x in xs)
    return (s * s) / (len(xs) * s2) if s2 else None


def _mt_events(args, kinds, reads, rng):
    """The multi-tenant request schedule: per-tenant streams interleaved
    round-robin, with open-loop arrival offsets (exponential interarrivals
    at ``--arrival-qps``; all-at-zero when 0 = maximum pressure). The last
    tenant is churn-heavy (write ops against the shared live graph) when
    ``--deltas > 0`` and at least two tenants exist."""
    tenants = [f"tenant{i}" for i in range(args.tenants)]
    churn = tenants[-1] if (args.deltas > 0 and args.tenants > 1) else None
    readers = [t for t in tenants if t != churn]
    streams = {t: [] for t in tenants}
    for i, (s, d, nq) in enumerate(reads):
        streams[readers[i % len(readers)]].append(
            {"op": "analyze", "kind": get_analysis(kinds[i % len(kinds)]).kind,
             "graph": (s, d, nq)})
    if churn is not None:
        streams[churn] = [{"op": None}] * args.deltas  # ops filled per phase
    events = []
    live = [t for t in tenants if streams[t]]
    while live:
        for t in live:
            events.append({"tenant": t, **streams[t].pop(0)})
        live = [t for t in tenants if streams[t]]
    if args.arrival_qps > 0:
        gaps = rng.exponential(1.0 / args.arrival_qps, size=len(events))
        arrivals = np.cumsum(gaps)
    else:
        arrivals = np.zeros(len(events))
    for ev, t_arr in zip(events, arrivals):
        ev["t"] = float(t_arr)
    return tenants, churn, events


def _mt_writes(count: int, n0: int, delta_edges: int, base, seed: int):
    """A churn-heavy tenant's write stream for one phase: inserts of fresh
    random deltas, link failures sampled from the base edge set (so some
    hit certificate edges and exercise the rebuild rule), at roughly the
    configured delete ratio via the seeded rng."""
    rng = np.random.default_rng(seed)
    s0, d0 = base
    ops = []
    for k in range(count):
        if rng.random() < 0.5 and len(s0) > delta_edges:
            idx = rng.choice(len(s0), delta_edges, replace=False)
            ops.append(("delete_edges", s0[idx], d0[idx]))
        else:
            ds, dd = gen.random_graph(n0, delta_edges, seed=seed + 100 + k)
            ops.append(("insert_edges", ds, dd))
    return ops


def serve_multitenant(engine: BridgeEngine, kinds, args,
                      metrics: MetricsRegistry) -> dict:
    """The continuous-batching request path vs the sequential loop, at the
    same open-loop arrival schedule (DESIGN.md §Serving).

    Phase order: warmup (compiles every program either phase can touch —
    the single-graph program per kind, the batched program per pow-2
    batch bucket up to ``--batch``, and one insert + one delete), then
    the SEQUENTIAL phase (one ``engine.analyze`` per request, in arrival
    order), then the SCHEDULER phase (same schedule submitted into a
    ``BridgeScheduler`` and drained). Latency is arrival-to-completion
    for both, so queueing is charged identically; after warmup the
    engine's ``traces`` counter must not move — shape-bucket admission
    means coalescing never retraces.
    """
    kinds = [get_analysis(k).kind for k in kinds]
    rng = np.random.default_rng(args.seed + 71)
    n_readers = max(args.tenants - (1 if args.deltas > 0 else 0), 1)
    reads = make_queries(args.queries * n_readers, args.n, args.edges,
                         seed=args.seed)
    tenants, churn, events = _mt_events(args, kinds, reads, rng)

    # live graph for the churn tenant + write sizing that never outgrows
    # the full-buffer bucket (bucket growth would be a mid-phase retrace)
    s0, d0, n0 = reads[0]
    engine.load(s0, d0, n0)
    n_writes = args.deltas if churn is not None else 0
    headroom = admission_capacity(len(s0)) - len(s0)
    delta_edges = max(1, min(args.delta_edges,
                             headroom // max(2 * n_writes + 2, 1)))
    write_streams = {
        "seq": _mt_writes(n_writes, n0, delta_edges, (s0, d0),
                          args.seed + 211),
        "sched": _mt_writes(n_writes, n0, delta_edges, (s0, d0),
                            args.seed + 409),
    }

    # ---- warmup: compile everything both phases can touch ----------------
    warm = BridgeScheduler(engine, max_batch=args.batch,
                           metrics=MetricsRegistry())
    ws, wd, wn = reads[0]
    for kind in set(kinds):
        engine.analyze(ws, wd, wn, kind=kind)
        b = 1
        while b <= args.batch:
            for _ in range(b):
                warm.submit("_warm", ws, wd, wn, kind=kind)
            warm.drain_all()
            b *= 2
    if churn is not None:
        engine.insert_edges(*gen.random_graph(n0, delta_edges,
                                              seed=args.seed + 7))
        engine.delete_edges(s0[:delta_edges], d0[:delta_edges])
    warm_traces = engine.stats.traces

    def percentiles(prefix):
        return latency_rollup(metrics, prefix, phases=("latency",)
                              ).get("latency")

    def run_phase(name, serve_fn):
        """Replay ``events`` against ``serve_fn`` under open-loop pacing;
        returns the phase rollup with per-tenant arrival-based latency."""
        writes = iter(write_streams[name])
        start = time.perf_counter()
        serve_fn(start, writes)
        wall = time.perf_counter() - start
        per_tenant = {}
        for t in tenants:
            served = sum(1 for ev in events if ev["tenant"] == t)
            per_tenant[t] = {
                "requests": served,
                "qps": served / max(wall, 1e-9),
                "latency": percentiles(f"mt/{name}/tenant/{t}"),
            }
        agg = percentiles(f"mt/{name}/all")
        return {"wall_s": wall, "qps": len(events) / max(wall, 1e-9),
                "latency": agg, "per_tenant": per_tenant}

    def observe(name, tenant, lat):
        metrics.histogram(f"mt/{name}/tenant/{tenant}/latency_s").observe(lat)
        metrics.histogram(f"mt/{name}/all/latency_s").observe(lat)

    def serve_sequential(start, writes):
        for ev in events:
            rel = time.perf_counter() - start
            if ev["t"] > rel:
                time.sleep(ev["t"] - rel)
            if ev["op"] == "analyze":
                s, d, nq = ev["graph"]
                got = engine.analyze(s, d, nq, kind=ev["kind"])
                if args.verify and ev is events[0]:
                    want = get_analysis(ev["kind"]).host_fn(s, d, nq)
                    assert _same(ev["kind"], got, want), "mt seq mismatch"
            else:
                op, ks, kd = next(writes)
                getattr(engine, op)(ks, kd)
            observe("seq", ev["tenant"],
                    time.perf_counter() - start - ev["t"])

    def serve_scheduler(start, writes):
        sched = BridgeScheduler(engine, max_batch=args.batch,
                                metrics=metrics)
        arrivals: list = []  # (ticket, event) in completion-check order
        i = 0
        while i < len(events) or sched.pending:
            rel = time.perf_counter() - start
            while i < len(events) and events[i]["t"] <= rel:
                ev = events[i]
                if ev["op"] == "analyze":
                    s, d, nq = ev["graph"]
                    tk = sched.submit(ev["tenant"], s, d, nq,
                                      kind=ev["kind"])
                else:
                    op, ks, kd = next(writes)
                    tk = sched.submit(ev["tenant"], ks, kd, op=op)
                arrivals.append((tk, ev))
                i += 1
            if sched.pending == 0:
                if i < len(events):
                    time.sleep(max(events[i]["t"] - rel, 0.0))
                continue
            sched.drain()
        for tk, ev in arrivals:
            observe("sched", ev["tenant"], tk.t_done - start - ev["t"])
            if args.verify and ev is events[0] and ev["op"] == "analyze":
                s, d, nq = ev["graph"]
                want = get_analysis(ev["kind"]).host_fn(s, d, nq)
                assert _same(ev["kind"], tk.result(), want), "mt sched mismatch"
        serve_scheduler.sched = sched

    seq = run_phase("seq", serve_sequential)
    sched_phase = run_phase("sched", serve_scheduler)
    sched = serve_scheduler.sched
    retraces = engine.stats.traces - warm_traces
    assert retraces == 0, (
        f"{retraces} retrace(s) during warm multi-tenant serving — "
        f"admission bucketing failed to guarantee program reuse")
    sched_snap = sched.snapshot()
    report = {
        "tenants": args.tenants,
        "churn_tenant": churn,
        "requests": len(events),
        "arrival_qps": args.arrival_qps,
        "delta_edges": delta_edges,
        "sequential": seq,
        "scheduler": sched_phase,
        "scheduler_rollup": sched_snap,
        "warm_retraces": retraces,
        "speedup": seq["wall_s"] / max(sched_phase["wall_s"], 1e-9),
        "fairness": {
            "jain_qps": jain_index(
                [row["qps"] for row in sched_phase["per_tenant"].values()]),
            "p99_spread": _p99_spread(sched_phase["per_tenant"]),
        },
    }
    occ = sched_snap["occupancy"] or 0.0
    print(f"[multitenant] {args.tenants} tenants x open-loop "
          f"({'pressure' if not args.arrival_qps else f'{args.arrival_qps:.0f} qps'})"
          f" | {len(events)} requests", flush=True)
    for name, phase in (("sequential", seq), ("scheduler", sched_phase)):
        lat = phase["latency"] or {}
        print(f"[multitenant] {name:10s}: {phase['qps']:.1f} qps | "
              + (_pctl_str(lat) if lat else "no latency samples"),
              flush=True)
    print(f"[multitenant] speedup {report['speedup']:.2f}x | occupancy "
          f"{occ:.2f} queries/dispatch ({sched_snap['dispatches']} "
          f"dispatches, {sched_snap['padded_slots']} padded slots, "
          f"{sched_snap['writes']} writes) | warm retraces {retraces}",
          flush=True)
    for t in tenants:
        row = sched_phase["per_tenant"][t]
        lat = row["latency"] or {}
        role = "churn" if t == churn else "read"
        print(f"[multitenant]   {t:9s} ({role:5s}): {row['qps']:.1f} qps | "
              + (_pctl_str(lat) if lat else "-"), flush=True)
    fair = report["fairness"]
    jain = fair["jain_qps"]
    spread = fair["p99_spread"]
    print(f"[multitenant] fairness: "
          f"jain={'n/a' if jain is None else f'{jain:.3f}'} "
          f"p99_spread={'n/a' if spread is None else f'{spread:.2f}x'}",
          flush=True)
    return report


def serve_ingest(engine: BridgeEngine, args, metrics: MetricsRegistry) -> dict:
    """The streaming-ingest drill: one dense world served twice.

    ONE-SHOT: ``load`` materializes the full edge buffer on device and
    certifies it (peak device memory O(E)). STREAMED: the same edges
    arrive as deltas through ``load_stream``/``ingest_chunk`` and fold
    into the live certificates through fixed ``--chunk-edges`` chunks
    (peak O(chunk + certificate); the host spill ring keeps the edge-set
    record). The drill then asserts bit-identical analyses for EVERY
    registry kind, zero retraces across the post-warmup ingest (the chunk
    bucket is ProgramCache currency), and reports edges/s + the two
    ``peak_live_bytes`` high-water marks whose ratio fig12 pins.
    """
    n = args.n
    src, dst = gen.random_graph(n, args.edges, seed=args.seed)
    kinds = [get_analysis(k).kind for k in analysis_kinds()]

    # ---- one-shot reference: full buffer resident, on the same device ---
    one = BridgeEngine(certificate=args.certificate, device=engine.device)
    t0 = time.perf_counter()
    one.load(src, dst, n)
    t_load = time.perf_counter() - t0
    ref = {k: one.current_analysis(kind=k) for k in kinds}
    one_peak = one.peak_live_bytes

    # ---- warmup: compile the chunk-bucket load/fold + final programs ----
    warm_edges = min(len(src), 2 * args.chunk_edges)
    engine.load_stream(src[:warm_edges], dst[:warm_edges], n,
                       chunk_edges=args.chunk_edges)
    for k in kinds:
        engine.current_analysis(kind=k)
    warm_traces = engine.stats.traces

    # ---- timed streamed ingest: fresh stream, warm programs -------------
    hist = metrics.histogram("ingest/chunk_s")
    t0 = time.perf_counter()
    engine.load_stream(src[:0], dst[:0], n, chunk_edges=args.chunk_edges)
    step = max(2 * args.chunk_edges, 1)  # arrivals bigger than one chunk
    for lo in range(0, len(src), step):
        t1 = time.perf_counter()
        engine.ingest_chunk(src[lo:lo + step], dst[lo:lo + step])
        hist.observe(time.perf_counter() - t1)
    t_ingest = time.perf_counter() - t0
    got = {k: engine.current_analysis(kind=k) for k in kinds}
    for k in kinds:
        assert _same(k, got[k], ref[k]), f"ingest parity: {k} mismatch"
    if args.verify:
        want = get_analysis("bridges").host_fn(src, dst, n)
        assert _same("bridges", got["bridges"], want), "ingest host mismatch"
    retraces = engine.stats.traces - warm_traces
    assert retraces == 0, (
        f"{retraces} retrace(s) during warm streamed ingest — the chunk "
        f"bucket stopped being ProgramCache currency")

    snap = engine.snapshot()
    streamed_peak = engine.peak_live_bytes
    eps = len(src) / max(t_ingest, 1e-9)
    report = {
        "edges": len(src), "n": n, "chunk_edges": args.chunk_edges,
        "chunk_bucket": snap["ingest"]["chunk_bucket"],
        "one_shot": {"load_s": t_load, "peak_live_bytes": one_peak},
        "streamed": {"ingest_s": t_ingest, "edges_per_s": eps,
                     "peak_live_bytes": streamed_peak,
                     **snap["ingest"]},
        "peak_bytes_ratio": streamed_peak / max(one_peak, 1),
        "parity_kinds": kinds,
        "warm_retraces": retraces,
        "latency": {"chunk": hist.snapshot()},
    }
    print(f"[ingest] {len(src)} edges via {snap['ingest']['chunks']} chunks "
          f"(bucket {report['chunk_bucket']}) | {eps:,.0f} edges/s | "
          f"folds {snap['ingest']['folds']} replays "
          f"{snap['ingest']['replays']}", flush=True)
    print(f"[ingest] peak live bytes: streamed {streamed_peak:,} vs "
          f"one-shot {one_peak:,} ({report['peak_bytes_ratio']:.0%}) | "
          f"parity {len(kinds)} kinds OK | warm retraces {retraces}",
          flush=True)
    return report


def _p99_spread(per_tenant: dict) -> float | None:
    """max/min ratio of per-tenant p99 latency (1.0 = perfectly even)."""
    p99s = [row["latency"]["p99"] for row in per_tenant.values()
            if row["latency"] and row["latency"].get("p99")]
    return max(p99s) / min(p99s) if p99s else None


def main(argv=None, *, device=None):
    """The serving driver; returns the report dict. Runs on the card
    unless ``device`` names another (``resolve_device``: without a card
    and without ``device`` it raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--analysis", action="append",
                    choices=list(KINDS) + ["all"], default=None,
                    help="query kind(s) to serve; repeatable (default: bridges)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--edges", type=int, default=8192)
    ap.add_argument("--deltas", type=int, default=16,
                    help="incremental updates served after the batched phase")
    ap.add_argument("--delta-edges", type=int, default=64)
    ap.add_argument("--workload",
                    choices=["insert", "churn", "multitenant", "failover",
                             "ingest"],
                    default="insert",
                    help="incremental phase: insert-only, churn with "
                         "interleaved link failures (delete_edges), the "
                         "multitenant continuous-batching request path "
                         "(scheduler vs sequential loop), the "
                         "failover drill (kill a machine mid-serve, watchdog "
                         "detection, checkpoint/recertify recovery — "
                         "DESIGN.md §Fault tolerance), or the streaming-"
                         "ingest drill (one-shot load vs chunked "
                         "load_stream: edges/s + peak live bytes — "
                         "DESIGN.md §Streaming ingest)")
    ap.add_argument("--chunk-edges", type=int, default=1024,
                    help="ingest workload: edges per device chunk (rounded "
                         "up to a pow-2 chunk bucket, the ProgramCache "
                         "currency)")
    ap.add_argument("--machines", type=int, default=4,
                    help="failover workload: serving fleet size")
    ap.add_argument("--steps", type=int, default=12,
                    help="failover workload: churn/serve steps")
    ap.add_argument("--kill-machine", type=int, default=None, metavar="I",
                    help="failover workload: machine to kill mid-serve")
    ap.add_argument("--kill-at-step", type=int, default=None, metavar="S",
                    help="failover workload: serve step at which machine I "
                         "falls silent (default: steps // 3)")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="failover workload: per-machine certificate "
                         "snapshot cadence in steps (0 disables; recovery "
                         "then always re-certifies the dead shard)")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="failover workload: checkpoint directory "
                         "(default: a fresh temp dir)")
    ap.add_argument("--schedule",
                    choices=["paper", "xor", "hierarchical"],
                    default="paper",
                    help="failover workload: merge schedule under drill")
    ap.add_argument("--delete-ratio", type=float, default=0.25,
                    help="churn workload: fraction of deltas that are "
                         "deletions")
    ap.add_argument("--tenants", type=int, default=4,
                    help="multitenant workload: number of tenants (each "
                         "reader issues --queries requests; the last tenant "
                         "is churn-heavy when --deltas > 0)")
    ap.add_argument("--arrival-qps", type=float, default=0.0,
                    help="multitenant workload: aggregate open-loop arrival "
                         "rate (exponential interarrivals; 0 = all requests "
                         "arrive at t=0, maximum pressure)")
    ap.add_argument("--certificate", choices=list(CERTS), default="auto",
                    help="serve every kind from this certificate where the "
                         "kind can ride it (falls back to the kind's "
                         "declared default elsewhere); 'auto' = defaults")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="check one query per batch against the host oracle")
    ap.add_argument("--json", dest="json_path", default=None, metavar="PATH",
                    help="write per-kind rates + latency percentiles + the "
                         "engine snapshot rollup")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable the span tracer for the run and write the "
                         "Chrome-trace JSON here (Perfetto/chrome://tracing)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace into DIR "
                         "(record_function ranges carry the span names)")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.queries < 1:
        ap.error("--batch and --queries must be >= 1")
    if args.tenants < 1:
        ap.error("--tenants must be >= 1")
    kinds = args.analysis or ["bridges"]
    if "all" in kinds:
        kinds = list(KINDS)
    if args.smoke:
        args.queries = min(args.queries, 16)
        args.n = min(args.n, 128)
        args.edges = min(args.edges, 1024)
        args.deltas = min(args.deltas, 4)
        args.steps = min(args.steps, 8)
        args.delta_edges = min(args.delta_edges, 16)
        if args.workload == "multitenant":
            args.queries = min(args.queries, 6)
        if args.workload == "ingest":
            # a still-dense smoke world: full buffer >> certificates, so
            # the streamed-vs-one-shot byte ratio stays meaningful
            args.edges = min(max(args.edges, 4096), 4096)
            args.chunk_edges = min(args.chunk_edges, 128)
    if args.workload == "failover":
        if args.kill_machine is not None and args.kill_at_step is None:
            args.kill_at_step = args.steps // 3
        if args.kill_machine is not None and not (
                0 <= args.kill_machine < args.machines):
            ap.error("--kill-machine must name a fleet machine")

    engine = BridgeEngine(certificate=args.certificate, device=device)
    metrics = MetricsRegistry()
    tracer = obs.enable_tracing() if args.trace_out else None
    multitenant = None
    failover = None
    ingest = None
    per_kind: list = []
    try:
        with profiler_trace(args.profile_dir):
            if args.workload == "failover":
                failover = serve_failover(args, device=engine.device)
            elif args.workload == "ingest":
                ingest = serve_ingest(engine, args, metrics)
            elif args.workload == "multitenant":
                multitenant = serve_multitenant(engine, kinds, args, metrics)
            else:
                queries = make_queries(args.queries, args.n, args.edges,
                                       seed=args.seed)
                per_kind = [serve_kind(engine, kind, queries, args, metrics)
                            for kind in kinds]
    finally:
        if tracer is not None:
            obs.disable_tracing()

    # the ONE engine rollup (BridgeEngine.snapshot): cache counters + hit
    # rate + live rebuild totals — nothing re-derived here
    snap = engine.snapshot()
    print(f"engine   : {snap['programs']} programs, {snap['hits']} hits, "
          f"{snap['misses']} misses, {snap['traces']} traces | "
          f"kernel_path={kernel_path(engine.device)}", flush=True)
    for row in per_kind:
        sub = row["substrates"]
        print(f"substrate: {row['kind']:11s} cert={sub['certificate']} "
              f"served={row['certificate']} "
              f"single={sub['single']} batched={sub['batched']} "
              f"incremental={sub['incremental']} "
              f"decremental={sub['decremental']} "
              f"distributed={sub['distributed']}", flush=True)
    by_cert = certificate_report(per_kind, metrics)
    for cert, agg in by_cert.items():
        print(f"cert     : {cert:11s} kinds={','.join(agg['kinds'])} "
              f"single {agg['single_qps']:.1f} q/s | batched steady "
              f"{agg['batched_steady_qps']:.1f} q/s | rebuilds "
              f"{agg['rebuilds']}", flush=True)
    report = {"kinds": per_kind, "engine": snap,
              "certificates": by_cert,
              "metrics": metrics.snapshot(),
              "config": {"batch": args.batch, "queries": args.queries,
                         "n": args.n, "edges": args.edges,
                         "certificate": args.certificate,
                         "workload": args.workload,
                         "tenants": args.tenants}}
    if multitenant is not None:
        report["multitenant"] = multitenant
    if failover is not None:
        report["failover"] = failover
    if ingest is not None:
        report["ingest"] = ingest
    if tracer is not None:
        tracer.write_chrome_trace(args.trace_out)
        stages = tracer.stage_rollup()
        total = sum(r["total_s"] for r in stages.values())
        print(f"trace    : {len(tracer.spans())} spans, "
              f"{len(stages)} stages, {total:.3f}s staged | "
              f"wrote {args.trace_out}", flush=True)
        report["trace"] = {"path": args.trace_out, "spans": len(tracer.spans()),
                           "stage_rollup": stages}
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"# wrote serving report to {args.json_path}", flush=True)
    return report


if __name__ == "__main__":
    main()
