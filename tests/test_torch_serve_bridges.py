"""Port parity of the serving driver (``launch/serve_bridges.py``), part 1:
the same argv through ``repro.launch.serve_bridges.main`` (JAX on the CPU)
and ``repro_torch.launch.serve_bridges.main(argv, device="cpu")``, the
reports held equal without the clock's values
(``tests/torch_serve_report.py``; tolerance: exact, ``jain_qps`` within
1e-12); ``--analysis all`` with ``--json`` and ``--trace-out``, ``churn``,
the reference's own retrace failure at a tiny size, the helpers one by
one, and no card. ``test_torch_serve_workloads.py`` holds the other
workloads, ``test_torch_serve_certificates.py`` the certificate
preferences."""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve_bridges as jserve
import repro_torch.launch.serve_bridges as tserve
from repro.obs import MetricsRegistry as JMetrics
from repro_torch.engine import BridgeEngine as TEngine
from repro_torch.obs import MetricsRegistry as TMetrics

from torch_engine_pair import same
from torch_serve_report import clock_free, clock_free_lines, span_names

#: the reference's own cut of ``--smoke``, at which its single-query phase
#: retraces (the query jitter crosses a shape bucket) and its assertion
#: fails (``serve_bridges.py:242``)
TINY = ["--queries", "4", "--n", "32", "--edges", "128", "--batch", "2",
        "--deltas", "2", "--delta-edges", "8", "--analysis", "all",
        "--verify"]


def test_analysis_all_report_json_trace_and_lines_match_reference(
        tmp_path, capsys):
    """``--smoke --analysis all --verify`` with ``--json`` and
    ``--trace-out``: the same report, the same printed lines, a JSON file
    holding what ``main`` returned, and a Chrome trace with the same
    ``serve/``, ``sched/`` and ``engine/`` spans."""
    reports, lines, names = {}, {}, {}
    for tag, main, kw in (("jax", jserve.main, {}),
                          ("torch", tserve.main, {"device": "cpu"})):
        argv = ["--smoke", "--analysis", "all", "--verify",
                "--json", str(tmp_path / f"{tag}.json"),
                "--trace-out", str(tmp_path / f"{tag}-trace.json")]
        reports[tag] = main(argv, **kw)
        lines[tag] = [line for line in clock_free_lines(capsys.readouterr().out)
                      if not line.startswith(("trace ", "# wrote"))]
        with open(tmp_path / f"{tag}.json") as f:
            assert json.load(f) == json.loads(json.dumps(reports[tag]))
        names[tag] = span_names(tmp_path / f"{tag}-trace.json")
        assert reports[tag]["trace"]["path"] == str(
            tmp_path / f"{tag}-trace.json")
    got, want = reports["torch"], reports["jax"]
    assert clock_free(got) == clock_free(want)
    assert lines["torch"] == lines["jax"]
    assert names["torch"] == names["jax"] and names["torch"]
    assert [row["kind"] for row in got["kinds"]] == list(tserve.KINDS)
    assert {row["kernel_path"] for row in got["kinds"]} == {"ref"}
    assert all(row["single"]["warm_retraces"] == 0 for row in got["kinds"])
    assert set(got["trace"]["stage_rollup"]) >= {
        "stage/certificate_build/2ec", "stage/final/bridges"}


def test_churn_report_matches_reference(capsys):
    """``--workload churn --delete-ratio 0.5``: deletions interleaved with
    the inserts; the same report, deletion counts and rebuild counters."""
    argv = ["--smoke", "--workload", "churn", "--delete-ratio", "0.5",
            "--analysis", "bridges", "--analysis", "cuts", "--verify"]
    want = jserve.main(argv)
    want_lines = clock_free_lines(capsys.readouterr().out)
    got = tserve.main(argv, device="cpu")
    assert clock_free_lines(capsys.readouterr().out) == want_lines
    assert clock_free(got) == clock_free(want)
    deletions = [row["incremental"]["deletions"] for row in got["kinds"]]
    assert sum(deletions) > 0, "the churn must delete"
    assert got["engine"]["rebuilds"] == want["engine"]["rebuilds"]


def test_profile_dir_writes_a_torch_profiler_trace_with_span_ranges(
        tmp_path):
    """``--profile-dir`` goes through ``obs.profiler_trace``: a
    ``torch.profiler`` Chrome trace in the directory whose ranges carry
    the tracer's span names (here with ``--trace-out``, so spans open)."""
    tserve.main(["--smoke", "--workload", "multitenant", "--queries", "2",
                 "--deltas", "2", "--profile-dir", str(tmp_path / "prof"),
                 "--trace-out", str(tmp_path / "trace.json")], device="cpu")
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert set(span_names(tmp_path / "trace.json")) <= names
    assert {"sched/drain", "engine/load"} <= names


def test_tiny_size_fails_the_reference_assertion_in_both():
    """The reference's own failure: at this cut its warm single-query phase
    retraces; the port raises the same ``AssertionError`` at the same
    point."""
    with pytest.raises(AssertionError) as want:
        jserve.main(TINY)
    with pytest.raises(AssertionError) as got:
        tserve.main(TINY, device="cpu")
    assert str(got.value) == str(want.value) == (
        "bridges: 1 retrace(s) during warm single-query serving")


def test_without_a_card_main_raises():
    """``main`` runs on the card unless told otherwise: without one it
    raises ``resolve_device``'s error before serving anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke"])


def test_argument_errors_match_reference(capsys):
    for argv in (["--batch", "0"], ["--tenants", "0"],
                 ["--workload", "failover", "--kill-machine", "9"]):
        errors = []
        for main in (jserve.main, tserve.main):
            with pytest.raises(SystemExit) as exit_info:
                main(argv)
            assert exit_info.value.code == 2
            errors.append(capsys.readouterr().err.splitlines()[-1])
        assert errors[0] == errors[1] and "error: " in errors[0]


# ------------------------------------------------------------ the helpers
def test_module_constants_match_reference():
    assert tserve.KINDS == jserve.KINDS
    assert tserve.CERTS == jserve.CERTS
    assert tserve.PHASES == jserve.PHASES


@pytest.mark.parametrize("num,n,edges,seed", [(6, 128, 1024, 0),
                                              (5, 32, 128, 3),
                                              (3, 512, 8192, 11)])
def test_make_queries_matches_reference(num, n, edges, seed):
    want = jserve.make_queries(num, n, edges, seed=seed)
    got = tserve.make_queries(num, n, edges, seed=seed)
    assert len(got) == len(want) == num
    for (gs, gd, gn), (ws, wd, wn) in zip(got, want):
        assert gn == wn
        assert same(gs, ws) and same(gd, wd)


def _mt_args(**kw):
    base = dict(tenants=4, deltas=4, arrival_qps=0.0, queries=3)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("args", [
    _mt_args(), _mt_args(arrival_qps=150.0), _mt_args(tenants=1),
    _mt_args(deltas=0, arrival_qps=40.0), _mt_args(tenants=3, deltas=2)])
def test_mt_events_match_reference(args):
    kinds = ["bridges", "cuts", "2ecc"]
    reads = jserve.make_queries(args.queries * args.tenants, 64, 256, seed=2)
    want = jserve._mt_events(args, kinds, reads, np.random.default_rng(71))
    got = tserve._mt_events(args, kinds, reads, np.random.default_rng(71))
    assert got[:2] == want[:2]
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        assert g.keys() == w.keys()
        assert (g["tenant"], g["op"], g.get("kind"), g["t"]) == \
            (w["tenant"], w["op"], w.get("kind"), w["t"])
        if "graph" in w:
            assert all(same(a, b) for a, b in zip(g["graph"], w["graph"]))


@pytest.mark.parametrize("count,delta_edges,seed", [(6, 16, 211), (4, 8, 409),
                                                     (3, 10_000, 5)])
def test_mt_writes_match_reference(count, delta_edges, seed):
    s, d, _ = jserve.make_queries(1, 128, 1024, seed=0)[0]
    want = jserve._mt_writes(count, 128, delta_edges, (s, d), seed)
    got = tserve._mt_writes(count, 128, delta_edges, (s, d), seed)
    assert [op for op, _, _ in got] == [op for op, _, _ in want]
    for (_, gs, gd), (_, ws, wd) in zip(got, want):
        assert same(gs, ws) and same(gd, wd)


def test_drop_pairs_matches_reference():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 20, 200).astype(np.int32)
    d = rng.integers(0, 20, 200).astype(np.int32)
    for k in (1, 5, 40):
        idx = rng.choice(200, k, replace=False)
        ks, kd = d[idx], s[idx]  # reversed: the pair key is unordered
        want = jserve._drop_pairs(s, d, ks, kd)
        got = tserve._drop_pairs(s, d, ks, kd)
        assert same(got[0], want[0]) and same(got[1], want[1])
        assert len(got[0]) < 200


@pytest.mark.parametrize("xs", [[], [0, 0], [3.0], [1.0, 1.0, 1.0],
                                [5.0, 1.0, 0.0, 2.5], [None, 2.0, 2.0]])
def test_jain_index_matches_reference(xs):
    assert tserve.jain_index(xs) == jserve.jain_index(xs)


def test_certificate_report_matches_reference():
    rows = [
        {"kind": "bridges", "certificate": "2ec",
         "batched": {"steady_qps": 10.0}, "single": {"qps": 2.0},
         "incremental": {"cert_rebuilds": {"2ec": 1, "sfs": 2}}},
        {"kind": "cuts", "certificate": "sfs",
         "batched": {"steady_qps": None}, "single": {"qps": 1.5}},
        {"kind": "bcc", "certificate": "sfs",
         "batched": {"steady_qps": 4.0}, "single": {"qps": 0.5},
         "incremental": {"cert_rebuilds": {"hybrid": 3}}},
    ]
    assert tserve.certificate_report(rows) == jserve.certificate_report(rows)
    jm, tm = JMetrics(), TMetrics()
    for m, mod in ((jm, jserve), (tm, tserve)):
        for prefix in ("serve/cert/2ec", "serve/cert/sfs"):
            hists = mod.phase_histograms(m, prefix)
            for k, phase in enumerate(mod.PHASES):
                for v in range(k + 1):
                    hists[phase].observe(0.001 * (v + 1))
    assert tserve.certificate_report(rows, tm) == \
        jserve.certificate_report(rows, jm)
    assert tserve.latency_rollup(tm, "serve/cert/sfs") == \
        jserve.latency_rollup(jm, "serve/cert/sfs")
    assert tserve._pctl_str({"p50": 0.0012, "p95": 0.0034, "p99": 0.5}) == \
        jserve._pctl_str({"p50": 0.0012, "p95": 0.0034, "p99": 0.5})


def test_p99_spread_matches_reference():
    per_tenant = {"a": {"latency": {"p99": 0.2}}, "b": {"latency": None},
                  "c": {"latency": {"p99": 0.05}}, "d": {"latency": {}}}
    assert tserve._p99_spread(per_tenant) == jserve._p99_spread(per_tenant)
    assert tserve._p99_spread({"a": {"latency": None}}) is None


@pytest.mark.parametrize("certificate", list(jserve.CERTS))
def test_substrates_match_reference(certificate):
    from repro.engine import BridgeEngine as JEngine

    jeng = JEngine(certificate=certificate)
    teng = TEngine(certificate=certificate, device="cpu")
    for kind in jserve.KINDS:
        assert tserve.substrates(kind) == jserve.substrates(kind)
        assert tserve.substrates(kind, teng) == jserve.substrates(kind, jeng)
