"""Port parity of the serving driver (``launch/serve_bridges.py``), part 2:
the ``multitenant``, ``ingest`` and ``failover`` workloads, the same argv
through ``repro.launch.serve_bridges.main`` (JAX on the CPU) and
``repro_torch.launch.serve_bridges.main(argv, device="cpu")``. Reports are
held equal without the clock's values (``tests/torch_serve_report.py``;
tolerance: exact, ``jain_qps`` within 1e-12). Under open-loop pacing
(``--arrival-qps > 0``) what a dispatch coalesces depends on the clock, so
that case holds only every ticket's answer, the request counts and the
arrival offsets."""
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve_bridges as jserve
import repro_torch.launch.serve_bridges as tserve

from torch_engine_pair import same
from torch_serve_report import clock_free, jain, span_names


def _recording(monkeypatch, module, tickets: list, events: list):
    """Every ticket the module's schedulers hand out, in submission order,
    and the events of its ``_mt_events``, recorded while ``main`` runs."""
    base = module.BridgeScheduler

    class Recording(base):
        def submit(self, *args, **kw):
            tk = super().submit(*args, **kw)
            tickets.append(tk)
            return tk

    make_events = module._mt_events

    def recorded_events(*args):
        out = make_events(*args)
        events.extend(out[2])
        return out

    monkeypatch.setattr(module, "BridgeScheduler", Recording)
    monkeypatch.setattr(module, "_mt_events", recorded_events)


def test_multitenant_under_pressure_matches_reference(tmp_path):
    """``--arrival-qps 0``: every request arrives at t = 0, so the
    dispatches are deterministic; the whole report is held, the scheduler
    rollup and the per-tenant request counts among it, and the traces'
    ``sched/`` and ``engine/`` spans (``--trace-out``)."""
    argv = ["--smoke", "--workload", "multitenant", "--arrival-qps", "0",
            "--analysis", "bridges", "--analysis", "cuts", "--verify",
            "--trace-out"]
    want = jserve.main([*argv, str(tmp_path / "jax.json")])
    got = tserve.main([*argv, str(tmp_path / "torch.json")], device="cpu")
    assert clock_free(got) == clock_free(want)
    names = span_names(tmp_path / "torch.json")
    assert names == span_names(tmp_path / "jax.json")
    assert names["sched/drain"] and names["sched/write/insert_edges"]
    assert abs(jain(got) - jain(want)) <= 1e-12
    mt = got["multitenant"]
    assert mt["warm_retraces"] == 0 and mt["churn_tenant"] == "tenant3"
    assert mt["scheduler_rollup"]["writes"] == 4
    assert sum(row["requests"] for row in
               mt["scheduler"]["per_tenant"].values()) == mt["requests"]


def test_multitenant_open_loop_answers_requests_and_arrivals(monkeypatch):
    """``--arrival-qps 150``: the same tickets in the same order with the
    same answers, the same request counts and the same arrival offsets."""
    argv = ["--smoke", "--workload", "multitenant", "--arrival-qps", "150",
            "--verify"]
    runs = {}
    for tag, module, kw in (("jax", jserve, {}),
                            ("torch", tserve, {"device": "cpu"})):
        tickets, events = [], []
        _recording(monkeypatch, module, tickets, events)
        report = module.main(argv, **kw)
        runs[tag] = (report, tickets, events)
    (got, g_tk, g_ev), (want, w_tk, w_ev) = runs["torch"], runs["jax"]
    assert len(g_tk) == len(w_tk) > len(w_ev)
    for g, w in zip(g_tk, w_tk):
        assert (g.tenant, g.op, g.kind) == (w.tenant, w.op, w.kind)
        assert same(g.result(), w.result())
    assert [(e["tenant"], e["op"], e["t"]) for e in g_ev] == \
        [(e["tenant"], e["op"], e["t"]) for e in w_ev]
    assert any(e["t"] > 0 for e in g_ev)
    g_mt, w_mt = got["multitenant"], want["multitenant"]
    for key in ("tenants", "churn_tenant", "requests", "arrival_qps",
                "delta_edges", "warm_retraces"):
        assert g_mt[key] == w_mt[key], key
    for phase in ("sequential", "scheduler"):
        assert {t: row["requests"] for t, row in
                g_mt[phase]["per_tenant"].items()} == \
            {t: row["requests"] for t, row in
             w_mt[phase]["per_tenant"].items()}


def test_ingest_report_matches_reference():
    """``--workload ingest``: one-shot against streamed, every kind
    bit-equal in both packages; the same chunk counters and both
    ``peak_live_bytes``."""
    argv = ["--smoke", "--workload", "ingest", "--verify"]
    want = jserve.main(argv)
    got = tserve.main(argv, device="cpu")
    assert clock_free(got) == clock_free(want)
    ing = got["ingest"]
    assert ing["streamed"]["peak_live_bytes"] < ing["one_shot"][
        "peak_live_bytes"]
    assert ing["warm_retraces"] == 0 and ing["chunk_bucket"] == 128
    assert ing["parity_kinds"] == list(want["ingest"]["parity_kinds"])


def test_failover_report_matches_reference(tmp_path):
    """``--workload failover`` at ``tests/test_failover.py``'s size: the
    CLI builds ``serve_failover``'s namespace in both; the same report
    (minus the checkpoint directory and the recovery's seconds)."""
    reports = {}
    for tag, main, kw in (("jax", jserve.main, {}),
                          ("torch", tserve.main, {"device": "cpu"})):
        reports[tag] = main(
            ["--workload", "failover", "--smoke", "--machines", "4",
             "--kill-machine", "1", "--kill-at-step", "2", "--ckpt-every",
             "1", "--n", "64", "--edges", "512",
             "--ckpt-dir", str(tmp_path / tag)], **kw)
    got, want = reports["torch"], reports["jax"]
    assert clock_free(got) == clock_free(want)
    assert got["failover"]["ckpt_dir"] == str(tmp_path / "torch")
    fo = got["failover"]
    assert fo["final_parity"] and fo["survivors"] == 3
    assert fo["recovery"]["source"] == "checkpoint"
    assert fo["recovery"]["machine"] == 1
    assert fo["parity_failures_post_recovery"] == 0
    assert fo["counters"] == {"failures/injected": 1,
                              "failures/recovered": 1,
                              "fleet/dead_machines": 1}
    assert fo["final_bridges"] > 0
