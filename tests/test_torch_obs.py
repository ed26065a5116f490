"""Port parity of ``repro_torch.obs`` against ``repro.obs``, mirroring
``tests/test_obs.py``: the tracer's synthetic spans (``add``), its Chrome
trace export (``chrome_trace``, ``write_chrome_trace``) and its per-stage
rollup (``stage_rollup``) on the same span sequence under the same fake
clock; the disabled tracer's no-ops; the ``kernel/forest/<which>`` spans of
a host forest pass with one ``kernel/round/<which>`` child per round; and
``profiler_trace`` on the CPU.

Tolerance: exact equality (the fake clock makes every time a fixed float).
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.core import forest as jforest
from repro.graph import datastructs as jds
from repro.graph import generators as gen
from repro_torch import obs as tobs
from repro_torch.core import forest as tforest
from repro_torch.graph import datastructs as tds
from repro_torch.kernels.boruvka_round.ops import (
    boruvka_round_bytes,
    frontier_round_bytes,
)

N = 48


@pytest.fixture(autouse=True)
def _no_tracer_leak():
    """Every test starts and ends on the disabled tracers."""
    jobs.disable_tracing()
    tobs.disable_tracing()
    yield
    jobs.disable_tracing()
    tobs.disable_tracing()


def _fake_clock():
    """Each reading 1.5 ms after the last: times are exact binary floats."""
    ticks = itertools.count()
    return lambda: next(ticks) * 0.0015


def _script(tr):
    """One span sequence: containers, nested stages, attributes of every
    JSON type and one that is not, and synthetic children."""
    with tr.span("engine/analyze/cuts", final="device"):
        with tr.span("stage/pad"):
            pass
        with tr.span("stage/pipeline/cuts", n_bucket=64, cap=None) as sp:
            with tr("stage/inner", ratio=0.5, ok=True):
                pass
        tr.add("kernel/round/boruvka", sp.t0, sp.dur / 2, parent=sp.index,
               round=0, model_bytes=900)
        tr.add("kernel/round/boruvka", sp.t0 + sp.dur / 2, sp.dur / 2,
               parent=sp.index, round=1, model_bytes=900)
    with tr.span("kernel/forest/sfs", path=("a", 1)):
        pass
    with tr.span("merge/level0", machines=2):
        with tr.span("merge/machine", machine=0):
            pass
    tr.add("host/orphan", 0.25, 0.125)


def _both():
    jt, tt = jobs.Tracer(clock=_fake_clock()), tobs.Tracer(clock=_fake_clock())
    _script(jt)
    _script(tt)
    return jt, tt


def test_spans_and_add_match_reference():
    jt, tt = _both()
    assert tt.spans() == jt.spans()
    kids = [s for s in tt.spans() if s["name"] == "kernel/round/boruvka"]
    parent = next(s for s in tt.spans()
                  if s["name"] == "stage/pipeline/cuts")
    assert [k["parent"] for k in kids] == [parent["index"]] * 2
    assert [k["depth"] for k in kids] == [parent["depth"] + 1] * 2


def test_chrome_trace_matches_reference():
    jt, tt = _both()
    doc = tt.chrome_trace()
    assert doc == jt.chrome_trace()
    assert json.loads(json.dumps(doc)) == doc
    xs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert len(xs) == len(tt.spans())
    for ev in xs:
        assert set(ev) == {"name", "ph", "pid", "tid", "ts", "dur", "args"}
        assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)


def test_rollups_match_reference():
    jt, tt = _both()
    assert tt.rollup() == jt.rollup()
    staged = tt.stage_rollup()
    assert staged == jt.stage_rollup()
    # outermost stage spans only: nested stages and rounds are not billed
    assert set(staged) == {"stage/pad", "stage/pipeline/cuts",
                           "kernel/forest/sfs", "merge/level0", "host/orphan"}
    assert tobs.STAGE_PREFIXES == jobs.STAGE_PREFIXES
    assert (tt.stage_rollup(prefixes=("merge/",))
            == jt.stage_rollup(prefixes=("merge/",)))


def test_write_chrome_trace_matches_reference(tmp_path):
    jt, tt = _both()
    jt.write_chrome_trace(str(tmp_path / "j.json"))
    tt.write_chrome_trace(str(tmp_path / "t.json"))
    assert ((tmp_path / "t.json").read_text()
            == (tmp_path / "j.json").read_text())


def test_null_tracer_no_ops(tmp_path):
    null, jnull = tobs.NULL_TRACER, jobs.NULL_TRACER
    assert null.enabled is False and tobs.Tracer.enabled is True
    with null("stage/x") as sp:
        assert sp.sync(5) == 5
    assert null.add("kernel/round/sfs", 0.0, 1.0, parent=0, round=0) is None
    assert null.reset() is None
    assert null.spans() == jnull.spans() == []
    assert null.chrome_trace() == jnull.chrome_trace()
    assert null.rollup() == null.stage_rollup() == jnull.stage_rollup() == {}
    null.write_chrome_trace(str(tmp_path / "none.json"))
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------ the forest spans
def _graph(seed):
    s, d, _ = gen.planted_bridge_graph(N, 200, n_bridges=3, seed=seed)
    return s, d


@pytest.mark.parametrize("which", ["boruvka", "sfs"])
def test_forest_spans_match_reference(which):
    """A host forest pass emits one ``kernel/forest/<which>`` span with one
    ``kernel/round/<which>`` child per round, as the reference does: the
    same names, counts, parent links and rounds; the attributes carry the
    port's own path and byte model, and each child is a measured round."""
    s, d = _graph(3)
    jel = jds.EdgeList.from_arrays(s, d, N)
    tel = tds.EdgeList.from_arrays(s, d, N, device="cpu")
    run = {"boruvka": (jforest.spanning_forest_ex,
                       tforest.spanning_forest_ex),
           "sfs": (jforest.scan_first_forest_ex,
                   tforest.scan_first_forest_ex)}[which]
    jt = jobs.enable_tracing(jobs.Tracer(clock=_fake_clock()))
    jout = run[0](jel)
    tt = tobs.enable_tracing(tobs.Tracer(clock=_fake_clock()))
    tout = run[1](tel)
    rounds = int(tout[-1])
    assert rounds == int(jout[-1]) > 0

    def shape(tr):
        return [(x["name"], x["parent"], x["depth"], x["attrs"].get("round"))
                for x in tr.spans()]

    assert shape(tt) == shape(jt)
    parent = [x for x in tt.spans() if x["name"] == f"kernel/forest/{which}"]
    kids = [x for x in tt.spans() if x["name"] == f"kernel/round/{which}"]
    assert len(parent) == 1 and len(kids) == rounds
    attrs = parent[0]["attrs"]
    assert attrs == {"edges": tel.capacity, "path": "ref", "rounds": rounds}
    assert set(attrs) == set(next(x for x in jt.spans()
                                  if x["name"] == parent[0]["name"])["attrs"])
    live = int(((tel.mask) & (tel.src != tel.dst)).sum())
    model = {"boruvka": boruvka_round_bytes,
             "sfs": frontier_round_bytes}[which](tel.capacity, N, live)
    assert [k["attrs"] for k in kids] == [
        {"round": i, "model_bytes": model} for i in range(rounds)]
    assert all(k["parent"] == parent[0]["index"] for k in kids)
    # consecutive measured rounds, inside the parent
    for a, b in zip(kids, kids[1:]):
        assert a["t0"] + a["dur"] == b["t0"]
    assert parent[0]["t0"] <= kids[0]["t0"]
    assert (kids[-1]["t0"] + kids[-1]["dur"]
            <= parent[0]["t0"] + parent[0]["dur"])


def test_forest_emits_nothing_while_tracing_is_off():
    s, d = _graph(4)
    tel = tds.EdgeList.from_arrays(s, d, N, device="cpu")
    tr = tobs.Tracer()
    tforest.scan_first_forest_ex(tel)
    assert tobs.get_tracer() is tobs.NULL_TRACER and tr.spans() == []


def test_engine_call_nests_forest_spans_under_its_stages():
    """Inside an engine program the forest spans nest under the stage that
    ran them, so the per-stage rollup bills them once."""
    from repro_torch.engine import BridgeEngine

    s, d = _graph(5)
    tr = tobs.enable_tracing()
    BridgeEngine(device="cpu").analyze(s, d, N, kind="cuts", final="host")
    names = {x["name"] for x in tr.spans()}
    assert {"kernel/forest/boruvka", "kernel/forest/sfs"} <= names
    by_index = {x["index"]: x for x in tr.spans()}
    for x in tr.spans():
        if x["name"].startswith("kernel/forest/"):
            assert by_index[x["parent"]]["name"].startswith("stage/")
    assert not any(k.startswith("kernel/") for k in tr.stage_rollup())


# ------------------------------------------------------- profiler capture
def test_profiler_trace_none_is_a_no_op():
    with tobs.profiler_trace(None) as got:
        assert got is None
    with tobs.profiler_trace("") as got:
        assert got is None


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    tr = tobs.enable_tracing()
    logdir = tmp_path / "prof"
    with tobs.profiler_trace(str(logdir)) as got:
        assert got == str(logdir)
        with tr.span("stage/pipeline/bridges"):
            torch.arange(64).sum()
    doc = json.loads((logdir / "trace.json").read_text())
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert "stage/pipeline/bridges" in names
    # no capture running: a span opens no profiler range
    with tr.span("stage/after") as sp:
        assert sp._label is None
    assert [x["name"] for x in tr.spans()] == ["stage/pipeline/bridges",
                                               "stage/after"]
    assert np.isfinite(tr.spans()[0]["dur"])
