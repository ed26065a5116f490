"""Port parity of ``repro_torch.obs`` against ``repro.obs``, mirroring
``tests/test_obs.py``: the tracer's synthetic spans (``add``), its Chrome
trace export (``chrome_trace``, ``write_chrome_trace``) and its per-stage
rollup (``stage_rollup``) on the same span sequence under the same fake
clock; the disabled tracer's no-ops; the ``kernel/forest/<which>`` spans of
a host forest pass with one ``kernel/round/<which>`` child per round; and
``profiler_trace`` on the CPU. Then the port's own: lazy attributes, stream
spans on the CPU (the host is the stream), ``host_sync``, and the spans of
one traced ``analyze`` call (the one-shot pipeline's stages, its host
syncs, the copy apart from the pad).

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
               round=0, bytes=900)
        tr.add("kernel/round/boruvka", sp.t0 + sp.dur / 2, sp.dur / 2,
               parent=sp.index, round=1, bytes=900)
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


#: spans the port records and the reference does not: its host syncs and
#: its segment-min launches
PORT_ONLY = ("sync/", "kernel/segment_min")


@pytest.mark.parametrize("which", ["boruvka", "sfs"])
def test_forest_spans_match_reference(which):
    """A host forest pass emits one ``kernel/forest/<which>`` span with one
    ``kernel/round/<which>`` child per round, as the reference does: the
    same names, counts, parents and rounds (the port's own spans left
    out); the attributes carry the port's own path, ``n`` and ``live``
    (for the byte rule of each round), and each child is a measured
    round."""
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
        spans = tr.spans()
        names = {x["index"]: x["name"] for x in spans}
        return [(x["name"], names.get(x["parent"]), x["depth"],
                 x["attrs"].get("round")) for x in spans
                if not x["name"].startswith(PORT_ONLY)]

    assert shape(tt) == shape(jt)
    parent = [x for x in tt.spans() if x["name"] == f"kernel/forest/{which}"]
    kids = [x for x in tt.spans() if x["name"] == f"kernel/round/{which}"]
    assert len(parent) == 1 and len(kids) == rounds
    attrs = parent[0]["attrs"]
    live = int(((tel.mask) & (tel.src != tel.dst)).sum())
    assert attrs == {"edges": tel.capacity, "n": N, "path": "ref",
                     "live": live, "rounds": rounds}
    assert type(attrs["live"]) is int
    assert set(attrs) > set(next(x for x in jt.spans()
                                 if x["name"] == parent[0]["name"])["attrs"])
    assert [k["attrs"] for k in kids] == [{"round": i} for i in range(rounds)]
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


# ------------------------------------------- the port's own tracing
def test_lazy_attributes_resolve_at_spans():
    """A 0-dim tensor attribute stays a tensor until ``spans()``, which
    reads every one back at once, spans and synthetic spans alike."""
    tr = tobs.Tracer(clock=_fake_clock())
    with tr.span("kernel/forest/boruvka", live=torch.tensor(7)) as sp:
        sp.attrs["rounds"] = 3
    tr.add("kernel/round/boruvka", 0.0, 1.0, parent=sp.index,
           hooked=torch.tensor(True))
    with tr.span("stage/x", ok=torch.tensor(2, dtype=torch.int32)):
        pass
    assert isinstance(tr._spans[0]["attrs"]["live"], torch.Tensor)
    got = [s["attrs"] for s in tr.spans()]
    assert got == [{"live": 7, "rounds": 3}, {"hooked": True}, {"ok": 2}]
    assert [type(v) for a in got for v in a.values()] == [int, int, bool, int]
    assert tr._lazy == []
    args = [ev["args"] for ev in tr.chrome_trace()["traceEvents"]
            if ev["ph"] == "X"]
    assert args == got


@pytest.mark.parametrize("stream", [True, "cpu"])
def test_stream_span_on_the_cpu_is_its_host_interval(stream):
    """On the CPU the host is the stream: a stream span's ``device_t0`` and
    ``device_ms`` are its own host interval, and the Chrome export puts
    them on the card-stream track beside the host's."""
    tr = tobs.Tracer(clock=_fake_clock())
    with tr.span("stage/pipeline/bridges", stream=stream, n_bucket=16):
        with tr.span("stage/tour", stream=torch.device(stream)
                     if isinstance(stream, str) else stream):
            pass
        with tr.span("kernel/forest/boruvka"):
            pass
    spans = tr.spans()
    for s in spans[:2]:
        assert s["attrs"]["device_t0"] == s["t0"]
        assert s["attrs"]["device_ms"] == 1e3 * s["dur"]
    assert set(spans[0]["attrs"]) == {"n_bucket", "device_t0", "device_ms"}
    assert "device_t0" not in spans[2]["attrs"]
    doc = tr.chrome_trace()
    card = [ev for ev in doc["traceEvents"] if ev.get("tid") == 1]
    assert [ev["name"] for ev in card if ev["ph"] == "X"] == [
        "stage/pipeline/bridges", "stage/tour"]
    assert [ev["args"]["name"] for ev in doc["traceEvents"]
            if ev["name"] == "thread_name"] == ["host", "card stream"]
    x = next(ev for ev in card if ev["name"] == "stage/tour")
    assert x["ts"] == spans[1]["t0"] * 1e6 and x["dur"] == spans[1]["dur"] * 1e6
    assert json.loads(json.dumps(doc)) == doc


def test_null_tracer_ignores_streams_and_host_syncs():
    """Tracing off: a stream span and a host sync are the one shared no-op
    handle; tracing on, ``host_sync`` opens ``sync/<site>``."""
    null = tobs.NULL_TRACER
    assert null.span("stage/tour", stream=True) is tobs.NULL_SPAN
    assert null("stage/tour", stream="cpu") is tobs.NULL_SPAN
    with tobs.host_sync("h2d") as sp:
        assert sp is tobs.NULL_SPAN
    assert null.spans() == []
    tr = tobs.enable_tracing(tobs.Tracer(clock=_fake_clock()))
    with tobs.host_sync("round/boruvka"):
        pass
    assert [(s["name"], s["attrs"]) for s in tr.spans()] == [
        ("sync/round/boruvka", {})]


def test_count_adds_to_the_counter_the_innermost_span_opened():
    """``count`` adds into the innermost open span's counter where that
    span opened one, and nowhere else; the disabled tracer ignores it."""
    tr = tobs.Tracer(clock=_fake_clock())
    tr.count("staged_bytes", 5)  # no span open
    with tr.span("stage/pad/h2d", bytes=16, staged_bytes=0):
        tr.count("staged_bytes", 4)
        with tr.span("sync/h2d"):
            tr.count("staged_bytes", 100)  # the innermost opened none
        tr.count("staged_bytes", 8)
    with tr.span("stage/pad"):
        tr.count("staged_bytes", 3)
    assert [(s["name"], s["attrs"]) for s in tr.spans()] == [
        ("stage/pad/h2d", {"bytes": 16, "staged_bytes": 12}),
        ("sync/h2d", {}), ("stage/pad", {})]
    assert tobs.NULL_TRACER.count("staged_bytes", 4) is None


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["index"]]


@pytest.mark.parametrize("kind, delete", [("bridges", False),
                                          ("cuts", False),
                                          ("bridges", True),
                                          ("2ecc", False)])
def test_analyze_spans_the_one_shot_pipeline(kind, delete):
    """One traced ``analyze`` call on the CPU: the certificate (where the
    kind has one), the final, its tour state and then the kind's own
    function (``stage/answer/<kind>``) nest in ``stage/pipeline/<kind>``
    as stream spans; every round's exit test is a ``sync/round/boruvka``;
    the copy is ``stage/pad/h2d`` (8 B an edge, none staged) inside
    ``stage/pad``, two ``sync/h2d`` inside it; the answer's copies are
    ``sync/convert``."""
    from repro_torch import analyze

    s, d = _graph(6)
    keys = (s[:2], d[:2]) if delete else None
    tr = tobs.enable_tracing()
    analyze(s, d, N, kind=kind, final="device", device="cpu", delete=keys)
    spans = tr.spans()

    def one(name):
        found = [x for x in spans if x["name"] == name]
        assert len(found) == 1, (name, found)
        return found[0]

    pipe = one(f"stage/pipeline/{kind}")
    final = one(f"stage/final/{kind}")
    tour = one("stage/tour")
    answer = one(f"stage/answer/{kind}")
    certified = kind in ("bridges", "2ecc")
    names = [x["name"] for x in _children(spans, pipe)]
    want = (["stage/tombstone"] if delete else []) + (
        ["stage/certificate_build/2ec"] if certified else []) + [
        f"stage/final/{kind}"]
    assert names == want
    assert _children(spans, final) == [tour, answer]
    for x in [pipe, final, tour, answer] + _children(spans, pipe):
        assert x["attrs"]["device_t0"] == x["t0"]
        assert x["attrs"]["device_ms"] == 1e3 * x["dur"]
    # ``final_ms`` sums the spans under ``stage/final/``: the final alone
    assert [x for x in spans if x["name"].startswith("stage/final/")] == [
        final]
    passes = [x for x in spans if x["name"] == "kernel/forest/boruvka"]
    # the certificate's two forests, the tour's; cuts' aux components and
    # 2ecc's components less the bridges inside the answer
    assert len(passes) == {"bridges": 3, "cuts": 2, "2ecc": 4}[kind]
    if kind != "bridges":
        assert passes[-1]["parent"] == answer["index"]
    rounds = [x for x in spans if x["name"] == "sync/round/boruvka"]
    assert len(rounds) == sum(x["attrs"]["rounds"] for x in passes)
    assert {x["parent"] for x in rounds} == {x["index"] for x in passes}
    pad, h2d = one("stage/pad"), one("stage/pad/h2d")
    assert h2d["parent"] == pad["index"]
    # the CPU takes the plain copy: nothing through a pinned ring
    assert h2d["attrs"] == {"bytes": 8 * len(s), "staged_bytes": 0}
    copies = [x for x in spans if x["name"] == "sync/h2d"]
    assert len(copies) >= 2
    assert [x["name"] for x in _children(spans, h2d)] == ["sync/h2d"] * 2
    convert = one("stage/convert")
    assert [x["name"] for x in _children(spans, convert)] == (
        ["sync/convert"] * (3 if kind == "bridges" else 1))
    syncs = {x["name"] for x in spans if x["name"].startswith("sync/")}
    assert syncs == {"sync/round/boruvka", "sync/h2d", "sync/convert"}
    seg = one("kernel/segment_min")
    assert seg["attrs"]["segments"] == pipe["attrs"]["n_bucket"]
    assert 0 < seg["attrs"]["live"] <= seg["attrs"]["keys"]
    assert not any(isinstance(v, torch.Tensor)
                   for x in spans for v in x["attrs"].values())
