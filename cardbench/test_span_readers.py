"""CPU tests of the readers of the program's stream spans and host syncs
(``certificate_ms``, ``final_ms``, ``tour_ms``, ``h2d_copy_ms``,
``host_syncs_per_req``): each on a made-up ``harness.Run``, where it finds
its spans and where it finds none, then a traced tiny run of every cell on
the CPU, which reports those whose spans its traffic opens or whose list
names it. On the card (``gpu``): the
profiler's clock as ``devtrace`` maps the program's spans onto it."""
from __future__ import annotations

import statistics

import pytest
import torch

from cardbench import harness
from cardbench.parts import BENCH_DIR, find, load_json, load_module
from cardbench.test_cardbench import CELLS, MANIFEST, tiny_cell

NEW = ("certificate_ms", "final_ms", "tour_ms", "h2d_copy_ms",
       "host_syncs_per_req")


def _reader(name):
    return load_module(find("metrics", name)).read


def _span(name, dur, **attrs):
    return {"name": name, "t0": 0.0, "dur": dur, "depth": 0, "parent": -1,
            "index": 0, "attrs": attrs}


def _run(spans, attempted=4):
    cell = harness.resolve_cell(MANIFEST, CELLS[0])
    return harness.Run(cell=cell, setup_s=1.0, window_s=1.0,
                       latencies_s=[0.25] * attempted, attempted=attempted,
                       failed=0, peak_bytes=None, launches={}, facts={},
                       spans=spans)


#: two requests of a bridge analysis, as the program traces them
SPANS = [
    _span("stage/pad", 0.010), _span("stage/pad/h2d", 0.008, bytes=800),
    _span("sync/h2d", 0.004), _span("sync/h2d", 0.004),
    _span("stage/pipeline/bridges", 0.030, device_t0=1.0, device_ms=29.0),
    _span("stage/certificate_build/2ec", 0.001, device_t0=1.0,
          device_ms=20.0),
    _span("sync/round/boruvka", 0.001), _span("sync/round/boruvka", 0.001),
    _span("stage/final/bridges", 0.001, device_t0=1.02, device_ms=9.0),
    _span("stage/tour", 0.001, device_t0=1.02, device_ms=8.0),
    _span("sync/convert", 0.001),
    _span("stage/pad/h2d", 0.006, bytes=800),
    _span("stage/certificate_build/2ec", 0.001, device_t0=2.0,
          device_ms=22.0),
    _span("stage/final/bridges", 0.001, device_t0=2.02, device_ms=11.0),
    _span("stage/tour", 0.001, device_t0=2.02, device_ms=10.0),
    # a host span of the same name (the live engine's) holds no stream time
    _span("stage/final/bridges", 0.5),
]


@pytest.mark.parametrize("name, want", [
    ("certificate_ms", (20.0 + 22.0) / 2),
    ("final_ms", (9.0 + 11.0) / 2),
    ("tour_ms", (8.0 + 10.0) / 2),
    ("h2d_copy_ms", 1e3 * (0.008 + 0.006) / 2),
    ("host_syncs_per_req", 5 / 2),
])
def test_reader_value_and_none_without_its_spans(name, want):
    read = _reader(name)
    assert read(_run(SPANS, attempted=2)) == pytest.approx(want, rel=1e-12)
    without = [s for s in SPANS if not s["name"].startswith(
        {"certificate_ms": "stage/certificate_build/",
         "final_ms": "stage/final/", "tour_ms": "stage/tour",
         "h2d_copy_ms": "stage/pad/h2d", "host_syncs_per_req": "sync/"}[name])]
    assert read(_run(without, attempted=2)) is None
    assert read(_run([], attempted=2)) is None
    assert read(_run(SPANS, attempted=0)) is None


def _is_certificate_ms(name: str) -> bool:
    """``certificate_ms`` or an entry of its own name for later cells
    (``certificate_ms.<suffix>``), whose list an accepted entry's is not."""
    return name == "certificate_ms" or name.startswith("certificate_ms.")


def check_span_lists(m: dict, roots=(BENCH_DIR,)) -> None:
    """The five readers' entries, for any manifest: each once. The
    certificate's time is read on the cells whose traffic is a bridge
    analysis on the device final, each listed by ``certificate_ms`` or an
    entry ``certificate_ms.<suffix>``, and only on bridge analyses (the
    one-shot path builds no certificate for the vertex kinds' device
    final). The other four carry no list: a cell without their spans
    reads nothing for them."""
    listed = [e["name"] for e in m["per_layer"]]
    for name in NEW:
        assert listed.count(name) == 1, name
    cells = {w["name"]: w for w in m["workloads"]}
    traffic = {c: load_json(find("traffic", w["traffic"], roots))
               for c, w in cells.items()}
    timed = set()
    for e in m["per_layer"]:
        if _is_certificate_ms(e["name"]):
            timed |= set(e.get("workloads", cells))
    for cell in timed:
        assert traffic[cell].get("kind") == "bridges", cell
    for cell, t in traffic.items():
        if (t.get("client"), t.get("kind"), t.get("final")) == (
                "oneshot", "bridges", "device"):
            assert cell in timed, \
                f"no certificate_ms entry lists the bridge cell {cell}"
    entries = {e["name"]: e for e in m["per_layer"]}
    for name in NEW[1:]:
        assert "workloads" not in entries[name], name


def spans_of(traffic: dict) -> set:
    """Those of the four listless readers whose spans every call of
    ``traffic`` opens: the copy and the host syncs on the one-shot path,
    and the final and its tour on its device final."""
    if traffic.get("client") != "oneshot":
        return set()
    if traffic.get("final") == "device":
        return {"final_ms", "tour_ms", "h2d_copy_ms", "host_syncs_per_req"}
    return {"h2d_copy_ms", "host_syncs_per_req"}


def check_new_metrics(cell: harness.Cell, result: dict) -> None:
    """A traced tiny run reports those of the five that the cell gets and
    whose spans it has (its list names it, or its traffic opens them),
    each above 0 wherever read, in their relations."""
    gets = {m["name"]: m for m in cell.per_layer if m["name"] in NEW}
    named = {n for n, m in gets.items() if cell.name in m.get("workloads",
                                                                 ())}
    want = set(gets) & (named | spans_of(cell.traffic))
    got = result["metrics"]
    assert want <= set(got), want - set(got)
    for name in set(gets) & set(got):
        assert got[name]["value"] > 0, name
    if "host_syncs_per_req" in want:
        # rounds, two copies, and one copy of the answer per buffer at least
        assert got["host_syncs_per_req"]["value"] >= 4
    if {"certificate_ms", "final_ms", "pipeline_ms"} <= set(got):
        assert (got["certificate_ms"]["value"] + got["final_ms"]["value"]
                <= got["pipeline_ms"]["value"] * 1.001)
    if {"tour_ms", "final_ms"} <= set(got):
        assert got["tour_ms"]["value"] <= got["final_ms"]["value"]


def test_new_metrics_are_listed_where_their_spans_are():
    check_span_lists(MANIFEST)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_run_reports_the_new_metrics(workload):
    cell = tiny_cell(workload, (BENCH_DIR,))
    result = harness.run_cell(cell, 2**31 + 11, 0.3, True, "cpu")
    assert result["correct"] is True, result["checks"]
    check_new_metrics(cell, result)


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_devtrace_maps_a_span_onto_its_kernel(card, capsys):
    """A synced stream span around one long kernel: mapped by
    ``devtrace``'s offset, its host interval contains the kernel's profiler
    event within 100 us, and so does its stream interval (mapped through
    the tracer's anchor), whose close meets the kernel's end."""
    from cardbench import devtrace
    from repro_torch import obs

    a = torch.randn(8192, 8192, device=card)
    (a @ a).sum().item()
    trace = devtrace.DeviceTrace()
    tr = obs.enable_tracing()
    try:
        with trace.window():
            for _ in range(5):
                with tr.span("stage/long", stream=card) as sp:
                    sp.sync(a @ a)
    finally:
        obs.disable_tracing()
    spans = tr.spans()
    events = sorted(devtrace._device_events(trace._prof))
    kernels = sorted(events, key=lambda e: e[0] - e[1])[:len(spans)]
    kernels.sort()
    off, us = trace.offset_ns, 1e3
    slack = []
    for s, (k0, k1, _) in zip(spans, kernels):
        h0, h1 = s["t0"] * 1e9 + off, (s["t0"] + s["dur"]) * 1e9 + off
        d0 = s["attrs"]["device_t0"] * 1e9 + off
        d1 = d0 + s["attrs"]["device_ms"] * 1e6
        slack.append(((k0 - h0) / us, (h1 - k1) / us, (k0 - d0) / us,
                      (d1 - k1) / us))
    with capsys.disabled():
        print("\nkernel start - host open, host close - kernel end, "
              "kernel start - stream open, stream close - kernel end (us):")
        for row in slack:
            print("  " + ", ".join(f"{v:.1f}" for v in row))
    for k_h0, h1_k, k_d0, d1_k in slack:
        assert k_h0 >= -100 and h1_k >= -100
        assert k_d0 >= -100 and -100 <= d1_k <= 100
    assert statistics.median(r[1] for r in slack) <= 100
