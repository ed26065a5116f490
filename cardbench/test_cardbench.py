"""CPU tests of the benchmark: the manifest and its parts found by name,
the result line of every traffic mix on a tiny graph, the plain reference
against the planted truth and networkx, the byte counts, the control, the
checks against planted faults, and the modules a run holds.

The ``check_*`` rules hold for any manifest, so that a cell joins by
files and appended entries alone (``test_adding_a_cell.py``). A tiny run
draws a cell's graph at its configuration's ``tiny`` sizes with its own
generator, or at ``TINY`` where it has none. ``tiny`` is also a
configuration these tests add under a root of their own: the harness
finds it beside the benchmark's own parts."""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cardbench import graphs, harness, percentiles, roofline
from cardbench.control import control_answer, control_run
from cardbench.parts import BENCH_DIR, find, load_json, load_module, names
from cardbench.reference import connectivity as reference

ROOT = BENCH_DIR.parent
MANIFEST = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"name": "tiny", "graph": "planted_bridge_graph", "n_nodes": 700,
        "n_edges": 14000, "n_bridges": 6}


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding the ``tiny`` configuration, searched first."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY))
    return (tmp_path, BENCH_DIR)


def tiny_config(config: dict) -> dict:
    """A configuration's CPU sizes: its own ``tiny`` object with its own
    ``graph`` where it carries one, else ``TINY``."""
    if "tiny" not in config:
        return dict(TINY)
    return dict(config["tiny"], name=f"{config['name']}.tiny",
                graph=config["graph"])


def tiny_cell(workload: str, roots, manifest=MANIFEST) -> harness.Cell:
    cell = harness.resolve_cell(manifest, workload, roots)
    return dataclasses.replace(cell, config=tiny_config(cell.config))


# ------------------------------------------------------------- the manifest
def check_manifest(m: dict) -> None:
    """The contract's keys, names and lists, for any manifest: every list
    of cells names cells of the manifest, and a metric without one is
    every cell's."""
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["cardbench"]
    assert not any(w.startswith("/") or ".." in w for w in m["command"])
    assert 1 <= m["run_seconds"] <= 51
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    cells = [w["name"] for w in m["workloads"]]
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        for cell in metric.get("workloads", cells):
            assert cell in cells, \
                f"{metric['name']} lists {cell!r}, which is no cell"
    for cell in cells:
        own = {e["name"] for e in m["end_to_end"]
               if cell in e.get("workloads", cells)}
        assert "setup_s" in own and len(own) >= 2, cell
        assert any(cell in e.get("workloads", cells)
                   for e in m["per_layer"]), cell
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        for cell in metric.get("workloads", cells):
            assert cell in e2e[metric["moves"]].get("workloads", cells)


def check_parts(m: dict, roots=(BENCH_DIR,)) -> None:
    """Every part a manifest names is found by name under ``roots``."""
    configs = {c["name"] for c in m["configs"]}
    assert configs <= set(names("configs", roots))
    for c in m["configs"]:
        path = find("configs", c["name"], roots)
        # the file the harness reads, relative to its checkout's root
        assert path.relative_to(path.parents[2]).as_posix() == c["file"]
        assert c["file"].startswith("cardbench/")
        assert isinstance(load_json(path).get("tiny", {}), dict)
    for w in m["workloads"]:
        # One process on one card: the harness reads the peak of one
        # device and starts no process per rank, so a four-chip cell (the
        # M-machine merge over NCCL across cards) brings those with it.
        assert w["config"] in configs and w["chips"] == 1
        traffic = load_json(find("traffic", w["traffic"], roots))
        assert traffic["client"] in names("clients", roots)
    assert configs == {w["config"] for w in m["workloads"]}
    for metric in m["end_to_end"] + m["per_layer"]:
        assert metric["name"] in names("metrics", roots)
    for c in configs:
        graph = load_json(find("configs", c, roots))["graph"]
        assert graph in names("generators", roots)


def test_manifest_keys_and_names():
    check_manifest(MANIFEST)


def test_every_part_is_found_by_name():
    check_parts(MANIFEST)


def test_added_parts_are_listed(tmp_path):
    """A later change adds a part by adding a file: the harness lists it
    and resolves a cell made of it, beside the existing ones."""
    for kind, text in (
            ("configs", json.dumps(dict(TINY, name="dummy"))),
            ("traffic", json.dumps({"client": "dummy"})),
            ("clients", "class Client:\n    pass\n"),
            ("generators", "def make(config, g):\n    return None\n"),
            ("metrics", "def read(run):\n    return 1.5\n")):
        (tmp_path / kind).mkdir()
        name = "dummy_metric" if kind == "metrics" else "dummy"
        suffix = ".json" if kind in ("configs", "traffic") else ".py"
        (tmp_path / kind / f"{name}{suffix}").write_text(text)
    roots = (BENCH_DIR, tmp_path)
    for kind in ("configs", "traffic", "clients", "generators"):
        assert "dummy" in names(kind, roots)
        assert set(names(kind)) < set(names(kind, roots))
    assert "dummy_metric" in names("metrics", roots)
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "dummy.cell", "config": "dummy",
                                  "traffic": "dummy", "chips": 1})
    manifest["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                                  "workloads": ["dummy.cell"]})
    cell = harness.resolve_cell(manifest, "dummy.cell", roots)
    assert cell.config["name"] == "dummy" and cell.traffic["client"] == "dummy"
    run = harness.Run(cell=cell, setup_s=1.0, window_s=1.0, latencies_s=[],
                      attempted=0, failed=0, peak_bytes=None, launches={},
                      facts={})
    got = harness.read_metrics(run, cell.per_layer, roots)
    assert got["dummy_metric"] == {"value": 1.5, "unit": "ms"}


# ------------------------------------------------------------- a tiny run
def tiny_run(cell: harness.Cell, seed: int, trace: int,
             roots=(BENCH_DIR,), seconds: float = 0.3):
    """A run of ``cell`` on the CPU, and the kernel launches the program
    counted in it."""
    from repro_torch.kernels import launch_counts

    before = sum(launch_counts().values())
    result = harness.run_cell(cell, seed, seconds, bool(trace), "cpu",
                              roots=roots)
    return result, sum(launch_counts().values()) - before


def check_result_line(cell: harness.Cell, result: dict, trace: int,
                      roots=(BENCH_DIR,), launches: int = 0) -> None:
    """A tiny run's result line, for any cell: correct, its metrics those
    the cell gets. Traced, some span metric reads, and every span or
    counter reader whose list names the cell reads something: a metric
    with no list may find nothing in a cell that lacks its spans. Exempt:
    readers of the card's profile (``device_trace``), and counter readers
    on a run that launched no kernel (the CPU runs the plain versions)."""
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert result["checks"]["failed_requests"] == {"value": 0, "limit": 0}
    listed = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in listed}
    for m in listed:
        if m["name"] in result["metrics"]:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert any(m["source"] == "program_span" and
                   m["name"] in result["metrics"] for m in listed)
        readers = ("program_span", "program_counter") if launches else (
            "program_span",)
        silent = [m["name"] for m in listed
                  if cell.name in m.get("workloads", ())
                  and m["source"] in readers
                  and m["name"] not in result["metrics"]]
        assert not silent, \
            f"{cell.name} lists {silent}, which read nothing on its tiny run"
    else:
        # every end-to-end metric on the host's clock reads, save the
        # card's memory; the card's profile is read on a card alone
        assert "setup_s" in result["metrics"]
        assert {m["name"] for m in listed if m["source"] == "host_clock"
                and m["name"] != "peak_device_bytes"} <= \
            set(result["metrics"])
    json.dumps(result)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_shape(workload, trace, tiny_root):
    cell = tiny_cell(workload, tiny_root)
    result, launches = tiny_run(cell, 2**31 + 7, trace, tiny_root)
    check_result_line(cell, result, trace, tiny_root, launches)


class _Profile:
    """A card's profile as a reader sees it."""

    def __init__(self, busy_s: float):
        self._summary = {"busy_s": busy_s, "window_s": 2.0}

    def summary(self, spans=()):
        return self._summary

    def busy_s(self):
        return self._summary["busy_s"]


@pytest.mark.parametrize("name, profile, attempted, want", [
    ("card_ms_per_req", _Profile(0.5), 4, 125.0),
    ("card_ms_per_req", None, 4, None),
    ("card_ms_per_req", _Profile(0.5), 0, None),
    ("requests_per_s", None, 4, 2.0),
    ("host_requests_per_s", _Profile(0.5), 4, 2.0),
    ("host_latency_p95_ms", None, 4, 400.0),
    ("host_latency_p95_ms", None, 0, None),
])
def test_window_readers(name, profile, attempted, want):
    """The readers of the window as a whole: the card's busy time over
    the requests, none without a profile (the CPU) or a request; the rate
    and the nearest-rank tail on the host's clock."""
    cell = harness.resolve_cell(MANIFEST, CELLS[0])
    run = harness.Run(cell=cell, setup_s=1.0, window_s=2.0,
                      latencies_s=[0.1, 0.2, 0.3, 0.4][:attempted],
                      attempted=attempted, failed=0, peak_bytes=None,
                      launches={}, facts={}, trace=profile)
    got = load_module(find("metrics", name)).read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_cuda_wanted_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------- the reference
def test_reference_finds_the_planted_truth():
    g = graphs.make(dict(TINY, n_nodes=2000, n_edges=40000),
                    graphs.generator(5, "cpu"))
    got = reference.analyze(g.src.numpy(), g.dst.numpy(), g.n_nodes)
    assert got["bridges"] == g.bridges
    assert got["cuts"] == {v for pair in g.bridges for v in pair}
    assert got["forest_edges"] == g.n_nodes - 1


@pytest.mark.parametrize("seed", range(4))
def test_reference_agrees_with_networkx(seed):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(2, 120))
        m = int(rng.integers(0, 3 * n))
        src = rng.integers(0, n, m).astype(np.int32)
        dst = rng.integers(0, n, m).astype(np.int32)
        got = reference.analyze(src, dst, n)
        multi = nx.MultiGraph(list(zip(src.tolist(), dst.tolist())))
        simple = nx.Graph(multi)
        simple.remove_edges_from(nx.selfloop_edges(simple))
        bridges = {(min(u, v), max(u, v)) for u, v in nx.bridges(simple)
                   if multi.number_of_edges(u, v) == 1}
        assert got["bridges"] == bridges
        assert got["cuts"] == set(nx.articulation_points(simple))


def test_generator_draws_the_planted_law():
    cfg = dict(TINY, n_nodes=1400, n_edges=30000)
    a = graphs.make(cfg, graphs.generator(9, "cpu"))
    b = graphs.make(cfg, graphs.generator(9, "cpu"))
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    key = torch.minimum(a.src, a.dst).long() * 1400 + torch.maximum(
        a.src, a.dst)
    assert bool((key[1:] > key[:-1]).all())  # sorted, one copy each
    assert bool((a.src != a.dst).all())
    assert 24000 < a.src.numel() <= 30000 + 1400
    assert [s for s, _ in a.blobs] == [0, 200, 400, 600, 800, 1000, 1200]


# ------------------------------------------------------------ byte counts
def test_byte_counts():
    # the first Borůvka round at the Fig. 2 point: 2^24 slots, 2^17
    # vertices, the 10,028,352 live slots of the port's own generator at
    # seed 0 -- chip_smoke.py's 0.02927 ms bound
    nbytes = roofline.boruvka_round_bytes(2**24, 2**17, 10_028_352)
    assert nbytes == 98_052_608
    assert round(nbytes / roofline.HBM_BYTES_PER_S * 1e3, 5) == 0.02927
    # the tour of the Fig. 2 certificate: both arcs of 2(n_bucket - 1)
    # slots, a spanning tree's 2(n - 1) of them live, 2^17 segments
    assert roofline.segment_min_bytes(4 * (2**17 - 1), 2 * 99_999,
                                      2**17) == 3_421_416
    assert roofline.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.roofline_pct(1.0, 0.0) is None


def test_statistics():
    assert percentiles.percentile(range(1, 101), 95) == 95
    assert percentiles.percentile([3.0], 95) == 3.0
    assert percentiles.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert percentiles.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


# --------------------------------------------------------- control, faults
def test_control_fails_the_check():
    n = 70_000  # ids past int16's range, as at the cells' sizes
    cfg = dict(TINY, n_nodes=n, n_edges=6 * n)
    g = graphs.make(cfg, graphs.generator(3, "cpu"))
    src, dst = g.src.numpy(), g.dst.numpy()
    assert control_answer(src, dst, n, "bridges", "cpu") != g.bridges
    assert control_answer(src, dst, n, "cuts", "cpu") != {
        v for pair in g.bridges for v in pair}


@pytest.mark.parametrize("workload", ["fig2_dense.oneshot_bridges",
                                      "fig2_dense.oneshot_cuts"])
def test_control_run_is_not_correct(workload, tiny_root, monkeypatch):
    """The control in the program's place, judged by the harness's own
    comparison, comes out ``correct: false``."""
    import repro_torch

    import cardbench.control as control

    # the tiny graph fits int16: narrow its ids to 8 bits instead
    monkeypatch.setattr(control, "ID_BITS", 8)
    real = repro_torch.analyze
    result = control_run(tiny_cell(workload, tiny_root), 11, 0.3, "cpu",
                         tiny_root)
    assert repro_torch.analyze is real
    assert result["correct"] is False and result["failed"] == 0
    wrong = result["checks"]["wrong_answers"]["value"]
    assert 1 <= wrong <= result["attempted"]


def _drop_one(answer):
    answer = set(answer)
    answer.pop()
    return answer


def _raises(real):
    """Every call of the window raises instead of answering (the traffic's
    two warm calls answer)."""
    calls = []

    def call(src, dst, n, **kw):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("planted fault")
        return real(src, dst, n, **kw)
    return call


FAULTS = {
    "answer_altered": lambda real: lambda src, dst, n, **kw:
        _drop_one(real(src, dst, n, **kw)),
    "half_the_edges": lambda real: lambda src, dst, n, **kw:
        real(src[: len(src) // 2], dst[: len(dst) // 2], n, **kw),
    "request_raises": _raises,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["fig2_dense.oneshot_bridges",
                                      "fig2_dense.oneshot_cuts"])
def test_oneshot_faults_fail_the_check(workload, fault, tiny_root,
                                       monkeypatch):
    import repro_torch

    monkeypatch.setattr(repro_torch, "analyze",
                        FAULTS[fault](repro_torch.analyze))
    cell = tiny_cell(workload, tiny_root)
    result = harness.run_cell(cell, 21, 0.3, False, "cpu", roots=tiny_root)
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] >= 1
    if fault == "request_raises":
        assert result["checks"]["failed_requests"]["value"] == \
            result["failed"] >= 1


FLAKY = """
class Client:
    def __init__(self, config, traffic, g, device, seed, roots):
        pass

    def warm(self):
        pass

    def request(self, i):
        def call():
            if i == 0:
                raise RuntimeError("planted fault")
            return i
        return call

    def close(self):
        pass

    def check(self, answers):
        return {"wrong_answers": {"value": 0, "limit": 0}}, {}
"""


def test_a_request_that_raises_is_not_correct(tiny_root):
    """A client whose own check finds nothing wrong still fails the run
    when a request raised."""
    root = tiny_root[0]
    (root / "clients").mkdir()
    (root / "clients" / "flaky.py").write_text(FLAKY)
    (root / "traffic").mkdir()
    (root / "traffic" / "flaky.json").write_text('{"client": "flaky"}')
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "tiny.flaky", "config": "tiny",
                                  "traffic": "flaky", "chips": 1})
    cell = harness.resolve_cell(manifest, "tiny.flaky", tiny_root)
    result = harness.run_cell(cell, 5, 0.05, False, "cpu", roots=tiny_root)
    assert result["failed"] == 1 and result["attempted"] >= 1
    assert result["checks"] == {
        "failed_requests": {"value": 1, "limit": 0},
        "wrong_answers": {"value": 0, "limit": 0}}
    assert result["correct"] is False


# ------------------------------------------------------------ the imports
def test_a_run_holds_no_jax_and_no_reference_package(tmp_path):
    """In a fresh interpreter: a tiny run leaves no ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` module (top-level names compared whole)."""
    script = (
        "import json, sys\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from cardbench import harness\n"
        "from cardbench.test_cardbench import CELLS, tiny_cell\n"
        "for name in CELLS:\n"
        "    cell = tiny_cell(name, (harness.BENCH_DIR,))\n"
        "    r = harness.run_cell(cell, 4, 0.2, True, 'cpu')\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    pattern = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", re.M)
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tops = set(pattern.findall(path.read_text()))
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in BENCH_DIR.rglob("*.py"):
        tops = set(pattern.findall(path.read_text()))
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, path


def test_forbidden_names_compare_whole():
    held = ["repro_torch", "repro_torch.core.api", "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core.api", "jax"]) == [
        "jax", "repro"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_the_card(workload, card, tiny_root):
    cell = tiny_cell(workload, tiny_root)
    result = harness.run_cell(cell, 2**31 + 99, 0.5, True, card,
                              roots=tiny_root)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_untraced_tiny_cell_reads_the_card_time(workload, card, tiny_root):
    """An untraced run on the card profiles the card alone, and reads
    its busy milliseconds a request from that profile."""
    cell = tiny_cell(workload, tiny_root)
    result = harness.run_cell(cell, 2**31 + 98, 0.5, False, card,
                              roots=tiny_root)
    assert result["correct"] is True
    ms = result["metrics"]["card_ms_per_req"]["value"]
    assert 0 < ms <= 1e3 * 0.6 * 2 / result["attempted"]
    assert "busy_s" not in result["device"] and "breakdown" not in result


def test_spread_summary():
    from cardbench.spread import summarize

    def rec(k, seed, value, correct=True):
        return {"workload": "w", "set": k, "seed": seed, "trace": 0,
                "result": {"correct": correct, "metrics": {
                    "m": {"value": value, "unit": "s"}}}}

    values = [[10.0, 10.1, 9.9, 10.2, 9.8, 13.0],
              [10.0, 10.1, 9.9, 10.2, 9.8, 10.0]]
    records = [rec(k, i, v) for k, vs in enumerate(values)
               for i, v in enumerate(vs)] + [rec(0, 9, 1.0, False)]
    got = summarize(records)["w"]
    assert got["not_correct"] == 1
    row = got["metrics"]["m"]
    assert row["medians"] == [10.05, 10.0]
    assert row["spreads"][0] == pytest.approx(percentiles.spread(values[0]))
    # the far run of set 0 (13.0) is left out of the tight reading
    assert row["trimmed_mean"] < row["spreads"][0]
    assert row["five_times_widest"] == pytest.approx(
        5 * max(row["spreads"] + [row["all_runs"]]))
