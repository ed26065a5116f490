"""A cell joins the benchmark by addition alone.

On a copy of the manifest, with a root of its own beside the benchmark's:
a made-up configuration with its own generator and ``tiny`` sizes, two
one-chip cells of it, one on the ``oneshot_bridges`` traffic and one on
an added traffic of the host final, a ``certificate_ms`` entry of its own
name for the first, and one per-layer metric that lists only the first.
Every rule the tests hold the manifest to passes on the copy, the cells'
tiny runs are correct, and each reports the metrics that carry no list
and whose spans it has, without any entry touched. The rules fail on a
list that names no cell, and on a span reader (or, on a run that
launched kernels, a counter reader) whose list names a cell but that
reads nothing on its tiny run; a reader with no list may read nothing."""
from __future__ import annotations

import json

import pytest

from cardbench import graphs, harness
from cardbench.parts import BENCH_DIR
from cardbench.reference import connectivity as reference
from cardbench.test_cardbench import (MANIFEST, check_manifest, check_parts,
                                      check_result_line, tiny_cell, tiny_run)
from cardbench.test_span_readers import check_new_metrics, check_span_lists

#: names no entry of the manifest takes
CONFIG = "made_up_cycles"
CELL = "made_up_cycles.oneshot_bridges"
HOST = "made_up_bridges_host"
HOST_CELL = f"made_up_cycles.{HOST}"
METRIC = "made_up_spans_per_req"
CERTIFICATE = "certificate_ms.made_up_cycles"
SILENT_METRIC = "made_up_silent"

GENERATOR = '''"""Cycles of ``block`` vertices filled with uniform chords,
each joined to the next by one bridge, and ``leaves`` pendant vertices
hung on uniform vertices of the cycles: one copy of each pair, no
self-pair."""
import torch

from cardbench.graphs import Graph


def make(config, g):
    dev = g.device
    blocks, block = config["n_blocks"], config["block"]
    core = blocks * block
    n = core + config["leaves"]
    src, dst = [], []
    for b in range(blocks):
        cycle = torch.randperm(block, generator=g, device=dev) + b * block
        src += [cycle, b * block + torch.randint(
            0, block, (config["chords"],), generator=g, device=dev)]
        dst += [cycle.roll(1), b * block + torch.randint(
            0, block, (config["chords"],), generator=g, device=dev)]
    hubs = torch.arange(blocks - 1, device=dev) * block
    leaves = torch.arange(core, n, device=dev)
    anchors = torch.randint(0, core, (n - core,), generator=g, device=dev)
    src += [hubs, leaves]
    dst += [hubs + block, anchors]
    src, dst = torch.cat(src), torch.cat(dst)
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    key = torch.unique(lo[lo != hi] * n + hi[lo != hi])
    bridges = {(int(u), int(u) + block) for u in hubs}
    bridges |= {(int(min(a, v)), int(max(a, v)))
                for a, v in zip(anchors.tolist(), leaves.tolist())}
    return Graph((key // n).int(), (key % n).int(), n,
                 [(b * block, block) for b in range(blocks)], bridges)
'''

SPANS_PER_REQ = '''"""Made up for the test: the program's spans per request."""


def read(run):
    if not run.spans or not run.attempted:
        return None
    return len(run.spans) / run.attempted
'''

SILENT = '''def read(run):
    return None
'''

CERTIFICATE_MS = '''"""The certificate's stream time per request, for the made-up cells."""
from cardbench.stream_spans import per_request_device_ms


def read(run):
    return per_request_device_ms(
        run, lambda name: name.startswith("stage/certificate_build/"))
'''


def _write(root, kind, name, text):
    (root / kind).mkdir(parents=True, exist_ok=True)
    (root / kind / name).write_text(text)


@pytest.fixture
def added(tmp_path):
    """The copy of the manifest with the cell added, and the roots that
    find its parts: the made-up ones first, then the benchmark's."""
    root = tmp_path / "cardbench"
    _write(root, "configs", f"{CONFIG}.json", json.dumps({
        "name": CONFIG, "source": "made up for the test",
        "graph": CONFIG, "n_blocks": 64, "block": 4096, "chords": 65536,
        "leaves": 8192,
        "tiny": {"n_blocks": 5, "block": 120, "chords": 600,
                 "leaves": 40}}))
    _write(root, "generators", f"{CONFIG}.py", GENERATOR)
    _write(root, "metrics", f"{METRIC}.py", SPANS_PER_REQ)
    _write(root, "metrics", f"{CERTIFICATE}.py", CERTIFICATE_MS)
    _write(root, "traffic", f"{HOST}.json", json.dumps({
        "client": "oneshot", "loop": "closed, one client",
        "kind": "bridges", "final": "host", "variants": 4,
        "warm_calls": 2}))
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({
        "name": CONFIG, "source": "made up for the test",
        "file": f"cardbench/configs/{CONFIG}.json", "reduced": [],
        "why": "chained cycles with pendant leaves"})
    m["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "oneshot_bridges",
        "chips": 1, "why": "one-shot bridges on a graph of many bridges"})
    m["workloads"].append({
        "name": HOST_CELL, "config": CONFIG, "traffic": HOST, "chips": 1,
        "why": "the same bridges, answered by the host final"})
    m["per_layer"].append({
        "name": METRIC, "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "host syncs",
        "moves": "card_ms_per_req", "workloads": [CELL]})
    m["per_layer"].append({
        "name": CERTIFICATE, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "certificate",
        "moves": "card_ms_per_req", "workloads": [CELL]})
    return m, (root, BENCH_DIR)


def _traced_tiny_run(m, roots, trace=True, workload=CELL):
    cell = tiny_cell(workload, roots, m)
    return (cell, *tiny_run(cell, 2**31 + 17, trace, roots))


def test_the_copy_only_appends(added):
    m, _ = added
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert m[group][:len(MANIFEST[group])] == MANIFEST[group]
    assert len(m["workloads"]) == len(MANIFEST["workloads"]) + 2


def test_the_added_generator_draws_its_bridges(added):
    """The made-up graph has answers to get right: the reference finds
    the bridges it planted."""
    m, roots = added
    config = tiny_cell(CELL, roots, m).config
    g = graphs.make(config, graphs.generator(2**31 + 5, "cpu"), roots)
    got = reference.analyze(g.src.numpy(), g.dst.numpy(), g.n_nodes)
    assert got["bridges"] == g.bridges and len(g.bridges) == 4 + 40


def test_an_added_cell_passes_the_manifest_rules(added):
    m, roots = added
    check_manifest(m)
    check_parts(m, roots)
    check_span_lists(m, roots)


#: what each added cell reports traced, with no list touched
REPORTS = {
    CELL: {"final_ms", "tour_ms", "h2d_copy_ms", "host_syncs_per_req",
           "h2d_staged_pct", METRIC, CERTIFICATE},
    # the host final opens no stream span of the final or its tour
    HOST_CELL: {"h2d_copy_ms", "host_syncs_per_req", "h2d_staged_pct"},
}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [CELL, HOST_CELL])
def test_an_added_cell_runs_correct_and_reports_without_a_list(added,
                                                               workload,
                                                               trace):
    m, roots = added
    cell, result, launches = _traced_tiny_run(m, roots, trace, workload)
    assert cell.config["graph"] == CONFIG and cell.config["block"] == 120
    check_result_line(cell, result, trace, roots, launches)
    if trace:
        check_new_metrics(cell, result)
        assert REPORTS[workload] <= set(result["metrics"])
        if workload == HOST_CELL:
            assert not {"final_ms", "tour_ms", METRIC,
                        CERTIFICATE} & set(result["metrics"])


def test_rules_fail_on_a_list_that_names_no_cell(added):
    m, _ = added
    m["per_layer"][-1]["workloads"].append(f"{CONFIG}.nowhere")
    with pytest.raises(AssertionError, match="which is no cell"):
        check_manifest(m)


def test_rules_fail_on_a_bridge_cell_without_its_certificate_time(added):
    """A bridge cell on the device final that no ``certificate_ms`` entry
    lists fails the span lists' rule."""
    m, roots = added
    m["per_layer"] = [e for e in m["per_layer"] if e["name"] != CERTIFICATE]
    with pytest.raises(AssertionError, match="no certificate_ms entry"):
        check_span_lists(m, roots)


@pytest.mark.parametrize("source", ["program_span", "program_counter",
                                    "device_trace"])
@pytest.mark.parametrize("listed", [True, False])
def test_rules_fail_on_a_reader_that_reads_nothing(added, source, listed):
    """A span reader whose list names a cell must read on its tiny run,
    and so must a counter reader on a run that launched kernels (judged
    here as if this CPU run had launched one); a reader of the card's
    profile reads nothing on the CPU, and a reader with no list may read
    nothing anywhere."""
    m, roots = added
    _write(roots[0], "metrics", f"{SILENT_METRIC}.py", SILENT)
    entry = {"name": SILENT_METRIC, "unit": "ms", "better": "lower",
             "source": source, "layer": "certificate",
             "moves": "card_ms_per_req"}
    if listed:
        entry["workloads"] = [CELL]
    m["per_layer"].append(entry)
    check_manifest(m)
    check_parts(m, roots)
    cell, result, launches = _traced_tiny_run(m, roots)
    assert SILENT_METRIC in {e["name"] for e in cell.per_layer}
    assert launches == 0  # the CPU runs the plain versions
    for launched in (0, 1):
        fails = listed and (source == "program_span" or
                            source == "program_counter" and launched)
        if fails:
            with pytest.raises(AssertionError, match="read nothing"):
                check_result_line(cell, result, 1, roots, launched)
        else:
            check_result_line(cell, result, 1, roots, launched)
