"""CPU tests of the Graph 500 cell's parts: the Kronecker generator's law,
the plain 2-edge-connected reference against networkx, the port's labels
against the reference, the client's carry of the labels to relabelled
copies, its check against planted faults and the control, and the spans a
traced tiny run of the cell reports."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench import graphs, harness
from cardbench.clients.oneshot_labels import carry_labels
from cardbench.control import narrowed
from cardbench.control_labels import control_run
from cardbench.generators.graph500_kronecker import kronecker_edges
from cardbench.parts import BENCH_DIR, find, load_json
from cardbench.reference import two_ecc
from cardbench.test_cardbench import tiny_cell

CELL = "graph500_s24.oneshot_2ecc"
CONFIG = load_json(find("configs", "graph500_s24"))
INITIATOR = CONFIG["initiator"]


def _kronecker(scale: int, seed: int):
    config = {"graph": "graph500_kronecker", "scale": scale,
              "edgefactor": 16, "initiator": INITIATOR,
              "n_nodes": 1 << scale, "n_edges": 16 << scale}
    g = graphs.make(config, graphs.generator(seed, "cpu"))
    return g.src.numpy(), g.dst.numpy(), g.n_nodes


def _nx_labels(src, dst, n: int) -> np.ndarray:
    """Smallest vertex id of each vertex's component once the bridges of
    multiplicity one are cut, by networkx."""
    nx = pytest.importorskip("networkx")
    multi = nx.MultiGraph()
    multi.add_nodes_from(range(n))
    multi.add_edges_from(zip(np.asarray(src).tolist(),
                             np.asarray(dst).tolist()))
    simple = nx.Graph(multi)
    simple.remove_edges_from(nx.selfloop_edges(simple))
    simple.remove_edges_from([(u, v) for u, v in nx.bridges(simple)
                              if multi.number_of_edges(u, v) == 1])
    want = np.arange(n)
    for comp in nx.connected_components(simple):
        want[list(comp)] = min(comp)
    return want


#: hand cases: (edges, n, labels)
HAND = {
    # a pair of two copies is no bridge; its single neighbour's edge is
    "parallel_pair": ([(0, 1), (1, 0), (1, 2)], 3, [0, 0, 2]),
    # a self-loop closes no cycle with another vertex
    "self_loop": ([(0, 0), (0, 1), (1, 2), (2, 0), (2, 3)], 4,
                  [0, 0, 0, 3]),
    # isolated vertices label themselves, a triangle its least vertex
    "isolated": ([(3, 1), (1, 2), (2, 3)], 6, [0, 1, 1, 1, 4, 5]),
}


def _hand(name):
    edges, n, labels = HAND[name]
    src = np.array([u for u, _ in edges], np.int32)
    dst = np.array([v for _, v in edges], np.int32)
    return src, dst, n, np.array(labels)


# ------------------------------------------------------------ the generator
def test_the_configuration_holds_what_the_generator_reads():
    for sizes in (CONFIG, CONFIG["tiny"]):
        assert sizes["n_nodes"] == 1 << sizes["scale"]
        assert sizes["n_edges"] == sizes["edgefactor"] << sizes["scale"]
        assert sizes["initiator"] == [0.57, 0.19, 0.19, 0.05]
    assert (CONFIG["scale"], CONFIG["edgefactor"]) == (24, 16)
    assert CONFIG["graph"] == "graph500_kronecker"


def test_generator_draws_the_specified_graph():
    scale = 12
    src, dst, n = _kronecker(scale, 2**31 + 3)
    assert n == 1 << scale and len(src) == len(dst) == 16 << scale
    assert src.dtype == dst.dtype == np.int32
    assert 0 <= min(src.min(), dst.min()) and max(src.max(), dst.max()) < n
    assert (src == dst).any()  # self-loops kept
    key = np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst)
    assert len(np.unique(key)) < len(key)  # duplicates kept
    again = _kronecker(scale, 2**31 + 3)
    assert np.array_equal(again[0], src) and np.array_equal(again[1], dst)


def test_the_top_bit_falls_in_the_initiators_quadrants():
    """Each bit of ``(i, j)`` before the permutation lands in quadrant
    (0, 0), (0, 1), (1, 0), (1, 1) with probability A, B, C, D: the top
    bit's shares lie within 4 binomial standard errors of them."""
    scale = 12
    i, j = kronecker_edges(scale, 16, INITIATOR,
                           graphs.generator(2**31 + 9, "cpu"))
    m = i.numel()
    top = scale - 1
    ii, jj = (i >> top) & 1, (j >> top) & 1
    for (a, b), p in zip([(0, 0), (0, 1), (1, 0), (1, 1)], INITIATOR):
        share = float(((ii == a) & (jj == b)).sum()) / m
        assert abs(share - p) <= 4 * (p * (1 - p) / m) ** 0.5, (a, b)
    assert int(i.max()) < 1 << scale and int(j.min()) >= 0


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("scale", range(4, 11))
def test_reference_agrees_with_networkx(scale):
    src, dst, n = _kronecker(scale, 2**31 + scale)
    got = two_ecc.analyze(src, dst, n)
    assert np.array_equal(got["labels"], _nx_labels(src, dst, n))


@pytest.mark.parametrize("case", sorted(HAND))
def test_reference_on_hand_cases(case):
    src, dst, n, want = _hand(case)
    assert np.array_equal(_nx_labels(src, dst, n), want)
    assert np.array_equal(two_ecc.analyze(src, dst, n)["labels"], want)


# --------------------------------------------------------------- the port
@pytest.mark.parametrize("final", ["device", "host"])
@pytest.mark.parametrize("graph", ["kronecker_8", "kronecker_10",
                                   "kronecker_12", *sorted(HAND)])
def test_port_labels_equal_the_reference(graph, final):
    from repro_torch import analyze

    if graph.startswith("kronecker_"):
        scale = int(graph.split("_")[1])
        src, dst, n = _kronecker(scale, 2**31 + 40 + scale)
    else:
        src, dst, n, _ = _hand(graph)
    got = analyze(src, dst, n, kind="2ecc", final=final, device="cpu")
    assert np.array_equal(got, two_ecc.analyze(src, dst, n)["labels"])


def test_carry_to_copies_equals_the_reference_on_each_copy():
    src, dst, n = _kronecker(8, 2**31 + 77)
    g = graphs.generator(2**31 + 78, "cpu")
    perms = graphs.relabelings(n, 4, g)
    copies = [(p[torch.as_tensor(src).long()].numpy(),
               p[torch.as_tensor(dst).long()].numpy()) for p in perms]
    labels = torch.as_tensor(two_ecc.analyze(*copies[0], n)["labels"])
    inv0 = torch.argsort(perms[0])
    for perm, (s, d) in zip(perms, copies):
        want = two_ecc.analyze(s, d, n)["labels"]
        assert np.array_equal(carry_labels(labels, perm[inv0]), want)
    # a class's label is not its old label mapped
    assert not np.array_equal(carry_labels(labels, perms[1][inv0]),
                              perms[1][inv0][labels].numpy())


# ------------------------------------------------------ the check, faults
def _altered(real):
    def call(src, dst, n, **kw):
        out = real(src, dst, n, **kw)
        out[n // 2] = (out[n // 2] + 1) % n
        return out
    return call


def _narrowed(real):
    import cardbench.control as control

    def call(src, dst, n, **kw):
        s, d = narrowed(src, dst)
        return real(s, d, max(n, 1 << control.ID_BITS), **kw)[:n]
    return call


def _raises(real):
    calls = []

    def call(src, dst, n, **kw):
        calls.append(1)
        if len(calls) > 2:  # the traffic's two warm calls answer
            raise RuntimeError("planted fault")
        return real(src, dst, n, **kw)
    return call


FAULTS = {"one_label_changed": _altered, "narrowed_ids": _narrowed,
          "request_raises": _raises}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_fail_the_check(fault, monkeypatch):
    import repro_torch

    import cardbench.control as control

    # the tiny graph's ids fit int16: narrow them to 8 bits instead
    monkeypatch.setattr(control, "ID_BITS", 8)
    monkeypatch.setattr(repro_torch, "analyze",
                        FAULTS[fault](repro_torch.analyze))
    cell = tiny_cell(CELL, (BENCH_DIR,))
    result = harness.run_cell(cell, 2**31 + 23, 0.3, False, "cpu")
    assert result["correct"] is False
    wrong = result["checks"]["wrong_answers"]["value"]
    assert 1 <= wrong <= result["attempted"]
    if fault == "request_raises":
        assert result["checks"]["failed_requests"]["value"] == \
            result["failed"] >= 1


def test_control_run_is_not_correct(monkeypatch):
    """The reference one precision down in the program's place, judged by
    the harness's own comparison, comes out ``correct: false``."""
    import repro_torch

    import cardbench.control as control

    monkeypatch.setattr(control, "ID_BITS", 8)
    real = repro_torch.analyze
    result = control_run(tiny_cell(CELL, (BENCH_DIR,)), 2**31 + 29, 0.3,
                         "cpu")
    assert repro_torch.analyze is real
    assert result["correct"] is False and result["failed"] == 0
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"]


# --------------------------------------------------------------- the spans
def test_traced_tiny_run_reports_the_label_spans():
    """The cell's traced tiny run reports the stream spans of the one-shot
    device final and the copy, as ``spans_of`` holds the ``oneshot``
    client's cells to, and its own two span readers; the labels and the
    tour lie inside the final."""
    cell = tiny_cell(CELL, (BENCH_DIR,))
    result = harness.run_cell(cell, 2**31 + 31, 0.3, True, "cpu")
    assert result["correct"] is True, result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    want = {"pipeline_ms.graph500", "labels_ms", "final_ms", "tour_ms",
            "h2d_copy_ms", "host_syncs_per_req"}
    assert want <= set(got), want - set(got)
    assert all(got[k] > 0 for k in want)
    assert got["tour_ms"] + got["labels_ms"] <= got["final_ms"] * 1.001
    assert got["final_ms"] <= got["pipeline_ms.graph500"] * 1.001
    # four Borůvka passes' rounds, two copies, one copy of the answer
    assert got["host_syncs_per_req"] >= 7
