"""CPU tests of the ``h2d_staged_pct`` reader on made-up spans, and of a
traced tiny run of every cell on the CPU, where nothing is staged."""
from __future__ import annotations

import pytest

from cardbench import harness
from cardbench.parts import BENCH_DIR, find, load_module
from cardbench.test_cardbench import CELLS, MANIFEST, tiny_cell

read = load_module(find("metrics", "h2d_staged_pct")).read


def _run(spans):
    cell = harness.resolve_cell(MANIFEST, CELLS[0])
    return harness.Run(cell=cell, setup_s=1.0, window_s=1.0,
                       latencies_s=[0.25] * 2, attempted=2, failed=0,
                       peak_bytes=None, launches={}, facts={}, spans=spans)


def _span(name, **attrs):
    return {"name": name, "t0": 0.0, "dur": 0.01, "depth": 0, "parent": -1,
            "index": 0, "attrs": attrs}


def _h2d(nbytes, staged):
    return _span("stage/pad/h2d", bytes=nbytes, staged_bytes=staged)


@pytest.mark.parametrize("spans, want", [
    ([_h2d(800, 800), _h2d(400, 400)], 100.0),
    ([_h2d(800, 0), _h2d(400, 0)], 0.0),
    ([_h2d(600, 600), _h2d(200, 0)], 75.0),
    ([_span("stage/pad"), _span("sync/h2d")], None),
    ([], None),
    # a program that does not record the attribute
    ([_span("stage/pad/h2d", bytes=800)], None),
])
def test_staged_share_of_the_copied_bytes(spans, want):
    got = read(_run(spans))
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_run_stages_nothing_on_the_cpu(workload):
    """The CPU takes the plain copy: a traced tiny run reads 0."""
    cell = tiny_cell(workload, (BENCH_DIR,))
    assert "h2d_staged_pct" in {m["name"] for m in cell.per_layer}
    result = harness.run_cell(cell, 2**31 + 13, 0.3, True, "cpu")
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["h2d_staged_pct"] == {"value": 0.0, "unit": "%"}
