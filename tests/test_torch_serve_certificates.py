"""Port parity of the serving driver (``launch/serve_bridges.py``), part 3:
``--certificate sfs`` and ``--certificate hybrid`` with ``--analysis
all``, the same argv through ``repro.launch.serve_bridges.main`` (JAX on
the CPU) and ``repro_torch.launch.serve_bridges.main(argv,
device="cpu")``: the same report without the clock's values
(``tests/torch_serve_report.py``; tolerance: exact), so the same served
certificates, substrate rows and per-certificate kinds and rebuilds."""
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve_bridges as jserve
import repro_torch.launch.serve_bridges as tserve

from torch_serve_report import clock_free


@pytest.mark.parametrize("certificate", ["sfs", "hybrid"])
def test_certificate_preference_report_matches_reference(certificate):
    argv = ["--smoke", "--analysis", "all", "--certificate", certificate,
            "--verify"]
    want = jserve.main(argv)
    got = tserve.main(argv, device="cpu")
    assert clock_free(got) == clock_free(want)
    served = {row["kind"]: row["certificate"] for row in got["kinds"]}
    assert served == {row["kind"]: row["certificate"]
                      for row in want["kinds"]}
    assert all(row["substrates"]["served_certificate"] == row["certificate"]
               for row in got["kinds"])
    # the vertex kinds ride the preferred certificate; bridges falls back
    # to its declared 2ec
    assert served["cuts"] == served["bcc"] == certificate
    assert served["bridges"] == "2ec"
    assert {cert: (agg["kinds"], agg["rebuilds"])
            for cert, agg in got["certificates"].items()} == \
        {cert: (agg["kinds"], agg["rebuilds"])
         for cert, agg in want["certificates"].items()}
