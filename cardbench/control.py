"""The control of a cell's check: the plain reference put in the program's
place, computed one precision down, and run through the harness's own
comparison.

The configurations state int32 vertex ids; the control narrows them to
int16 (two's complement, read back as ``0 .. 65535``) and answers with the
reference on the narrowed graph. ``repro_torch.analyze`` is replaced by
the control for the run, so the client sends the cell's own traffic to it
and ``harness.run_cell`` judges its answers as it judges the program's:
the check must come out ``correct: false``. The benchmark's own runs never
run this.

    python3 cardbench/control.py --workload fig2_dense.oneshot_bridges \
        --seeds 11 12 13 [--seconds 20]

runs the seeds in one process on the card and prints one JSON line per
seed: ``{"workload", "seed", "correct", "attempted", "failed", "checks",
"seconds"}``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

from cardbench import harness  # noqa: E402
from cardbench.parts import BENCH_DIR, load_json  # noqa: E402
from cardbench.reference import connectivity as reference  # noqa: E402

ID_BITS = 16


def narrowed(src, dst):
    """The edge arrays with int32 ids stored as int16 and read back."""
    wrap = 1 << ID_BITS
    return (np.asarray(src).astype(np.int16).astype(np.int64) % wrap,
            np.asarray(dst).astype(np.int16).astype(np.int64) % wrap)


def control_answer(src, dst, n: int, kind: str, device):
    """The reference's answer on the narrowed graph."""
    s, d = narrowed(src, dst)
    return reference.analyze(s, d, max(n, 1 << ID_BITS), device)[kind]


class ControlAnalyze:
    """The control in the place of ``repro_torch.analyze``. Its answer
    depends on the arrays alone, so it is worked out once for each pair of
    arrays the client hands it and given again when the same pair comes
    back."""

    def __init__(self, device):
        self.device = device
        self._done = []

    def __call__(self, src, dst, n, *, kind="bridges", **_):
        for s, d, k, answer in self._done:
            if s is src and d is dst and k == kind:
                return set(answer)
        answer = control_answer(src, dst, n, kind, self.device)
        self._done.append((src, dst, kind, answer))
        return set(answer)


def control_run(cell, seed: int, seconds: float, device,
                roots=(BENCH_DIR,)) -> dict:
    """One run of ``cell`` with the control in the program's place: the
    harness's result line."""
    import repro_torch

    real = repro_torch.analyze
    repro_torch.analyze = ControlAnalyze(device)
    try:
        return harness.run_cell(cell, seed, seconds, False, device,
                                roots=roots)
    finally:
        repro_torch.analyze = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: the manifest's run_seconds)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    manifest = load_json(harness.MANIFEST)
    cell = harness.resolve_cell(manifest, args.workload)
    seconds = args.seconds or manifest["run_seconds"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        result = control_run(cell, seed, seconds, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
