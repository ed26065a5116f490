"""The control of a label cell's check (``clients/oneshot_labels.py``):
``control.py``'s control for an analysis that answers with one label per
vertex. The plain reference (``reference/two_ecc.py``) is put in the
program's place and computed one precision down, on the int32 ids
narrowed to int16 (``control.narrowed``), and ``harness.run_cell`` judges
its answers as it judges the program's: the check must come out
``correct: false``. The benchmark's own runs never run this.

    python3 cardbench/control_labels.py \
        --workload graph500_s24.oneshot_2ecc --seeds 11 12 13 [--seconds 20]

runs the seeds in one process on the card and prints one JSON line per
seed, as ``control.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

from cardbench import control, harness  # noqa: E402
from cardbench.parts import BENCH_DIR, load_json  # noqa: E402
from cardbench.reference import two_ecc  # noqa: E402


def control_labels(src, dst, n: int, device):
    """The reference's labels of the narrowed graph, for ``range(n)``."""
    s, d = control.narrowed(src, dst)
    return two_ecc.analyze(s, d, max(n, 1 << control.ID_BITS),
                           device)["labels"][:n]


class ControlLabels(control.ControlAnalyze):
    """The control in the place of ``repro_torch.analyze``, worked out
    once for each pair of arrays the client hands it."""

    def __call__(self, src, dst, n, *, kind="2ecc", **_):
        for s, d, k, answer in self._done:
            if s is src and d is dst and k == kind:
                return answer.copy()
        answer = control_labels(src, dst, n, self.device)
        self._done.append((src, dst, kind, answer))
        return answer.copy()


def control_run(cell, seed: int, seconds: float, device,
                roots=(BENCH_DIR,)) -> dict:
    """One run of ``cell`` with the control in the program's place: the
    harness's result line."""
    import repro_torch

    real = repro_torch.analyze
    repro_torch.analyze = ControlLabels(device)
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
