"""Run sets of runs of one cell, one process a run, and keep each result.

    python3 cardbench/sets.py --workload fig2_dense.oneshot_bridges \
        --seeds 101 102 103 104 105 106 --sets 2 --trace-seeds 201 202 203 \
        --extra-seeds 301 302 --seconds 20 \
        --out runs/fig2_dense.oneshot_bridges.jsonl

Each set runs the seeds in order with ``--trace 0``; the trace seeds run
once each with ``--trace 1`` after the sets, and the extra seeds once
each with ``--trace 0`` (set -2: more seeds judged, outside the spread).
One JSON line per run goes to ``--out``: the workload, set, seed, trace
flag, exit code, wall seconds, the result line (or None) and the end of
standard error. ``spread.py`` reads the file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(RUN), "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"rc": proc.returncode, "elapsed_s": time.perf_counter() - t0,
            "result": result, "stderr": proc.stderr[-1500:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    p.add_argument("--extra-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    plan = [(k, s, 0) for k in range(args.sets) for s in args.seeds]
    plan += [(-1, s, 1) for s in args.trace_seeds]
    plan += [(-2, s, 0) for s in args.extra_seeds]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for k, seed, trace in plan:
            rec = {"workload": args.workload, "set": k, "seed": seed,
                   "trace": trace,
                   **one_run(args.workload, seed, args.seconds, trace)}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            res = rec["result"] or {}
            print(json.dumps({
                "set": k, "seed": seed, "trace": trace, "rc": rec["rc"],
                "elapsed_s": round(rec["elapsed_s"], 1),
                "correct": res.get("correct"),
                "metrics": {m: v["value"] for m, v in
                            res.get("metrics", {}).items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
