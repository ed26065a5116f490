"""Run one cell of the benchmark on the card and print its result line.

    python3 cardbench/run.py --workload fig2_dense.oneshot_bridges \
        --seed 12345 --seconds 20 --trace 0

Run from the root of a checkout: the program under test is the package
under ``src/`` beside this directory (``repro_torch``).
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``cardbench``) and its ``src`` (for the
# program), in place of this file's own directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from cardbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], started=STARTED))
