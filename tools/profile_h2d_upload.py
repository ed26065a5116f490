#!/usr/bin/env python3
"""The one-shot entry's copy of an edge list to the card, by size and path.

    python3 tools/profile_h2d_upload.py [--repeats 5]
                                        [--out build/h2d_upload.json]

``--repeats`` sweeps over the edge counts (powers of two from 2^10 to 2^25,
and the benchmark's Fig. 2 and Fig. 4 sizes), each size in three ways of
putting int32 ``src`` and ``dst`` into a bucket-sized edge buffer on the
card, each timed on the host clock from the call to a
``torch.cuda.synchronize()`` after it (the copy done, as the pipeline after
it needs it), median of turns, each way's turns in a block of their own:

  tensor_cat  ``torch.tensor(np.asarray(x, np.int32), device=...)`` twice,
              then ``torch.cat`` with zeros to the bucket (the entry's copy
              before the pinned ring)
  plain       ``EdgeList.from_arrays`` with the plain copy forced at every
              size
  staged      ``EdgeList.from_arrays`` with the pinned ring forced at every
              size

``STAGED_MIN_IDS`` is the smallest size from which the median over the
sweeps of ``staged`` is no slower than that of ``plain`` at every larger
size. Each sweep's own such size is printed too: one slow turn of the
shared host at a single size can push a sweep's own past sizes where
``staged`` then wins again, which the median over sweeps does not. Then
the ring's parts at the Fig. 4 size: the host memcpy into the ring's
pinned slots alone (GB/s, with the CPU threads torch uses), one pinned DMA
alone (CUDA events), and the staged upload with other slot sizes and
counts. Prints one JSON line with all of it, the card's name, power limit
and PCIe link, and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.graph import datastructs as ds  # noqa: E402

FIG2_EDGES = 10_028_352
FIG4_EDGES = 38_990_000


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,pcie.link.gen.current,"
         "pcie.link.gen.max,pcie.link.width.current", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def tensor_cat(src, dst, cap, dev):
    s = torch.tensor(np.asarray(src, np.int32), device=dev)
    d = torch.tensor(np.asarray(dst, np.int32), device=dev)
    z = torch.zeros(cap - len(src), dtype=torch.int32, device=dev)
    mask = torch.ones(len(src), dtype=torch.bool, device=dev)
    return (torch.cat([s, z]), torch.cat([d, z]),
            torch.cat([mask, z.bool()]))


def forced(staged: bool):
    """``EdgeList.from_arrays`` with the threshold moved so that every size
    takes one path."""
    def call(src, dst, cap, dev):
        keep = ds.STAGED_MIN_IDS
        ds.STAGED_MIN_IDS = 0 if staged else 1 << 62
        try:
            return ds.EdgeList.from_arrays(src, dst, 7, capacity=cap,
                                           device=dev)
        finally:
            ds.STAGED_MIN_IDS = keep
    return call


def time_turns(calls: dict, args, turns: int) -> dict:
    """Median seconds of each call, from its start to the card's sync after
    it: each call's turns in a block of their own, after two untimed ones.
    Not in rotation: a pageable copy of the same size just before slows
    the ring's next multithreaded memcpy (on an H100 host of 8 cores, the
    Fig. 4 upload through the ring read 20-21 ms in rotation and 12 ms in
    blocks on one host, 74 ms in rotation and 13 ms alone on a busier
    one), and no caller makes such a copy between two staged ones."""
    out = {}
    for name, fn in calls.items():
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
        times = []
        for _ in range(turns):
            t0 = time.perf_counter()
            got = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del got
        out[name] = statistics.median(times)
    return out


def sweep(dev, seed: int) -> list:
    rng = np.random.default_rng(seed)
    sizes = sorted({1 << k for k in range(10, 26)} | {FIG2_EDGES,
                                                      FIG4_EDGES})
    calls = {"tensor_cat": tensor_cat, "plain": forced(False),
             "staged": forced(True)}
    if seed % 2:  # the other order, against drift within a size
        calls = dict(reversed(calls.items()))
    rows = []
    for m in sizes:
        src = rng.integers(0, 1 << 20, m, dtype=np.int32)
        dst = rng.integers(0, 1 << 20, m, dtype=np.int32)
        cap = ds.admission_capacity(m)
        turns = 40 if m <= 1 << 20 else 12
        t = time_turns(calls, (src, dst, cap, dev), turns)
        rows.append({"edges": m, "bytes": 8 * m,
                     **{f"{k}_ms": 1e3 * v for k, v in t.items()},
                     "staged_gb_s": 8 * m / t["staged"] / 1e9,
                     "plain_gb_s": 8 * m / t["plain"] / 1e9,
                     "tensor_cat_gb_s": 8 * m / t["tensor_cat"] / 1e9})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def median_rows(runs: list) -> list:
    """Per size, the median over the sweeps of each time."""
    keys = ("tensor_cat_ms", "plain_ms", "staged_ms")
    return [{"edges": rows[0]["edges"],
             **{k: statistics.median(r[k] for r in rows) for k in keys}}
            for rows in zip(*runs)]


def threshold(rows) -> int:
    """The smallest swept size from which ``staged`` is no slower than
    ``plain`` at every larger one."""
    pick = rows[-1]["edges"]
    for row in reversed(rows):
        if row["staged_ms"] > row["plain_ms"]:
            break
        pick = row["edges"]
    return pick


def parts(dev) -> dict:
    """The ring's two halves at the Fig. 4 size, and other ring shapes."""
    rng = np.random.default_rng(1)
    m = FIG4_EDGES
    host = torch.from_numpy(rng.integers(0, 1 << 20, m, dtype=np.int32))
    slots = torch.empty((ds.RING_SLOTS, ds.RING_SLOT_IDS), dtype=torch.int32,
                        pin_memory=True)
    step = ds.RING_SLOT_IDS
    memcpy = []
    for _ in range(5):  # through the ring's slots in turn, as a copy does
        t0 = time.perf_counter()
        for k, start in enumerate(range(0, m, step)):
            stop = min(start + step, m)
            slots[k % ds.RING_SLOTS, :stop - start].copy_(host[start:stop])
        memcpy.append(time.perf_counter() - t0)
    big = torch.empty(m, dtype=torch.int32, pin_memory=True)
    big.copy_(host)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    dma = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out.copy_(big, non_blocking=True)
        b.record()
        b.synchronize()
        dma.append(a.elapsed_time(b) / 1e3)
    shapes = {}
    src = host.numpy()
    dst = np.ascontiguousarray(src[::-1])
    cap = ds.admission_capacity(m)
    keep = ds.RING_SLOT_IDS, ds.RING_SLOTS
    for slot_ids, slots in ((1 << 20, 4), (1 << 21, 4), (1 << 22, 2),
                            (1 << 22, 4), (1 << 22, 8), (1 << 23, 4)):
        ds.RING_SLOT_IDS, ds.RING_SLOTS = slot_ids, slots
        ring = ds.PinnedRing(dev)
        ds._RINGS[dev.index] = ring
        try:
            t = time_turns({"staged": forced(True)}, (src, dst, cap, dev), 8)
        finally:
            ds.RING_SLOT_IDS, ds.RING_SLOTS = keep
            ds._RINGS.pop(dev.index)
        shapes[f"{4 * slot_ids >> 20}MiB_x{slots}"] = 1e3 * t["staged"]
    return {"edges": m, "torch_threads": torch.get_num_threads(),
            "cpu_count": os.cpu_count(),
            "host_memcpy_gb_s": 4 * m / statistics.median(memcpy) / 1e9,
            "pinned_dma_gb_s": 4 * m / statistics.median(dma) / 1e9,
            "staged_ms_by_ring": shapes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--out", default="build/h2d_upload.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)
    runs = [sweep(dev, seed) for seed in range(args.repeats)]
    medians = median_rows(runs)
    result = {"card": nvidia_smi(), "sweeps": runs, "medians": medians,
              "staged_min_ids_by_sweep": [threshold(r) for r in runs],
              "staged_min_ids": threshold(medians),
              "constant": ds.STAGED_MIN_IDS, "parts": parts(dev)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "sweeps"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
